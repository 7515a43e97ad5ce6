"""The flagship model at full width: the archived real-prose-vae-r5 weights
(d_model 512, 8 heads, 6 layers, vocab 32,768) in fp32 on the CPU, through
the JAX package and the port on the same token ids and the same z.

Tolerance: logits reach |18| after six layers; fp32 differences in
summation order stay near 3e-5 absolute (measured 2.5e-5 on this input),
so the bound is 2e-4 absolute.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_vae_tpu.ops.attention import fill_cache_row as j_fill
from sparse_vae_tpu_torch.ops.attention import fill_cache_row as t_fill
from tests.test_torch_checkpoint import jax_r5, torch_r5

ATOL = 2e-4


@pytest.fixture(scope="module")
def r5():
    module, params = jax_r5()
    return module, {"params": params}, torch_r5()


def _inputs(seed=0, b=2, length=256):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, 32768, size=(b, length))
    ids[:, 0] = 1
    ids[1, 200:] = 0                  # a right-padded second document
    z = rng.standard_normal((b, 1, 64)).astype(np.float32)
    return ids, z


def test_reconstruct_logits_match_jax(r5):
    module, variables, model = r5
    ids, z = _inputs()
    want = module.apply(variables, jnp.asarray(ids), jnp.asarray(z),
                        method=type(module).reconstruct)
    with torch.no_grad():
        got = model.reconstruct(torch.from_numpy(ids), torch.from_numpy(z))
    real = ids != 0
    np.testing.assert_allclose(got.numpy()[real], np.asarray(want)[real],
                               atol=ATOL)


def test_decode_steps_with_per_row_offsets_match_jax(r5):
    """Row 0 decodes from position 0 (its z is the first input); row 1
    starts at position 130 after a bulk-prefilled prefix, so the rows sit
    in different blocks and ring slots. 16 steps, logits compared each."""
    module, variables, model = r5
    cls = type(module)
    rng = np.random.default_rng(1)
    b, steps, prefix = 2, 16, 130
    z = rng.standard_normal((b, 1, 64)).astype(np.float32)
    ids = np.zeros((1, 256), np.int64)
    ids[0, 0] = 1
    ids[0, 1:prefix] = rng.integers(3, 32768, size=prefix - 1)
    tokens = rng.integers(3, 32768, size=(steps, b))

    j_caches = module.apply(variables, b, 512, method=cls.init_caches)
    _, seeds = module.apply(variables, jnp.asarray(ids),
                            jnp.asarray(z[1:]), mutable=["cache_seed"],
                            method=cls.reconstruct_hidden)
    seeds = seeds["cache_seed"]
    j_caches = [j_fill(c, 1, seeds[f"layer_{i}"]["attention"]["k"][-1][0],
                       seeds[f"layer_{i}"]["attention"]["v"][-1][0], prefix)
                for i, c in enumerate(j_caches)]
    step_fn = jax.jit(lambda t, c, i, zz: module.apply(
        variables, t, c, i, zz, method=cls.decode_step_z_rowwise))

    with torch.no_grad():
        t_caches = model.init_caches(b, 512)
        _, kvs = model.reconstruct_hidden(torch.from_numpy(ids),
                                          torch.from_numpy(z[1:]),
                                          return_kv=True)
        for cache, (k, v) in zip(t_caches, kvs):
            t_fill(cache, 1, k[0], v[0], prefix)
        for s in range(steps):
            index = np.array([s, prefix + s])
            want, j_caches = step_fn(jnp.asarray(tokens[s]), j_caches,
                                     jnp.asarray(index), jnp.asarray(z))
            got, t_caches = model.decode_step_z_rowwise(
                torch.from_numpy(tokens[s]), t_caches,
                torch.from_numpy(index), torch.from_numpy(z))
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=ATOL, err_msg=f"step {s}")
