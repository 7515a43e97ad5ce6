"""The port's initialisation (models/init.py) against the JAX package's
`model.init`, and the carry-across of params at 4 heads.

The two random streams never agree, so the init test compares statistics
per parameter, not values: at the JAX train bench's Dh = 128 geometry
(train.py `bench_hparams(4)`, every leaf of the model), constant leaves
(zero biases, unit LayerNorm scales) must be equal, and random leaves must
have the same mean and standard deviation up to sampling error: for n
samples of std s, the means within 6 s sqrt(2 / n) and the stds within a
relative 6 / sqrt(n) (six standard errors of the difference of two
independent estimates; the smallest random leaf has 512 entries).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze
from flax.traverse_util import flatten_dict

from sparse_vae_tpu_torch import checkpoint as ckpt
from sparse_vae_tpu_torch.models.transformer_vae import TransformerVAE
from sparse_vae_tpu_torch.train import bench_hparams
from tests.test_torch_checkpoint import r5_archive


@pytest.fixture(scope="module")
def jax_bench_params():
    """{leaf path: fp32 array} of JAX's model.init at bench.py --heads 4
    (bench.py initialises on tokens [1, 256])."""
    from dataclasses import asdict

    from sparse_vae_tpu import build_model
    module, _, _ = build_model("transformer-vae",
                               {**asdict(bench_hparams(4)),
                                "grad_checkpointing": False})
    tokens = jnp.full((1, 256), 5, jnp.int32).at[:, 0].set(1)
    params = module.init({"params": jax.random.PRNGKey(0),
                          "sample": jax.random.PRNGKey(0)}, tokens)["params"]
    return {"/".join(k): np.asarray(v, np.float32)
            for k, v in flatten_dict(unfreeze(params)).items()}


def test_init_statistics_match_jax_per_leaf(jax_bench_params):
    model, hp = ckpt.model_from_hparams(bench_hparams(4),
                                        torch.Generator().manual_seed(0),
                                        device="cpu", train=True)
    assert hp.num_heads == 4 and hp.d_model // hp.num_heads == 128
    named = dict(model.named_parameters())
    assert len(jax_bench_params) == len(named)
    for path, want in jax_bench_params.items():
        key, transpose = ckpt.torch_key(path)
        got = named[key].detach().numpy()
        got = got.T if transpose else got
        assert got.shape == want.shape, path
        n = want.size
        if want.std() == 0:
            assert got.std() == 0 and got.mean() == want.mean(), path
            continue
        s = float(want.std())
        assert abs(got.mean() - want.mean()) <= 6 * s * np.sqrt(2 / n), path
        assert abs(got.std() / s - 1) <= 6 / np.sqrt(n), path


def test_init_draws_from_the_given_generator():
    hp = bench_hparams(4)
    hp.num_layers = 1
    a, _ = ckpt.model_from_hparams(hp, torch.Generator().manual_seed(3),
                                   device="cpu")
    b, _ = ckpt.model_from_hparams(hp, torch.Generator().manual_seed(3),
                                   device="cpu")
    c, _ = ckpt.model_from_hparams(hp, torch.Generator().manual_seed(4),
                                   device="cpu")
    for (name, pa), pb, pc in zip(a.named_parameters(), b.parameters(),
                                  c.parameters()):
        assert torch.equal(pa, pb), name
        if pa.std() > 0:
            assert not torch.equal(pa, pc), name


def test_params_from_numpy_takes_four_heads(jax_bench_params):
    """The archive format of JAX-initialised heads-4 params loads through
    `params_from_numpy` into a 4-head model, strictly and bit for bit (the
    archive's bf16 values), and the heads-4 model has exactly r5's leaves:
    the head split changes no parameter shape."""
    flat = {path + ckpt.BF16_SUFFIX: np.asarray(jax.lax.bitcast_convert_type(
        jnp.asarray(arr).astype(jnp.bfloat16), jnp.uint16))
        for path, arr in jax_bench_params.items()}
    hp = bench_hparams(4)
    state = ckpt.params_from_numpy(flat, hp)
    model = TransformerVAE(hp)
    model.load_state_dict(state, strict=True)
    for path, arr in jax_bench_params.items():
        key, transpose = ckpt.torch_key(path)
        got = state[key].numpy()
        want = np.asarray(jnp.asarray(arr).astype(jnp.bfloat16)
                          .astype(jnp.float32))
        np.testing.assert_array_equal(got.T if transpose else got, want,
                                      err_msg=path)
    r5 = ckpt.params_from_numpy(r5_archive(), hp)
    assert {k: v.shape for k, v in r5.items()} == \
        {k: v.shape for k, v in state.items()}
