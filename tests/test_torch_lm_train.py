"""draft-tlm-r5's training objective, its bf16 training form and its
decode steps against the JAX package on the CPU, in fp32 unless a test
says otherwise (tests/test_torch_lm.py has the helpers and states the
tolerances: losses 2e-5 relative, gradients 2e-3 of the largest entry +
1e-7, logits 2e-5 of the largest |logit|; bf16 within the margins
tests/test_torch_train.py gives r5).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_vae_tpu.training.objectives import ARObjective as JObjective
from sparse_vae_tpu_torch import checkpoint as ckpt
from sparse_vae_tpu_torch.ops import attention as tattn
from sparse_vae_tpu_torch.training.objectives import ARObjective
from tests.test_torch_lm import (BF16_COS_MARGIN, BF16_LOSS_MARGIN,
                                 LOGIT_REL, LOSS_RTOL, RUN,
                                 _assert_grads_match, _batch, _cosines,
                                 _documents, _jax_lm, _jax_loss, _port_loss,
                                 draft, one_thread)  # noqa: F401 (fixtures)

DOCUMENTS = {512: [512, 300], 384: [384, 200, 97]}
_FP32 = {}


def _fp32_reference(draft, width: int):
    """(batch, JAX's fp32 loss, its gradients) of draft-tlm-r5 on the
    documents of DOCUMENTS[width], computed once in this process (the bf16
    test holds itself against the same reference); at 384 the loss only."""
    if width not in _FP32:
        module, objective, params, _, _ = draft
        batch = _batch(*_documents(np.random.default_rng(width),
                                   DOCUMENTS[width], width, 32768))
        _FP32[width] = (batch, *_jax_loss(module, objective, params, batch,
                                          grads=width == 512))
    return _FP32[width]


@pytest.mark.parametrize("width", [512, 384])
def test_draft_objective_matches_jax(draft, width):
    """ARObjective's chunked loss (forward_hidden + the fused tied CE at
    D = 256) on draft-tlm-r5 at a width inside the dense gate (512, also
    its 36 gradients, eval_stats and reduce_eval) and one outside it (384:
    the masked dense path, the loss)."""
    module, objective, params, model, hp = draft
    batch, jax_loss, jax_grads = _fp32_reference(draft, width)
    port_loss, metrics, port_grads = _port_loss(model, hp, batch)
    np.testing.assert_allclose(port_loss, jax_loss, rtol=LOSS_RTOL)
    assert float(metrics["train_nll"].detach()) == port_loss
    if width != 512:
        return
    _assert_grads_match(port_grads, jax_grads)

    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = objective.eval_stats(module, params, jb, jax.random.PRNGKey(0))
    with torch.no_grad():
        got = ARObjective(hp).eval_stats(
            model, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(got) == set(want)
    for name in want:
        np.testing.assert_allclose(float(got[name]), float(want[name]),
                                   rtol=LOSS_RTOL, err_msg=name)
    stats = {k: float(v) for k, v in got.items()}
    jstats = {k: float(v) for k, v in want.items()}
    port_red, jax_red = ARObjective.reduce_eval(stats), \
        JObjective.reduce_eval(jstats)
    assert set(port_red) == set(jax_red) == {"val_nll", "val_bpb",
                                             "val_loss"}
    for name in jax_red:
        np.testing.assert_allclose(port_red[name], jax_red[name],
                                   rtol=LOSS_RTOL, err_msg=name)


def test_draft_bf16_loss_is_as_close_to_fp32_as_jax_bf16(draft):
    """draft-tlm-r5 computing in bf16 over fp32 master weights, as it was
    trained, in both packages: the port's loss and its 36 gradients no
    farther from JAX's fp32 ones than JAX's bf16, within the margins
    tests/test_torch_train.py gives r5."""
    params = draft[2]
    batch, loss32, grads32 = _fp32_reference(draft, 512)
    jmodule, jobjective = _jax_lm("bf16")
    jax_loss, jax_grads = _jax_loss(jmodule, jobjective, params, batch)
    model, hp, _ = ckpt.load_run(RUN, device="cpu", dtype=torch.bfloat16,
                                 train=True)
    port_loss, _, port_grads = _port_loss(model, hp, batch)
    jax_rel = abs(jax_loss - loss32) / abs(loss32)
    port_rel = abs(port_loss - loss32) / abs(loss32)
    jax_cos = min(_cosines(jax_grads, grads32).values())
    port_cos = min(_cosines(port_grads, grads32).values())
    assert np.isfinite(port_loss) and port_rel <= jax_rel + BF16_LOSS_MARGIN, \
        (port_rel, jax_rel)
    assert port_cos >= jax_cos - BF16_COS_MARGIN, (port_cos, jax_cos)


def test_draft_rowwise_and_scalar_decode_match_jax(draft):
    """decode_step_rowwise with the rows at their own positions (row 1
    after a bulk-prefilled 130-token prefix, through the dense cache) and
    decode_step with every row at one position, 12 steps each, logits
    against JAX's."""
    from sparse_vae_tpu.ops.attention import fill_cache_row as j_fill
    module, _, params, model, _ = draft
    cls = type(module)
    v = {"params": params}
    rng = np.random.default_rng(5)
    b, steps, prefix, ml = 2, 12, 130, 256
    ids = np.zeros((1, 256), np.int64)
    ids[0, 0] = 1
    ids[0, 1:prefix] = rng.integers(3, 32768, size=prefix - 1)
    tokens = rng.integers(3, 32768, size=(steps, b))

    rowwise = jax.jit(lambda t, c, i: module.apply(
        v, t, c, i, method=cls.decode_step_rowwise))
    scalar = jax.jit(lambda t, c, i: module.apply(
        v, t, c, i, method=cls.decode_step))
    j_caches = module.apply(v, b, ml, method=cls.init_caches)
    _, seeds = module.apply(v, jnp.asarray(ids), mutable=["cache_seed"],
                            method=cls.forward_hidden)
    seeds = seeds["cache_seed"]
    j_caches = [j_fill(c, 1, seeds[f"layer_{i}"]["attention"]["k"][-1][0],
                       seeds[f"layer_{i}"]["attention"]["v"][-1][0], prefix)
                for i, c in enumerate(j_caches)]
    with torch.no_grad():
        t_caches = model.init_caches(b, ml)
        _, kvs = model.forward_hidden(torch.from_numpy(ids), return_kv=True)
        for cache, (k, vv) in zip(t_caches, kvs):
            tattn.fill_cache_row(cache, 1, k[0], vv[0], prefix)
        index = np.array([0, prefix])
        for s in range(steps):
            want, j_caches = rowwise(jnp.asarray(tokens[s]), j_caches,
                                     jnp.asarray(index))
            got, t_caches = model.decode_step_rowwise(
                torch.from_numpy(tokens[s]), t_caches,
                torch.from_numpy(index))
            want = np.asarray(want)
            assert np.abs(got.numpy() - want).max() <= \
                LOGIT_REL * np.abs(want).max(), s
            index = index + 1

        j_caches = module.apply(v, b, ml, method=cls.init_caches)
        t_caches = model.init_caches(b, ml)
        for s in range(steps):
            want, j_caches = scalar(jnp.asarray(tokens[s]), j_caches,
                                    jnp.asarray(s))
            got, t_caches = model.decode_step(torch.from_numpy(tokens[s]),
                                              t_caches, s)
            want = np.asarray(want)
            assert np.abs(got.numpy() - want).max() <= \
                LOGIT_REL * np.abs(want).max(), s
