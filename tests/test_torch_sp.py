"""Sequence parallelism in the port (sparse_vae_tpu_torch/parallel/, K6 in
ops/sp_kernel.py) against the JAX package on the CPU.

- K6 with no ranks: the port's plain K6 (`SpWindowedAttentionFn` on CPU
  tensors) and its `windowed_attention_ctx` against JAX's
  `windowed_attention_ctx`, values and the gradients of sum(out * cot), on
  the cases of tests/test_sp.py; one case also against JAX's
  `sp_windowed_attention_pallas` in interpret mode. Tolerances as JAX's
  own test: 1e-5 on values, 1e-4 on gradients (fp32, summation order).
  A filler row (no valid key) gives out 0 and zero gradients, no NaN.
- The collectives over a gloo group of 4 ranks on the CPU: values and
  adjoints of `halo_from_left`, `sum_over_shards`, `max_over_shards`, the
  distributed-softmax cross attention, and `sp_shifted_labels` against
  the global shift (1e-5 as tests/test_sp.py).
- The sharded optimizer step, world 4, against the port's single-process
  step on JAX-initialised parameters and the same eps (loss rtol 1e-5;
  parameters rtol 2e-4, atol 2e-6, as tests/test_sp.py), and the
  single-process step against JAX's (metrics 2e-5 relative + 2e-6, params
  1e-6, as tests/test_torch_train.py), at block 16 (the blocked plain
  path), at block 128 with Dh 64 (the K6 route's plain version), with
  free bits, and on the multi-sample IWAE/DReG bound (train_mc_samples
  3; train_iwae_log_prob 1e-5 as tests/test_sp.py).
- The guard rails.

The ranks run tests/torch_sp_worker.py, which imports no JAX; they meet
through a file:// rendezvous in a temporary directory, and `spawn` stops
them after a timeout.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze
from flax.traverse_util import flatten_dict

from sparse_vae_tpu import build_model
from sparse_vae_tpu.ops.pallas_kernels import (_sp_fwd_impl,
                                               sp_windowed_attention_pallas)
from sparse_vae_tpu.parallel.sp import \
    windowed_attention_ctx as jax_windowed_attention_ctx
from sparse_vae_tpu.parallel.spmd import make_train_step
from sparse_vae_tpu.training.optimizer import make_optimizer as j_make_opt
from sparse_vae_tpu_torch import checkpoint as ckpt
from sparse_vae_tpu_torch.models.transformer_vae import (
    TransformerVAE, TransformerVAEHparams)
from sparse_vae_tpu_torch.models.vae import VAEObjective
from sparse_vae_tpu_torch.ops import sp_kernel, swa_kernel
from sparse_vae_tpu_torch.ops.attention import Attention, dense_attention
from sparse_vae_tpu_torch.parallel.group import SeqGroup, spawn
from sparse_vae_tpu_torch.parallel.sp import (halo_blocks, sp_localize,
                                              windowed_attention_ctx)
from sparse_vae_tpu_torch.parallel.spmd import SeqOnceObjective
from sparse_vae_tpu_torch.training.optimizer import make_optimizer
from sparse_vae_tpu_torch.training.train_step import train_step
from tests.torch_sp_worker import collective_inputs, run_rank

WORLD = 4
RANK_TIMEOUT_S = 300.0


# -- K6 without ranks ------------------------------------------------------------
def _k6_inputs(seed, start_blocks, pad, ws, B=2, H=2, S=64, D=8, bs=16,
               cls_lens=None):
    rng = np.random.default_rng(seed)
    ctx = halo_blocks(ws) * bs
    f32 = np.float32
    q = rng.standard_normal((B, H, S, D)).astype(f32)
    k_ext, v_ext = (rng.standard_normal((B, H, ctx + S, D)).astype(f32)
                    for _ in range(2))
    cls_k, cls_v = (rng.standard_normal((B, H, bs, D)).astype(f32)
                    for _ in range(2))
    ext_len = (rng.integers(ctx + S // 2, ctx + S, size=B) if pad
               else np.full(B, ctx + S)).astype(np.int32)
    cls_len = np.array(cls_lens if cls_lens else [bs] * B, np.int32)
    if start_blocks == 0:
        # shard 0: the halo rows are invalid, ext_len counts LOCAL keys.
        ext_len = np.minimum(ext_len - ctx, S).astype(np.int32)
    pos = np.arange(ctx + S)
    if start_blocks == 0:
        mask_ext = (pos[None] >= ctx) & (pos[None] - ctx < ext_len[:, None])
    else:
        mask_ext = pos[None] < ext_len[:, None]
    cls_mask = np.arange(bs)[None] < cls_len[:, None]
    cot = rng.standard_normal((B, H, S, D)).astype(f32)
    return (q, k_ext, v_ext, cls_k, cls_v), ext_len, cls_len, mask_ext, \
        cls_mask, cot, ctx, bs


@pytest.mark.parametrize("start_blocks,pad,ws,cls_lens", [
    pytest.param(*case, None, id="-".join(map(str, case))) for case in (
        (0, False, 2), (8, False, 2), (8, True, 2), (4, True, 2),
        (8, False, 1), (8, False, 3))] + [
    # A partial [CLS] on a banded shard: both rows short of the block,
    # then one row with no [CLS] key beside a full one.
    pytest.param(8, True, 2, (9, 13), id="8-True-2-cls9,13"),
    pytest.param(8, False, 3, (0, 16), id="8-False-3-cls0,16")])
def test_k6_matches_jax(start_blocks, pad, ws, cls_lens):
    (arrays, ext_len, cls_len, mask_ext, cls_mask, cot, ctx,
     bs) = _k6_inputs(start_blocks + 17, start_blocks, pad, ws,
                      cls_lens=cls_lens)
    start = start_blocks * bs
    # On shard 0 the [CLS] store IS the local block 0: derive it inside
    # the function, so that both sides (whose split of the gradient
    # between dk_ext and dcls differs there) are compared on the total.
    if start_blocks == 0:
        def expand(a):
            return (a[0], a[1], a[2], a[1][:, :, ctx:ctx + bs],
                    a[2][:, :, ctx:ctx + bs])
        arrays = arrays[:3]
    else:
        def expand(a):
            return a

    def jax_fn(a):
        return jax_windowed_attention_ctx(
            *expand(a), jnp.asarray(start), jnp.asarray(mask_ext),
            jnp.asarray(cls_mask), window_size=ws, block_size=bs)

    ja = tuple(jnp.asarray(x) for x in arrays)
    want = np.asarray(jax_fn(ja))
    want_g = jax.grad(lambda a: jnp.sum(jax_fn(a) * cot))(ja)
    runs = {
        "k6": lambda a: sp_kernel.sp_windowed_attention(
            *expand(a), start, torch.tensor(ext_len), torch.tensor(cls_len),
            ws, bs),
        "ctx": lambda a: windowed_attention_ctx(
            *expand(a), start, torch.tensor(mask_ext),
            torch.tensor(cls_mask), window_size=ws, block_size=bs)}
    interpret = (start_blocks, pad, ws) == (8, True, 2)
    if interpret:
        def jax_kernel(a):
            return sp_windowed_attention_pallas(
                *expand(a), jnp.asarray(start), jnp.asarray(ext_len),
                jnp.asarray(cls_len), ws, bs, True)
        kernel_out = np.asarray(jax_kernel(ja))
        kernel_g = jax.grad(lambda a: jnp.sum(jax_kernel(a) * cot))(ja)
    for name, fn in runs.items():
        ta = tuple(torch.tensor(x, requires_grad=True) for x in arrays)
        out = fn(ta)
        (out * torch.tensor(cot)).sum().backward()
        np.testing.assert_allclose(out.detach().numpy(), want, rtol=1e-5,
                                   atol=1e-5, err_msg=name)
        for t, g in zip(ta, want_g):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                       rtol=1e-4, atol=1e-4, err_msg=name)
        if interpret:
            np.testing.assert_allclose(out.detach().numpy(), kernel_out,
                                       rtol=1e-5, atol=1e-5)
            for t, g in zip(ta, kernel_g):
                np.testing.assert_allclose(t.grad.numpy(), np.asarray(g),
                                           rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("start_blocks", [0, 8])
def test_k6_filler_row_gives_zero_and_no_nan(start_blocks):
    """Row 1 is a filler row: no valid extended key and no valid [CLS]
    key. Its out and every gradient it feeds are 0, and row 0 is as if
    row 1 were absent."""
    (arrays, ext_len, cls_len, _, _, cot, ctx,
     bs) = _k6_inputs(5, start_blocks, False, 2)
    ext_len[1], cls_len[1] = 0, 0
    ta = tuple(torch.tensor(x, requires_grad=True) for x in arrays)
    out = sp_kernel.sp_windowed_attention(
        *ta, start_blocks * bs, torch.tensor(ext_len),
        torch.tensor(cls_len), 2, bs)
    (out * torch.tensor(cot)).sum().backward()
    assert bool(torch.isfinite(out).all())
    assert bool((out[1] == 0).all())
    for t in ta:
        assert bool(torch.isfinite(t.grad).all())
        assert bool((t.grad[1] == 0).all())
    solo = tuple(torch.tensor(x[:1], requires_grad=True) for x in arrays)
    out0 = sp_kernel.sp_windowed_attention(
        *solo, start_blocks * bs, torch.tensor(ext_len[:1]),
        torch.tensor(cls_len[:1]), 2, bs)
    (out0 * torch.tensor(cot[:1])).sum().backward()
    torch.testing.assert_close(out[:1], out0)
    for t, s in zip(ta, solo):
        torch.testing.assert_close(t.grad[:1], s.grad)


def _swa_fwd_cls(arrays, ext_len, cls_len, ws, bs):
    """The port's K1 forward with the broadcast [CLS] slot on a banded
    shard (the CPU runs its plain version): (out, lse)."""
    q, k_ext, v_ext, cls_k, cls_v = (torch.tensor(x) for x in arrays)
    return swa_kernel.swa_fwd(
        q, k_ext, v_ext, torch.tensor(ext_len), window_size=ws,
        block_size=bs, include_cls=False, q_off=halo_blocks(ws),
        cls=(cls_k, cls_v, torch.tensor(cls_len)))


@pytest.mark.parametrize("ws,cls_lens", [
    (1, None), (2, None), (3, None), (2, (9, 13)), (3, (0, 16))])
def test_swa_fwd_with_cls_matches_jax_kernel(ws, cls_lens):
    """`swa_fwd(..., cls=...)`, K6's banded forward as one call (at window
    1 q_off is 0 beside a broadcast block), against JAX's
    `_sp_fwd_impl` (the band kernel in interpret mode, `_cls_attend` and
    the logaddexp merge): out and the joint lse, on ragged rows with a
    full, a partial or no [CLS]. Tolerance as K6's: 1e-5 (fp32, summation
    order)."""
    (arrays, ext_len, cls_len, _, _, _, _,
     bs) = _k6_inputs(30 + ws, 8, True, ws, cls_lens=cls_lens)
    want, want_lse = _sp_fwd_impl(
        *(jnp.asarray(x) for x in arrays), jnp.asarray(8 * bs),
        jnp.asarray(ext_len), jnp.asarray(cls_len), ws, bs, True)
    out, lse = _swa_fwd_cls(arrays, ext_len, cls_len, ws, bs)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), rtol=1e-5,
                               atol=1e-5)


def test_swa_fwd_with_cls_filler_row_gives_zero_and_no_nan():
    """Row 1 of a banded shard has no valid extended key and no valid
    [CLS] key: out 0, lse -inf, no NaN, and row 0 is as if row 1 were
    absent."""
    (arrays, ext_len, cls_len, _, _, _, _,
     bs) = _k6_inputs(6, 8, False, 2)
    ext_len[1], cls_len[1] = 0, 0
    out, lse = _swa_fwd_cls(arrays, ext_len, cls_len, 2, bs)
    assert bool(torch.isfinite(out).all())
    assert bool((out[1] == 0).all()) and bool(torch.isneginf(lse[1]).all())
    out0, lse0 = _swa_fwd_cls(tuple(x[:1] for x in arrays), ext_len[:1],
                              cls_len[:1], 2, bs)
    torch.testing.assert_close(out[:1], out0)
    torch.testing.assert_close(lse[:1], lse0)


# -- the multi-rank run ------------------------------------------------------------
def _jax_hparams(**kw):
    base = dict(d_model=64, num_heads=2, num_layers=2, latent_depth=8,
                vocab_size=128, num_encoder_latents=4,
                sparse_self_attention=True, attn_window_size=2,
                attn_block_size=16, use_pallas_kernel=False,
                loss_chunk_size=32, free_bits=0.0, precision="fp32",
                grad_checkpointing=False)
    base.update(kw)
    return base


OPTIMIZER = dict(lr=1e-2, lr_decay_steps=1000, grad_clip_threshold=5.0)

# name: (JAX hparams overrides, micro-batches k, rows b, length L, seed)
CASES = {
    # tests/test_sp.py's exact step: num_encoder_latents == the shard
    # length (64), so a learned-query layer must add no residual.
    "block16": (dict(num_encoder_latents=64), 2, 3, 256, 0),
    # Dh 64 at block 128: the K6 route ("kernel"), on the CPU its plain
    # version, and K1/K2's route in the single-process step.
    "block128": (dict(d_model=128, attn_block_size=128), 1, 2, 1024, 31),
    "free_bits": (dict(free_bits=0.25), 1, 2, 256, 5),
    # The multi-sample IWAE/DReG bound (tests/test_sp.py
    # test_dreg_train_step_exact): every shard decodes the same 3 samples
    # of z and reconstruct_ll sums each document over the shards.
    "dreg": (dict(train_mc_samples=3), 1, 2, 256, 21),
}

# The step's metrics each case's checks compare.
ELBO_METRICS = ("loss", "train_nll", "train_kl", "grad_norm")
DREG_METRICS = ("loss", "train_iwae_log_prob", "grad_norm")


def _metrics(name):
    return DREG_METRICS if name == "dreg" else ELBO_METRICS


def _batch(rng, k, b, L, vocab):
    """[k] micro-batches [b, L] with trailing pad runs (tests/test_sp.py
    `_batch`)."""
    lengths = rng.integers(L // 2, L, size=(k, b))
    tokens = rng.integers(3, vocab, size=(k, b, L))
    tokens = tokens * (np.arange(L)[None, None] < lengths[:, :, None])
    return tokens, lengths


def _leaves(tree):
    return {"/".join(p): np.array(v)
            for p, v in flatten_dict(unfreeze(tree)).items()}


def _port_hparams(jax_kw):
    kw = {k: v for k, v in jax_kw.items() if k != "grad_checkpointing"}
    kw["use_pallas_kernel"] = True
    return TransformerVAEHparams(**kw)


def _prepare(name):
    """The case's JAX step (make_train_step, mesh=None), its inputs and
    the port's inputs: JAX-initialised parameters carried across and the
    noise read off the JAX step's own rng splits."""
    overrides, k, b, L, seed = CASES[name]
    jkw = _jax_hparams(**overrides)
    module, jhp, jobj = build_model("transformer-vae", jkw)
    rng = np.random.default_rng(seed)
    tokens, lengths = _batch(rng, k, b, L, jhp.vocab_size)
    params = module.init({"params": jax.random.PRNGKey(seed),
                          "sample": jax.random.PRNGKey(seed)},
                         jnp.asarray(tokens[0][:1]))["params"]
    leaves = _leaves(params)
    key = jax.random.PRNGKey(seed + 7)
    cls = type(module)
    noise = []
    for r, ids in zip(jax.random.split(key, k), tokens):
        drop, sample, mi = jax.random.split(r, 3)
        if jhp.train_mc_samples > 1:
            # iwae_dreg_loss's draw: normal(sample, (K, *loc.shape)).
            eps = jax.random.normal(sample, (jhp.train_mc_samples, b, 1,
                                             jhp.latent_depth))
            noise.append({"eps": torch.tensor(np.array(eps))})
            continue
        q, _, z = module.apply({"params": params}, jnp.asarray(ids),
                               rngs={"dropout": drop, "sample": sample},
                               method=cls.posterior_and_z)
        mi_eps = jax.random.normal(mi, (jobj.mi_samples, b,
                                        jhp.latent_depth))
        noise.append({"eps": torch.tensor(np.array((z - q.loc) / q.scale)),
                      "mi": torch.tensor(np.array(mi_eps))})
    optimizer = j_make_opt(**OPTIMIZER)
    batch = {"token_ids": jnp.asarray(tokens),
             "num_tokens": jnp.asarray(lengths),
             "num_bytes": jnp.asarray(lengths)}
    step = 3
    step_fn = make_train_step(module, jobj, optimizer, mesh=None)
    new_params, _, metrics = step_fn(params, optimizer.init(params), batch,
                                     step, key)
    hp = _port_hparams(jkw)
    z = torch.tensor(rng.standard_normal((b, 1, hp.latent_depth)),
                     dtype=torch.float32)
    case = {"hparams": dataclasses.asdict(hp),
            "state": ckpt.state_from_leaves(leaves, hp),
            "batches": [{"token_ids": torch.tensor(t),
                         "num_tokens": torch.tensor(n)}
                        for t, n in zip(tokens, lengths)],
            "noise": noise, "step": step, "optimizer": OPTIMIZER, "z": z}
    jax_out = {"metrics": {n: float(v) for n, v in metrics.items()},
               "params": _leaves(new_params)}
    return case, jax_out


def _single_process(case):
    hp = TransformerVAEHparams(**case["hparams"])
    model = TransformerVAE(hp)
    model.load_state_dict(case["state"], strict=True)
    with torch.no_grad():
        ll = model.reconstruct_ll(case["batches"][0]["token_ids"], case["z"])
    opt = make_optimizer(model.parameters(), **case["optimizer"])
    metrics = train_step(model, VAEObjective(hp), opt, case["batches"],
                         case["step"], case["noise"])
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "params": {k: v.detach().clone()
                       for k, v in model.state_dict().items()},
            "reconstruct_ll": ll}


@pytest.fixture(scope="module")
def sp_run():
    """One spawn of 4 gloo ranks on the CPU for every multi-rank check:
    the collectives and each case's step. Returns (rank records, the
    cases, JAX's steps, the single-process steps)."""
    names = list(CASES)
    prepared = [_prepare(n) for n in names]
    cases = [c for c, _ in prepared]
    records = spawn(run_rank, WORLD, "cpu", (cases,),
                    timeout=RANK_TIMEOUT_S)
    return {"records": records,
            "cases": dict(zip(names, cases)),
            "jax": {n: j for n, (_, j) in zip(names, prepared)},
            "single": {n: _single_process(c) for n, c in zip(names, cases)}}


def test_halo_from_left_values_and_adjoint(sp_run):
    inp = collective_inputs(WORLD)
    for r, rec in enumerate(sp_run["records"]):
        y, dx = rec["collectives"]["halo"]
        want = inp["x"][r - 1] if r > 0 else np.zeros_like(inp["x"][0])
        want_dx = (inp["cot"][r + 1] if r < WORLD - 1
                   else np.zeros_like(inp["x"][0]))
        np.testing.assert_array_equal(y.numpy(), want)
        np.testing.assert_array_equal(dx.numpy(), want_dx)


def test_sum_and_max_over_shards_values_and_adjoints(sp_run):
    inp = collective_inputs(WORLD)
    for rec in sp_run["records"]:
        y, dx = rec["collectives"]["sum"]
        np.testing.assert_allclose(y.numpy(), inp["x"].sum(0), rtol=1e-5)
        np.testing.assert_allclose(dx.numpy(), inp["cot"].sum(0), rtol=1e-5)
        y, dx = rec["collectives"]["max"]
        np.testing.assert_array_equal(y.numpy(), inp["x"].max(0))
        np.testing.assert_array_equal(dx.numpy(), np.zeros_like(inp["x"][0]))


def test_shifted_labels_cross_shard_boundaries(sp_run):
    tokens = collective_inputs(WORLD)["tokens"]
    want = TransformerVAE.shifted_labels(torch.tensor(tokens))
    got = torch.cat([rec["collectives"]["labels"]
                     for rec in sp_run["records"]], dim=1)
    assert torch.equal(got, want)


def test_cross_attention_combine_matches_dense(sp_run):
    """The distributed softmax of replicated queries over 4 key shards
    against dense attention over all keys: output, dq (each rank's
    partial, summed as the train step sums gradients) and dk, dv."""
    inp = collective_inputs(WORLD)
    q = torch.tensor(inp["q"], requires_grad=True)
    k, v = (torch.tensor(inp[n], requires_grad=True) for n in ("k", "v"))
    mask = torch.tensor(inp["kv_mask"])[:, None, None, :]
    want = dense_attention(q, k, v, mask)
    (want * torch.tensor(inp["attn_cot"])).sum().backward()
    recs = [rec["collectives"]["cross"] for rec in sp_run["records"]]
    for y, *_ in recs:
        torch.testing.assert_close(y, want.detach(), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(sum(dq for _, dq, _, _ in recs), q.grad,
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(torch.cat([dk for *_, dk, _ in recs], 2),
                               k.grad, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(torch.cat([dv for *_, dv in recs], 2),
                               v.grad, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", list(CASES))
def test_single_process_step_matches_jax(sp_run, name):
    got, want = sp_run["single"][name], sp_run["jax"][name]
    for metric in _metrics(name):
        np.testing.assert_allclose(got["metrics"][metric],
                                   want["metrics"][metric], rtol=2e-5,
                                   atol=2e-6, err_msg=metric)
    for path, value in want["params"].items():
        key, transpose = ckpt.torch_key(path)
        p = got["params"][key].numpy()
        np.testing.assert_allclose(p.T if transpose else p, value,
                                   atol=1e-6, err_msg=path)


@pytest.mark.parametrize("name", list(CASES))
def test_sp_step_matches_single_process(sp_run, name):
    """Every rank's step on its quarter of the length axis: the same
    (global) metrics as the single-process step, and the same updated
    parameters, bitwise equal on every rank."""
    single = sp_run["single"][name]
    idx = list(CASES).index(name)
    steps = [rec["steps"][idx] for rec in sp_run["records"]]
    for rec in steps:
        np.testing.assert_allclose(rec["metrics"]["loss"],
                                   single["metrics"]["loss"], rtol=1e-5)
        if name == "dreg":
            np.testing.assert_allclose(
                rec["metrics"]["train_iwae_log_prob"],
                single["metrics"]["train_iwae_log_prob"], rtol=1e-5)
        else:
            np.testing.assert_allclose(rec["metrics"]["train_kl"],
                                       single["metrics"]["train_kl"],
                                       rtol=1e-4, atol=1e-7)
        for key, want in single["params"].items():
            torch.testing.assert_close(rec["params"][key], want, rtol=2e-4,
                                       atol=2e-6, msg=key)
        for key, p in steps[0]["params"].items():
            assert torch.equal(rec["params"][key], p), key
        torch.testing.assert_close(rec["reconstruct_ll"],
                                   single["reconstruct_ll"], rtol=1e-5,
                                   atol=1e-4)
    counts = [rec["launches"] for rec in steps]
    if name == "block128":
        # The K6 route's plain version on the CPU: no plain_routes count,
        # no kernel launch.
        assert all(c["swa_plain_routes"] == 0 for c in counts)
    assert all(c["sp_windowed_attention"] == 0 for c in counts)


# -- guard rails ------------------------------------------------------------------
def _tiny(**kw):
    hp = _port_hparams(_jax_hparams(**kw))
    torch.manual_seed(0)
    return TransformerVAE(hp)


def _group(rank=1):
    return SeqGroup(rank, WORLD, torch.device("cpu"), "gloo")


def test_dense_self_attention_is_rejected():
    with pytest.raises(ValueError, match="sparse sliding-window"):
        sp_localize(_tiny(sparse_self_attention=False), _group())
    attn = Attention(64, 2, causal=True)
    attn.seq_group = _group()
    with pytest.raises(ValueError, match="sparse causal"):
        attn(torch.zeros(1, 64, 64))


def test_shard_shorter_than_the_window_is_rejected():
    model = sp_localize(_tiny(), _group())
    ids = torch.full((1, 16), 5)         # one block; the window is two
    with pytest.raises(ValueError, match="window span"):
        model.reconstruct_hidden(ids, torch.zeros(1, 1, 8))


def test_unchunked_loss_is_rejected():
    model = _tiny(loss_chunk_size=0)
    with pytest.raises(ValueError, match="chunked loss"):
        SeqOnceObjective(VAEObjective(model.hparams), _group())


def test_model_built_sharded_is_rejected():
    hp = _port_hparams(_jax_hparams())
    with pytest.raises(ValueError, match="sp_localize"):
        TransformerVAE(dataclasses.replace(hp, sp_size=4))


def test_k6_shape_outside_the_instantiation_raises_off_the_cpu():
    """Dh 520 at block 128 is inside the JAX package's K6 gate but beyond
    every CUDA kernel's range: a meta tensor (standing in for a CUDA one)
    raises, and a CPU call counts a plain route. Dh 32 and 128 and block
    256 take the kernels (the generic pair, K1/K2)."""
    assert sp_kernel.route(520, 128) == "plain"
    assert sp_kernel.route(64, 128) == "kernel"
    assert sp_kernel.route(32, 128) == "kernel"
    assert sp_kernel.route(128, 256) == "kernel"
    assert sp_kernel.route(32, 16) == "outside"
    attn = Attention(1040, 2, causal=True, sparse=True, block_size=128)
    attn.seq_group = _group()
    with pytest.raises(NotImplementedError, match="head_dim 520"):
        attn(torch.zeros(1, 256, 1040, device="meta"))
    before = swa_kernel.plain_routes
    # With no process group it stops at the first collective.
    with pytest.raises(ValueError, match="process group"):
        attn(torch.zeros(1, 256, 1040))
    assert swa_kernel.plain_routes == before + 1


def test_train_entry_point_runs_sequence_parallel_on_the_cpu(capfd):
    """`python -m sparse_vae_tpu_torch.train ... sp=2 device=cpu`: r5 on one
    [1, 1024] document over 2 spawned gloo ranks; each rank prints its
    line, rank 0 the step's finite metrics."""
    import json

    from sparse_vae_tpu_torch import train
    assert train.main(["train", "transformer-vae", "real-prose-vae-r5",
                       "sp=2", "steps=1", "batch=1", "seq=1024",
                       "accumulate=1", "device=cpu"]) == 0
    lines = [json.loads(line) for line in capfd.readouterr().out.splitlines()
             if line.startswith("{")]
    assert lines[0] == {"sp": 2, "backend": "gloo"}
    ranks = sorted(x["rank"] for x in lines if "rank" in x)
    assert ranks == [0, 1]
    assert all(x["local_tokens"] == 512 for x in lines if "rank" in x)
    (step,) = [x for x in lines if "loss" in x]
    assert step["sp"] == 2 and step["tokens"] == 1024
    assert all(np.isfinite(step[k]) for k in ("loss", "grad_norm"))
