"""The Transformer LM family against the JAX package on the CPU: the fused
tied CE's plain versions at the LM's width D = 256, the dense causal
attention route (K1/K2's plain versions at a causal band of every block),
draft-tlm-r5's archived weights (forward, ARObjective, bf16, decode
steps), a JAX-initialised sparse LM, and the checkpoint.

The same numpy inputs, made from a seed, go through both packages in
fp32. Tolerances, each stated where it is used:
- logits and losses: fp32 summation order through 2 layers and a
  32,768-way softmax, measured ~4e-6 absolute on logits of |6|; logits
  within 2e-5 of the largest |logit|, losses within 2e-5 relative;
- gradients: per tensor, |port - jax| <= 2e-3 * max|jax| + 1e-7, as the
  Transformer-VAE's training tests;
- the fused CE at D = 256: as tests/test_torch_ce.py (nll 1e-5, gradients
  1e-4 relative + 5e-5 absolute);
- attention outputs at real query positions 2e-5 absolute on values of
  order 1, gradients 1e-4 absolute.
"""
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze
from flax.traverse_util import flatten_dict

from sparse_vae_tpu import build_model
from sparse_vae_tpu.ops.attention import dense_attention as j_dense
from sparse_vae_tpu.ops.pallas_ce import fused_tied_cross_entropy
from sparse_vae_tpu_torch import checkpoint as ckpt
from sparse_vae_tpu_torch.models.transformer_lm import (
    TransformerHparams, TransformerLanguageModel)
from sparse_vae_tpu_torch.ops import ce_kernel, swa_kernel
from sparse_vae_tpu_torch.ops import attention as tattn
from sparse_vae_tpu_torch.ops.sliding_window_attention import (
    sliding_window_attention)
from sparse_vae_tpu_torch.training.objectives import ARObjective
from tests.test_torch_checkpoint import jax_params_from_archive

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUN = "draft-tlm-r5"
LOGIT_REL = 2e-5
LOSS_RTOL = 2e-5
GRAD_REL, GRAD_ATOL = 2e-3, 1e-7
CE_RTOL, CE_ATOL = 1e-5, 1e-5
CE_G_RTOL, CE_G_ATOL = 1e-4, 5e-5
ATTN_ATOL, ATTN_G_ATOL = 2e-5, 1e-4
# bf16 against fp32, as tests/test_torch_train.py holds r5's ELBO.
BF16_LOSS_MARGIN = 1e-4
BF16_COS_MARGIN = 3e-3


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The port's side of these comparisons is small: one intra-op thread
    runs it about as fast and leaves the suite's other workers their
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _archive():
    with np.load(os.path.join(REPO, "runs", RUN, "ckpt_bf16.npz")) as npz:
        return {k: npz[k] for k in npz.files}


def _meta():
    with open(os.path.join(REPO, "runs", RUN, "meta.json")) as fh:
        return json.load(fh)


def _jax_lm(precision="fp32", **over):
    hp = dict(_meta()["model_hparams"])
    hp.update(precision=precision, **over)
    module, _, objective = build_model("transformer-lm", hp)
    return module, objective


@pytest.fixture(scope="module")
def draft():
    module, objective = _jax_lm()
    params = jax_params_from_archive(_archive())
    model, hp, _ = ckpt.load_run(RUN, device="cpu", dtype=torch.float32,
                                 train=True)
    return module, objective, params, model, hp


def _documents(rng, lengths, width, vocab):
    ids = np.zeros((len(lengths), width), np.int64)
    for row, n in enumerate(lengths):
        ids[row, 0] = 1
        ids[row, 1:n - 1] = rng.integers(3, vocab, size=n - 2)
        ids[row, n - 1] = 2
    num_bytes = np.array([4 * n + 3 for n in lengths], np.int64)
    return ids, np.array(lengths, np.int64), num_bytes


def _batch(ids, num_tokens, num_bytes):
    return {"token_ids": ids, "num_tokens": num_tokens,
            "num_bytes": num_bytes}


def _leaf_grads(grads):
    return {"/".join(k): np.asarray(v)
            for k, v in flatten_dict(unfreeze(grads)).items()}


def _port_grads(model):
    out = {}
    for key, p in model.named_parameters():
        path, transpose = ckpt.flax_path(model, key)
        g = p.grad.float().numpy()
        out[path] = g.T if transpose else g
    return out


def _assert_grads_match(got: dict, want: dict):
    assert set(got) == set(want)
    for path, w in want.items():
        bound = GRAD_REL * np.abs(w).max() + GRAD_ATOL
        err = np.abs(got[path] - w).max()
        assert err <= bound, f"{path}: max err {err:.3g} > {bound:.3g}"


def _cosines(grads: dict, want: dict) -> dict:
    out = {}
    for path, w in want.items():
        a, b = grads[path].astype(np.float64), w.astype(np.float64)
        out[path] = float((a * b).sum() / max(
            np.linalg.norm(a) * np.linalg.norm(b), 1e-300))
    return out


def _jax_loss(module, objective, params, batch, chunked=True, grads=True):
    """The reference's training loss and (with grads) its gradients
    without dropout (on the chunked path its loss without an rng; its
    unchunked path applies none): the two packages' random streams
    differ."""
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    rng = None if chunked else jax.random.PRNGKey(0)

    def f(p):
        return objective.loss(module, p, jb, 0, rng)[0]

    if not grads:
        return float(jax.jit(f)(params)), None
    loss, g = jax.jit(jax.value_and_grad(f))(params)
    return float(loss), _leaf_grads(g)


def _without_dropout(model):
    """The model with its training dropout at rate 0 (the input dropout
    and each layer's FFN dropout): its training loss is then the one the
    reference computes without an rng."""
    model.hparams.input_dropout = 0.0
    for layer in model.decoder_layers:
        layer.dropout_rate = 0.0
    return model


def _port_loss(model, hp, batch):
    model.zero_grad(set_to_none=True)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, metrics = ARObjective(hp).loss(_without_dropout(model), tb, 0)
    loss.backward()
    return float(loss.detach()), metrics, _port_grads(model)


# -- K3/K3b's plain versions at D = 256 ---------------------------------------
@pytest.mark.parametrize("n", [64, 29])
def test_ce_plain_at_lm_width_matches_pallas_interpret(n):
    """nll, dg, dE and dbias of the plain versions at D = 256 (the LM's
    width, now a kernel instantiation) against the Pallas kernels in
    interpret mode, aligned and unaligned token counts."""
    rng = np.random.default_rng(n)
    d, v = 256, 512
    g = (0.5 * rng.standard_normal((n, d))).astype(np.float32)
    table = (0.5 * rng.standard_normal((v, d))).astype(np.float32)
    bias = (0.1 * rng.standard_normal(v)).astype(np.float32)
    labels = rng.integers(0, v, size=n).astype(np.int32)
    w = rng.standard_normal(n).astype(np.float32)

    def f(g, table, bias):
        nll = fused_tied_cross_entropy(g, table, bias, jnp.asarray(labels),
                                       tt=16, vt=128, interpret=True)
        return jnp.sum(nll * w), nll

    (_, want), grads = jax.value_and_grad(f, argnums=(0, 1, 2),
                                          has_aux=True)(
        jnp.asarray(g), jnp.asarray(table), jnp.asarray(bias))
    tg, tt, tb = (torch.from_numpy(a) for a in (g, table, bias))
    tl = torch.from_numpy(labels).long()
    assert ce_kernel.route(True, 1024, d) == "kernel"
    nll, lse = ce_kernel.tied_ce_fwd(tg, tt, tb, tl)
    np.testing.assert_allclose(nll.numpy(), np.asarray(want), rtol=CE_RTOL,
                               atol=CE_ATOL)
    got = ce_kernel.tied_ce_bwd(tg, tt, tb, tl, lse, torch.from_numpy(w))
    for name, a, b in zip(("dg", "dE", "dbias"), got, grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=CE_G_RTOL,
                                   atol=CE_G_ATOL, err_msg=name)
    chunked = ce_kernel.tied_ce_bwd_chunked(tg, tt, tb, tl, lse,
                                            torch.from_numpy(w))
    for name, a, b in zip(("dg", "dE", "dbias"), chunked, grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-2,
                                   atol=1e-3, err_msg=name)


# -- the dense causal route -------------------------------------------------
def _attn_inputs(seed, b=3, h=2, length=512, d=64, lengths=(512, 301, 129)):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, length, d)).astype(np.float32)
               for _ in range(3))
    mask = np.arange(length)[None, :] < np.array(lengths)[:, None]
    cot = rng.standard_normal((b, h, length, d)).astype(np.float32)
    return q, k, v, mask, cot * mask[:, None, :, None]


@pytest.mark.parametrize("length", [512, 1024])
def test_dense_causal_route_matches_jax_masked_dense(length):
    """The dense causal route (K1/K2's Function on the CPU: their plain
    versions at a causal band of length / 128 blocks, no [CLS] slot)
    against the JAX package's masked dense attention (its path off the
    TPU, and the oracle of its flash-attention branch) with ragged key
    masks: outputs at real query positions, and the gradients of q, k, v
    under a cotangent that is zero at pad queries."""
    q, k, v, mask, cot = _attn_inputs(length, length=length,
                                      lengths=(length, 301, 129))
    causal = np.tril(np.ones((length, length), bool))
    jmask = causal[None, None] & mask[:, None, None, :]

    def f(q, k, v):
        out = j_dense(q, k, v, jnp.asarray(jmask))
        return jnp.sum(out * cot), out

    (_, want), jgrads = jax.value_and_grad(f, argnums=(0, 1, 2),
                                           has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    out = sliding_window_attention(tq, tk, tv, torch.from_numpy(mask),
                                   window_size=length // 128,
                                   block_size=128, causal=True,
                                   include_cls=False, dense=True)
    (out * torch.from_numpy(cot)).sum().backward()
    real = np.broadcast_to(mask[:, None, :], out.shape[:3])
    np.testing.assert_allclose(out.detach().numpy()[real],
                               np.asarray(want)[real], atol=ATTN_ATOL)
    for name, t, w in zip("qkv", (tq, tk, tv), jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w),
                                   atol=ATTN_G_ATOL, err_msg=name)


def test_dense_gate_is_the_jax_flash_gate():
    """The dense causal module takes K1/K2 (route "dense") exactly where
    the JAX package takes its flash attention: kernels on, its own
    queries, lq == lk, lq % 512 == 0; elsewhere the masked dense path.
    An off-gate length gives the same outputs through the masked path."""
    attn = tattn.Attention(128, 2, causal=True, sparse=False)
    assert attn._route(512, 512) == "dense"
    assert attn._route(1024, 1024) == "dense"
    assert attn._route(384, 384) is None          # not a multiple of 512
    assert attn._route(512, 256) is None          # cross-shaped
    assert tattn.Attention(128, 2, causal=True, sparse=False,
                           use_kernel=False)._route(512, 512) is None
    assert tattn.Attention(128, 2, causal=False,
                           sparse=False)._route(512, 512) is None
    # Dh 128 takes K1/K2's Dh 128 instantiation, Dh 256 the generic pair;
    # beyond Dh 512 no kernel does.
    assert tattn.Attention(256, 2, causal=True,
                           sparse=False)._route(512, 512) == "dense"
    assert tattn.Attention(512, 2, causal=True,
                           sparse=False)._route(512, 512) == "dense"
    assert tattn.Attention(1040, 2, causal=True,
                           sparse=False)._route(512, 512) == "dense_plain"
    torch.manual_seed(0)
    x = torch.randn(2, 512, 128)
    mask = torch.arange(512)[None, :] < torch.tensor([[512], [300]])
    before = swa_kernel.plain_routes
    with torch.no_grad():
        y_kernel = attn(x, kv_mask=mask)
        attn.use_kernel = False
        y_dense = attn(x, kv_mask=mask)
    assert swa_kernel.plain_routes == before
    real = mask.numpy()
    np.testing.assert_allclose(y_kernel.numpy()[real], y_dense.numpy()[real],
                               atol=ATTN_ATOL)
    # A length off the gate: the masked dense path, as in JAX.
    attn.use_kernel = True
    with torch.no_grad():
        y_off = attn(x[:, :384], kv_mask=mask[:, :384])
    np.testing.assert_allclose(y_off.numpy()[real[:, :384]],
                               y_dense[:, :384].numpy()[real[:, :384]],
                               atol=ATTN_ATOL)


def test_dense_route_without_an_instantiation_raises_off_the_cpu():
    """A dense causal layer at head dim 520 (beyond every CUDA kernel's
    range) raises on a non-CPU device instead of running the plain
    version, as the sparse gates do; the counter does not move. Head
    dims 128 (K1/K2) and 256 (the generic pair) take the dense route."""
    attn = tattn.Attention(1040, 2, causal=True, sparse=False)
    before = swa_kernel.plain_routes
    with pytest.raises(NotImplementedError, match="head_dim 520"):
        attn(torch.empty(1, 512, 1040, device="meta"))
    assert swa_kernel.plain_routes == before
    for d_model in (256, 512):
        layer = tattn.Attention(d_model, 2, causal=True, sparse=False)
        assert layer._dense_route(512, 512) == "dense"


# -- draft-tlm-r5 -------------------------------------------------------------
def test_draft_checkpoint_accounts_for_every_leaf():
    """All 36 leaves of draft-tlm-r5 map to the LM's parameters: 10,066,688
    of them, d_model 256, 4 heads, 2 layers, dense attention."""
    hp = ckpt.hparams_from_meta(_meta())
    assert type(hp) is TransformerHparams
    state = ckpt.params_from_numpy(_archive(), hp)
    assert len(_archive()) == len(state) == 36
    assert sum(t.numel() for t in state.values()) == 10_066_688
    assert (hp.d_model, hp.num_heads, hp.num_layers) == (256, 4, 2)
    assert not hp.sparse_self_attention
    model, _, _ = ckpt.load_run(RUN, device="cpu")
    assert type(model) is TransformerLanguageModel
    assert model.dtype == torch.bfloat16 and not model.training


def test_draft_logits_match_jax(draft):
    """Logits of [2, 512] ragged documents in fp32: the dense causal route
    (L = 512 is inside the gate) through both layers and the tied head."""
    module, _, params, model, _ = draft
    rng = np.random.default_rng(0)
    ids, _, _ = _documents(rng, [512, 300], 512, 32768)
    want = np.asarray(module.apply({"params": params}, jnp.asarray(ids)))
    with torch.no_grad():
        got = model(torch.from_numpy(ids)).numpy()
    real = ids != 0
    err = np.abs(got - want)[real].max()
    assert err <= LOGIT_REL * np.abs(want).max(), err


# -- a JAX-initialised sparse LM ----------------------------------------------
SPARSE_LM = dict(vocab_size=2048, d_model=256, num_heads=4, num_layers=2,
                 attn_window_size=2, attn_block_size=128,
                 sparse_self_attention=True, precision="fp32")


@pytest.mark.parametrize("chunk", [2048, 0])
def test_jax_initialised_sparse_lm_objective_matches_jax(chunk):
    """A sparse (sliding-window) LM built from the JAX package's
    initialisation and carried across as numpy leaves: ARObjective's loss
    and gradients on the chunked path (the fused tied CE) and on the
    unchunked one (full logits through token_nll), and eval_stats."""
    over = dict(SPARSE_LM, loss_chunk_size=chunk)
    module, _, jobjective = build_model("transformer-lm", over)
    params = module.init(jax.random.PRNGKey(3),
                         jnp.ones((1, 128), jnp.int32))["params"]
    leaves = {k: np.asarray(a) for k, a in _leaf_grads(params).items()}
    hp = TransformerHparams(**over)
    model = TransformerLanguageModel(hp)
    model.load_state_dict(ckpt.state_from_leaves(leaves, hp), strict=True)
    rng = np.random.default_rng(chunk + 1)
    batch = _batch(*_documents(rng, [256, 133], 256, 2048))
    jax_loss, jax_grads = _jax_loss(module, jobjective, params, batch,
                                    chunked=chunk > 0)
    port_loss, _, port_grads = _port_loss(model, hp, batch)
    np.testing.assert_allclose(port_loss, jax_loss, rtol=LOSS_RTOL)
    _assert_grads_match(port_grads, jax_grads)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    want = jobjective.eval_stats(module, params, jb, jax.random.PRNGKey(0))
    with torch.no_grad():
        got = ARObjective(hp).eval_stats(
            model, {k: torch.from_numpy(v) for k, v in batch.items()})
    for name in want:
        np.testing.assert_allclose(float(got[name]), float(want[name]),
                                   rtol=LOSS_RTOL, err_msg=name)


def test_objective_refuses_experts_and_a_seq_group():
    """ARObjective builds an MoE LM (tests/test_torch_moe.py holds it
    against JAX) and, since the seq axis is ported, an LM bound to a seq
    group (tests/test_torch_seq_mesh.py holds it against JAX over 2
    shards): over a group of one shard it gives the unbound loss, and
    its dropout stream is the generator folded by the shard."""
    from sparse_vae_tpu_torch.parallel.group import AxisGroup
    from sparse_vae_tpu_torch.parallel.spmd import fold_generator
    hp = TransformerHparams(**SPARSE_LM, num_experts=4)
    loss, metrics = ARObjective(hp).loss(
        TransformerLanguageModel(hp), {"token_ids": torch.ones(
            1, 128, dtype=torch.int64)}, 0)
    assert torch.isfinite(loss) and "train_moe_aux" in metrics
    hp = TransformerHparams(**SPARSE_LM, loss_chunk_size=256)
    model = TransformerLanguageModel(hp)
    ids = torch.randint(3, 2048, (2, 256), generator=torch.Generator()
                        .manual_seed(0))
    objective = ARObjective(hp)
    with torch.no_grad():
        want, _ = objective.loss(model, {"token_ids": ids}, 0,
                                 generator=fold_generator(
                                     torch.Generator().manual_seed(1), 0))
        model.bind_seq_group(AxisGroup(0, 1, torch.device("cpu"), "gloo"))
        got, _ = objective.loss(model, {"token_ids": ids}, 0,
                                generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_training_dropout_draws_from_the_generator():
    """The training forward's dropout, as the reference's: input_dropout
    on the embeddings and 0.1 on each layer's FFN output, each value kept
    with probability 1 - p and scaled by 1 / (1 - p), the masks drawn from
    the generator; the training loss repeats with the generator's seed,
    differs from the deterministic one, and validation has no dropout."""
    hp = TransformerHparams(**SPARSE_LM, input_dropout=0.25,
                            loss_chunk_size=2048)
    model = TransformerLanguageModel(hp)
    ids = torch.randint(3, 2048, (4, 256))
    plain = model.embed(ids)
    a = model.embed(ids, False, torch.Generator().manual_seed(1))
    b = model.embed(ids, False, torch.Generator().manual_seed(1))
    assert torch.equal(a, b)
    kept = a != 0
    assert 0.70 < float(kept.float().mean()) < 0.80
    torch.testing.assert_close(a[kept], plain[kept] / 0.75)
    assert torch.equal(model.embed(ids, True), plain)

    layer = model.decoder_layers[0]
    x = torch.randn(4, 256, 256)
    with torch.no_grad():
        y = layer._ffn(x) - x
        yd = layer._ffn(x, False, torch.Generator().manual_seed(2)) - x
    kept = yd != 0
    assert layer.dropout_rate == 0.1
    assert 0.88 < float(kept.float().mean()) < 0.92
    torch.testing.assert_close(yd[kept], y[kept] / 0.9, atol=1e-5,
                               rtol=1e-5)

    batch = {"token_ids": ids}
    objective = ARObjective(hp)
    with torch.no_grad():
        l1 = objective.loss(model, batch, 0, None,
                            torch.Generator().manual_seed(3))[0]
        l2 = objective.loss(model, batch, 0, None,
                            torch.Generator().manual_seed(3))[0]
        val = objective.eval_stats(model, {**batch, "num_bytes": ids})
        l0 = objective.loss(_without_dropout(model), batch, 0)[0]
    assert float(l1) == float(l2) and float(l1) != float(l0)
    assert float(val["nll_sum"]) / float(val["token_count"]) == \
        pytest.approx(float(l0), rel=1e-6)


def test_unported_methods_name_what_they_need():
    """The parallel, speculative and draft methods are ported; the
    frontier decoders name what they need where the model lacks it: the
    sparse sliding-window band."""
    model = TransformerLanguageModel(TransformerHparams(**SPARSE_LM))
    for name in ("draft_propose", "draft_init_state", "decode_chunk",
                 "commit_chunk", "frontier_generate", "speculative_generate",
                 "spec_draft_generate", "parallel_generate"):
        assert callable(getattr(model, name))
    dense = TransformerLanguageModel(TransformerHparams(
        **{**SPARSE_LM, "sparse_self_attention": False}))
    for name in ("frontier_generate", "speculative_generate"):
        with pytest.raises(ValueError, match="sparse sliding-window"):
            getattr(dense, name)(0, 256, 1)
