"""The packed-layout attention (K5/K5b's plain versions, their autograd
Function, the `Attention` module's packed branch, a small Dh = 128
Transformer-VAE) against the JAX package's packed Pallas kernels, run in
interpret mode on the CPU; and the port's routing predicates, its lr and
the profilers' busy-interval union.

The same numpy inputs, made from a seed, go through both packages in fp32.
Tolerances, each stated where it is used:
- packed forward: rtol 2e-4, atol 2e-5, as the JAX package's own packed
  tests (fp32 summation order over two 128-wide products and a softmax);
- gradients of the packed attention: rtol 5e-4, atol 5e-5, as there;
- the Attention module: 5e-5 absolute on its output after three
  projections (tests/test_torch_ops.py's bound) and the gradients' bound;
- the small VAE: ELBO sums 2e-5 relative and every gradient within 2e-3
  of that tensor's largest entry, the bounds of the r5 parity test
  (tests/test_torch_train.py).
Query rows past a row's length are compared only for being finite: their
cotangent is zero under a masked loss.
"""
import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze
from flax.traverse_util import flatten_dict

from sparse_vae_tpu.ops import attention as jattn
from sparse_vae_tpu.ops.pallas_kernels import (
    _sliding_window_attention_fwd_packed,
    sliding_window_attention_pallas_packed)
from sparse_vae_tpu.utils.schedules import scaled_lr as j_scaled_lr
from sparse_vae_tpu_torch import checkpoint as ckpt
from sparse_vae_tpu_torch import profile_serve, profile_train
from sparse_vae_tpu_torch.models.transformer_vae import (
    TransformerVAE, TransformerVAEHparams)
from sparse_vae_tpu_torch.models.vae import VAEObjective
from sparse_vae_tpu_torch.ops import attention as tattn
from sparse_vae_tpu_torch.ops import ce_kernel, swa_kernel
from sparse_vae_tpu_torch.ops.sliding_window_attention import (
    SlidingWindowAttentionPackedFn, sliding_window_attention_packed_bwd_plain,
    sliding_window_attention_packed_plain)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FWD_RTOL, FWD_ATOL = 2e-4, 2e-5
GRAD_RTOL, GRAD_ATOL = 5e-4, 5e-5
D = 128


def _problem(seed, heads, length, lengths):
    rng = np.random.default_rng(seed)
    q, k, v, w = (rng.standard_normal((2, length, heads * D))
                  .astype(np.float32) for _ in range(4))
    lens = np.array(lengths, np.int32)
    real = np.arange(length)[None, :] < lens[:, None]
    return q, k, v, w * real[..., None], lens, real


@pytest.mark.parametrize("heads,length,lengths", [(2, 256, (256, 170)),
                                                  (4, 512, (512, 301))])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [1, 2])
def test_packed_plain_matches_jax_forward(window, causal, heads, length,
                                          lengths):
    """out and lse of the packed plain version against the packed Pallas
    forward, with a padded row, at two and four heads."""
    q, k, v, _, lens, real = _problem(window + 2 * causal + heads, heads,
                                      length, lengths)
    want, want_lse, _ = _sliding_window_attention_fwd_packed(
        *(jnp.asarray(t) for t in (q, k, v)), jnp.asarray(real),
        num_heads=heads, window_size=window, block_size=128, causal=causal,
        include_cls=True, interpret=True)
    got, lse = sliding_window_attention_packed_plain(
        *(torch.from_numpy(t) for t in (q, k, v)), torch.from_numpy(lens),
        heads, window_size=window, causal=causal)
    assert got.shape == q.shape and lse.shape == (2, heads, length)
    np.testing.assert_allclose(got.numpy()[real], np.asarray(want)[real],
                               rtol=FWD_RTOL, atol=FWD_ATOL)
    rows = np.broadcast_to(real[:, None], lse.shape)
    np.testing.assert_allclose(lse.numpy()[rows], np.asarray(want_lse)[rows],
                               rtol=FWD_RTOL, atol=FWD_ATOL)
    assert bool(torch.isfinite(got).all())


@pytest.mark.parametrize("heads,length", [(2, 256), (4, 512)])
def test_packed_plain_without_cls_matches_jax_forward(heads, length):
    q, k, v, _, lens, real = _problem(7 + heads, heads, length,
                                      (length, length - 100))
    want = sliding_window_attention_pallas_packed(
        *(jnp.asarray(t) for t in (q, k, v)), jnp.asarray(real), heads, 2,
        128, True, False, True)
    got, _ = sliding_window_attention_packed_plain(
        *(torch.from_numpy(t) for t in (q, k, v)), torch.from_numpy(lens),
        heads, include_cls=False)
    np.testing.assert_allclose(got.numpy()[real], np.asarray(want)[real],
                               rtol=FWD_RTOL, atol=FWD_ATOL)


def _jax_grads(q, k, v, w, real, heads, window, causal):
    def f(q, k, v):
        out = sliding_window_attention_pallas_packed(
            q, k, v, jnp.asarray(real), heads, window, 128, causal, True,
            True)
        return jnp.sum(out * w)
    return [np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


@pytest.mark.parametrize("heads,window,causal,lengths", [
    pytest.param(*case, (512, 333), id="-".join(map(str, case)))
    for case in ((2, 2, True), (2, 2, False), (4, 1, True))] + [
    # A row shorter than one block, at window 3.
    pytest.param(2, 3, True, (512, 77), id="2-3-True-short")])
def test_packed_backward_and_function_match_jax_grad(heads, window, causal,
                                                     lengths):
    """K5b's plain version (given the plain forward's out and lse) and the
    autograd Function's wiring on the CPU both give jax.grad of the packed
    Pallas kernels; the Function never counts a kernel launch. L = 512, so
    the [CLS] column's beyond-band contributions run."""
    q, k, v, w, lens, real = _problem(30 + heads + window, heads, 512,
                                      lengths)
    want = _jax_grads(q, k, v, w, real, heads, window, causal)
    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    tw, tl = torch.from_numpy(w), torch.from_numpy(lens)
    out, lse = sliding_window_attention_packed_plain(
        tq, tk, tv, tl, heads, window_size=window, causal=causal)
    plain = sliding_window_attention_packed_bwd_plain(
        tq, tk, tv, tl, lse, out, tw, heads, window_size=window,
        causal=causal)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    before = (swa_kernel.packed_launches, swa_kernel.packed_bwd_launches)
    fn_out = SlidingWindowAttentionPackedFn.apply(*leaves, tl, heads, window,
                                                  128, causal, True)
    assert fn_out.grad_fn is not None
    fn_grads = torch.autograd.grad((fn_out * tw).sum(), leaves)
    assert (swa_kernel.packed_launches,
            swa_kernel.packed_bwd_launches) == before
    for name, p, g, want_g in zip("qkv", plain, fn_grads, want):
        np.testing.assert_allclose(p.numpy(), want_g, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg="plain d" + name)
        np.testing.assert_allclose(g.numpy(), want_g, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL, err_msg="Fn d" + name)


def test_attention_module_packed_route_matches_jax(monkeypatch):
    """`Attention` at d_model 256 and 2 heads (Dh 128) takes the packed
    route and gives the JAX packed dispatch's output and parameter
    gradients (params carried across); its bulk-prefill k/v are the
    head-major ones."""
    monkeypatch.setattr(jattn, "_PACKED_KERNEL_INTERPRET", True)
    d_model, heads, length = 256, 2, 256
    jmod = jattn.Attention(d_model=d_model, num_heads=heads, causal=True,
                           sparse=True, window_size=2, block_size=128)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, length, d_model)).astype(np.float32)
    real = np.arange(length)[None, :] < np.array([[length], [130]])
    w = rng.standard_normal(x.shape).astype(np.float32) * real[..., None]
    params = unfreeze(jmod.init(jax.random.PRNGKey(0), jnp.asarray(x),
                                jnp.asarray(x))["params"])
    for name in params:              # non-zero biases, so a missed one shows
        params[name]["bias"] = jnp.asarray(
            0.1 * rng.standard_normal(params[name]["bias"].shape),
            jnp.float32)

    def loss(p):
        out = jmod.apply({"params": p}, jnp.asarray(x), jnp.asarray(x),
                         kv_mask=jnp.asarray(real))
        return jnp.sum(out * w), out

    (_, want), grads = jax.value_and_grad(loss, has_aux=True)(params)

    tmod = tattn.Attention(d_model, heads, causal=True, sparse=True,
                           window_size=2, block_size=128)
    tmod.load_state_dict({
        f"{name}.{leaf}": (torch.from_numpy(np.array(v["kernel"])).T
                           if leaf == "weight"
                           else torch.from_numpy(np.array(v["bias"])))
        for name, v in params.items() for leaf in ("weight", "bias")})
    assert tmod._route(length, length) == "packed"
    tx, treal = torch.from_numpy(x), torch.from_numpy(real)
    got, (k, v) = tmod(tx, treal, return_kv=True)
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=5e-5)
    for name in params:
        np.testing.assert_allclose(
            getattr(tmod, name).weight.grad.numpy().T,
            np.asarray(grads[name]["kernel"]), rtol=GRAD_RTOL,
            atol=GRAD_ATOL, err_msg=name)
        np.testing.assert_allclose(
            getattr(tmod, name).bias.grad.numpy(),
            np.asarray(grads[name]["bias"]), rtol=GRAD_RTOL, atol=GRAD_ATOL,
            err_msg=name)
    with torch.no_grad():
        q_hm, k_hm, v_hm = tmod._project(tx)
    assert k.shape == (2, heads, length, d_model // heads)
    torch.testing.assert_close(k, k_hm, rtol=0, atol=0)
    torch.testing.assert_close(v, v_hm, rtol=0, atol=0)


def _small_vae_hparams(num_heads=2):
    return dict(d_model=256, num_heads=num_heads, num_layers=2,
                latent_depth=16, vocab_size=1024, num_encoder_latents=8,
                attn_window_size=2, attn_block_size=128,
                loss_chunk_size=256, precision="fp32")


def _documents(rng, lengths, width, vocab):
    ids = np.zeros((len(lengths), width), np.int64)
    for row, n in enumerate(lengths):
        ids[row, 0] = 1
        ids[row, 1:n - 1] = rng.integers(3, vocab, size=n - 2)
        ids[row, n - 1] = 2
    return ids, np.array(lengths, np.int64)


def test_small_dh128_vae_elbo_and_gradients_match_jax(monkeypatch):
    """A small Transformer-VAE at Dh = 128 (d_model 256, 2 heads, 2 decoder
    layers, L = 512, vocab 1024, fp32) with JAX-initialised params carried
    across and the same eps: the ELBO sums and every parameter's gradient
    against the JAX model with its decoder on the packed Pallas kernels
    (interpret mode). The port's decoder takes the packed route."""
    from sparse_vae_tpu import build_model
    from sparse_vae_tpu.models.transformer_lm import (
        TransformerLanguageModel)
    from sparse_vae_tpu.models.vae import VAEObjective as JObjective
    from sparse_vae_tpu.models.vae import kl_sums as j_kl_sums

    monkeypatch.setattr(jattn, "_PACKED_KERNEL_INTERPRET", True)
    overrides = _small_vae_hparams()
    module, jhp, _ = build_model("transformer-vae",
                                 {**overrides, "grad_checkpointing": False})
    rng = np.random.default_rng(9)
    ids, num_tokens = _documents(rng, [512, 300], 512, 1024)
    eps = rng.standard_normal((2, 1, 16)).astype(np.float32)
    params = module.init({"params": jax.random.PRNGKey(0),
                          "sample": jax.random.PRNGKey(1)},
                         jnp.asarray(ids[:1]))["params"]
    cls = type(module)
    jobj = JObjective(jhp)
    step = 3

    def jax_loss(p):
        v = {"params": p}
        q, raw_kl = module.apply(v, jnp.asarray(ids), get_kl=True,
                                 method=cls.posterior)
        z = q.loc + q.scale * jnp.asarray(eps)
        h = module.apply(v, jnp.asarray(ids), z,
                         method=cls.reconstruct_hidden)
        labels = TransformerLanguageModel.shifted_labels(jnp.asarray(ids))
        nll_sum, count = module.apply(v, h, labels, method=cls.sequence_nll)
        kl_sum, raw_sum, rows = j_kl_sums(raw_kl, jnp.asarray(num_tokens))
        loss, _ = jobj.compose_loss(
            {"nll_sum": nll_sum, "kl_sum": kl_sum, "raw_kl_sum": raw_sum},
            {"token_count": count, "row_count": rows}, step)
        return loss, (nll_sum, count, kl_sum, raw_sum)

    (_, want), grads = jax.value_and_grad(jax_loss, has_aux=True)(params)

    hp = TransformerVAEHparams(**overrides)
    model = TransformerVAE(hp)
    leaves = {"/".join(k): np.array(v)
              for k, v in flatten_dict(unfreeze(params)).items()}
    model.load_state_dict(ckpt.state_from_leaves(leaves, hp), strict=True)
    assert model.decoder_layers[0].attention._route(512, 512) == "packed"
    objective = VAEObjective(hp)
    batch = {"token_ids": torch.from_numpy(ids),
             "num_tokens": torch.from_numpy(num_tokens)}
    sums, counts = objective.loss_sums(model, batch,
                                       {"eps": torch.from_numpy(eps)})
    loss, _ = objective.compose_loss(sums, counts, step)
    loss.backward()
    got = (sums["nll_sum"], counts["token_count"], sums["kl_sum"],
           sums["raw_kl_sum"])
    for name, g, w in zip(("nll_sum", "count", "kl_sum", "raw_kl_sum"),
                          got, want):
        np.testing.assert_allclose(g.item(), float(w), rtol=2e-5,
                                   err_msg=name)
    named = dict(model.named_parameters())
    jgrads = {"/".join(k): np.asarray(v)
              for k, v in flatten_dict(unfreeze(grads)).items()}
    assert len(jgrads) == len(named)
    for path, want_g in jgrads.items():
        key, transpose = ckpt.torch_key(path)
        g = named[key].grad.numpy()
        g = g.T if transpose else g
        bound = 2e-3 * np.abs(want_g).max() + 1e-7
        err = np.abs(g - want_g).max()
        assert err <= bound, f"{path}: max err {err:.3g} > {bound:.3g}"


# -- routing ------------------------------------------------------------------
def _draft_tlm_widths():
    with open(os.path.join(REPO, "runs", "draft-tlm-r5", "meta.json")) as fh:
        hp = json.load(fh)["model_hparams"]
    return hp["d_model"], hp["vocab_size"]


@pytest.mark.parametrize("head_dim,block,want", [
    (64, 128, "head_major"),     # r5: 512 / 8 heads -> K1/K2
    (128, 128, "packed"),        # bench.py --heads 4 -> K5/K5b
    (32, 128, "generic"),        # JAX's head-major gate: the generic pair
    (256, 128, "packed_generic"),  # JAX's packed gate: the generic pair
    (128, 256, "packed_generic"),
    (64, 256, "generic"),
    (512, 128, "packed_generic"),  # the widest head in range
    (1024, 128, "plain"),        # JAX's packed gate beyond Dh 512
    (520, 128, "plain"),         # JAX's head-major gate beyond Dh 512
    (12, 128, "outside"),        # Dh % 8 != 0: JAX runs XLA
    (64, 8, "outside"),          # block % 128 != 0: JAX runs XLA
])
def test_attention_route_table(head_dim, block, want):
    assert swa_kernel.route(head_dim, block) == want


def test_ce_route_table():
    d_draft, v_draft = _draft_tlm_widths()
    assert d_draft == 256
    assert ce_kernel.route(True, 32768, 512) == "kernel"        # r5, heads 4
    assert ce_kernel.route(True, v_draft, d_draft) == "kernel"  # draft-tlm
    assert ce_kernel.route(True, 32768, 384) == "plain"         # no kernel
    assert ce_kernel.route(True, 1000, 512) == "outside"        # V % 1024
    assert ce_kernel.route(False, 32768, 512) == "outside"      # untied


def test_plain_routes_are_counted_where_the_module_takes_them():
    """A Dh = 520 sparse attention (inside JAX's head-major gate, beyond
    every CUDA kernel's range) and a D = 384 tied loss each raise their
    plain_routes counter once per call; an r5-shaped attention and a
    Dh = 32 one (the generic pair's) do not."""
    torch.manual_seed(0)
    wide = tattn.Attention(1040, 2, causal=True, sparse=True)
    narrow = tattn.Attention(64, 2, causal=True, sparse=True)
    r5_like = tattn.Attention(512, 8, causal=True, sparse=True)
    before = swa_kernel.plain_routes
    with torch.no_grad():
        wide(torch.randn(1, 128, 1040))
        narrow(torch.randn(1, 128, 64))
        r5_like(torch.randn(1, 128, 512))
    assert swa_kernel.plain_routes == before + 1

    hp = TransformerVAEHparams(**{**_small_vae_hparams(), "d_model": 384})
    model = TransformerVAE(hp)
    ids = torch.randint(3, 1024, (1, 256))
    before_ce = ce_kernel.plain_routes
    with torch.no_grad():
        model.sequence_nll(torch.randn(1, 256, 384), ids)
    assert ce_kernel.plain_routes == before_ce + 1


@pytest.mark.parametrize("d_model,heads,block,names", [
    (1040, 2, 128, "head_dim 520"),     # JAX's head-major gate
    (1024, 1, 128, "head_dim 1024"),    # JAX's packed gate
    (2048, 2, 256, "block_size 256"),   # JAX's packed gate, block 256
])
def test_plain_attention_route_raises_off_the_cpu(d_model, heads, block,
                                                  names):
    """Off the CPU a shape inside JAX's kernel gates beyond every CUDA
    kernel's range (Dh > 512) raises instead of running the plain
    version: the JAX package runs a kernel there. A meta tensor stands in
    for a CUDA one; the counter does not move."""
    module = tattn.Attention(d_model, heads, causal=True, sparse=True,
                             block_size=block)
    before = swa_kernel.plain_routes
    with pytest.raises(NotImplementedError, match=names):
        module(torch.empty(1, block, d_model, device="meta"))
    assert swa_kernel.plain_routes == before


def test_plain_ce_route_raises_off_the_cpu():
    """A tied loss at a width with no K3/K3b instantiation (D = 384) off
    the CPU raises instead of taking the chunked plain CE."""
    model = TransformerVAE(TransformerVAEHparams(
        **{**_small_vae_hparams(), "d_model": 384}))
    before = ce_kernel.plain_routes
    with pytest.raises(NotImplementedError, match="d_model 384"):
        model.sequence_nll(
            torch.empty(1, 256, 384, device="meta"),
            torch.zeros(1, 256, dtype=torch.int64, device="meta"))
    assert ce_kernel.plain_routes == before


@pytest.mark.parametrize("d_model,route", [(256, "kernel"), (512, "kernel"),
                                           (384, "plain"), (128, "plain")])
def test_ce_route_takes_the_instantiated_widths(d_model, route):
    """K3/K3b are instantiated at D = 256 (the Transformer LM) and 512 (the
    Transformer-VAE); another width inside the JAX package's gate is a
    plain route (CPU only), and outside the gate the chunked CE runs."""
    assert ce_kernel.D_MODELS == (256, 512)
    assert ce_kernel.route(True, 32768, d_model) == route
    assert ce_kernel.route(True, 1000, d_model) == "outside"
    assert ce_kernel.route(False, 32768, d_model) == "outside"


# -- the lr and the profilers' busy share --------------------------------------
def test_train_lr_is_scaled_by_the_datas_token_budget():
    """`train.build` on r5 steps at the JAX trainer's lr:
    scaled_lr(lr, tokens_per_batch * accumulate_grad_batches,
    base_batch_size), 100,000 x 2 tokens for r5."""
    from sparse_vae_tpu_torch.train import build
    with open(os.path.join(REPO, "runs", "real-prose-vae-r5",
                           "meta.json")) as fh:
        meta = json.load(fh)
    hp = meta["model_hparams"]
    accumulate = meta["trainer_hparams"]["accumulate_grad_batches"]
    want = j_scaled_lr(hp["lr"],
                       meta["data_hparams"]["tokens_per_batch"] * accumulate,
                       hp["base_batch_size"])
    _, _, optimizer, acc = build("real-prose-vae-r5", device="cpu")
    assert acc == accumulate == 2
    assert optimizer.param_groups[0]["lr"](0) == pytest.approx(want,
                                                               rel=1e-12)


def _event(name, start, end, cuda=True, annotation=False):
    kind = torch.autograd.DeviceType.CUDA if cuda else \
        torch.autograd.DeviceType.CPU
    return SimpleNamespace(name=name, device_type=kind,
                           time_range=SimpleNamespace(start=start, end=end),
                           is_user_annotation=annotation)


@pytest.mark.parametrize("window", [profile_train.WINDOW,
                                    profile_serve.WINDOW])
def test_busy_share_takes_the_union_of_overlapping_intervals(window):
    """Device intervals [5, 20), [10, 30) (overlapping), [40, 50), [95, 120)
    (clipped at the window's end) inside the host window [0, 100): busy is
    25 + 10 + 5 = 40 us. A device-side annotation range and host events
    count nowhere. Both profilers read their own window this way."""
    events = [_event(window, 0, 100, cuda=False),
              _event("k1", 5, 20), _event("k2", 10, 30), _event("k3", 40, 50),
              _event("k4", 95, 120), _event("step", 0, 100, annotation=True),
              _event("aten::add", 60, 70, cuda=False)]
    assert profile_train.busy_share(events, window) == (100, 40)
    with pytest.raises(RuntimeError):
        profile_train.busy_share(events[1:], window)


def _average(key, count, device_ms=0.0, cuda=True):
    kind = torch.autograd.DeviceType.CUDA if cuda else \
        torch.autograd.DeviceType.CPU
    return SimpleNamespace(key=key, count=count, device_type=kind,
                           self_device_time_total=device_ms * 1e3,
                           is_user_annotation=False)


@pytest.mark.parametrize("dq_records,want", [
    (5, {"dq": 0.5, "dkv": 0.6}),     # every record kept
    (4, {"dq": 0.5, "dkv": 0.6}),     # one dropped: the same per call
    (0, None),                        # a kernel's records all lost
])
def test_per_call_device_ms_tolerates_a_dropped_record(dq_records, want):
    """Five calls of two kernels (10 launches the runtime saw): a dropped
    record leaves each kernel's per-call time as its mean per record;
    a trace missing a kernel altogether is refused."""
    averages = [_average("cudaLaunchKernel", 10, cuda=False),
                _average("dkv", 5, 3.0),
                _average("Memcpy DtoD (Device -> Device)", 1, 0.01)]
    if dq_records:
        averages.append(_average("dq", dq_records, 0.5 * dq_records))
    got = profile_train.per_call_device_ms(averages, 5)
    if want is None:
        assert got is None
    else:
        assert got == pytest.approx(want)


def test_packed_wrappers_reject_shapes_they_do_not_take():
    """The packed wrappers check [B, L, H * D] shapes themselves, without
    head views: k and v as q, H dividing the width, L a multiple of the
    block, one valid length per row, a window of at least one block."""
    q = torch.zeros((2, 256, 4 * 16))
    lens = torch.tensor([256, 100], dtype=torch.int32)
    out, lse = swa_kernel.swa_fwd_packed(q, q, q, lens, 4)
    assert out.shape == q.shape and lse.shape == (2, 4, 256)
    for bad in ((q, q[:, :128], q, lens, 4), (q, q, q, lens, 3),
                (q[0], q[0], q[0], lens, 4)):
        with pytest.raises(ValueError, match="H \\* D"):
            swa_kernel.swa_fwd_packed(*bad)
    with pytest.raises(ValueError, match="multiple"):
        swa_kernel.swa_fwd_packed(q[:, :200], q[:, :200], q[:, :200], lens,
                                  4)
    with pytest.raises(ValueError, match="lengths"):
        swa_kernel.swa_fwd_packed(q, q, q, lens[:1], 4)
    with pytest.raises(ValueError, match="window_size"):
        swa_kernel.swa_fwd_packed(q, q, q, lens, 4, window_size=0)
    with pytest.raises(ValueError, match="lse"):
        swa_kernel.swa_bwd_packed(q, q, q, lens, lse[:, :2], out, out, 4)
