"""The attention shapes that the generic pair of csrc/swa_generic.cu takes
on the card (head dims other than 64 and 128, blocks other than 128), and
K1/K2's head-major Dh 128, against the JAX package on the CPU.

The same numpy inputs, made from a seed, go through the port's plain
versions (what the kernels compute, and what the wrappers run on CPU
tensors) and the JAX package's Pallas kernels in interpret mode, in fp32:
- head-major Dh 32 at block 256 (`sliding_window_attention_pallas`),
  packed Dh 256 at block 128 (`sliding_window_attention_pallas_packed`)
  and K6 at Dh 128 (`sp_windowed_attention_pallas` on a banded shard):
  out and lse within rtol 2e-4, atol 2e-5, gradients within rtol 5e-4,
  atol 5e-5, the JAX package's own packed-test tolerances (fp32
  summation order);
- a small Transformer-VAE at d_model 256 and one head (packed Dh 256, the
  width of bench.py --heads 2 at half the model width), 2 decoder layers,
  L = 512: the ELBO sums within 2e-5 relative and every gradient within
  2e-3 of that tensor's largest entry, the bounds of the r5 parity test
  (tests/test_torch_train.py), with JAX's decoder on its packed Pallas
  kernels (`_PACKED_KERNEL_INTERPRET`);
- the wrappers on meta tensors, with the library replaced by a recorder:
  which C entry they call and the strides, head dim and block they pass.
Query rows past a row's length are compared only for being finite.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze
from flax.traverse_util import flatten_dict

from sparse_vae_tpu.ops import attention as jattn
from sparse_vae_tpu.ops.pallas_kernels import (
    _sliding_window_attention_fwd_packed, _sliding_window_attention_fwd_pallas,
    sliding_window_attention_pallas, sliding_window_attention_pallas_packed,
    sp_windowed_attention_pallas)
from sparse_vae_tpu_torch import checkpoint as ckpt
from sparse_vae_tpu_torch.models.transformer_vae import (
    TransformerVAE, TransformerVAEHparams)
from sparse_vae_tpu_torch.models.vae import VAEObjective
from sparse_vae_tpu_torch.ops import attention as tattn
from sparse_vae_tpu_torch.ops import cuda_lib, sp_kernel, swa_kernel
from sparse_vae_tpu_torch.ops.sliding_window_attention import (
    SlidingWindowAttentionFn, SlidingWindowAttentionPackedFn,
    sliding_window_attention_bwd_plain,
    sliding_window_attention_packed_bwd_plain,
    sliding_window_attention_packed_plain, sliding_window_attention_plain)

FWD_RTOL, FWD_ATOL = 2e-4, 2e-5
GRAD_RTOL, GRAD_ATOL = 5e-4, 5e-5


def _close(got, want, rows=None, grad=False, name=""):
    got, want = np.asarray(got), np.asarray(want)
    if rows is not None:
        got, want = got[rows], want[rows]
    rtol, atol = (GRAD_RTOL, GRAD_ATOL) if grad else (FWD_RTOL, FWD_ATOL)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                               err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
def test_head_major_dh32_block256_matches_jax(causal):
    """Dh 32 (bench.py --heads 16) at block 256, ragged rows: out, lse and
    the gradients of sum(out * w) of the plain versions (and of the
    autograd Function on CPU tensors) against the head-major Pallas
    kernels."""
    b, h, L, d, block = 2, 2, 1024, 32, 256
    rng = np.random.default_rng(3 + causal)
    q, k, v, w = (rng.standard_normal((b, h, L, d)).astype(np.float32)
                  for _ in range(4))
    lens = np.array([L, 600], np.int32)
    real = np.arange(L)[None, :] < lens[:, None]
    w = w * real[:, None, :, None]
    kw = dict(window_size=2, block_size=block, causal=causal,
              include_cls=True)
    jq, jk, jv = (jnp.asarray(t) for t in (q, k, v))
    want, want_lse, _ = _sliding_window_attention_fwd_pallas(
        jq, jk, jv, jnp.asarray(real), interpret=True, **kw)

    def f(q, k, v):
        out = sliding_window_attention_pallas(q, k, v, jnp.asarray(real),
                                              2, block, causal, True, True)
        return jnp.sum(out * jnp.asarray(w))
    want_g = jax.grad(f, argnums=(0, 1, 2))(jq, jk, jv)

    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    tl = torch.from_numpy(lens)
    out, lse = sliding_window_attention_plain(
        tq, tk, tv, torch.from_numpy(real), return_lse=True, **kw)
    rows = np.broadcast_to(real[:, None], (b, h, L))
    _close(out, want, rows, name="out")
    _close(lse, want_lse, rows, name="lse")
    plain = sliding_window_attention_bwd_plain(
        tq, tk, tv, tl, lse, out, torch.from_numpy(w), **kw)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    fn_out = SlidingWindowAttentionFn.apply(*leaves, tl, 2, block, causal,
                                            True)
    fn_grads = torch.autograd.grad((fn_out * torch.from_numpy(w)).sum(),
                                   leaves)
    for name, p, g, want_t in zip("qkv", plain, fn_grads, want_g):
        _close(p, want_t, grad=True, name="plain d" + name)
        _close(g, want_t, grad=True, name="Fn d" + name)


def test_packed_dh256_matches_jax():
    """Packed Dh 256 (the bench.py --heads 2 head) at block 128, two
    heads, a short row: the packed plain versions and the packed autograd
    Function on CPU tensors against the packed Pallas kernels."""
    heads, L, d = 2, 512, 256
    rng = np.random.default_rng(11)
    q, k, v, w = (rng.standard_normal((2, L, heads * d)).astype(np.float32)
                  for _ in range(4))
    lens = np.array([L, 300], np.int32)
    real = np.arange(L)[None, :] < lens[:, None]
    w = w * real[..., None]
    jq, jk, jv = (jnp.asarray(t) for t in (q, k, v))
    want, want_lse, _ = _sliding_window_attention_fwd_packed(
        jq, jk, jv, jnp.asarray(real), num_heads=heads, window_size=2,
        block_size=128, causal=True, include_cls=True, interpret=True)

    def f(q, k, v):
        out = sliding_window_attention_pallas_packed(
            q, k, v, jnp.asarray(real), heads, 2, 128, True, True, True)
        return jnp.sum(out * jnp.asarray(w))
    want_g = jax.grad(f, argnums=(0, 1, 2))(jq, jk, jv)

    tq, tk, tv = (torch.from_numpy(t) for t in (q, k, v))
    tl, tw = torch.from_numpy(lens), torch.from_numpy(w)
    out, lse = sliding_window_attention_packed_plain(tq, tk, tv, tl, heads)
    _close(out, want, real, name="out")
    _close(lse, want_lse, np.broadcast_to(real[:, None], lse.shape),
           name="lse")
    plain = sliding_window_attention_packed_bwd_plain(tq, tk, tv, tl, lse,
                                                      out, tw, heads)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    fn_out = SlidingWindowAttentionPackedFn.apply(*leaves, tl, heads, 2, 128,
                                                  True, True)
    fn_grads = torch.autograd.grad((fn_out * tw).sum(), leaves)
    for name, p, g, want_t in zip("qkv", plain, fn_grads, want_g):
        _close(p, want_t, grad=True, name="plain d" + name)
        _close(g, want_t, grad=True, name="Fn d" + name)


def test_k6_at_dh128_matches_jax():
    """K6 on a banded shard at Dh 128 (bench.py --heads 4 over `seq`):
    q_off = 1 over the extended keys and the broadcast [CLS] block with a
    partial cls_len, ragged rows; `SpWindowedAttentionFn` on CPU tensors
    against `sp_windowed_attention_pallas` in interpret mode."""
    b, h, S, d, bs, ws = 2, 2, 256, 128, 128, 2
    ctx, start = bs, 1024
    rng = np.random.default_rng(17)
    f32 = np.float32
    q, cot = (rng.standard_normal((b, h, S, d)).astype(f32)
              for _ in range(2))
    k_ext, v_ext = (rng.standard_normal((b, h, ctx + S, d)).astype(f32)
                    for _ in range(2))
    cls_k, cls_v = (rng.standard_normal((b, h, bs, d)).astype(f32)
                    for _ in range(2))
    ext_len = np.array([ctx + S, ctx + 150], np.int32)
    cls_len = np.array([bs, 77], np.int32)
    arrays = (q, k_ext, v_ext, cls_k, cls_v)

    def jax_kernel(a):
        return sp_windowed_attention_pallas(
            *a, jnp.asarray(start), jnp.asarray(ext_len),
            jnp.asarray(cls_len), ws, bs, True)
    ja = tuple(jnp.asarray(x) for x in arrays)
    want = np.asarray(jax_kernel(ja))
    want_g = jax.grad(lambda a: jnp.sum(jax_kernel(a) * cot))(ja)
    ta = tuple(torch.tensor(x, requires_grad=True) for x in arrays)
    out = sp_kernel.sp_windowed_attention(
        *ta, start, torch.tensor(ext_len), torch.tensor(cls_len), ws, bs)
    (out * torch.tensor(cot)).sum().backward()
    _close(out.detach(), want, name="out")
    for name, t, g in zip(("q", "k_ext", "v_ext", "cls_k", "cls_v"), ta,
                          want_g):
        _close(t.grad, g, grad=True, name="d" + name)


def _documents(rng, lengths, width, vocab):
    ids = np.zeros((len(lengths), width), np.int64)
    for row, n in enumerate(lengths):
        ids[row, 0] = 1
        ids[row, 1:n - 1] = rng.integers(3, vocab, size=n - 2)
        ids[row, n - 1] = 2
    return ids, np.array(lengths, np.int64)


def test_small_dh256_vae_elbo_and_gradients_match_jax(monkeypatch):
    """A small Transformer-VAE at packed Dh 256 (d_model 256, one head, 2
    decoder layers, L = 512, vocab 1024, fp32) with JAX-initialised params
    carried across and the same eps: the ELBO sums and every parameter's
    gradient against the JAX model with its decoder on the packed Pallas
    kernels (interpret mode). The port's decoder takes the packed generic
    route."""
    from sparse_vae_tpu import build_model
    from sparse_vae_tpu.models.transformer_lm import (
        TransformerLanguageModel)
    from sparse_vae_tpu.models.vae import VAEObjective as JObjective
    from sparse_vae_tpu.models.vae import kl_sums as j_kl_sums

    monkeypatch.setattr(jattn, "_PACKED_KERNEL_INTERPRET", True)
    overrides = dict(d_model=256, num_heads=1, num_layers=2, latent_depth=16,
                     vocab_size=1024, num_encoder_latents=8,
                     attn_window_size=2, attn_block_size=128,
                     loss_chunk_size=256, precision="fp32")
    module, jhp, _ = build_model("transformer-vae",
                                 {**overrides, "grad_checkpointing": False})
    rng = np.random.default_rng(19)
    ids, num_tokens = _documents(rng, [512, 290], 512, 1024)
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

    (_, want), grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(
        params)

    hp = TransformerVAEHparams(**overrides)
    model = TransformerVAE(hp)
    leaves = {"/".join(k): np.array(v)
              for k, v in flatten_dict(unfreeze(params)).items()}
    model.load_state_dict(ckpt.state_from_leaves(leaves, hp), strict=True)
    assert model.decoder_layers[0].attention._route(512, 512) == \
        "packed_generic"
    objective = VAEObjective(hp)
    batch = {"token_ids": torch.from_numpy(ids),
             "num_tokens": torch.from_numpy(num_tokens)}
    before = swa_kernel.plain_routes
    sums, counts = objective.loss_sums(model, batch,
                                       {"eps": torch.from_numpy(eps)})
    loss, _ = objective.compose_loss(sums, counts, step)
    loss.backward()
    assert swa_kernel.plain_routes == before
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


class _Recorder:
    """Stands in for the kernel library: records each C entry called and
    its arguments, and returns 0 (success)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("svt_"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.fixture
def recorder(monkeypatch):
    lib = _Recorder()
    monkeypatch.setattr(cuda_lib, "library", lambda: lib)
    monkeypatch.setattr(swa_kernel, "_stream", lambda device: 0)
    return lib


# Argument positions of svt_swa_generic_fwd / _bwd after their pointers:
# q's (row, head, batch) strides, k's, then batch, heads, q_len, key_len,
# head_dim, block_size, window, causal, include_cls, q_off.
_FWD_POINTERS, _BWD_POINTERS = 9, 17
_INT_NAMES = ("q_row", "q_head", "q_batch", "k_row", "k_head", "k_batch",
              "batch", "heads", "q_len", "key_len", "head_dim", "block",
              "window", "causal", "include_cls", "q_off")


def _ints(call, pointers):
    return dict(zip(_INT_NAMES, call[1][pointers:pointers + 16]))


@pytest.mark.parametrize("d_model,heads,block,tp,entry,layout", [
    (512, 2, 128, 1, "generic", "packed"),        # bench.py --heads 2
    (256, 1, 256, 1, "generic", "packed"),        # Dh 256 at block 256
    (512, 16, 128, 1, "generic", "head_major"),   # bench.py --heads 16
    (128, 2, 256, 1, "generic", "head_major"),    # Dh 64 at block 256
    (512, 4, 128, 2, "swa", "head_major"),        # --heads 4 over model 2
])
def test_wrapper_launches_the_entry_with_the_layout(recorder, d_model, heads,
                                                    block, tp, entry,
                                                    layout):
    """An attention layer on meta tensors (standing in for CUDA ones)
    launches, forward and backward, the C entry its shape takes, with the
    layout's strides, the head dim and the block: the generic pair
    (svt_swa_generic_*) or K1/K2's head-major Dh 128 instantiation
    (svt_swa_fwd / svt_swa_bwd) under tensor parallelism."""
    L = 2 * block
    attn = tattn.Attention(d_model, heads, causal=True, sparse=True,
                           block_size=block, tp_size=tp)
    attn = attn.to(device="meta", dtype=torch.bfloat16)
    x = torch.empty((3, L, d_model), device="meta", dtype=torch.bfloat16,
                    requires_grad=True)
    f0, b0 = swa_kernel.generic_launches, swa_kernel.generic_bwd_launches
    h0, hb0 = swa_kernel.hm128_launches, swa_kernel.hm128_bwd_launches
    attn(x).sum().backward()
    names = [name for name, _ in recorder.calls]
    h = heads // tp
    d = d_model // heads
    if entry == "swa":
        assert names == ["svt_swa_fwd", "svt_swa_bwd"]
        fwd_ints = recorder.calls[0][1][9:19]
        # batch, heads, q_len, key_len, head_dim, block, window, causal,
        # include_cls, q_off
        assert list(fwd_ints) == [3, h, L, L, d, block, 2, 1, 1, 0]
        assert recorder.calls[1][1][17:23] == (3, h, L, L, d, block)
        assert (swa_kernel.hm128_launches,
                swa_kernel.hm128_bwd_launches) == (h0 + 1, hb0 + 1)
        return
    assert names == ["svt_swa_generic_fwd", "svt_swa_generic_bwd"]
    if layout == "packed":
        strides = (h * d, d, L * h * d)
    else:
        strides = (d, L * d, h * L * d)
    want = dict(zip(_INT_NAMES, (*strides, *strides, 3, h, L, L, d, block,
                                 2, 1, 1, 0)))
    assert _ints(recorder.calls[0], _FWD_POINTERS) == want
    assert _ints(recorder.calls[1], _BWD_POINTERS) == want
    assert (swa_kernel.generic_launches,
            swa_kernel.generic_bwd_launches) == (f0 + 1, b0 + 1)


def test_wrappers_beyond_the_range_raise_and_count_on_the_cpu(recorder):
    """Beyond Dh 512 no kernel takes the shape: off the CPU the layer
    raises before any launch, on the CPU it counts a plain route and runs
    the plain version. Dh 512 itself launches the generic entry."""
    widest = tattn.Attention(512, 1, causal=True, sparse=True).to(
        device="meta", dtype=torch.bfloat16)
    widest(torch.empty((1, 256, 512), device="meta", dtype=torch.bfloat16))
    assert [name for name, _ in recorder.calls] == ["svt_swa_generic_fwd"]
    beyond = tattn.Attention(1024, 1, causal=True, sparse=True)
    with pytest.raises(NotImplementedError, match="up to 512"):
        tattn.Attention(1024, 1, causal=True, sparse=True).to(
            device="meta")(torch.empty((1, 256, 1024), device="meta"))
    assert len(recorder.calls) == 1
    before = swa_kernel.plain_routes
    with torch.no_grad():
        beyond(torch.zeros((1, 256, 1024)))
    assert swa_kernel.plain_routes == before + 1


def test_profilers_take_a_head_count():
    """`profile_train` and `profile_serve` both build the bench's model at
    `heads=N` (heads=2: the generic pair's Dh 256) in place of a run."""
    from sparse_vae_tpu_torch import profile_serve, profile_train
    assert profile_serve._args(["profile_serve", "heads=2"])[:2] == (
        "real-prose-vae-r5", 2)
    assert profile_serve._args(["profile_serve"])[1] is None
    with pytest.raises(SystemExit):
        profile_serve._args(["profile_serve", "heads=2", "run=x"])
    assert profile_train._args(["profile_train", "heads=2"])[1] == 2
