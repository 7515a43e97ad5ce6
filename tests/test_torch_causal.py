"""The dense causal pair (sparse_vae_tpu_torch/ops/causal_kernel.py; the
CUDA kernels csrc/causal_fwd.cu and causal_bwd.cu run on the card only)
on the CPU:

- its plain versions against the band plain versions at a causal band of
  L / 128 blocks without a [CLS] slot (what the dense route runs on the CPU)
  and against the JAX package's masked dense causal attention (its path
  off the TPU, sparse_vae_tpu/ops/attention.py), pad positions and a
  fully padded row included;
- the Python twins of the kernels' CTA orders and of the backward's dq
  order;
- the dense route's choice of pair by head dim, and the wrappers on meta
  tensors with the kernel library replaced by a recorder.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_vae_tpu.ops.attention import dense_attention as j_dense
from sparse_vae_tpu_torch.ops import attention as tattn
from sparse_vae_tpu_torch.ops import causal_kernel, cuda_lib, swa_kernel
from sparse_vae_tpu_torch.ops.sliding_window_attention import (
    _dense_pair, sliding_window_attention_bwd_plain,
    sliding_window_attention_plain)

OUT_ATOL, GRAD_ATOL = 2e-5, 2e-3
LENGTHS = (512, 301, 0)   # full, ragged, fully padded


def _inputs(seed: int, d: int, lengths=LENGTHS, length: int = 512):
    rng = np.random.default_rng(seed)
    b, h = len(lengths), 2
    q, k, v, cot = (rng.standard_normal((b, h, length, d)).astype(np.float32)
                    for _ in range(4))
    return q, k, v, cot, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("d", [64, 128])
def test_plain_matches_the_band_plain_version(d):
    """The pair's plain versions equal K1/K2's at a causal band of every
    block without a [CLS] slot, on a full, a ragged and a fully padded
    row (out 0 and lse -inf there)."""
    q, k, v, do, lengths = (torch.from_numpy(a) for a in _inputs(d, d))
    L = q.shape[2]
    kw = dict(window_size=L // 128, block_size=128, causal=True,
              include_cls=False)
    out, lse = causal_kernel.causal_attention_plain(q, k, v, lengths)
    mask = torch.arange(L)[None, :] < lengths[:, None].long()
    ref, ref_lse = sliding_window_attention_plain(q, k, v, mask,
                                                  return_lse=True, **kw)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), atol=OUT_ATOL)
    assert torch.equal(torch.isfinite(lse), torch.isfinite(ref_lse))
    finite = torch.isfinite(ref_lse)
    np.testing.assert_allclose(lse[finite].numpy(), ref_lse[finite].numpy(),
                               atol=OUT_ATOL)
    assert not bool(finite[2].any()) and bool((out[2] == 0).all())
    grads = causal_kernel.causal_attention_bwd_plain(q, k, v, lengths, lse,
                                                     out, do)
    want = sliding_window_attention_bwd_plain(q, k, v, lengths, lse, out,
                                              do, **kw)
    for name, g, w in zip(("dq", "dk", "dv"), grads, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=GRAD_ATOL,
                                   err_msg=name)


@pytest.mark.parametrize("d", [64, 128])
def test_plain_matches_jax_masked_dense(d):
    """The pair's plain versions against the JAX package's masked dense
    causal attention, at every position of the rows with a valid key (pad
    queries attend the valid keys in both), and their gradients under a
    cotangent that is zero on the fully padded row, where the port gives
    0 and the reference's -1e9 fill averages the values."""
    q, k, v, cot, lengths = _inputs(100 + d, d)
    L = q.shape[2]
    valid = np.arange(L)[None, :] < lengths[:, None]
    cot = cot * (lengths > 0)[:, None, None, None]
    jmask = np.tril(np.ones((L, L), bool))[None, None] \
        & valid[:, None, None, :]

    def f(q, k, v):
        out = j_dense(q, k, v, jnp.asarray(jmask))
        return jnp.sum(out * cot), out

    (_, want), jgrads = jax.value_and_grad(f, argnums=(0, 1, 2),
                                           has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv, tcot, tlen = (torch.from_numpy(a)
                              for a in (q, k, v, cot, lengths))
    out, lse = causal_kernel.causal_attention_plain(tq, tk, tv, tlen)
    rows = lengths > 0
    np.testing.assert_allclose(out.numpy()[rows], np.asarray(want)[rows],
                               atol=OUT_ATOL)
    grads = causal_kernel.causal_attention_bwd_plain(tq, tk, tv, tlen, lse,
                                                     out, tcot)
    for name, g, w in zip("qkv", grads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                   atol=GRAD_ATOL, err_msg=name)


@pytest.mark.parametrize("b,h,L,d", [
    (3, 2, 1024, 64),      # one chunk each way
    (14, 8, 3584, 64),     # the r4 LM: chunks of 9 and 18 pairs
    (14, 4, 3584, 128),    # Dh 128: chunks of 4 and 9, a short last one
])
def test_cta_orders_visit_every_tile_once_chunk_by_chunk(b, h, L, d):
    """The forward grid visits each (row, head, query tile) once and the
    backward pass each (row, head, key tile) once, chunk by chunk of
    (head, row) pairs that fit the kernel's L2 budget: the forward's
    longest tiles of a chunk first, the backward's shortest first; a
    backward key tile waits only on the higher tiles of its (row, head),
    launched before it."""
    tiles = L // causal_kernel.TILE
    every = {(i, j, t) for i in range(b) for j in range(h)
             for t in range(tiles)}
    fwd = causal_kernel.fwd_order(b, h, L, d)
    bwd = causal_kernel.bwd_order(b, h, L, d)
    assert len(fwd) == len(bwd) == len(every)
    assert set(fwd) == set(bwd) == every
    for order, work, per_row, budget in (
            (fwd, lambda t: -(t + 1), 4 * L * d, causal_kernel.FWD_L2_BYTES),
            (bwd, lambda t: tiles - t, 8 * L * d,
             causal_kernel.BWD_L2_BYTES)):
        group = causal_kernel.l2_group(b * h, per_row, budget)
        assert group * per_row <= budget or group == 1
        for start in range(0, b * h, group):
            pairs = {(hb // h, hb % h)
                     for hb in range(start, min(b * h, start + group))}
            chunk = order[start * tiles:(start + len(pairs)) * tiles]
            assert {(i, j) for i, j, _ in chunk} == pairs
            load = [work(t) for _, _, t in chunk]
            assert load == sorted(load)
    position = {cta: i for i, cta in enumerate(bwd)}
    assert all(position[(i, j, t + 1)] < position[(i, j, t)]
               for i, j, t in bwd if t < tiles - 1)


def test_dq_order():
    """dq's key tiles add in descending order, only those at or before
    the query step's tile that hold a valid key."""
    L = 1024
    tiles = L // causal_kernel.TILE
    assert causal_kernel.dq_order(700, 0) == [0]
    assert causal_kernel.dq_order(700, 15) == [5, 4, 3, 2, 1, 0]
    assert causal_kernel.dq_order(L, 15) == list(range(7, -1, -1))
    assert causal_kernel.dq_order(0, 3) == []
    steps = L // causal_kernel.STEP
    for valid in (1, 129, 700, L):
        adds = {t: [s for s in range(steps)
                    if t in causal_kernel.dq_order(valid, s)]
                for t in range(tiles)}
        for t, got in adds.items():
            # Tile t adds to every step from its own first query on, while
            # it holds a valid key.
            live = t * causal_kernel.TILE < valid
            want = list(range(2 * t, steps)) if live else []
            assert got == want, (valid, t)


@pytest.mark.parametrize("d_model,heads,pair", [
    (128, 2, "causal"), (256, 2, "causal"), (512, 8, "causal"),
    (512, 16, "generic"), (512, 2, "generic"), (1040, 2, "plain")])
def test_dense_route_picks_the_pair_by_head_dim(d_model, heads, pair):
    """The dense causal gate takes the dense causal pair at head-major Dh
    64 and 128 on the card and the generic pair at the other widths of
    the kernels' range; beyond it the plain version. On the CPU the route
    hands nothing to the pair."""
    attn = tattn.Attention(d_model, heads, causal=True, sparse=False)
    assert attn._dense_route(512, 512) == (
        "dense_plain" if pair == "plain" else "dense")
    d = d_model // heads
    q = torch.empty((1, heads, 512, d), device="meta")
    assert _dense_pair(True, q) == (pair == "causal")
    assert not _dense_pair(False, q)
    assert not _dense_pair(True, torch.empty((1, heads, 512, d)))
    assert swa_kernel.in_range(d, 128) == (pair != "plain")


class _Recorder:
    """Stands in for the kernel library: records each C entry called and
    its arguments, and returns 0 (success)."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("svt_"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.mark.parametrize("d_model,heads", [(128, 2), (512, 4)])
def test_dense_layer_launches_the_pair(monkeypatch, d_model, heads):
    """A dense causal layer at Dh 64 or 128 on meta tensors (standing in
    for CUDA ones) launches svt_causal_fwd and svt_causal_bwd with (batch,
    heads, length, head dim), counted in the dense counters, and no band
    kernel; on the CPU the same call runs the band plain version, counts
    nothing and does not reach the pair's wrappers."""
    lib = _Recorder()
    monkeypatch.setattr(cuda_lib, "library", lambda: lib)
    monkeypatch.setattr(swa_kernel, "_stream", lambda device: 0)
    attn = tattn.Attention(d_model, heads, causal=True, sparse=False)
    L, d = 512, d_model // heads
    counts = (swa_kernel.dense_launches, swa_kernel.dense_bwd_launches,
              swa_kernel.hm128_launches, swa_kernel.launches)
    meta = attn.to(device="meta", dtype=torch.bfloat16)
    x = torch.empty((3, L, d_model), device="meta", dtype=torch.bfloat16,
                    requires_grad=True)
    meta(x).sum().backward()
    assert [name for name, _ in lib.calls] == ["svt_causal_fwd",
                                               "svt_causal_bwd"]
    assert lib.calls[0][1][6:11] == (
        3, heads, L, d, causal_kernel.fwd_group(3, heads, L, d))
    assert lib.calls[1][1][13:18] == (
        3, heads, L, d, causal_kernel.bwd_group(3, heads, L, d))
    assert lib.calls[0][1][11] == pytest.approx(d ** -0.5)
    assert lib.calls[1][1][18] == pytest.approx(d ** -0.5)
    assert (swa_kernel.dense_launches, swa_kernel.dense_bwd_launches,
            swa_kernel.hm128_launches, swa_kernel.launches) == (
        counts[0] + 1, counts[1] + 1, counts[2], counts[3])
    # The CPU: the band plain versions, no launch and no count.
    def not_here(*args):
        raise AssertionError("the CPU route reached the dense causal pair")

    monkeypatch.setattr(causal_kernel, "causal_fwd", not_here)
    monkeypatch.setattr(causal_kernel, "causal_bwd", not_here)
    torch.manual_seed(0)
    cpu = tattn.Attention(d_model, heads, causal=True, sparse=False)
    y = cpu(torch.randn((2, L, d_model)),
            kv_mask=torch.arange(L)[None, :] < torch.tensor([[L], [200]]))
    assert bool(torch.isfinite(y).all()) and len(lib.calls) == 2
    assert swa_kernel.dense_launches == counts[0] + 1
