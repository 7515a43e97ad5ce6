"""The dense causal attention pair: the counterpart of the JAX library's
Pallas flash attention, which the JAX package calls for dense causal
self-attention on the TPU (sparse_vae_tpu/ops/attention.py:472:
jax.experimental.pallas.ops.tpu.flash_attention with causal=True and the
key mask as segment ids). The CUDA kernels are csrc/causal_fwd.cu and
csrc/causal_bwd.cu, at head-major Dh 64 and 128; the dense causal route
(ops/attention.py `_dense_route`, through `SlidingWindowAttentionFn` with
dense=True) hands them its card tensors at those widths, and the generic
pair of csrc/swa_generic.cu takes the others. On the CPU the route runs
the band plain version at every width.

Query i attends key j iff j <= i and j < lengths[b]: a pad query attends
the valid keys, as the JAX package's masked dense path does (its flash
branch's segment ids differ there; no loss reads a pad position). Each
wrapper launches its kernel for CUDA tensors, counted in
`swa_kernel.dense_launches` / `dense_bwd_launches`, and runs its plain
version (`causal_attention_plain`, `causal_attention_bwd_plain`) for CPU
tensors; there is no other fallback.

The wrappers pass each grid's chunk of (head, row) pairs (`fwd_group`,
`bwd_group`) to the kernels. `fwd_order` and `bwd_order` are the
kernels' CTA orders over those chunks, and `dq_order` the order in which
the backward's key tiles add to a query step's dq: Python copies of the
kernels' index arithmetic (csrc/hopper.cuh `chunked_tile`, the tile
order of causal_fwd.cu and causal_bwd.cu), kept in step by hand.
"""
from __future__ import annotations

import torch

from . import cuda_lib, swa_kernel

HEAD_DIMS = (64, 128)
TILE = 128   # queries of a forward CTA, keys of a backward CTA
STEP = 64    # queries of a backward step (one dq counter each)
NEG_INF = -1e9


def _mask(length: int, lengths, device):
    """[B, 1, L, L] bool: key j attended by query i (j <= i, j < length)."""
    pos = torch.arange(length, device=device)
    causal = pos[None, :] <= pos[:, None]
    valid = pos[None, :] < lengths.to(device=device,
                                      dtype=torch.int64)[:, None]
    return (causal[None] & valid[:, None, :])[:, None]


def causal_attention_plain(q, k, v, lengths):
    """Dense causal attention over each row's valid keys, the plain version
    of the forward kernel. q, k, v: [B, H, L, D]; lengths: [B]. Returns
    (out [B, H, L, D] in v's dtype, lse [B, H, L] fp32, -inf for a row
    with no valid key). Scores and softmax are fp32; the weights are cast
    to v's dtype before the value product."""
    d = q.shape[-1]
    mask = _mask(q.shape[2], lengths, q.device)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * d ** -0.5
    weights = torch.softmax(scores.masked_fill(~mask, NEG_INF), dim=-1)
    has_key = mask.any(dim=-1, keepdim=True)
    weights = torch.where(has_key, weights, 0.0).to(v.dtype)
    out = torch.matmul(weights, v)
    lse = torch.logsumexp(scores.masked_fill(~mask, float("-inf")), dim=-1)
    return out, lse


def causal_attention_bwd_plain(q, k, v, lengths, lse, out, do):
    """The backward of `causal_attention_plain`, in fp32: p = exp(s - lse)
    where the mask allows and 0 elsewhere (chosen by select, so a -inf lse
    never meets a masked score), delta = rowsum(do * out), ds = p (dp -
    delta) scale. Returns (dq, dk, dv) in the dtypes of q, k and v."""
    d = q.shape[-1]
    scale = d ** -0.5
    mask = _mask(q.shape[2], lengths, q.device)
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    scores = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    p = torch.where(mask, torch.exp(scores - lse.float()[..., None]), 0.0)
    delta = (dof * out.float()).sum(dim=-1, keepdim=True)
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta) * scale
    dq = torch.matmul(ds, kf)
    dk = torch.matmul(ds.transpose(-1, -2), qf)
    dv = torch.matmul(p.transpose(-1, -2), dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# The pair's per-row gate, beside PERF.md section 2's (chip_smoke.py and
# the card tests): a late row of a dense causal row attends thousands of
# keys, so one key tile's share of it (a wrong V slot, a lost dq add)
# moves it by about sqrt(128 / its keys) of its norm (0.19 at 3,584 keys),
# while the absolute gates are set by the early rows' larger values.
ROW_REL_TOL = 0.03
# A row's norm counts as at least this share of the largest row's, so that
# a row which cancels to about zero (the dq of a query with one key) does
# not divide rounding by rounding.
ROW_FLOOR = 1e-3


def row_start(length: int) -> int:
    """The first row of [B, H, L, D] that `row_rel_err` reads: 1,024, or
    half of a shorter length."""
    return min(1024, length // 2)


def row_rel_err(got, want) -> float:
    """The largest ||got - want|| / ||want|| over the rows (the vectors of
    the last dim) at positions `row_start` and past of [B, H, L, D]
    tensors: the query rows of out and dq, the key rows of dk and dv. A
    row's norm is taken as at least ROW_FLOOR of the tensor's largest."""
    start = row_start(want.shape[2])
    g, w = got.float(), want.float()
    err = (g - w).norm(dim=-1)[:, :, start:]
    norm = w.norm(dim=-1)
    floor = ROW_FLOOR * norm.max().clamp_min(1e-30)
    return (err / norm[:, :, start:].clamp_min(floor)).max().item()


def _check(q, k, v, lengths, *extra):
    b = q.shape[0]
    if k.shape != q.shape or v.shape != q.shape \
            or any(t.shape != q.shape for t in extra):
        raise ValueError(f"q, k, v (out, do) must share [B, H, L, D], got "
                         f"{[tuple(t.shape) for t in (q, k, v, *extra)]}")
    if lengths.shape != (b,):
        raise ValueError(f"lengths must be [{b}], got {tuple(lengths.shape)}")
    if len({t.device for t in (q, k, v, lengths, *extra)}) != 1:
        raise ValueError("inputs on several devices")


def _check_cuda(kernel: str, tensors, lengths):
    d, L = tensors[0].shape[-1], tensors[0].shape[2]
    if d not in HEAD_DIMS or L % TILE:
        raise ValueError(f"the {kernel} kernel takes Dh 64 or 128 and a "
                         f"length that is a multiple of {TILE}, got Dh {d},"
                         f" L {L}")
    if any(t.dtype != torch.bfloat16 for t in tensors):
        raise TypeError(f"the {kernel} kernel takes bf16 tensors")
    if lengths.dtype != torch.int32:
        raise TypeError("lengths must be int32")
    if not all(t.is_contiguous() for t in (*tensors, lengths)):
        raise ValueError(f"the {kernel} kernel takes contiguous inputs")


def causal_fwd(q, k, v, lengths):
    """Dense causal attention forward: (out [B, H, L, D], lse [B, H, L]
    fp32). CPU tensors run `causal_attention_plain`; CUDA tensors (bf16,
    contiguous, Dh 64 or 128, L a multiple of 128) launch
    csrc/causal_fwd.cu, counted in `swa_kernel.dense_launches`."""
    _check(q, k, v, lengths)
    if q.device.type == "cpu":
        return causal_attention_plain(q, k, v, lengths)
    _check_cuda("causal_fwd", (q, k, v), lengths)
    b, h, L, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, L), dtype=torch.float32, device=q.device)
    code = cuda_lib.library().svt_causal_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), lse.data_ptr(), b, h, L, d, fwd_group(b, h, L, d),
        d ** -0.5, swa_kernel._stream(q.device))
    cuda_lib.check(code, "causal_fwd")
    swa_kernel.dense_launches += 1
    return out, lse


def causal_bwd(q, k, v, lengths, lse, out, do):
    """The backward of `causal_fwd`: (dq, dk, dv). CPU tensors run
    `causal_attention_bwd_plain`; CUDA tensors launch csrc/causal_bwd.cu
    (delta, the one pass over key tiles, the dq rounding), counted in
    `swa_kernel.dense_bwd_launches`."""
    _check(q, k, v, lengths, out, do)
    if lse.shape != q.shape[:3] or lse.device != q.device:
        raise ValueError(f"lse must be {tuple(q.shape[:3])} on q's device, "
                         f"got {tuple(lse.shape)} on {lse.device}")
    if q.device.type == "cpu":
        return causal_attention_bwd_plain(q, k, v, lengths, lse, out, do)
    _check_cuda("causal_bwd", (q, k, v, out, do), lengths)
    if lse.dtype != torch.float32 or not lse.is_contiguous():
        raise TypeError("the causal_bwd kernel takes a contiguous fp32 lse")
    b, h, L, d = q.shape
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    delta = torch.empty((b, h, L), dtype=torch.float32, device=q.device)
    dq_acc = torch.empty((b, h, L, d), dtype=torch.float32, device=q.device)
    counters = torch.empty((b * h * L // STEP,), dtype=torch.int32,
                           device=q.device)
    code = cuda_lib.library().svt_causal_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        lse.data_ptr(), out.data_ptr(), do.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), delta.data_ptr(), dq_acc.data_ptr(),
        counters.data_ptr(), b, h, L, d, bwd_group(b, h, L, d), d ** -0.5,
        swa_kernel._stream(q.device))
    cuda_lib.check(code, "causal_bwd")
    swa_kernel.dense_bwd_launches += 1
    return dq, dk, dv


# A chunk of the forward's grid holds as many (head, row) pairs as keep
# their K and V within FWD_L2_BYTES of the card's 50 MB L2, the
# backward's their dq buffer, Q and dO within BWD_L2_BYTES.
FWD_L2_BYTES = 8 << 20
BWD_L2_BYTES = 32 << 20


def l2_group(rows: int, bytes_per_row: int, budget: int) -> int:
    """The (head, row) pairs of a chunk: as many as keep `bytes_per_row`
    each within `budget`, at least one."""
    return max(1, min(rows, budget // max(bytes_per_row, 1)))


def fwd_group(batch: int, heads: int, length: int, head_dim: int) -> int:
    """The forward's chunk: pairs whose K and V (4 L Dh bytes a pair) fit
    FWD_L2_BYTES."""
    return l2_group(batch * heads, 4 * length * head_dim, FWD_L2_BYTES)


def bwd_group(batch: int, heads: int, length: int, head_dim: int) -> int:
    """The backward pass's chunk: pairs whose dq buffer, Q and dO (8 L Dh
    bytes a pair) fit BWD_L2_BYTES."""
    return l2_group(batch * heads, 8 * length * head_dim, BWD_L2_BYTES)


def _chunked(rows: int, tiles: int, group: int) -> list:
    """csrc/hopper.cuh `chunked_tile` over the grid: (row, tile) of each
    CTA in launch order."""
    order = []
    for cta in range(rows * tiles):
        chunk, within = divmod(cta, group * tiles)
        g = min(group, rows - chunk * group)
        order.append((chunk * group + within % g, within // g))
    return order


def fwd_order(batch: int, heads: int, length: int, head_dim: int) -> list:
    """The forward grid's CTAs in launch order as (b, h, query tile): in
    chunks of `fwd_group` (head, row) pairs, the pairs fastest within a
    chunk, then the query tiles from the last (the longest rows) down
    (csrc/causal_fwd.cu)."""
    tiles = length // TILE
    group = fwd_group(batch, heads, length, head_dim)
    return [(hb // heads, hb % heads, tiles - 1 - t)
            for hb, t in _chunked(batch * heads, tiles, group)]


def bwd_order(batch: int, heads: int, length: int, head_dim: int) -> list:
    """The backward pass's CTAs in launch order as (b, h, key tile): in
    chunks of `bwd_group` (head, row) pairs, the pairs fastest within a
    chunk, then the key tiles from the last (the fewest queries) down
    (csrc/causal_bwd.cu):
    key tile t adds to a query step's dq after tile t + 1, which was
    launched before it and reaches the step two steps before it does."""
    tiles = length // TILE
    group = bwd_group(batch, heads, length, head_dim)
    return [(hb // heads, hb % heads, tiles - 1 - t)
            for hb, t in _chunked(batch * heads, tiles, group)]


def dq_order(valid: int, step: int) -> list:
    """The key tiles that add to query step `step`'s dq (queries step *
    STEP ..), in the order they add: every tile at or before the step's
    query tile that holds a valid key (`valid` of them), the highest
    first (it stores, the others add)."""
    if valid <= 0:
        return []
    top = min(step * STEP // TILE, (valid - 1) // TILE)
    return list(range(top, -1, -1))
