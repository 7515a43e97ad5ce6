"""Sliding-window + [CLS] block-sparse attention
(port of sparse_vae_tpu/ops/sliding_window_attention.py).

`sliding_window_attention_plain` is the blocked computation of
`sliding_window_attention_xla`: each query block gathers only its band key
blocks plus block 0 for [CLS]. It is the plain version of the K1 kernel
(ops/swa_kernel.py::swa_fwd). `sliding_window_attention_bwd_plain` is the
explicit blocked backward (p = exp(s - lse), delta = rowsum(do * o),
ds = p * (dp - delta) * scale) and the plain version of the K2 kernel
(ops/swa_kernel.py::swa_bwd). Both take `q_off`, the sequence-parallel
form of the JAX package's band kernels (K6's band part): q holds Lq rows,
k and v Lk = Lq + q_off * block extended keys, and query block i sits at
key block i + q_off; and `cls`, the broadcast [CLS] block that every query
of a banded shard also attends (K6's [CLS] part): the forward attends it
apart (`cls_attend`) and merges the two parts by logaddexp (`merge`), as
the JAX package's `_sp_fwd_impl` does. `SlidingWindowAttentionFn` wraps
the pair as one autograd Function: the kernels for CUDA tensors, the plain
versions for CPU tensors. The dispatcher `sliding_window_attention` goes
through it, or through autograd of the plain forward when the caller turns
the kernels off (the JAX package's `force_xla`).

The packed layout ([B, L, H * Dh], the projections' own, which the JAX
package takes at Dh % 128 == 0): `sliding_window_attention_packed_plain`
and `sliding_window_attention_packed_bwd_plain` are the head-major plain
versions between head views, the oracle of the JAX package's packed tests
and the plain versions of K5/K5b (ops/swa_kernel.py::swa_fwd_packed,
::swa_bwd_packed); `SlidingWindowAttentionPackedFn` wraps them as
`SlidingWindowAttentionFn` wraps K1/K2. Both Functions launch the generic
pair of csrc/swa_generic.cu instead at the shapes no tuned instantiation
takes (any Dh % 8 == 0 up to 512, any block that is a multiple of 128),
and these plain versions are its plain versions too: none assumes a head
dim or a block.

One deliberate difference from the reference: a query row with no valid
key at all (a row whose kv_mask is all False) gives 0 here, where the
reference's -1e9 fill averages the masked values. Such rows are padding
and are never read.
"""
from __future__ import annotations


import torch

from ..models.remat import kernel_forward

NEG_INF = -1e9


def _band_indices(num_blocks: int, window_size: int, include_cls: bool,
                  causal: bool = True, device=None, q_off: int = 0):
    """For each of `num_blocks` query blocks, the attended key block
    indices [num_blocks, window_size (+1 cls)] clamped to the
    num_blocks + q_off key blocks, and a parallel bool marking real
    (non-clamped, non-duplicate) entries. Query block i sits at key block
    i + q_off (_slot_to_block with the shifted block)."""
    num_k_blocks = num_blocks + q_off
    q = torch.arange(num_blocks, device=device)[:, None] + q_off
    if causal:
        offsets = torch.arange(window_size, device=device) - (window_size - 1)
    else:
        left = (window_size + 1) // 2
        offsets = torch.arange(window_size, device=device) - (left - 1)
    k_idx = q + offsets[None, :]
    valid = (k_idx >= 0) & (k_idx < num_k_blocks)
    k_idx = k_idx.clamp(0, num_k_blocks - 1)
    if include_cls:
        cls_idx = torch.zeros((num_blocks, 1), dtype=k_idx.dtype,
                              device=device)
        # The [CLS] column is redundant when the band already covers block 0.
        cls_valid = k_idx[:, :1] > 0
        k_idx = torch.cat([cls_idx, k_idx], dim=1)
        valid = torch.cat([cls_valid, valid], dim=1)
    return k_idx, valid


def _check_q_off(L: int, key_len: int, block_size: int, q_off: int,
                 include_cls: bool) -> int:
    """The query block count; raises unless Lq and Lk are block multiples
    with Lk = Lq + q_off * block_size, and q_off > 0 has no [CLS] slot."""
    if L % block_size:
        raise ValueError(f"length {L} is not a multiple of {block_size}")
    if q_off < 0 or key_len != L + q_off * block_size:
        raise ValueError(f"key length {key_len} is not {L} + q_off "
                         f"{q_off} x {block_size}")
    if q_off and include_cls:
        raise ValueError("q_off > 0 takes no [CLS] slot (include_cls)")
    return L // block_size


def sliding_window_attention_plain(q, k, v, kv_mask=None, *,
                                   window_size: int = 2,
                                   block_size: int = 128,
                                   causal: bool = True,
                                   include_cls: bool = True,
                                   return_lse: bool = False,
                                   q_off: int = 0, cls=None):
    """Blocked sliding-window attention.

    q: [B, H, L, D] with L % block_size == 0; k/v: [B, H, L + q_off *
    block_size, D]; kv_mask: [B, Lk] bool (True = valid). Returns out
    [B, H, L, D] in v's dtype, and with return_lse also the fp32
    log-sum-exp [B, H, L] of the attended scores (-inf for a row with no
    valid key). Scores and softmax are fp32; the weights are cast to v's
    dtype before the value product, as in the reference. cls: (cls_k,
    cls_v [B, H, block_size, D], cls_len [B] valid keys) in place of
    include_cls, the broadcast [CLS] block of a banded shard: the band's
    (out, lse), out in v's dtype, merged with `cls_attend`'s by logaddexp;
    lse is then the joint one.
    """
    if cls is not None:
        if include_cls:
            raise ValueError("cls takes the place of include_cls")
        out, lse = sliding_window_attention_plain(
            q, k, v, kv_mask, window_size=window_size,
            block_size=block_size, causal=causal, include_cls=False,
            return_lse=True, q_off=q_off)
        out, lse = merge(out, lse, *cls_attend(q, *cls), v.dtype)
        return (out, lse) if return_lse else out
    b, h, L, d = q.shape
    nb = _check_q_off(L, k.shape[2], block_size, q_off, include_cls)
    nk = nb + q_off
    k_idx, band_valid = _band_indices(nb, window_size, include_cls, causal,
                                      q.device, q_off)
    s = k_idx.shape[1]
    flat_idx = k_idx.reshape(-1)

    kb = k.reshape(b, h, nk, block_size, d)
    vb = v.reshape(b, h, nk, block_size, d)
    k_band = kb[:, :, flat_idx].reshape(b, h, nb, s, block_size, d)
    v_band = vb[:, :, flat_idx].reshape(b, h, nb, s, block_size, d)
    qb = q.reshape(b, h, nb, block_size, d)
    scores = torch.einsum("bhnqd,bhnskd->bhnqsk", qb.float(),
                          k_band.float()) * d ** -0.5

    ar = torch.arange(block_size, device=q.device)
    q_pos = (torch.arange(nb, device=q.device)[:, None] + q_off) \
        * block_size + ar
    k_pos = k_idx[:, :, None] * block_size + ar                # [nQ, S, bs]
    mask = band_valid[:, None, :, None].expand(nb, block_size, s, block_size)
    if causal:
        mask = mask & (k_pos[:, None] <= q_pos[:, :, None, None])
    mask = mask[None, None]                                  # [1,1,nQ,bs,S,bs]
    if kv_mask is not None:
        pad = kv_mask.reshape(b, nk, block_size)[:, flat_idx].reshape(
            b, nb, s, block_size)
        mask = mask & pad[:, None, :, None, :, :]

    flat_mask = mask.reshape(*mask.shape[:4], s * block_size)
    flat = scores.reshape(b, h, nb, block_size, s * block_size)
    flat = flat.masked_fill(~flat_mask, NEG_INF)
    weights = torch.softmax(flat, dim=-1)
    has_key = flat_mask.any(dim=-1, keepdim=True)
    weights = torch.where(has_key, weights, 0.0).to(v.dtype)
    weights = weights.reshape(b, h, nb, block_size, s, block_size)
    out = torch.einsum("bhnqsk,bhnskd->bhnqd", weights, v_band)
    out = out.reshape(b, h, L, d)
    if not return_lse:
        return out
    lse = torch.logsumexp(flat.masked_fill(~flat_mask, float("-inf")),
                          dim=-1)
    return out, lse.reshape(b, h, L)


def cls_attend(q, cls_k, cls_v, cls_len):
    """Attention of every query over the [CLS] key block (the JAX
    package's `_cls_attend`): (out [B, H, S, D] fp32, lse [B, H, S] fp32),
    out 0 and lse -inf where cls_len is 0."""
    scale = q.shape[-1] ** -0.5
    s = torch.matmul(q.float(), cls_k.float().transpose(-1, -2)) * scale
    col = torch.arange(cls_k.shape[2], device=q.device)
    mask = (col[None, :] < cls_len.to(torch.int64)[:, None])[:, None, None]
    s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(dim=-1)
    p = torch.exp(s - torch.where(torch.isfinite(m), m, 0.0)[..., None])
    l = p.sum(dim=-1)
    o = torch.matmul(p.to(cls_v.dtype), cls_v).float() \
        / l.clamp_min(1e-30)[..., None]
    lse = torch.where(l > 0, m + torch.log(l), float("-inf"))
    return o, lse


def merge(out_b, lse_b, out_c, lse_c, dtype):
    """Flash merge of two normalised attention parts by logaddexp; a row
    where both lse are -inf gives out 0 and lse -inf."""
    lse = torch.logaddexp(lse_b, lse_c)
    finite = torch.where(torch.isfinite(lse), lse, 0.0)
    w_b = torch.exp(lse_b - finite)[..., None]
    w_c = torch.exp(lse_c - finite)[..., None]
    return (w_b * out_b.float() + w_c * out_c).to(dtype), lse


def _band_mask(b, nb, block_size, k_idx, band_valid, lengths, causal,
               device, q_off: int = 0):
    """[B, 1, nQ, bs, S, bs] bool: band slot validity, the causal triangle
    and the per-row valid key prefix (positions on the key axis)."""
    s = k_idx.shape[1]
    ar = torch.arange(block_size, device=device)
    q_pos = (torch.arange(nb, device=device)[:, None] + q_off) * block_size \
        + ar
    k_pos = k_idx[:, :, None] * block_size + ar                # [nQ, S, bs]
    mask = band_valid[:, None, :, None].expand(nb, block_size, s, block_size)
    if causal:
        mask = mask & (k_pos[:, None] <= q_pos[:, :, None, None])
    keys = k_pos[None] < lengths.to(torch.int64)[:, None, None, None]
    return (mask[None] & keys[:, :, None])[:, None]


def sliding_window_attention_bwd_plain(q, k, v, lengths, lse, out, do, *,
                                       window_size: int = 2,
                                       block_size: int = 128,
                                       causal: bool = True,
                                       include_cls: bool = True,
                                       q_off: int = 0, cls=None):
    """Explicit blocked backward of `sliding_window_attention_plain` (the
    JAX package's `_bwd_pallas` math), in fp32.

    q/out/do: [B, H, L, D]; k/v: [B, H, L + q_off * block_size, D];
    lengths: [B] valid key prefix; lse: the forward's fp32 [B, H, L] (-inf
    for a row with no valid key). p is exp(s - lse) where the mask allows
    and 0 elsewhere, chosen by select so that a -inf lse never meets a
    masked score. Returns (dq, dk, dv) in the dtypes of q, k and v.
    cls: (cls_k, cls_v, cls_len) in place of include_cls, the broadcast
    [CLS] block of a banded shard (`cls_backward_plain`); then also
    returns dcls_k and dcls_v.
    """
    b, h, L, d = q.shape
    nb = _check_q_off(L, k.shape[2], block_size, q_off, include_cls)
    if cls is not None and include_cls:
        raise ValueError("cls takes the place of include_cls")
    nk = nb + q_off
    scale = d ** -0.5
    k_idx, band_valid = _band_indices(nb, window_size, include_cls, causal,
                                      q.device, q_off)
    s = k_idx.shape[1]
    flat_idx = k_idx.reshape(-1)

    def band(x):
        return x.float().reshape(b, h, nk, block_size, d)[:, :, flat_idx] \
            .reshape(b, h, nb, s, block_size, d)

    k_band, v_band = band(k), band(v)
    qb = q.float().reshape(b, h, nb, block_size, d)
    dob = do.float().reshape(b, h, nb, block_size, d)
    mask = _band_mask(b, nb, block_size, k_idx, band_valid, lengths, causal,
                      q.device, q_off)
    scores = torch.einsum("bhnqd,bhnskd->bhnqsk", qb, k_band) * scale
    lse_b = lse.float().reshape(b, h, nb, block_size, 1, 1)
    p = torch.where(mask, torch.exp(scores - lse_b), 0.0)
    delta = (do.float() * out.float()).sum(-1).reshape(b, h, nb, block_size,
                                                       1, 1)
    dp = torch.einsum("bhnqd,bhnskd->bhnqsk", dob, v_band)
    ds = p * (dp - delta) * scale
    dq = torch.einsum("bhnqsk,bhnskd->bhnqd", ds, k_band)
    # Per (q block, slot) key-block gradients, then summed into their key
    # blocks. Invalid slots carry p = ds = 0, so their clamped duplicate
    # indices add nothing.
    dk_band = torch.einsum("bhnqsk,bhnqd->bhnskd", ds, qb)
    dv_band = torch.einsum("bhnqsk,bhnqd->bhnskd", p, dob)
    dk = torch.zeros((b, h, nk, block_size, d), device=q.device)
    dv = torch.zeros_like(dk)
    dk.index_add_(2, flat_idx, dk_band.reshape(b, h, nb * s, block_size, d))
    dv.index_add_(2, flat_idx, dv_band.reshape(b, h, nb * s, block_size, d))
    grads = (dq.reshape(b, h, L, d).to(q.dtype),
             dk.reshape(b, h, nk * block_size, d).to(k.dtype),
             dv.reshape(b, h, nk * block_size, d).to(v.dtype))
    if cls is None:
        return grads
    dq, dcls_k, dcls_v = cls_backward_plain(q, *cls, lse, out, do, grads[0])
    return (dq, *grads[1:], dcls_k, dcls_v)


def cls_backward_plain(q, cls_k, cls_v, cls_len, lse, out, do, dq):
    """The broadcast [CLS] block's part of a banded shard's backward (the
    JAX package's `_sp_bwd`, banded branch), every query attending the
    [CLS] keys 0 .. cls_len - 1 under the JOINT lse and the merged out:
    returns (dq plus the [CLS] term, dcls_k, dcls_v). As in JAX, ds and p
    are rounded to the inputs' dtype before their products, and the term
    is added to the band's already rounded dq; where the mask forbids, p
    is chosen 0 so that a -inf lse never meets a score."""
    scale = q.shape[-1] ** -0.5
    s = torch.matmul(q.float(), cls_k.float().transpose(-1, -2)) * scale
    col = torch.arange(cls_k.shape[2], device=q.device)
    mask = (col[None, :] < cls_len.to(torch.int64)[:, None])[:, None, None]
    p = torch.where(mask, torch.exp(s - lse[..., None]), 0.0)
    gf = do.float()
    delta = (gf * out.float()).sum(dim=-1)                      # [B, H, S]
    dp = torch.matmul(gf, cls_v.float().transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * scale
    dq = (dq.float() + torch.matmul(ds.to(cls_k.dtype), cls_k).float()
          ).to(q.dtype)
    dcls_k = torch.matmul(ds.to(q.dtype).transpose(-1, -2), q)
    dcls_v = torch.matmul(p.to(do.dtype).transpose(-1, -2), do)
    return dq, dcls_k.to(cls_k.dtype), dcls_v.to(cls_v.dtype)


def split_heads(x, num_heads: int):
    """[B, L, H * D] -> [B, H, L, D] (a view where the strides allow)."""
    b, length, width = x.shape
    return x.reshape(b, length, num_heads, width // num_heads).transpose(1, 2)


def merge_heads(x):
    """[B, H, L, D] -> [B, L, H * D]."""
    b, h, length, d = x.shape
    return x.transpose(1, 2).reshape(b, length, h * d)


def sliding_window_attention_packed_plain(q, k, v, lengths, num_heads: int,
                                          *, window_size: int = 2,
                                          block_size: int = 128,
                                          causal: bool = True,
                                          include_cls: bool = True):
    """`sliding_window_attention_plain` on packed operands: q/k/v
    [B, L, H * D], lengths [B] valid key prefix. Returns (out
    [B, L, H * D], lse [B, H, L] fp32), the packed forward's layouts."""
    length = q.shape[1]
    mask = (torch.arange(length, device=q.device)[None, :]
            < lengths.to(torch.int64)[:, None])
    out, lse = sliding_window_attention_plain(
        *(split_heads(t, num_heads) for t in (q, k, v)), mask,
        window_size=window_size, block_size=block_size, causal=causal,
        include_cls=include_cls, return_lse=True)
    return merge_heads(out), lse


def sliding_window_attention_packed_bwd_plain(q, k, v, lengths, lse, out, do,
                                              num_heads: int, *,
                                              window_size: int = 2,
                                              block_size: int = 128,
                                              causal: bool = True,
                                              include_cls: bool = True):
    """`sliding_window_attention_bwd_plain` on packed operands: q/k/v/out/do
    [B, L, H * D], lse [B, H, L]. Returns (dq, dk, dv) packed."""
    grads = sliding_window_attention_bwd_plain(
        *(split_heads(t, num_heads) for t in (q, k, v)), lengths, lse,
        split_heads(out, num_heads), split_heads(do, num_heads),
        window_size=window_size, block_size=block_size, causal=causal,
        include_cls=include_cls)
    return tuple(merge_heads(g) for g in grads)


def _dense_pair(dense: bool, q) -> bool:
    """Whether a call goes to the dense causal pair (ops/causal_kernel.py):
    the dense causal route off the CPU at head-major Dh 64 or 128. On the
    CPU the route runs the band plain version at every width."""
    from .causal_kernel import HEAD_DIMS
    return dense and q.device.type != "cpu" and q.shape[-1] in HEAD_DIMS


class SlidingWindowAttentionFn(torch.autograd.Function):
    """Sliding-window + [CLS] attention with its backward: K1 forward and
    K2 backward for CUDA tensors, the plain versions for CPU tensors.
    lengths: [B] int32 valid key prefix per row. dense: the call is the
    dense causal route (ops/attention.py: a causal band of every block, no
    [CLS] slot), which the dense causal pair takes on the card at
    head-major Dh 64 and 128 (`_dense_pair`). The forward's (out, lse) is
    a rematerialisation save point (models/remat.py `kernel_forward`)."""

    @staticmethod
    def forward(ctx, q, k, v, lengths, window_size, block_size, causal,
                include_cls, dense=False):
        from . import causal_kernel
        from .swa_kernel import swa_fwd
        if _dense_pair(dense, q):
            out, lse = kernel_forward(
                lambda: causal_kernel.causal_fwd(q, k, v, lengths))
        else:
            out, lse = kernel_forward(lambda: swa_fwd(
                q, k, v, lengths, window_size=window_size,
                block_size=block_size, causal=causal,
                include_cls=include_cls))
        ctx.save_for_backward(q, k, v, lengths, out, lse)
        ctx.options = (window_size, block_size, causal, include_cls, dense)
        return out

    @staticmethod
    def backward(ctx, do):
        from . import causal_kernel
        from .swa_kernel import swa_bwd
        q, k, v, lengths, out, lse = ctx.saved_tensors
        window_size, block_size, causal, include_cls, dense = ctx.options
        if _dense_pair(dense, q):
            dq, dk, dv = causal_kernel.causal_bwd(q, k, v, lengths, lse, out,
                                                  do.contiguous())
        else:
            dq, dk, dv = swa_bwd(q, k, v, lengths, lse, out, do.contiguous(),
                                 window_size=window_size,
                                 block_size=block_size, causal=causal,
                                 include_cls=include_cls)
        return dq, dk, dv, None, None, None, None, None, None


def sliding_window_attention(q, k, v, kv_mask=None, *, window_size: int = 2,
                             block_size: int = 128, causal: bool = True,
                             include_cls: bool = True,
                             use_kernel: bool = True, dense: bool = False):
    """Dispatcher: `SlidingWindowAttentionFn` (K1/K2 for CUDA tensors, their
    plain versions for CPU tensors), or autograd of the plain forward when
    use_kernel is False. On the Function's path kv_mask must be a
    right-padding prefix mask (the kernels take per-row valid lengths).
    dense: the dense causal route (a causal band of every block, no [CLS]
    slot): the dense causal pair on the card at head-major Dh 64 and
    128."""
    if not use_kernel:
        return sliding_window_attention_plain(
            q, k, v, kv_mask, window_size=window_size,
            block_size=block_size, causal=causal, include_cls=include_cls)
    b, _, L, _ = q.shape
    if kv_mask is None:
        lengths = torch.full((b,), L, dtype=torch.int32, device=q.device)
    else:
        lengths = kv_mask.sum(dim=-1, dtype=torch.int32)
    return SlidingWindowAttentionFn.apply(q, k, v, lengths, window_size,
                                          block_size, causal, include_cls,
                                          dense)


class SlidingWindowAttentionPackedFn(torch.autograd.Function):
    """Sliding-window + [CLS] attention on packed [B, L, H * D] operands
    with its backward: K5 forward and K5b backward for CUDA tensors, the
    packed plain versions for CPU tensors. lengths: [B] int32 valid key
    prefix per row."""

    @staticmethod
    def forward(ctx, q, k, v, lengths, num_heads, window_size, block_size,
                causal, include_cls):
        from .swa_kernel import swa_fwd_packed
        out, lse = kernel_forward(lambda: swa_fwd_packed(
            q, k, v, lengths, num_heads, window_size=window_size,
            block_size=block_size, causal=causal, include_cls=include_cls))
        ctx.save_for_backward(q, k, v, lengths, out, lse)
        ctx.options = (num_heads, window_size, block_size, causal,
                       include_cls)
        return out

    @staticmethod
    def backward(ctx, do):
        from .swa_kernel import swa_bwd_packed
        q, k, v, lengths, out, lse = ctx.saved_tensors
        num_heads, window_size, block_size, causal, include_cls = ctx.options
        dq, dk, dv = swa_bwd_packed(q, k, v, lengths, lse, out,
                                    do.contiguous(), num_heads,
                                    window_size=window_size,
                                    block_size=block_size, causal=causal,
                                    include_cls=include_cls)
        return dq, dk, dv, None, None, None, None, None, None
