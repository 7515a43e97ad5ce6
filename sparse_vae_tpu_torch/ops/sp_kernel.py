"""K6: the decoder's sliding-window + [CLS] attention for one length shard
of sequence parallelism (replacing sparse_vae_tpu/ops/pallas_kernels.py::
sp_windowed_attention_pallas, its custom VJP `_sp_fwd` / `_sp_bwd`,
`_sp_fwd_impl` and `_cls_attend`).

Shard r holds S queries at absolute positions start..start+S-1 and the
extended keys [halo | local] at start-ctx..start+S-1, ctx = (window - 1) *
block; the [CLS] block 0 comes separately, broadcast from shard 0. As in
the JAX package, K6 is the band kernels taught an offset, not a third
attention family:

- shard 0 (start == 0) runs K1/K2 unchanged on its local keys: its band
  holds block 0 with the [CLS] slot's guard against counting it twice,
  which the offset cannot express; dk_ext and dv_ext are zero over the
  halo rows and the [CLS] gradients are zero;
- every other shard runs K1 with q_off = window - 1 over the extended
  keys with no [CLS] slot (csrc/swa_fwd.cu: query block i at key block
  i + q_off), attends the [CLS] block in PyTorch (`cls_attend`) and merges
  the two parts by logaddexp. The backward is one K2 call
  (csrc/swa_bwd.cu) over the extended keys with the broadcast [CLS] block
  as a slot with its own pointer, given the JOINT lse and the merged
  output, so p = exp(s - lse) is the exact partial probability and delta
  = rowsum(do * out) the whole row's; it returns all five gradients. Its
  plain version (sliding_window_attention_bwd_plain with `cls`) adds the
  [CLS] term as JAX's `_sp_bwd` does, to the band's dq already rounded to
  bf16; the kernel sums both parts of dq in fp32 and rounds once.

The shard index is a Python int on each rank, so the branch is a plain
`if`. Rows with no valid key at all (a filler row: ext_len 0 and cls_len
0) give out 0, lse -inf and zero gradients, with no NaN: the merge and the
[CLS] backward select where a -inf lse would meet another.

`SpWindowedAttentionFn` launches the kernels for CUDA tensors and runs the
plain versions for CPU tensors (through ops/swa_kernel.py, which counts
the banded branch's launches as K6's, in `sp_launches` and
`sp_bwd_launches`, and shard 0's as K1's and K2's); `sp_fwd_plain` and
`sp_bwd_plain` are the plain versions on any device, the oracle on the
card.
"""
from __future__ import annotations

import torch

from . import swa_kernel
from .sliding_window_attention import (sliding_window_attention_bwd_plain,
                                       sliding_window_attention_plain)


def route(head_dim: int, block_size: int) -> str:
    """How one shard's decoder attention runs with the kernels on, as the
    JAX package's `Attention._sp_call` dispatches it (block % 128 == 0 and
    Dh % 8 == 0: its Pallas path):

    - "kernel": inside that gate at the K1/K2 instantiation (Dh 64,
      block 128): `SpWindowedAttentionFn`;
    - "plain": inside the gate at another shape: the plain K6 on the CPU,
      counted in swa_kernel.plain_routes; on the card it raises
      (swa_kernel.take_plain_route);
    - "outside": outside the gate: parallel.sp.windowed_attention_ctx, as
      JAX takes its XLA oracle there.
    """
    if block_size % 128 == 0 and head_dim % 8 == 0:
        at = (head_dim, block_size) == (swa_kernel.HEAD_DIM,
                                        swa_kernel.BLOCK_SIZE)
        return "kernel" if at else "plain"
    return "outside"


def cls_attend(q, cls_k, cls_v, cls_len):
    """Attention of every query over the [CLS] key block: (out [B, H, S, D]
    fp32, lse [B, H, S] fp32), out 0 and lse -inf where cls_len is 0."""
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


def _band_plain(q, k, v, lengths, *, window_size, block_size, causal,
                include_cls, q_off, sp=False):
    mask = (torch.arange(k.shape[2], device=q.device)[None, :]
            < lengths.to(torch.int64)[:, None])
    return sliding_window_attention_plain(
        q, k, v, mask, window_size=window_size, block_size=block_size,
        causal=causal, include_cls=include_cls, return_lse=True, q_off=q_off)


def _band_plain_bwd(*args, sp=False, **kwargs):
    return sliding_window_attention_bwd_plain(*args, **kwargs)


def _local(x, ctx: int):
    """The local rows of an extended key tensor, contiguous."""
    return x[:, :, ctx:].contiguous() if ctx else x


def _forward(band_fwd, q, k_ext, v_ext, cls_k, cls_v, start, ext_len,
             cls_len, window_size, block_size):
    hb = window_size - 1
    ctx = hb * block_size
    kw = dict(window_size=window_size, block_size=block_size, causal=True)
    if start == 0:
        return band_fwd(q, _local(k_ext, ctx), _local(v_ext, ctx), ext_len,
                        include_cls=True, q_off=0, **kw)
    out_b, lse_b = band_fwd(q, k_ext, v_ext, ext_len, include_cls=False,
                            q_off=hb, sp=True, **kw)
    out_c, lse_c = cls_attend(q, cls_k, cls_v, cls_len)
    return merge(out_b, lse_b, out_c, lse_c, q.dtype)


def _backward(band_bwd, q, k_ext, v_ext, cls_k, cls_v, start, ext_len,
              cls_len, out, lse, g, window_size, block_size):
    hb = window_size - 1
    ctx = hb * block_size
    kw = dict(window_size=window_size, block_size=block_size, causal=True)
    if start == 0:
        dq, dk, dv = band_bwd(q, _local(k_ext, ctx), _local(v_ext, ctx),
                              ext_len, lse, out, g, include_cls=True,
                              q_off=0, **kw)
        halo = k_ext[:, :, :ctx]
        return (dq, torch.cat([torch.zeros_like(halo), dk], dim=2),
                torch.cat([torch.zeros_like(halo), dv], dim=2),
                torch.zeros_like(cls_k), torch.zeros_like(cls_v))
    return band_bwd(q, k_ext, v_ext, ext_len, lse, out, g, include_cls=False,
                    q_off=hb, cls=(cls_k, cls_v, cls_len), sp=True, **kw)


def sp_fwd(q, k_ext, v_ext, cls_k, cls_v, start: int, ext_len, cls_len,
           window_size: int, block_size: int):
    """(out [B, H, S, D] in q's dtype, lse [B, H, S] fp32) of one shard:
    K1 (with q_off on shards past the first) for CUDA tensors, its plain
    version for CPU tensors. q: [B, H, S, D] at positions start..; k_ext,
    v_ext: [B, H, ctx + S, D]; cls_k, cls_v: [B, H, block, D]; ext_len:
    [B] int32 valid extended keys (on shard 0 the LOCAL prefix: its halo
    rows are never valid); cls_len: [B] int32 valid [CLS] keys."""
    return _forward(swa_kernel.swa_fwd, q, k_ext, v_ext, cls_k, cls_v,
                    start, ext_len, cls_len, window_size, block_size)


def sp_bwd(q, k_ext, v_ext, cls_k, cls_v, start: int, ext_len, cls_len,
           out, lse, g, window_size: int, block_size: int):
    """(dq, dk_ext, dv_ext, dcls_k, dcls_v) of `sp_fwd` given its out and
    lse and the cotangent g: K2 for CUDA tensors, its plain version for
    CPU tensors."""
    return _backward(swa_kernel.swa_bwd, q, k_ext, v_ext, cls_k, cls_v,
                     start, ext_len, cls_len, out, lse, g, window_size,
                     block_size)


def sp_fwd_plain(q, k_ext, v_ext, cls_k, cls_v, start: int, ext_len,
                 cls_len, window_size: int, block_size: int):
    """`sp_fwd` through the plain band versions on any device."""
    return _forward(_band_plain, q, k_ext, v_ext, cls_k, cls_v, start,
                    ext_len, cls_len, window_size, block_size)


def sp_bwd_plain(q, k_ext, v_ext, cls_k, cls_v, start: int, ext_len,
                 cls_len, out, lse, g, window_size: int, block_size: int):
    """`sp_bwd` through the plain band versions on any device."""
    return _backward(_band_plain_bwd, q, k_ext, v_ext, cls_k, cls_v, start,
                     ext_len, cls_len, out, lse, g, window_size, block_size)


class SpWindowedAttentionFn(torch.autograd.Function):
    """K6 with its backward for one length shard (see the module note):
    returns out and gives gradients to q, k_ext, v_ext, cls_k and cls_v."""

    @staticmethod
    def forward(ctx, q, k_ext, v_ext, cls_k, cls_v, start, ext_len, cls_len,
                window_size, block_size):
        out, lse = sp_fwd(q, k_ext, v_ext, cls_k, cls_v, start, ext_len,
                          cls_len, window_size, block_size)
        ctx.save_for_backward(q, k_ext, v_ext, cls_k, cls_v, ext_len,
                              cls_len, out, lse)
        ctx.options = (start, window_size, block_size)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k_ext, v_ext, cls_k, cls_v, ext_len, cls_len, out, lse = \
            ctx.saved_tensors
        start, window_size, block_size = ctx.options
        grads = sp_bwd(q, k_ext, v_ext, cls_k, cls_v, start, ext_len,
                       cls_len, out, lse, g.contiguous(), window_size,
                       block_size)
        return (*grads, None, None, None, None, None)


def sp_windowed_attention(q, k_ext, v_ext, cls_k, cls_v, start: int,
                          ext_len, cls_len, window_size: int,
                          block_size: int):
    """The fused sliding-window + [CLS] attention of one length shard
    (semantics of parallel.sp.windowed_attention_ctx on rows with a valid
    key): `SpWindowedAttentionFn`."""
    return SpWindowedAttentionFn.apply(q, k_ext, v_ext, cls_k, cls_v, start,
                                       ext_len, cls_len, window_size,
                                       block_size)
