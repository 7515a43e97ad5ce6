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
- every other shard runs one K1 launch and one K2 launch set over the
  extended keys with q_off = window - 1 (0 at window 1; query block i at
  key block i + q_off), the broadcast [CLS] block a slot of each with its
  own pointer (`cls`), masked by cls_len only and never causally. The
  forward's online softmax spans the [CLS] block and the band, so it
  gives the merged output and the JOINT lse in one pass
  (csrc/swa_fwd.cu); the backward, given that lse and output, has p =
  exp(s - lse) the exact partial probability and delta = rowsum(do * out)
  the whole row's, and returns all five gradients (csrc/swa_bwd.cu).

The plain versions keep JAX's composition: the forward's
(sliding_window_attention_plain with `cls`) runs the band, attends the
[CLS] block apart and merges the two by logaddexp, the band's output
rounded to bf16 before the merge; the backward's
(sliding_window_attention_bwd_plain with `cls`) adds the [CLS] term, as
`_sp_bwd` does, to the band's dq already rounded to bf16. The kernels sum
both parts in fp32 and round once, so on bf16 inputs they differ from the
plain versions by about one bf16 rounding.

The shard index is a Python int on each rank, so the branch is a plain
`if`. Rows with no valid key at all (a filler row: ext_len 0 and cls_len
0) give out 0, lse -inf and zero gradients, with no NaN.

`SpWindowedAttentionFn` launches the kernels for CUDA tensors and runs the
plain versions for CPU tensors (through ops/swa_kernel.py, which counts
the banded branch's launches as K6's, in `sp_launches` and
`sp_bwd_launches`, and shard 0's as K1's and K2's); `sp_fwd_plain` and
`sp_bwd_plain` are the plain versions on any device, the oracle on the
card.
"""
from __future__ import annotations

import torch

from ..models.remat import kernel_forward
from . import swa_kernel
from .sliding_window_attention import (sliding_window_attention_bwd_plain,
                                       sliding_window_attention_plain)


def route(head_dim: int, block_size: int) -> str:
    """How one shard's decoder attention runs with the kernels on, as the
    JAX package's `Attention._sp_call` dispatches it (block % 128 == 0 and
    Dh % 8 == 0: its Pallas path):

    - "kernel": inside that gate up to Dh 512: `SpWindowedAttentionFn`,
      on K1/K2 at Dh 64 or 128 and block 128, on the generic pair
      (csrc/swa_generic.cu) at the other shapes;
    - "plain": inside the gate beyond Dh 512: the plain K6 on the CPU,
      counted in swa_kernel.plain_routes; on the card it raises
      (swa_kernel.take_plain_route);
    - "outside": outside the gate: parallel.sp.windowed_attention_ctx, as
      JAX takes its XLA oracle there.
    """
    if block_size % 128 == 0 and head_dim % 8 == 0:
        return "kernel" if swa_kernel.in_range(head_dim, block_size) \
            else "plain"
    return "outside"


def _band_plain(q, k, v, lengths, *, window_size, block_size, causal,
                include_cls, q_off, cls=None, sp=False):
    mask = (torch.arange(k.shape[2], device=q.device)[None, :]
            < lengths.to(torch.int64)[:, None])
    return sliding_window_attention_plain(
        q, k, v, mask, window_size=window_size, block_size=block_size,
        causal=causal, include_cls=include_cls, return_lse=True, q_off=q_off,
        cls=cls)


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
    return band_fwd(q, k_ext, v_ext, ext_len, include_cls=False, q_off=hb,
                    cls=(cls_k, cls_v, cls_len), sp=True, **kw)


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
    K1 (with q_off and the broadcast [CLS] slot on shards past the first)
    for CUDA tensors, its plain version for CPU tensors. q: [B, H, S, D] at
    positions start..; k_ext, v_ext: [B, H, ctx + S, D]; cls_k, cls_v:
    [B, H, block, D]; ext_len: [B] int32 valid extended keys (on shard 0
    the LOCAL prefix: its halo rows are never valid); cls_len: [B] int32
    valid [CLS] keys."""
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
        out, lse = kernel_forward(lambda: sp_fwd(
            q, k_ext, v_ext, cls_k, cls_v, start, ext_len, cls_len,
            window_size, block_size))
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
