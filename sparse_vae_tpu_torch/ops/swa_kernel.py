"""K1 and K2: the sliding-window attention forward and backward as CUDA
kernels (csrc/swa_fwd.cu, csrc/swa_bwd.cu), replacing
sparse_vae_tpu/ops/pallas_kernels.py::_sliding_window_attention_fwd_pallas
and ::_bwd_pallas.

`swa_fwd` and `swa_bwd` launch their kernels for CUDA tensors and run the
plain versions (`sliding_window_attention_plain`,
`sliding_window_attention_bwd_plain`) for CPU tensors. There is no other
fallback: a CUDA tensor a kernel does not take raises.
"""
from __future__ import annotations

import torch

from . import cuda_lib
from .sliding_window_attention import (sliding_window_attention_bwd_plain,
                                       sliding_window_attention_plain)

# Kernel launches in this process (raised only where a kernel launches):
# K1 in `launches`, K2 in `bwd_launches`.
launches = 0
bwd_launches = 0

BLOCK_SIZE = 128
HEAD_DIM = 64


def _check(q, k, v, lengths, block_size: int, window_size: int):
    if q.ndim != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v must share one [B, H, L, D] shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, _, L, _ = q.shape
    if L % block_size:
        raise ValueError(f"length {L} is not a multiple of {block_size}")
    if window_size < 1:
        raise ValueError(f"window_size must be >= 1, got {window_size}")
    if lengths.shape != (b,):
        raise ValueError(f"lengths must be [{b}], got {tuple(lengths.shape)}")
    devices = {t.device for t in (q, k, v, lengths)}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {devices}")


def _check_cuda(kernel: str, tensors, lengths, head_dim: int,
                block_size: int):
    if any(t.dtype != torch.bfloat16 for t in tensors):
        raise TypeError(f"the {kernel} kernel takes bf16 tensors")
    if lengths.dtype != torch.int32:
        raise TypeError("lengths must be int32")
    if head_dim != HEAD_DIM or block_size != BLOCK_SIZE:
        raise ValueError(f"the {kernel} kernel takes head_dim {HEAD_DIM} "
                         f"and block_size {BLOCK_SIZE}, got {head_dim} and "
                         f"{block_size}")
    if not all(t.is_contiguous() for t in (*tensors, lengths)):
        raise ValueError(f"the {kernel} kernel takes contiguous inputs")


def swa_fwd(q, k, v, lengths, *, window_size: int = 2,
            block_size: int = 128, causal: bool = True,
            include_cls: bool = True):
    """Sliding-window + [CLS] attention forward.

    q/k/v: [B, H, L, D]; lengths: [B] int32 valid key prefix per row.
    Returns (out [B, H, L, D] in q's dtype, lse [B, H, L] fp32).
    CUDA: bf16, D = 64, block_size = 128, contiguous.
    """
    global launches
    _check(q, k, v, lengths, block_size, window_size)
    if not q.is_cuda:
        L = q.shape[2]
        mask = (torch.arange(L, device=q.device)[None, :]
                < lengths.to(torch.int64)[:, None])
        return sliding_window_attention_plain(
            q, k, v, mask, window_size=window_size, block_size=block_size,
            causal=causal, include_cls=include_cls, return_lse=True)

    _check_cuda("K1", (q, k, v), lengths, q.shape[3], block_size)
    b, h, L, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, L), dtype=torch.float32, device=q.device)
    lib = cuda_lib.library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = lib.svt_swa_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           lengths.data_ptr(), out.data_ptr(),
                           lse.data_ptr(), b, h, L, d, block_size,
                           window_size, int(causal), int(include_cls),
                           d ** -0.5, stream)
    cuda_lib.check(code, "swa_fwd")
    launches += 1
    return out, lse


def swa_bwd(q, k, v, lengths, lse, out, do, *, window_size: int = 2,
            block_size: int = 128, causal: bool = True,
            include_cls: bool = True):
    """Sliding-window + [CLS] attention backward.

    q/k/v/out/do: [B, H, L, D]; lengths: [B] int32; lse: [B, H, L] fp32
    from `swa_fwd` (-inf for a row with no valid key). Returns (dq, dk, dv)
    in q's dtype. CUDA: bf16, D = 64, block_size = 128, contiguous.
    """
    global bwd_launches
    _check(q, k, v, lengths, block_size, window_size)
    if out.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"out/do must be {tuple(q.shape)}, got "
                         f"{tuple(out.shape)}, {tuple(do.shape)}")
    if lse.shape != q.shape[:3]:
        raise ValueError(f"lse must be {tuple(q.shape[:3])}, got "
                         f"{tuple(lse.shape)}")
    if len({t.device for t in (q, out, do, lse)}) != 1:
        raise ValueError("inputs on several devices")
    if not q.is_cuda:
        return sliding_window_attention_bwd_plain(
            q, k, v, lengths, lse, out, do, window_size=window_size,
            block_size=block_size, causal=causal, include_cls=include_cls)

    _check_cuda("K2", (q, k, v, out, do), lengths, q.shape[3], block_size)
    if lse.dtype != torch.float32 or not lse.is_contiguous():
        raise TypeError("the K2 kernel takes a contiguous fp32 lse")
    b, h, L, d = q.shape
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    delta = torch.empty((b, h, L), dtype=torch.float32, device=q.device)
    chunks = cls_chunks(L // block_size, window_size, causal, include_cls)
    # fp32 scratch for the [CLS] column's split reduction: the band part
    # of key block 0, then one partial per chunk of query blocks.
    scratch = torch.empty((2, b, h, 1 + chunks, block_size, d),
                          dtype=torch.float32, device=q.device)
    lib = cuda_lib.library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = lib.svt_swa_bwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           lengths.data_ptr(), lse.data_ptr(),
                           out.data_ptr(), do.data_ptr(), dq.data_ptr(),
                           dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
                           scratch.data_ptr(), b, h, L, d, block_size,
                           window_size, int(causal), int(include_cls),
                           CLS_CHUNK, d ** -0.5, stream)
    cuda_lib.check(code, "swa_bwd")
    bwd_launches += 1
    return dq, dk, dv


# Query blocks per CTA in K2's [CLS]-column pass.
CLS_CHUNK = 8


def cls_chunks(num_blocks: int, window_size: int, causal: bool,
               include_cls: bool) -> int:
    """Chunks of query blocks that reach key block 0 only through the [CLS]
    slot (blocks at or past the band's left extent)."""
    left = window_size if causal else (window_size + 1) // 2
    if not include_cls or num_blocks <= left:
        return 0
    return -(-(num_blocks - left) // CLS_CHUNK)
