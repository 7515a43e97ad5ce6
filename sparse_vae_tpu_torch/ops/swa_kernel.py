"""K1: the sliding-window attention forward as a CUDA kernel
(csrc/swa_fwd.cu), replacing
sparse_vae_tpu/ops/pallas_kernels.py::_sliding_window_attention_fwd_pallas.

`swa_fwd` launches the kernel for CUDA tensors and runs the plain version
(`sliding_window_attention_plain`) for CPU tensors. There is no other
fallback: a CUDA tensor the kernel does not take raises.
"""
from __future__ import annotations

import torch

from . import cuda_lib
from .sliding_window_attention import sliding_window_attention_plain

# Kernel launches in this process (raised only where the kernel launches).
launches = 0

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

    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise TypeError("the K1 kernel takes bf16 q/k/v")
    if lengths.dtype != torch.int32:
        raise TypeError("lengths must be int32")
    if q.shape[3] != HEAD_DIM or block_size != BLOCK_SIZE:
        raise ValueError(f"the K1 kernel takes head_dim {HEAD_DIM} and "
                         f"block_size {BLOCK_SIZE}, got {q.shape[3]} and "
                         f"{block_size}")
    if not all(t.is_contiguous() for t in (q, k, v, lengths)):
        raise ValueError("the K1 kernel takes contiguous inputs")
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
