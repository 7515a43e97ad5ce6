"""K4: fused nucleus / Gumbel-max token selection as a CUDA kernel
(csrc/nucleus_select.cu), replacing
sparse_vae_tpu/ops/pallas_select.py::nucleus_gumbel_argmax.

`nucleus_gumbel_argmax` launches the kernel for CUDA tensors and runs the
plain version (`nucleus_gumbel_argmax_plain`, the port of `_select_tile`)
for CPU tensors. The Gumbel noise is an input drawn by the caller from an
explicit torch.Generator (models/generation.py).

The kernel computes each p = exp(s - m) once and replays the bisection's
first 24 steps from three 256-bin histograms of floor(p * 2^(8l + 8)),
l = 0, 1, 2: every mid of those steps is a multiple of 2^-24, so p >= mid
is an integer comparison there and the steps make the bisection's own
decisions (tests/test_torch_select.py replays the scheme on the CPU).
Its masses are fixed-point sums (units of 2^-40), so the same inputs give
bit-identical choices. The select reads the logits and noise of the kept
tokens only. A row is split over a cluster of two CTAs while each CTA
can have an SM of its own (2 N <= SMs, the serving batch) or one CTA
cannot hold the row (V > 2^15); else one CTA of 1024 threads takes a
row.

The kernel and the plain version round the bisection masses differently,
so a row whose kept mass sits within rounding of top_p * z at some
bisection step can keep a slightly different set of tokens
(sparse_vae_tpu/ops/pallas_select.py notes the same for its two paths).
`select_rows_plain` reports each row's smallest margin so that a check can
tell such rows from a real disagreement.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import cuda_lib

# Kernel launches in this process (raised only where the kernel launches).
launches = 0

NUM_ITERS = 24


def select_rows_plain(s, noise=None, *, top_p: float = 0.9,
                      temperature: float = 1.0, num_iters: int = NUM_ITERS):
    """The selection math on [N, V] fp32 logits, with diagnostics.

    Returns (choice [N] int64, threshold [N] fp32, margin [N] fp32) where
    threshold is the bisection's final lo on the unnormalised exp(s - m)
    (0 without a nucleus) and margin the smallest |mass - target| / target
    over the bisection steps (inf without a nucleus).
    """
    s = s.to(torch.float32)
    if temperature != 1.0 and temperature > 0.0:
        s = s / temperature
    n, v = s.shape
    keep = None
    lo = torch.zeros(n, dtype=torch.float32, device=s.device)
    margin = torch.full((n,), float("inf"), device=s.device)
    if 0.0 < top_p < 1.0:
        m = s.amax(dim=-1, keepdim=True)
        p_un = torch.exp(s - m)
        target = top_p * p_un.sum(dim=-1, keepdim=True)
        pmax = p_un.amax(dim=-1, keepdim=True)
        lo, hi = torch.zeros_like(pmax), pmax
        for _ in range(num_iters):
            mid = (lo + hi) * 0.5
            mass = torch.where(p_un >= mid, p_un, 0.0).sum(dim=-1,
                                                           keepdim=True)
            margin = torch.minimum(
                margin, ((mass - target).abs() / target)[:, 0])
            raise_ = mass >= target
            lo = torch.where(raise_, mid, lo)
            hi = torch.where(raise_, hi, mid)
        keep = (p_un >= lo) | (p_un == pmax)
        lo = lo[:, 0]
    val = s if noise is None else s + noise.to(torch.float32)
    if keep is not None:
        val = val.masked_fill(~keep, float("-inf"))
    # First-tie argmax: the max, then the smallest index attaining it.
    row_max = val.amax(dim=-1, keepdim=True)
    idx = torch.arange(v, device=s.device).expand(n, v)
    choice = torch.where(val == row_max, idx, v).amin(dim=-1)
    return choice, lo, margin


def nucleus_gumbel_argmax_plain(s, noise=None, *, top_p: float = 0.9,
                                temperature: float = 1.0,
                                num_iters: int = NUM_ITERS):
    """Port of pallas_select._select_tile: [N, V] -> chosen [N] int64."""
    return select_rows_plain(s, noise, top_p=top_p, temperature=temperature,
                             num_iters=num_iters)[0]


def nucleus_gumbel_argmax(s, noise: Optional[torch.Tensor] = None, *,
                          top_p: float = 0.9, temperature: float = 1.0,
                          num_iters: int = NUM_ITERS):
    """Temperature, nucleus filter and Gumbel-max over [N, V] logits.

    s: [N, V] already-penalised logits; noise: optional [N, V] Gumbel
    noise (None: the argmax of the filtered logits). Returns [N] int64.
    CUDA: fp32, contiguous, 16-byte aligned, V % 4 == 0 and V * 4 bytes
    within one CTA's shared memory.
    """
    global launches
    if s.ndim != 2:
        raise ValueError(f"logits must be [N, V], got {tuple(s.shape)}")
    if noise is not None and (noise.shape != s.shape
                              or noise.device != s.device):
        raise ValueError("noise must match the logits' shape and device")
    if not s.is_cuda:
        return nucleus_gumbel_argmax_plain(s, noise, top_p=top_p,
                                           temperature=temperature,
                                           num_iters=num_iters)
    tensors = (s,) if noise is None else (s, noise)
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError("the K4 kernel takes fp32 logits and noise")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the K4 kernel takes contiguous inputs")
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("the K4 kernel reads 16-byte aligned rows")
    n, v = s.shape
    if v % 4 or v * 4 > 227 * 1024 - 512:
        raise ValueError(f"the K4 kernel takes V % 4 == 0 and "
                         f"V <= {(227 * 1024 - 512) // 4}, got {v}")
    out = torch.empty(n, dtype=torch.int64, device=s.device)
    lib = cuda_lib.library()
    stream = torch.cuda.current_stream(s.device).cuda_stream
    code = lib.svt_nucleus_select(
        s.data_ptr(), None if noise is None else noise.data_ptr(),
        out.data_ptr(), n, v, float(top_p), float(temperature),
        num_iters, stream)
    cuda_lib.check(code, "nucleus_select")
    launches += 1
    return out
