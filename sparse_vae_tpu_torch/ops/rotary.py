"""Rotary position embedding (port of sparse_vae_tpu/ops/rotary.py).

Interleaved-pair rotation with theta_d = max_pos^(-d / (D/2)), applied per
head, with a scalar position offset or a per-row [B] offset.
"""
from __future__ import annotations

import torch


def rotary_angles(length: int, dim_half: int, max_pos: float, offset=0,
                  device=None) -> torch.Tensor:
    """[length, dim_half] fp32 rotation angles for positions
    offset..offset+length-1."""
    freqs = torch.arange(dim_half, dtype=torch.float32, device=device)
    theta = max_pos ** (-freqs / dim_half)
    positions = torch.arange(length, dtype=torch.float32,
                             device=device) + offset
    return positions[:, None] * theta[None, :]


def apply_rotary(x: torch.Tensor, max_pos: float = 10_000.0,
                 offset=0) -> torch.Tensor:
    """Rotate interleaved pairs of the last axis of x [..., L, D].

    For pair (x0, x1): (x0 cos - x1 sin, x1 cos + x0 sin). offset is a
    Python int (the whole batch at one position) or a [B] tensor of per-row
    positions, with x of shape [B, H, L, D]. Angles are fp32; cos and sin
    are cast to x's dtype before the products, as in the reference.
    """
    d_half = x.shape[-1] // 2
    if isinstance(offset, torch.Tensor) and offset.ndim == 1:
        if x.ndim != 4:
            raise ValueError("per-row offsets need [B, H, L, D] inputs")
        freqs = torch.arange(d_half, dtype=torch.float32, device=x.device)
        theta = max_pos ** (-freqs / d_half)
        positions = (torch.arange(x.shape[-2], dtype=torch.float32,
                                  device=x.device)[None, :]
                     + offset[:, None].to(torch.float32))      # [B, L]
        angles = (positions[..., None] * theta)[:, None]       # [B,1,L,half]
    else:
        angles = rotary_angles(x.shape[-2], d_half, max_pos, offset,
                               x.device)
    cos = torch.cos(angles).to(x.dtype)
    sin = torch.sin(angles).to(x.dtype)
    pairs = x.reshape(*x.shape[:-1], d_half, 2)
    x0, x1 = pairs[..., 0], pairs[..., 1]
    out0 = x0 * cos - x1 * sin
    out1 = x1 * cos + x0 * sin
    return torch.stack([out0, out1], dim=-1).reshape(x.shape)
