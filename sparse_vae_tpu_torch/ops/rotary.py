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
                 offset=0, seq_dim: int = -2) -> torch.Tensor:
    """Rotate interleaved pairs of the last axis of x, with the positions
    along `seq_dim`: -2 for head-major [..., L, D] (the reference's split
    heads), -3 for a [B, L, H, D] view of the packed projections.

    For pair (x0, x1): (x0 cos - x1 sin, x1 cos + x0 sin). offset is a
    Python int (the whole batch at one position) or a [B] tensor of per-row
    positions, with x of 4 dims. Angles are fp32; cos and sin are cast to
    x's dtype before the products, as in the reference.
    """
    if seq_dim not in (-2, -3):
        raise ValueError(f"seq_dim must be -2 or -3, got {seq_dim}")
    d_half = x.shape[-1] // 2
    length = x.shape[seq_dim]
    if isinstance(offset, torch.Tensor) and offset.ndim == 1:
        if x.ndim != 4:
            raise ValueError("per-row offsets need 4-dim inputs")
        freqs = torch.arange(d_half, dtype=torch.float32, device=x.device)
        theta = max_pos ** (-freqs / d_half)
        positions = (torch.arange(length, dtype=torch.float32,
                                  device=x.device)[None, :]
                     + offset[:, None].to(torch.float32))      # [B, L]
        angles = positions[..., None] * theta                  # [B,L,half]
        angles = angles[:, None] if seq_dim == -2 else angles[:, :, None]
    else:
        angles = rotary_angles(length, d_half, max_pos, offset, x.device)
        if seq_dim == -3:
            angles = angles[:, None]
    cos = torch.cos(angles).to(x.dtype)
    sin = torch.sin(angles).to(x.dtype)
    pairs = x.reshape(*x.shape[:-1], d_half, 2)
    x0, x1 = pairs[..., 0], pairs[..., 1]
    out0 = x0 * cos - x1 * sin
    out1 = x1 * cos + x0 * sin
    return torch.stack([out0, out1], dim=-1).reshape(x.shape)
