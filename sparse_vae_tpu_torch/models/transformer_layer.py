"""Pre-LN transformer layer (port of sparse_vae_tpu/models/transformer_layer.py,
dense-FFN self-attention layer): self-attention, then a 4x tanh-GELU FFN
whose output projection has no bias. Dropout is not ported (the slice
serves only).
"""
from __future__ import annotations

import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import Attention
from .base import LAYER_NORM_EPS


class TransformerLayer(nn.Module):
    def __init__(self, d_model: int, num_heads: int, causal: bool = False,
                 sparse_self_attention: bool = False, window_size: int = 2,
                 block_size: int = 128):
        super().__init__()
        self.attention = Attention(d_model, num_heads, causal=causal,
                                   sparse=sparse_self_attention,
                                   window_size=window_size,
                                   block_size=block_size)
        self.ffn_in = nn.Linear(d_model, 4 * d_model)
        self.ffn_out = nn.Linear(4 * d_model, d_model, bias=False)
        self.attn_layer_norm = nn.LayerNorm(d_model, eps=LAYER_NORM_EPS)
        self.ffn_layer_norm = nn.LayerNorm(d_model, eps=LAYER_NORM_EPS)

    def _ffn(self, x):
        y = self.ffn_layer_norm(x)
        y = self.ffn_out(F.gelu(self.ffn_in(y), approximate="tanh"))
        return x + y

    def forward(self, x, mask=None, return_kv: bool = False):
        """x: [B, L, D]; mask: [B, L] key-padding mask (True = valid).
        With return_kv also returns the attention's head-major (k, v)."""
        y = self.attention(self.attn_layer_norm(x), kv_mask=mask,
                           return_kv=return_kv)
        if return_kv:
            y, kv = y
            return self._ffn(x + y), kv
        return self._ffn(x + y)

    def decode_rowwise(self, x_t, cache: dict, index):
        """One-token step at PER-ROW positions index [B]."""
        y, cache = self.attention.decode_rowwise(self.attn_layer_norm(x_t),
                                                 cache, index)
        return self._ffn(x_t + y), cache

    def init_cache(self, batch_size: int, max_length: int, device=None,
                   dtype=None) -> dict:
        return self.attention.init_cache(batch_size, max_length, device,
                                         dtype)
