"""The generic transformer stack: embedding -> N layers -> tied logits
(port of sparse_vae_tpu/models/transformer.py, the reference's reusable
building block; the concrete models use the Transformer LM instead).

Sparse layers take the sliding-window attention (K1, and K2 in a
backward, where the JAX package's kernel gate admits the shape); dense
causal layers take the flash-attention gate's route (ops/attention.py
`_dense_route`: the dense causal pair at Dh 64 and 128, the generic pair
at the other widths). The logits are a plain product
with the embedding table, as JAX's `x @ table.T` outside any kernel.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from .transformer_layer import TransformerLayer


class Transformer(nn.Module):
    def __init__(self, vocab_size: int, d_model: int, num_heads: int,
                 num_layers: int, causal: bool = True,
                 sparse_self_attention: bool = False, window_size: int = 2,
                 block_size: int = 128, use_pallas_kernel: bool = True):
        super().__init__()
        self.vocab_size, self.d_model = vocab_size, d_model
        self.embedding = nn.Embedding(vocab_size, d_model)
        self.decoder_layers = nn.ModuleList([
            TransformerLayer(d_model, num_heads, causal=causal,
                             sparse_self_attention=sparse_self_attention,
                             window_size=window_size, block_size=block_size,
                             use_kernel=use_pallas_kernel)
            for _ in range(num_layers)])
        # None: compute in the parameters' dtype (models/base.py).
        self.compute_dtype: Optional[torch.dtype] = None

    @property
    def dtype(self) -> torch.dtype:
        return self.compute_dtype or self.embedding.weight.dtype

    def forward(self, token_ids, mask: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        """token_ids [B, L] -> logits [B, L, V] in the compute dtype through
        the tied embedding. mask: [B, L] key mask (True = a real token),
        default token_ids != 0; deterministic False applies each layer's
        FFN dropout, its masks drawn from `generator`."""
        if mask is None:
            mask = token_ids != 0
        x = self.embedding(token_ids).to(self.dtype)
        for layer in self.decoder_layers:
            x = layer(x, mask, deterministic=deterministic,
                      generator=generator)
        return torch.matmul(x, self.embedding.weight.to(self.dtype).t())
