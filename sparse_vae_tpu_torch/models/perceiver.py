"""Perceiver encoder: a variable-length sequence -> a fixed set of latents
(port of sparse_vae_tpu/models/perceiver.py).

The first layer's learned-query bank attends over the input; the middle
layers self-attend over the latents and cross-attend back to the input;
the bottleneck layer's bank compresses to `bottleneck_width` vectors.
num_heads = d_model // 64. No layer is causal or sparse: every attention
here is the dense masked path.

Sequence parallelism (`bind_seq_group`, parallel/sp.py): the input is
sharded over the group and the latent set is the same on every rank. The
first (learned-query) layer and the middle layers' cross-attention read
the sharded document through the distributed softmax; the latent
self-attention and the bottleneck run replicated on every rank.

Tensor parallelism (tp_size > 1, `bind_model_group`): every layer holds a
shard of the heads and of the FFN, as the decoder's do.
"""
from __future__ import annotations

from typing import Optional

import torch.nn as nn

from .transformer_layer import TransformerLayer


class Perceiver(nn.Module):
    def __init__(self, num_layers: int, num_latents: int, d_model: int,
                 bottleneck_width: Optional[int] = None, tp_size: int = 1):
        super().__init__()
        if num_layers < 2:
            raise ValueError("the Perceiver needs at least two layers")
        num_heads = max(1, d_model // 64)
        self.first_layer = TransformerLayer(d_model, num_heads,
                                            learned_queries=num_latents,
                                            tp_size=tp_size)
        middle = num_layers - 1
        self.bottleneck = None
        if bottleneck_width:
            self.bottleneck = TransformerLayer(
                d_model, num_heads, learned_queries=bottleneck_width,
                tp_size=tp_size)
            middle -= 1
        self.middle_layers = nn.ModuleList([
            TransformerLayer(d_model, num_heads, use_cross_attention=True,
                             sp_cross_only=True, tp_size=tp_size)
            for _ in range(max(middle, 0))])

    def layers(self) -> list:
        return [self.first_layer, *self.middle_layers,
                *([self.bottleneck] if self.bottleneck is not None else [])]

    def bind_model_group(self, group):
        """Bind every layer's f/g collectives to the `model` group (tensor
        parallelism: tp_size > 1; the learned-query banks are sharded on
        their last dim)."""
        for layer in self.layers():
            layer.bind_model_group(group)

    def bind_seq_group(self, group):
        """Bind the layers that read the sharded input to `group`."""
        self.first_layer.bind_seq_group(group)
        for layer in self.middle_layers:
            layer.bind_seq_group(group)

    def forward(self, x, mask=None):
        """x: [B, L, D], mask: [B, L] (True = valid). Returns
        [B, bottleneck_width or num_latents, D]."""
        z = self.first_layer(x, mask)
        for layer in self.middle_layers:
            z = layer(z, context=x, context_mask=mask)
        if self.bottleneck is not None:
            z = self.bottleneck(z)
        return z
