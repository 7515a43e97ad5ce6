"""Decoder-only causal transformer language model: the pieces the VAE's
serving path shares (port of sparse_vae_tpu/models/transformer_lm.py:
`embed`, `pre_logits`, the tied `project` and `init_caches`).

Ported configurations: tied input/output embedding with
d_embedding == d_model, dense FFNs, no cross-attention, one device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .base import LAYER_NORM_EPS, LanguageModelHparams
from .transformer_layer import TransformerLayer


@dataclass
class TransformerHparams(LanguageModelHparams):
    d_embedding: Optional[int] = None   # None => d_model
    d_model: int = 512
    num_heads: int = 8
    num_layers: int = 6
    tie_embedding_weights: bool = True
    cross_attention: bool = False
    attn_window_size: int = 2           # in attn_block_size blocks
    attn_block_size: int = 128
    sparse_self_attention: bool = True
    precision: str = "fp32"
    tp_size: int = 1
    sp_size: int = 1
    num_experts: int = 0

    def check_ported(self):
        """Raise for a configuration this port does not run yet."""
        unported = {
            "d_embedding != d_model": self.d_embedding not in (
                None, self.d_model),
            "untied output embedding": not self.tie_embedding_weights,
            "cross_attention": self.cross_attention,
            "tensor parallelism": self.tp_size > 1,
            "sequence parallelism": self.sp_size > 1,
            "mixture-of-experts FFNs": self.num_experts > 1,
        }
        bad = [name for name, on in unported.items() if on]
        if bad:
            raise NotImplementedError(f"not ported yet: {', '.join(bad)}")


class TransformerLanguageModel(nn.Module):
    def __init__(self, hparams: TransformerHparams):
        super().__init__()
        hparams.check_ported()
        hp = self.hparams = hparams
        self.input_embedding = nn.Embedding(hp.vocab_size, hp.d_model)
        self.decoder_layers = nn.ModuleList([
            TransformerLayer(hp.d_model, hp.num_heads, causal=True,
                             sparse_self_attention=hp.sparse_self_attention,
                             window_size=hp.attn_window_size,
                             block_size=hp.attn_block_size)
            for _ in range(hp.num_layers)])
        self.head_dense = nn.Linear(hp.d_model, hp.d_model)
        self.head_norm = nn.LayerNorm(hp.d_model, eps=LAYER_NORM_EPS)
        self.output_bias = nn.Parameter(torch.zeros(hp.vocab_size))

    @property
    def dtype(self) -> torch.dtype:
        return self.input_embedding.weight.dtype

    @property
    def device(self) -> torch.device:
        return self.input_embedding.weight.device

    def embed(self, token_ids):
        return self.input_embedding(token_ids)

    def pre_logits(self, h):
        """The head before the vocab projection: Dense -> GELU -> LN."""
        return self.head_norm(F.gelu(self.head_dense(h), approximate="tanh"))

    def project(self, h):
        """Head + tied output projection, [..., D] -> fp32 [..., V]. The
        product rounds to the compute dtype before the fp32 bias is added,
        as the reference's bf16 dot plus fp32 bias does."""
        logits = F.linear(self.pre_logits(h), self.input_embedding.weight)
        return logits.float() + self.output_bias.float()

    def init_caches(self, batch_size: int, max_length: int) -> list:
        return [layer.init_cache(batch_size, max_length, self.device,
                                 self.dtype)
                for layer in self.decoder_layers]
