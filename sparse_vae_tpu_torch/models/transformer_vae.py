"""The flagship Transformer-VAE's decoder (port of
sparse_vae_tpu/models/transformer_vae.py: the per-layer z projections,
`reconstruct_hidden` and `decode_step_z_rowwise`).

z replaces position 0 ([CLS]) of every decoder layer's input. The Perceiver
encoder and the posterior are not ported yet: the slice serves with z
drawn from the prior or passed in.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn as nn

from .transformer_lm import TransformerHparams, TransformerLanguageModel


@dataclass
class TransformerVAEHparams(TransformerHparams):
    latent_depth: int = 64


def z_projection_module(hp: TransformerVAEHparams) -> nn.Linear:
    """One per-layer z-injection projection."""
    return nn.Linear(hp.latent_depth, hp.d_model)


class TransformerVAE(TransformerLanguageModel):
    def __init__(self, hparams: TransformerVAEHparams):
        super().__init__(hparams)
        self.z_projections = nn.ModuleList([
            z_projection_module(hparams) for _ in range(hparams.num_layers)])

    def reconstruct_hidden(self, token_ids, z, return_kv: bool = False):
        """Decoder stack with z injected at position 0 of every layer.
        token_ids: [B, L] (0 = pad); z: [B, 1, latent_depth]. Returns the
        pre-head hidden [B, L, D]; with return_kv also each layer's
        head-major rotary (k, v), the bulk-prefill cache seed."""
        x = self.embed(token_ids)
        mask = token_ids != 0
        kvs = []
        for proj, layer in zip(self.z_projections, self.decoder_layers):
            z_hidden = proj(z.to(x.dtype)).expand(x.shape[0], 1, x.shape[-1])
            x = torch.cat([z_hidden, x[:, 1:]], dim=1)
            if return_kv:
                x, kv = layer(x, mask, return_kv=True)
                kvs.append(kv)
            else:
                x = layer(x, mask)
        return (x, kvs) if return_kv else x

    def reconstruct(self, token_ids, z):
        return self.project(self.reconstruct_hidden(token_ids, z))

    def decode_step_z_rowwise(self, token, caches: list, index, z):
        """One decode step at PER-ROW positions index [B]: rows at position
        0 take their z projection as the layer input. token: [B];
        z: [B, 1, latent_depth]. Returns (fp32 logits [B, V], caches)."""
        x = self.embed(token[:, None])
        first = (index == 0)[:, None, None]
        new_caches = []
        for proj, layer, cache in zip(self.z_projections,
                                      self.decoder_layers, caches):
            zh = proj(z.to(x.dtype)).expand(x.shape[0], 1, x.shape[-1])
            x = torch.where(first, zh, x)
            x, cache = layer.decode_rowwise(x, cache, index)
            new_caches.append(cache)
        return self.project(x[:, 0]), new_caches
