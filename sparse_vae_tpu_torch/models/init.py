"""The JAX package's parameter initialisation, for a model built from
hparams without an archive (port of sparse_vae_tpu/models/base.py
`dense_kernel_init` / `embed_init` and each flax module's defaults):

- Dense kernels: N(0, init_scale) for the embedding head, the z
  projections and the posterior's Dense (`hp.init_scale`, 0.02 by
  default); N(0, 0.02) always for attention and FFN projections, which
  the reference fixes at 0.02 (ops/attention.py, models/transformer_layer.py);
- Embed table: N(0, init_scale);
- Dense biases: 0 (flax's default);
- LayerNorm: scale 1, bias 0 (flax's default);
- learned query banks: N(0, 1) (ops/attention.py `learned_queries`);
- the tied output bias: 0 (models/transformer_lm.py `output_bias`).

Draws come from an explicit torch.Generator, in the order of
`model.modules()`. They are not JAX's numbers: the two random streams
never agree, so the tests compare statistics per parameter, not values.
"""
from __future__ import annotations

import torch
import torch.nn as nn

from ..ops.attention import Attention
from .transformer_layer import TransformerLayer

# The reference's fixed scale for attention and FFN projections.
LAYER_INIT_SCALE = 0.02


@torch.no_grad()
def init_parameters(model: nn.Module, generator: torch.Generator,
                    init_scale: float = 0.02) -> nn.Module:
    """Initialise every parameter of `model` in place; returns it. The
    generator must live on the parameters' device."""
    if init_scale is None:
        raise NotImplementedError(
            "init_scale=None (flax's default initialisers) is not ported")
    in_layers = {id(m) for layer in model.modules()
                 if isinstance(layer, TransformerLayer)
                 for m in layer.modules() if isinstance(m, nn.Linear)}
    for module in model.modules():
        if isinstance(module, nn.Linear):
            std = LAYER_INIT_SCALE if id(module) in in_layers else init_scale
            module.weight.normal_(0.0, std, generator=generator)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, nn.Embedding):
            module.weight.normal_(0.0, init_scale, generator=generator)
        elif isinstance(module, nn.LayerNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
        elif isinstance(module, Attention) and module.num_queries:
            module.learned_queries.normal_(0.0, 1.0, generator=generator)
    output_bias = getattr(model, "output_bias", None)
    if output_bias is not None:
        output_bias.zero_()
    return model
