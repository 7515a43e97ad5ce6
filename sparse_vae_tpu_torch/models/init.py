"""The JAX package's parameter initialisation, for a model built from
hparams without an archive (port of sparse_vae_tpu/models/base.py
`dense_kernel_init` / `embed_init` and each flax module's defaults):

- Dense kernels: N(0, init_scale) for the model's own projections (the
  embedding head, the Transformer LM's factorised `embedding_projection`
  and untied `output_embedding`, the z projections, the LSTM families'
  logit bottleneck or output layer and z_to_hidden) and the posterior's
  Dense, or flax's
  `lecun_normal` where init_scale is None: a normal truncated at two
  standard deviations, scaled so that its standard deviation is
  1 / sqrt(fan_in), fan_in the kernel's input width. N(0, 0.02) always for
  attention and FFN projections, which the reference fixes at 0.02
  (ops/attention.py, models/transformer_layer.py). The posterior's scale
  is its ConditionalGaussian's `init_scale` where it has one (the
  LSTM-VAE's `init_scale or 0.02`);
- Embed tables (the input table, the cross-attention's
  `context_embedding`, the generic Transformer's `embedding`): N(0,
  init_scale), N(0, 1) where init_scale is None;
- RNN matrices (ops/rnn.py, `w_ih_{l}` and `w_hh_{l}` [gates * H, in]):
  `lecun_normal` whatever init_scale is, and over flax's fan_in, the
  array's axis -2: gates * H, not the input width; RNN biases 0;
- the learned initial states `c0` and `encoder_c0`: N(0, 1);
- Dense biases: 0 (flax's default);
- LayerNorm: scale 1, bias 0 (flax's default);
- learned query banks: N(0, 1) (ops/attention.py `learned_queries`);
- mixture-of-experts FFNs (models/moe.py): the router (a Dense of the
  layer) and the expert stacks `w_in`, `w_out` N(0, 0.02), `b_in` 0;
- the tied output biases `output_bias` and `logit_bias`: 0.

Draws come from an explicit torch.Generator, in the order of
`model.modules()`. They are not JAX's numbers: the two random streams
never agree, so the tests compare statistics per parameter, not values.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn

from ..ops.attention import Attention
from ..ops.rnn import StackedRNN
from .conditional_gaussian import ConditionalGaussian
from .moe import MoEFFN
from .transformer_layer import TransformerLayer

# The reference's fixed scale for attention and FFN projections.
LAYER_INIT_SCALE = 0.02
# flax's truncated_normal variance correction: the standard deviation of
# a standard normal truncated to [-2, 2].
TRUNCATED_STD = 0.87962566103423978


def lecun_normal_(tensor: torch.Tensor, fan_in: int,
                  generator: torch.Generator) -> torch.Tensor:
    """flax.linen.initializers.lecun_normal: a normal truncated at +-2
    standard deviations, whose standard deviation is 1 / sqrt(fan_in)."""
    std = math.sqrt(1.0 / fan_in) / TRUNCATED_STD
    return nn.init.trunc_normal_(tensor, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)


@torch.no_grad()
def init_parameters(model: nn.Module, generator: torch.Generator,
                    init_scale: Optional[float] = 0.02) -> nn.Module:
    """Initialise every parameter of `model` in place; returns it. The
    generator must live on the parameters' device."""
    fixed = {}
    for layer in model.modules():
        if isinstance(layer, TransformerLayer):
            fixed.update({id(m): LAYER_INIT_SCALE for m in layer.modules()
                          if isinstance(m, nn.Linear)})
        elif (isinstance(layer, ConditionalGaussian)
              and layer.init_scale is not None):
            fixed[id(layer.linear)] = layer.init_scale
    for module in model.modules():
        if isinstance(module, nn.Linear):
            std = fixed.get(id(module), init_scale)
            if std is None:
                lecun_normal_(module.weight, module.in_features, generator)
            else:
                module.weight.normal_(0.0, std, generator=generator)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, nn.Embedding):
            module.weight.normal_(
                0.0, 1.0 if init_scale is None else init_scale,
                generator=generator)
        elif isinstance(module, nn.LayerNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
        elif isinstance(module, MoEFFN):
            for stack in (module.w_in, module.w_out):
                stack.normal_(0.0, LAYER_INIT_SCALE, generator=generator)
            module.b_in.zero_()
        elif isinstance(module, Attention) and module.num_queries:
            module.learned_queries.normal_(0.0, 1.0, generator=generator)
        elif isinstance(module, StackedRNN):
            for name, p in module.named_parameters(recurse=False):
                if name.startswith("w_"):
                    lecun_normal_(p, p.shape[0], generator)
                else:
                    p.zero_()
    for name in ("c0", "encoder_c0"):
        state = getattr(model, name, None)
        if state is not None:
            state.normal_(0.0, 1.0, generator=generator)
    for name in ("output_bias", "logit_bias"):
        bias = getattr(model, name, None)
        if bias is not None:
            bias.zero_()
    return model
