"""Gaussian posterior head (port of
sparse_vae_tpu/models/conditional_gaussian.py): one Linear producing
(mu, logvar), a DiagonalGaussian and the analytic standard-normal KL.

The head has no compute dtype in the reference, so flax promotes its bf16
input to its fp32 parameters: it computes in fp32 even in a bf16 model,
and so does this port. `init_scale` is the scale of the Dense's
initialisation (models/init.py) where the model fixes one (the
LSTM-VAE's `init_scale or 0.02`); None follows the model's.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ..utils.distributions import gaussian_from_params, standard_normal_kl
from .base import Linear


class ConditionalGaussian(nn.Module):
    def __init__(self, out_features: int, in_features: int,
                 init_scale: Optional[float] = None):
        super().__init__()
        self.init_scale = init_scale
        self.linear = Linear(in_features, 2 * out_features)

    def forward(self, x, get_kl: bool = False):
        params = self.linear(x.float())
        mu, logvar = params.chunk(2, dim=-1)
        gaussian = gaussian_from_params(mu, logvar)
        if get_kl:
            return gaussian, standard_normal_kl(mu, logvar)
        return gaussian
