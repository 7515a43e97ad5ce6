"""Diagonal Gaussian (port of sparse_vae_tpu/utils/distributions.py), the
standard normal's log density and the analytic KL to it.

Sampling takes its noise explicitly — an `eps` tensor or a
torch.Generator — because the JAX and torch random streams never agree:
a test draws eps once with numpy and hands it to both packages.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


class DiagonalGaussian(NamedTuple):
    loc: torch.Tensor
    scale: torch.Tensor

    @property
    def variance(self):
        return self.scale.square()

    def sample(self, eps: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None):
        """Reparameterized sample loc + scale * eps, with eps (broadcast
        against loc) given or drawn standard normal from `generator`."""
        if eps is None:
            eps = torch.randn(self.loc.shape, generator=generator,
                              dtype=self.loc.dtype, device=self.loc.device)
        return self.loc + self.scale * eps.to(self.loc.dtype)

    def log_prob(self, x):
        """Elementwise log N(x; loc, scale^2)."""
        z = (x - self.loc) / self.scale
        return -0.5 * z.square() - torch.log(self.scale) - _LOG_SQRT_2PI


def gaussian_from_params(mu, logvar) -> DiagonalGaussian:
    """(mu, logvar) -> DiagonalGaussian with scale = exp(logvar / 2).
    Nothing is clamped, as in the reference: a degenerate scale gives an
    inf KL and a non-finite loss the trainer can see."""
    return DiagonalGaussian(loc=mu, scale=torch.exp(0.5 * logvar))


def standard_normal_log_prob(z):
    """log N(z; 0, I) summed over the last axis."""
    d = z.shape[-1]
    return -0.5 * z.square().sum(-1) - _LOG_SQRT_2PI * d


def standard_normal_kl(mu, logvar):
    """Elementwise KL(N(mu, var) || N(0, 1)) = 0.5 (mu^2 + var - logvar
    - 1)."""
    return 0.5 * (mu.square() + torch.exp(logvar) - logvar - 1.0)
