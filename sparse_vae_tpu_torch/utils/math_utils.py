"""The mutual-information diagnostic's marginal KL (port of
sparse_vae_tpu/utils/math_utils.py::marginal_kl), with its noise passed
in."""
from __future__ import annotations

import math

import torch

from .distributions import DiagonalGaussian

_LOG_2PI = math.log(2.0 * math.pi)


def marginal_kl(posterior: DiagonalGaussian, noise: torch.Tensor):
    """Monte-Carlo KL(q(z) || N(0, I)) of the aggregate posterior q(z), the
    mixture of the batch's B posteriors.

    noise: [S, B, D] standard normal draws; sample s of posterior b is
    loc_b + scale_b * noise[s, b]. Each sample is scored under every
    posterior to estimate log q(z). Returns the positive KL, so that
    mutual information = kl - marginal_kl (the JAX package's sign).
    """
    loc = posterior.loc.reshape(posterior.loc.shape[0], -1)
    scale = posterior.scale.reshape(loc.shape)
    flat = DiagonalGaussian(loc, scale)
    samples = flat.sample(noise.reshape(noise.shape[0], *loc.shape))
    cross = flat.log_prob(samples[:, :, None, :]).sum(-1)      # [S, B, B]
    log_marginal = torch.logsumexp(cross, dim=2) - math.log(loc.shape[0])
    d = loc.shape[-1]
    log_prior = -0.5 * (samples.square().sum(-1).mean() + d * _LOG_2PI)
    return log_marginal.mean() - log_prior
