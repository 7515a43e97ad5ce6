"""Distribution math and text metrics (port of
sparse_vae_tpu/utils/math_utils.py): the Monte-Carlo marginal KL of the
mutual-information diagnostic, the Gaussian entropy, pairwise KL and
cross-entropy matrices, the RBF and IMQ MMD statistics against a Gaussian,
and reconstruction and corpus BLEU (pure Python, this package's own copy).

Random draws are passed in, or drawn from a torch.Generator: the JAX and
torch random streams never agree, so a test hands both packages the same
draws.
"""
from __future__ import annotations

import math
from collections import Counter
from typing import Optional, Sequence

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


def multivariate_gaussian_entropy(g: DiagonalGaussian):
    """H(g) reduced over the last axis."""
    d = g.scale.shape[-1]
    return torch.log(g.scale).sum(-1) + 0.5 * (_LOG_2PI + 1.0) * d


def _flat(g: DiagonalGaussian):
    """(mu, var, sum of log sigma) of a batch of Gaussians as [N, D],
    [N, D], [N]."""
    var = g.variance.reshape(g.loc.shape[0], -1)
    return (g.loc.reshape(var.shape), var,
            torch.log(g.scale.reshape(var.shape)).sum(-1))


def _quad(mu_p, mu_q, inv_var_q):
    """[N, M]: sum_d (mu_p[i] - mu_q[j])^2 / var_q[j], expanded."""
    return (mu_p.square() @ inv_var_q.T
            - 2.0 * mu_p @ (mu_q * inv_var_q).T
            + (mu_q.square() * inv_var_q).sum(-1)[None, :])


def pairwise_gaussian_kl(g: DiagonalGaussian):
    """[B, B] matrix of KL(g_i || g_j) for a batch of diagonal
    Gaussians."""
    mu, var, log_sigma = _flat(g)
    inv_var = 1.0 / var
    log_sigma_ratio = log_sigma[None, :] - log_sigma[:, None]
    return log_sigma_ratio + 0.5 * (var @ inv_var.T + _quad(mu, mu, inv_var)
                                    - var.shape[-1])


def multivariate_gaussian_cross_entropy(p: DiagonalGaussian,
                                        q: DiagonalGaussian):
    """[N, M] matrix of cross-entropies H(p_i, q_j) = sum_d log sigma_q +
    1/2 (sum_d (var_p + (mu_p - mu_q)^2) / var_q + d log 2 pi), for any N
    and M (the JAX package's corrected cross term)."""
    mu_p, var_p, _ = _flat(p)
    mu_q, var_q, log_sigma_q = _flat(q)
    inv_var_q = 1.0 / var_q
    d = var_p.shape[-1]
    return log_sigma_q[None, :] + 0.5 * (
        var_p @ inv_var_q.T + _quad(mu_p, mu_q, inv_var_q) + d * _LOG_2PI)


def pairwise_gaussian_cross_entropy(g: DiagonalGaussian):
    """[B, B] matrix of H(g_i, g_j)."""
    return multivariate_gaussian_cross_entropy(g, g)


def _pdist_sq(x):
    """Squared distances of the rows of x over the pairs i < j, in
    row-major order."""
    sq = x.square().sum(-1)
    d2 = sq[:, None] + sq[None, :] - 2.0 * x @ x.T
    iu = torch.triu_indices(x.shape[0], x.shape[0], offset=1,
                            device=x.device)
    return d2[iu[0], iu[1]].clamp_min(0.0)


def _log_rbf_gaussian_overlap(bw_sq, target_var, copies: int):
    """log prod_d sqrt(bw^2 / (bw^2 + copies * v_d)): log E[k(a, b)] for an
    RBF kernel of bandwidth^2 `bw_sq` where ||a - b||^2 has per-dimension
    variance copies * target_var (1: a sample against the target; 2: the
    target against itself; 3 and 4: the null-variance terms)."""
    return 0.5 * (math.log(bw_sq)
                  - torch.log(bw_sq + copies * target_var)).sum(-1)


def custom_gaussian_rbf_mmd_sq(x, mean, var, standardize: bool = True):
    """Unbiased squared MMD between the rows of x [N, D] and N(mean,
    diag(var)) under an RBF kernel of bandwidth^2 D / 8: E_pp[k] -
    2 E_xp[k] + E_xx[k], the first two in closed form. `standardize`
    divides by the estimator's standard error under the null (x from the
    target), a z-score. mean and var broadcast against a row."""
    n, d = x.shape
    bw_sq = 0.125 * d
    var = torch.broadcast_to(torch.as_tensor(var, dtype=x.dtype,
                                             device=x.device), (d,))
    mean = torch.as_tensor(mean, dtype=x.dtype, device=x.device)
    log_pp = _log_rbf_gaussian_overlap(bw_sq, var, copies=2)
    log_xp_scale = _log_rbf_gaussian_overlap(bw_sq, var, copies=1)
    xp_quad = ((x - mean).square() / (bw_sq + var)).sum(-1)
    e_pp = torch.exp(log_pp)
    e_xp = torch.exp(log_xp_scale - 0.5 * xp_quad).mean()
    e_xx = torch.exp(-0.5 * _pdist_sq(x) / bw_sq).mean()
    mmd_sq = e_pp - 2.0 * e_xp + e_xx
    if standardize:
        log_o3 = _log_rbf_gaussian_overlap(bw_sq, var, copies=3)
        log_o4 = _log_rbf_gaussian_overlap(bw_sq, var, copies=4)
        null_var = (2.0 / (n * (n - 1))) * (
            torch.exp(2.0 * log_pp) + torch.exp(log_o4)
            - 2.0 * torch.exp(log_xp_scale + log_o3))
        mmd_sq = mmd_sq / torch.sqrt(null_var)
    return mmd_sq


def analytic_gaussian_rbf_mmd_sq(x, standardize: bool = True):
    """custom_gaussian_rbf_mmd_sq against the standard normal."""
    return custom_gaussian_rbf_mmd_sq(x, 0.0, 1.0, standardize=standardize)


IMQ_SCALES = (0.1, 0.2, 0.5, 1.0, 2.0, 5.0, 10.0)


def gaussian_imq_mmd_sq(x, prior: Optional[torch.Tensor] = None,
                        num_prior_samples: int = 1000,
                        generator: Optional[torch.Generator] = None):
    """IMQ-kernel MMD of the rows of x [N, D] against N(0, I), averaged
    over the seven WAE scales (times 2 D). prior: [P, D] standard normal
    draws, or `num_prior_samples` of them drawn from `generator`; they are
    standardised exactly (their mean and population variance) before
    use."""
    n, d = x.shape
    c = 2.0 * d
    scales = torch.tensor(IMQ_SCALES, dtype=x.dtype,
                          device=x.device).reshape(-1, 1) * c
    if prior is None:
        prior = torch.randn((num_prior_samples, d), generator=generator,
                            dtype=x.dtype, device=x.device)
    raw = prior.to(x.dtype)
    raw = (raw - raw.mean()) / torch.sqrt(raw.var(correction=0))
    first = (scales / (scales + _pdist_sq(x)[None, :])).mean()
    inter = (x[None, :, :] * raw[:, None, :]).sum(-1)          # [P, N]
    dists = x.square().sum(-1)[None, :] - 2 * inter + d
    middle = 2 * (scales[:, :, None]
                  / (scales[:, :, None] + dists[None])).mean()
    prior_term = (scales / (scales + _pdist_sq(raw)[None, :])).mean()
    return first - middle + prior_term


def _ngrams(seq: Sequence, n: int) -> Counter:
    return Counter(tuple(seq[i:i + n]) for i in range(len(seq) - n + 1))


def reconstruction_bleu(output: Sequence[int], original: Sequence[int],
                        max_n: int = 4) -> float:
    """Clipped n-gram precision BLEU between two token-id sequences: the
    geometric mean over n = 1 .. max_n + 1, 0 when any precision is 0.
    For logging."""
    output = [int(t) for t in output]
    original = [int(t) for t in original]
    if not output or not original:
        return 0.0
    scores = []
    for n in range(1, max_n + 2):
        out_ngrams, ref_ngrams = _ngrams(output, n), _ngrams(original, n)
        total = sum(out_ngrams.values())
        if total == 0:
            scores.append(0.0)
            continue
        clipped = sum(min(c, ref_ngrams[g]) for g, c in out_ngrams.items())
        scores.append(clipped / total)
    if any(s == 0.0 for s in scores):
        return 0.0
    return math.exp(sum(math.log(s) for s in scores) / len(scores))


def bleu_score_corpus(candidates: Sequence[Sequence[str]],
                      references: Sequence[Sequence[Sequence[str]]],
                      max_n: int = 2) -> float:
    """Corpus BLEU over word lists with uniform weights over n = 1 ..
    max_n and the brevity penalty (torchtext's bleu_score): each
    candidate's n-grams clipped by their most frequent count in any of its
    references, the reference length the one closest to the candidate's
    (the shorter on a tie)."""
    clipped = [0] * max_n
    totals = [0] * max_n
    cand_len, ref_len = 0, 0
    for cand, refs in zip(candidates, references):
        cand_len += len(cand)
        ref_len += min((len(r) for r in refs),
                       key=lambda length: (abs(length - len(cand)), length))
        for n in range(1, max_n + 1):
            cand_ngrams = _ngrams(cand, n)
            max_ref = Counter()
            for ref in refs:
                for g, c in _ngrams(ref, n).items():
                    max_ref[g] = max(max_ref[g], c)
            totals[n - 1] += sum(cand_ngrams.values())
            clipped[n - 1] += sum(min(c, max_ref[g])
                                  for g, c in cand_ngrams.items())
    if any(t == 0 for t in totals) or any(c == 0 for c in clipped):
        return 0.0
    log_p = sum(math.log(c / t) for c, t in zip(clipped, totals)) / max_n
    bp = 1.0 if cand_len > ref_len else math.exp(
        1 - ref_len / max(cand_len, 1))
    return bp * math.exp(log_p)
