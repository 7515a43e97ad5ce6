"""The port's distribution math and text metrics
(sparse_vae_tpu_torch/utils/math_utils.py, distributions.py) against the
JAX package's on the same seeded numpy inputs, on the CPU, and the
properties tests/test_utils.py checks of the JAX functions.

Random draws (the marginal-KL noise, the IMQ prior samples) are made once
and handed to both packages. Tolerances: fp32 through a few products and
sums of at most a few hundred terms, 1e-5 relative plus 1e-5 absolute
(absolute for statistics that are differences of O(1) terms near 0, as an
MMD under its null); the IMQ statistic 1e-4 relative (means of 7 x ~10^4
fp32 ratios); BLEU is pure Python on both sides, equal to 1e-12.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_vae_tpu.utils import distributions as jd
from sparse_vae_tpu.utils import math_utils as jm
from sparse_vae_tpu_torch.utils import distributions as td
from sparse_vae_tpu_torch.utils import math_utils as tm

RTOL, ATOL = 1e-5, 1e-5


def _gaussians(seed, n, d, spread=0.2):
    rng = np.random.default_rng(seed)
    loc = rng.standard_normal((n, d)).astype(np.float32)
    scale = np.exp(spread * rng.standard_normal((n, d))).astype(np.float32)
    return loc, scale


def _pair(loc, scale):
    return (jd.DiagonalGaussian(jnp.asarray(loc), jnp.asarray(scale)),
            td.DiagonalGaussian(torch.from_numpy(loc),
                                torch.from_numpy(scale)))


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def test_standard_normal_log_prob_and_variance_match_jax():
    loc, scale = _gaussians(0, 6, 16)
    jg, tg = _pair(loc, scale)
    _close(td.standard_normal_log_prob(torch.from_numpy(loc)),
           jd.standard_normal_log_prob(jnp.asarray(loc)))
    _close(tg.variance, jg.variance)


@pytest.mark.parametrize("shape", [(5, 8), (7, 1, 64)])
def test_entropy_and_pairwise_kl_match_jax(shape):
    n, d = shape[0], int(np.prod(shape[1:]))
    loc, scale = _gaussians(1, n, d)
    jg, tg = _pair(loc.reshape(shape), scale.reshape(shape))
    _close(tm.multivariate_gaussian_entropy(tg),
           jm.multivariate_gaussian_entropy(jg))
    _close(tm.pairwise_gaussian_kl(tg), jm.pairwise_gaussian_kl(jg))
    _close(tm.pairwise_gaussian_cross_entropy(tg),
           jm.pairwise_gaussian_cross_entropy(jg))


def test_cross_entropy_of_two_batches_matches_jax():
    """N != M, the case the reference's broadcasting could not take."""
    jp, tp = _pair(*_gaussians(2, 5, 8))
    jq, tq = _pair(*_gaussians(3, 3, 8, spread=0.4))
    got = tm.multivariate_gaussian_cross_entropy(tp, tq)
    assert got.shape == (5, 3)
    _close(got, jm.multivariate_gaussian_cross_entropy(jp, jq))


def test_marginal_kl_matches_jax():
    loc, scale = _gaussians(4, 6, 8)
    jg, tg = _pair(loc, scale)
    rng = jax.random.PRNGKey(4)
    noise = np.array(jax.random.normal(rng, (10, 6, 8)))
    _close(tm.marginal_kl(tg, torch.from_numpy(noise)),
           jm.marginal_kl(jg, rng, 10))


def test_pdist_and_overlap_match_jax():
    x = np.random.default_rng(5).standard_normal((9, 16)).astype(np.float32)
    _close(tm._pdist_sq(torch.from_numpy(x)), jm._pdist_sq(jnp.asarray(x)))
    var = np.linspace(0.5, 2.0, 16).astype(np.float32)
    for copies in (1, 2, 3, 4):
        _close(tm._log_rbf_gaussian_overlap(2.0, torch.from_numpy(var),
                                            copies),
               jm._log_rbf_gaussian_overlap(2.0, jnp.asarray(var), copies))


@pytest.mark.parametrize("standardize", [False, True])
@pytest.mark.parametrize("shift", [0.0, 3.0])
def test_rbf_mmd_matches_jax(standardize, shift):
    rng = np.random.default_rng(6)
    mean = (np.arange(16) * 0.3).astype(np.float32)
    var = np.linspace(0.5, 2.0, 16).astype(np.float32)
    x = (mean + np.sqrt(var) * rng.standard_normal((64, 16))
         + shift).astype(np.float32)
    _close(tm.custom_gaussian_rbf_mmd_sq(torch.from_numpy(x),
                                         torch.from_numpy(mean),
                                         torch.from_numpy(var), standardize),
           jm.custom_gaussian_rbf_mmd_sq(jnp.asarray(x), jnp.asarray(mean),
                                         jnp.asarray(var), standardize))
    _close(tm.analytic_gaussian_rbf_mmd_sq(torch.from_numpy(x), standardize),
           jm.analytic_gaussian_rbf_mmd_sq(jnp.asarray(x), standardize))


def test_imq_mmd_matches_jax_with_its_prior_draws():
    x = np.random.default_rng(7).standard_normal((32, 8)).astype(np.float32)
    rng = jax.random.PRNGKey(7)
    prior = np.array(jax.random.normal(rng, (200, 8)))
    got = tm.gaussian_imq_mmd_sq(torch.from_numpy(x),
                                 torch.from_numpy(prior))
    _close(got, jm.gaussian_imq_mmd_sq(jnp.asarray(x), rng, 200), rtol=1e-4)
    drawn = tm.gaussian_imq_mmd_sq(torch.from_numpy(x), num_prior_samples=200,
                                   generator=torch.Generator().manual_seed(0))
    assert torch.isfinite(drawn) and abs(drawn - got) < 0.5


def _token_lists(seed, n, vocab, length):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=rng.integers(1, length)).tolist()
            for _ in range(n)]


@pytest.mark.parametrize("vocab", [3, 8, 1000])
def test_reconstruction_bleu_matches_jax(vocab):
    outs = _token_lists(8, 20, vocab, 30)
    refs = _token_lists(9, 20, vocab, 30)
    pairs = list(zip(outs, refs)) + [(outs[0], outs[0]), ([], refs[0])]
    for out, ref in pairs:
        for max_n in (1, 4):
            assert tm.reconstruction_bleu(out, ref, max_n) == pytest.approx(
                jm.reconstruction_bleu(out, ref, max_n), rel=1e-12, abs=0)


@pytest.mark.parametrize("max_n", [1, 2, 4])
def test_corpus_bleu_matches_jax(max_n):
    words = "the cat sat on a mat and then the dog ran off".split()
    rng = np.random.default_rng(10 + max_n)

    def sentence():
        return [words[i] for i in rng.integers(0, len(words),
                                               size=rng.integers(2, 14))]

    cands = [sentence() for _ in range(12)]
    refs = [[sentence() for _ in range(rng.integers(1, 4))] for _ in cands]
    refs[0].append(list(cands[0]))
    assert tm.bleu_score_corpus(cands, refs, max_n) == pytest.approx(
        jm.bleu_score_corpus(cands, refs, max_n), rel=1e-12, abs=0)
    assert tm.bleu_score_corpus([["dog"]], [[["the", "cat"]]], 1) == 0.0


# -- the properties of tests/test_utils.py's TestMathUtils -----------------

def test_pairwise_kl_has_a_zero_diagonal_and_the_elementwise_entries():
    loc, scale = _gaussians(11, 5, 8, spread=0.1)
    _, tg = _pair(loc, scale)
    mat = tm.pairwise_gaussian_kl(tg)
    np.testing.assert_allclose(torch.diagonal(mat).numpy(), 0.0, atol=1e-4)
    p = jd.DiagonalGaussian(jnp.asarray(loc[0]), jnp.asarray(scale[0]))
    q = jd.DiagonalGaussian(jnp.asarray(loc[1]), jnp.asarray(scale[1]))
    assert mat[0, 1].item() == pytest.approx(
        float(jd.kl_divergence(p, q).sum()), rel=1e-4)


def test_marginal_kl_is_small_at_the_prior_and_large_when_spread():
    gen = torch.Generator().manual_seed(12)
    prior = td.DiagonalGaussian(torch.zeros(64, 8), torch.ones(64, 8))
    assert abs(tm.marginal_kl(prior, torch.randn(64, 64, 8,
                                                 generator=gen))) < 0.3
    spread = td.DiagonalGaussian(5.0 * torch.randn(32, 8, generator=gen),
                                 torch.full((32, 8), 0.1))
    assert tm.marginal_kl(spread, torch.randn(32, 32, 8,
                                              generator=gen)) > 1.0


def test_mmd_z_scores_tell_a_shift():
    gen = torch.Generator().manual_seed(13)
    x = torch.randn(256, 16, generator=gen)
    assert abs(tm.analytic_gaussian_rbf_mmd_sq(x)) < 4.0
    assert tm.analytic_gaussian_rbf_mmd_sq(x + 3.0) > 10.0
    mean, var = torch.arange(16.0) * 0.3, torch.linspace(0.5, 2.0, 16)
    y = mean + var.sqrt() * x
    assert abs(tm.custom_gaussian_rbf_mmd_sq(y, mean, var)) < 4.0
    assert tm.custom_gaussian_rbf_mmd_sq(y + 3.0, mean, var) > 10.0
    for std in (False, True):
        a = tm.analytic_gaussian_rbf_mmd_sq(x[:128], standardize=std)
        b = tm.custom_gaussian_rbf_mmd_sq(x[:128], torch.zeros(16),
                                          torch.ones(16), standardize=std)
        np.testing.assert_allclose(a.item(), b.item(), rtol=5e-4, atol=1e-6)


def test_cross_entropy_less_entropy_is_the_kl():
    """The diagonal of H(g, g) is H(g), and H(p, q) - H(p) = KL(p || q)."""
    loc, scale = _gaussians(14, 5, 8)
    _, g = _pair(loc, scale)
    mat = tm.multivariate_gaussian_cross_entropy(g, g)
    ent = tm.multivariate_gaussian_entropy(g)
    np.testing.assert_allclose(torch.diagonal(mat).numpy(), ent.numpy(),
                               rtol=1e-5)
    q = td.DiagonalGaussian(g.loc[:3] + 1.0, g.scale[:3] * 1.5)
    hpq = tm.multivariate_gaussian_cross_entropy(g, q)
    kl = tm.pairwise_gaussian_kl(td.DiagonalGaussian(
        torch.cat([g.loc, q.loc]), torch.cat([g.scale, q.scale])))[:5, 5:]
    np.testing.assert_allclose((hpq - ent[:, None]).numpy(), kl.numpy(),
                               rtol=1e-4, atol=1e-4)


def test_bleu_identity_and_disjoint():
    seq = list(range(5, 40))
    assert tm.reconstruction_bleu(seq, seq) == pytest.approx(1.0)
    assert tm.reconstruction_bleu(seq, list(range(100, 135))) == 0.0
    refs = [[["the", "cat", "sat"]]]
    assert tm.bleu_score_corpus([["the", "cat", "sat"]], refs,
                                max_n=2) == pytest.approx(1.0)
