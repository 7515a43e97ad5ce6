"""The evaluation slice against the JAX package on the CPU: the
per-document log-likelihoods and the importance-weighted estimators
(`estimate_log_prob_iw`, `iwae_dreg_loss`, `iwae_dreg_sums`,
`_scale_gradient`); tests/test_torch_eval_train.py holds the
multi-sample training branch, the checkpoint loader and the `test`
entry.

The same numpy inputs go through both packages. JAX draws its own noise,
so each test rebuilds JAX's draws and hands them to the port as eps:
`estimate_log_prob_iw` splits its rng into num_iter keys and draws
normal(key_i, (chunk, *loc.shape)) for chunk i; `iwae_dreg_loss` draws
normal(rng, (K, *loc.shape)).

The port stacks the K samples as rows beside the ids repeated
sample-major; every input here has B >= 2 distinct documents of
different lengths where the order could go wrong, so pairing a sample
with another document's tokens would show.

Tolerances, each stated where it is used: per-document log-likelihoods
and bounds at full width in fp32, 2e-5 relative (the ELBO parity's,
tests/test_torch_train.py: summation order over 512-2,048 tokens x
32,768 logits); gradients |port - jax| <= 2e-3 * max|jax| + 1e-7 per
tensor, as there.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_vae_tpu import build_model
from sparse_vae_tpu.models import vae as jvae
from sparse_vae_tpu.ops import cross_entropy as jce
from sparse_vae_tpu_torch import checkpoint as ckpt
from sparse_vae_tpu_torch.models import vae as tvae
from sparse_vae_tpu_torch.models.transformer_vae import (
    TransformerVAE, TransformerVAEHparams)
from sparse_vae_tpu_torch.ops import cross_entropy as tce
from sparse_vae_tpu_torch.utils.distributions import DiagonalGaussian
from tests.test_torch_checkpoint import REPO, jax_params_from_archive, jax_r5
from tests.test_torch_train import (_assert_grads_match, _documents,
                                    _leaf_grads, _tiny_hparams)

LL_RTOL = 2e-5
PG19 = "real-prose-pg19-fb8"


def _jax_pg19():
    with open(os.path.join(REPO, "runs", PG19, "meta.json")) as fh:
        hp = dict(json.load(fh)["model_hparams"])
    hp.update(precision="fp32", grad_checkpointing=False)
    module, _, _ = build_model("transformer-vae", hp)
    with np.load(os.path.join(REPO, "runs", PG19, "ckpt_bf16.npz")) as npz:
        params = jax_params_from_archive({k: npz[k] for k in npz.files})
    return module, params


def _iw_eps(rng, loc_shape, num_samples, num_iter):
    """JAX estimate_log_prob_iw's draws: [num_samples, *loc_shape]."""
    chunk = num_samples // num_iter
    return np.concatenate([np.array(jax.random.normal(r, (chunk, *loc_shape)))
                           for r in jax.random.split(rng, num_iter)])


def _jax_iw(module, params, ids, method, rng, num_samples, num_iter):
    cls = type(module)
    v = {"params": params}
    posterior = module.apply(v, jnp.asarray(ids), method=cls.posterior)

    def rec(z):
        return module.apply(v, jnp.asarray(ids), z,
                            method=getattr(cls, method))

    lp = jvae.estimate_log_prob_iw(rec, posterior, jnp.asarray(ids), rng,
                                   num_samples, num_iter)
    return np.asarray(lp), posterior.loc.shape


def _port_iw(model, ids, method, eps, num_samples, num_iter):
    with torch.no_grad():
        ids_t = torch.from_numpy(ids)
        posterior = model.posterior(ids_t)
        return tvae.estimate_log_prob_iw(
            getattr(model, method), posterior, ids_t, num_samples, num_iter,
            eps=torch.from_numpy(eps)).numpy()


@pytest.fixture(scope="module")
def r5_pair():
    module, params = jax_r5()
    model, _, _ = ckpt.load_run("real-prose-vae-r5", device="cpu",
                                dtype=torch.float32)
    return module, params, model


# -- the per-document log-likelihoods --------------------------------------

def test_sequence_log_likelihoods_match_jax():
    """sequence_log_likelihood on logits and chunked_sequence_log_likelihood
    on hidden states with a random projection, rows of padding included:
    [3, 40] tokens, vocab 96, chunks of 16 (the last one padded). 1e-5
    relative: fp32 sums of 40 log-softmax terms."""
    rng = np.random.default_rng(0)
    ids, _ = _documents(rng, [40, 23, 9], 40, 96)
    labels = np.pad(ids[:, 1:], ((0, 0), (0, 1)))
    logits = rng.standard_normal((3, 40, 96)).astype(np.float32)
    np.testing.assert_allclose(
        tce.sequence_log_likelihood(torch.from_numpy(logits),
                                    torch.from_numpy(labels)).numpy(),
        np.asarray(jce.sequence_log_likelihood(jnp.asarray(logits),
                                               jnp.asarray(labels))),
        rtol=1e-5)
    hidden = rng.standard_normal((3, 40, 8)).astype(np.float32)
    proj = rng.standard_normal((8, 96)).astype(np.float32)
    got = tce.chunked_sequence_log_likelihood(
        torch.from_numpy(hidden), lambda h: h @ torch.from_numpy(proj),
        torch.from_numpy(labels), chunk_size=16)
    want = jce.chunked_sequence_log_likelihood(
        jnp.asarray(hidden), lambda h: h @ jnp.asarray(proj),
        jnp.asarray(labels), chunk_size=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


# -- estimate_log_prob_iw --------------------------------------------------

@pytest.mark.parametrize("method", ["reconstruct_ll", "reconstruct"])
def test_r5_iwae_matches_jax(r5_pair, method):
    """r5's trained weights in fp32, two distinct documents of 512 and 300
    tokens, 4 samples in 2 chunks, through per-document log-likelihoods
    and through full logits: log p(x) [2] within 2e-5 relative."""
    module, params, model = r5_pair
    ids, _ = _documents(np.random.default_rng(1), [512, 300], 512, 32768)
    rng = jax.random.PRNGKey(1)
    want, loc_shape = _jax_iw(module, params, ids, method, rng, 4, 2)
    eps = _iw_eps(rng, loc_shape, 4, 2)
    got = _port_iw(model, ids, method, eps, 4, 2)
    np.testing.assert_allclose(got, want, rtol=LL_RTOL)
    assert abs(got[0] - got[1]) > 100.0     # distinct documents


def test_stacked_rows_pair_each_sample_with_its_own_document(r5_pair):
    """The samples stacked as rows: sample k of document b decodes
    document b. Reordering the rows the other way (`repeat_interleave`)
    pairs z with another document's tokens and moves the estimate far
    from the right one, computed here one document at a time."""
    _, _, model = r5_pair
    ids, _ = _documents(np.random.default_rng(2), [256, 256, 256], 256,
                        32768)
    eps = np.random.default_rng(3).standard_normal(
        (2, 3, 1, 64)).astype(np.float32)
    got = _port_iw(model, ids, "reconstruct_ll", eps, 2, 1)
    one_at_a_time = [_port_iw(model, ids[b:b + 1], "reconstruct_ll",
                              eps[:, b:b + 1], 2, 1)[0] for b in range(3)]
    np.testing.assert_allclose(got, one_at_a_time, rtol=LL_RTOL)

    def interleaved(token_ids, z):
        return model.reconstruct_ll(
            token_ids.reshape(2, 3, -1).transpose(0, 1).reshape(6, -1), z)

    with torch.no_grad():
        wrong = tvae.estimate_log_prob_iw(
            interleaved, model.posterior(torch.from_numpy(ids)),
            torch.from_numpy(ids), 2, 1, eps=torch.from_numpy(eps)).numpy()
    assert np.abs(wrong - got).max() > 10.0


def test_pg19_fb8_iwae_matches_jax():
    """pg19-fb8's trained weights in fp32 on one 2,048-token document, 4
    samples in 2 chunks, through reconstruct_ll: 2e-5 relative."""
    module, params = _jax_pg19()
    model, _, _ = ckpt.load_run(PG19, device="cpu", dtype=torch.float32)
    ids, _ = _documents(np.random.default_rng(4), [2048], 2048, 32768)
    rng = jax.random.PRNGKey(4)
    want, loc_shape = _jax_iw(module, params, ids, "reconstruct_ll", rng, 4,
                              2)
    got = _port_iw(model, ids, "reconstruct_ll",
                   _iw_eps(rng, loc_shape, 4, 2), 4, 2)
    np.testing.assert_allclose(got, want, rtol=LL_RTOL)


def test_iwae_rejects_a_ragged_sample_split():
    q = DiagonalGaussian(torch.zeros(1, 1, 2), torch.ones(1, 1, 2))
    with pytest.raises(ValueError, match="multiple of num_iter"):
        tvae.estimate_log_prob_iw(None, q, torch.ones(1, 4), 5, 2)


# -- iwae_dreg_loss and iwae_dreg_sums -------------------------------------

def _tiny(**kw):
    overrides = {**_tiny_hparams(), "free_bits": 0.0, **kw}
    module, jhp, jobj = build_model("transformer-vae", overrides)
    hp = TransformerVAEHparams(**{k: v for k, v in overrides.items()
                                  if k != "grad_checkpointing"})
    return module, jhp, jobj, hp


def _tiny_pair(seed, **kw):
    """A tiny JAX-initialised model in both packages."""
    module, jhp, jobj, hp = _tiny(**kw)
    ids, num_tokens = _documents(np.random.default_rng(seed),
                                 [32, 20, 11], 32, hp.vocab_size)
    params = module.init({"params": jax.random.PRNGKey(seed),
                          "sample": jax.random.PRNGKey(seed)},
                         jnp.asarray(ids[:1]))["params"]
    model = TransformerVAE(hp)
    model.load_state_dict(ckpt.state_from_leaves(
        {k: np.array(v) for k, v in _leaf_grads(params).items()}, hp),
        strict=True)
    return module, params, model, ids, num_tokens


def _jax_dreg(module, params, ids, num_tokens, rng, k, method, sums=False):
    cls = type(module)
    fn = jvae.iwae_dreg_sums if sums else jvae.iwae_dreg_loss

    def loss(p):
        v = {"params": p}
        posterior = module.apply(v, jnp.asarray(ids), method=cls.posterior)

        def rec(z):
            return module.apply(v, jnp.asarray(ids), z,
                                method=getattr(cls, method))

        out = fn(rec, posterior, jnp.asarray(ids), jnp.asarray(num_tokens),
                 rng, k)
        return out[0], out[1:]

    return jax.jit(jax.value_and_grad(loss, has_aux=True))(params)


def _dreg_eps(rng, k, b, latent):
    return torch.from_numpy(np.array(jax.random.normal(rng, (k, b, 1,
                                                             latent))))


@pytest.mark.parametrize("method", ["reconstruct_ll", "reconstruct"])
def test_tiny_dreg_loss_bound_and_every_gradient_match_jax(method):
    """iwae_dreg_loss of a tiny JAX-initialised model (2 layers, d_model
    64), K = 4 on three ragged documents: the loss and the bound within
    2e-5 relative, and the gradient of every parameter against jax.grad
    (2e-3 of each tensor's largest entry)."""
    module, params, model, ids, num_tokens = _tiny_pair(5)
    rng = jax.random.PRNGKey(5)
    (want_loss, (want_bound,)), grads = _jax_dreg(
        module, params, ids, num_tokens, rng, 4, method)
    ids_t = torch.from_numpy(ids)
    loss, bound = tvae.iwae_dreg_loss(
        getattr(model, method), model.posterior(ids_t), ids_t,
        torch.from_numpy(num_tokens), 4,
        eps=_dreg_eps(rng, 4, 3, model.hparams.latent_depth))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=LL_RTOL)
    np.testing.assert_allclose(bound.detach().numpy(), np.asarray(want_bound),
                               rtol=LL_RTOL)
    _assert_grads_match(model, _leaf_grads(grads))


def test_tiny_dreg_sums_over_rows_are_the_loss():
    """iwae_dreg_sums against JAX's on a batch with a filler row, and its
    first sum over its rows equal to iwae_dreg_loss's loss (1e-6: one
    multiply and one divide)."""
    module, params, model, ids, num_tokens = _tiny_pair(6)
    ids, num_tokens = ids.copy(), num_tokens.copy()
    ids[2], num_tokens[2] = 0, 0
    rng = jax.random.PRNGKey(6)
    (want_neg, (want_bound_sum, want_rows)), _ = _jax_dreg(
        module, params, ids, num_tokens, rng, 3, "reconstruct_ll",
        sums=True)
    ids_t, nt = torch.from_numpy(ids), torch.from_numpy(num_tokens)
    eps = _dreg_eps(rng, 3, 3, model.hparams.latent_depth)
    with torch.no_grad():
        q = model.posterior(ids_t)
        neg, bound_sum, rows = tvae.iwae_dreg_sums(
            model.reconstruct_ll, q, ids_t, nt, 3, eps=eps)
        loss, _ = tvae.iwae_dreg_loss(model.reconstruct_ll, q, ids_t, nt, 3,
                                      eps=eps)
    assert rows.item() == float(want_rows) == 2.0
    np.testing.assert_allclose(neg.item(), float(want_neg), rtol=LL_RTOL)
    np.testing.assert_allclose(bound_sum.item(), float(want_bound_sum),
                               rtol=LL_RTOL)
    np.testing.assert_allclose(neg.item() / rows.item(), loss.item(),
                               rtol=1e-6)


def test_r5_dreg_loss_matches_jax(r5_pair):
    """r5's trained weights in fp32, K = 2 on one 512-token document
    beside a 300-token one: iwae_dreg_loss's loss and bound within 2e-5
    relative."""
    module, params, model = r5_pair
    ids, num_tokens = _documents(np.random.default_rng(7), [512, 300], 512,
                                 32768)
    rng = jax.random.PRNGKey(7)
    cls = type(module)
    v = {"params": params}
    want_loss, want_bound = jvae.iwae_dreg_loss(
        lambda z: module.apply(v, jnp.asarray(ids), z,
                               method=cls.reconstruct_ll),
        module.apply(v, jnp.asarray(ids), method=cls.posterior),
        jnp.asarray(ids), jnp.asarray(num_tokens), rng, 2)
    ids_t = torch.from_numpy(ids)
    with torch.no_grad():
        loss, bound = tvae.iwae_dreg_loss(
            model.reconstruct_ll, model.posterior(ids_t), ids_t,
            torch.from_numpy(num_tokens), 2, eps=_dreg_eps(rng, 2, 2, 64))
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=LL_RTOL)
    np.testing.assert_allclose(bound.numpy(), np.asarray(want_bound),
                               rtol=LL_RTOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scale_gradient_keeps_the_value_and_scales_the_gradient(dtype):
    """_scale_gradient(x, s): the value x (up to one rounding of x where s
    is far from 1, as in the reference's identity) and the gradient s,
    in fp32 and in bf16."""
    gen = torch.Generator().manual_seed(8)
    x = torch.randn(64, generator=gen).to(dtype).requires_grad_()
    s = torch.rand(64, generator=gen).to(dtype)
    y = tvae._scale_gradient(x, s)
    ulp = torch.finfo(dtype).eps
    assert y.dtype == dtype
    assert torch.all((y - x).abs() <= ulp * x.abs().detach())
    y.backward(torch.ones_like(y))
    assert torch.equal(x.grad, s)


@pytest.mark.parametrize("run,cut", [("real-prose-vae-r5", "older"),
                                     (PG19, "current")])
def test_the_stand_in_iwae_sees_the_attention_band(run, cut):
    """chip_smoke.py's eval phases hold the kernels' IWAE NLL against the
    plain versions within TRAIN_LOSS_RTOL on documents that repeat a
    segment, beside a plain run with a band block dropped (EVAL_CUTS),
    which must move it by VAL_POWER x that or more. Here, on the CPU in
    fp32 at [2, 2048] with 2 samples, that cut moves it so: r5 reads the
    segment's copy one period back in the older band block; pg19-fb8
    reads its own block."""
    import chip_smoke as cs

    assert cs.EVAL_CUTS[run] == cut
    model, hp, _ = ckpt.load_run(run, device="cpu", dtype=torch.float32)
    batch = cs.segment_documents([2048, 1500], 2048, hp.vocab_size,
                                 cs.EVAL_SEED, device="cpu")
    eps = torch.randn((2, 2, 1, hp.latent_depth),
                      generator=torch.Generator().manual_seed(0))
    from sparse_vae_tpu_torch.test import batch_nll
    with torch.no_grad():
        right = batch_nll(model, batch, 2, 1, eps=eps)
        with cs.band_without_block(cut):
            wrong = batch_nll(model, batch, 2, 1, eps=eps)
    assert abs(wrong - right) / right >= cs.VAL_POWER * cs.TRAIN_LOSS_RTOL
