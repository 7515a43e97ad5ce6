"""The training slice against the JAX package on the CPU: the flagship's
encoder, posterior and chunked ELBO with every parameter's gradient, the
RAdam/LAMB chain, and a whole accumulated train step.

The same numpy inputs and noise go through both packages. JAX's random
streams are not torch's, so the posterior noise eps (z = loc + scale *
eps) and the marginal-KL draws are made once and handed to both; for the
train step they are read off the JAX step's own rng splits.

Tolerances, each stated where it is used:
- ELBO sums at full width in fp32: summation order over 1,024 tokens x
  32,768 logits and six layers, ~1e-6 relative; bound 2e-5 relative.
- Gradients at full width: per tensor, |port - jax| <= 2e-3 * max|jax|
  + 1e-7 (fp32 summation order through 9 layers and a 32,768-way softmax
  measured below 2e-4 of the largest entry).
- RAdam/LAMB: the step's scalars are fp64 on the host in the port and
  fp32 in JAX; 8 steps of lr-sized updates agree to 1e-6 absolute.
- The ELBO in bf16 compute (fp32 master weights), as r5 was trained: the
  two packages round to bf16 at other places, so neither is the other's
  reference; each is held against JAX in fp32, and the port may be no
  farther from it than JAX's own bf16, by the margins stated at the test.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze
from flax.traverse_util import flatten_dict

from sparse_vae_tpu import build_model
from sparse_vae_tpu.models.transformer_lm import TransformerLanguageModel
from sparse_vae_tpu.models.vae import VAEObjective as JObjective
from sparse_vae_tpu.models.vae import kl_sums as j_kl_sums
from sparse_vae_tpu.parallel.spmd import make_train_step
from sparse_vae_tpu.training.optimizer import make_optimizer as j_make_opt
from sparse_vae_tpu_torch import checkpoint as ckpt
from sparse_vae_tpu_torch.models.transformer_vae import (
    TransformerVAE, TransformerVAEHparams)
from sparse_vae_tpu_torch.models.vae import VAEObjective
from sparse_vae_tpu_torch.training.optimizer import make_optimizer
from sparse_vae_tpu_torch.training.train_step import train_step
from tests.test_torch_checkpoint import jax_r5

SUM_RTOL = 2e-5
GRAD_REL, GRAD_ATOL = 2e-3, 1e-7


def _documents(rng, lengths, width, vocab):
    ids = np.zeros((len(lengths), width), np.int64)
    for row, n in enumerate(lengths):
        ids[row, 0] = 1
        ids[row, 1:n - 1] = rng.integers(3, vocab, size=n - 2)
        ids[row, n - 1] = 2
    return ids, np.array(lengths, np.int64)


def _leaf_grads(grads):
    """{flax path: np array} of a JAX param-shaped pytree."""
    return {"/".join(k): np.asarray(v)
            for k, v in flatten_dict(unfreeze(grads)).items()}


def _assert_grads_match(model, jax_grads):
    named = dict(model.named_parameters())
    assert len(jax_grads) == len(named)
    for path, want in jax_grads.items():
        key, transpose = ckpt.torch_key(path)
        got = named[key].grad.numpy()
        got = got.T if transpose else got
        bound = GRAD_REL * np.abs(want).max() + GRAD_ATOL
        err = np.abs(got - want).max()
        assert err <= bound, f"{path}: max err {err:.3g} > {bound:.3g}"


@pytest.fixture(scope="module")
def r5_pair():
    module, params = jax_r5()
    model, _, _ = ckpt.load_run("real-prose-vae-r5", device="cpu",
                                dtype=torch.float32, train=True)
    return module, params, model


# The ELBO of the r5 tests: ragged documents [2, 512] and the posterior
# noise, made from seed 0, at step 100 (KL weight 0.145).
ELBO_STEP = 100


def _elbo_inputs():
    rng = np.random.default_rng(0)
    ids, num_tokens = _documents(rng, [512, 300], 512, 32768)
    eps = rng.standard_normal((2, 1, 64)).astype(np.float32)
    return ids, num_tokens, eps


def _jax_elbo(module, params, ids, num_tokens, eps):
    """JAX's loss, (nll_sum, count, kl_sum, raw_kl_sum) and the gradient
    of the loss by flax path."""
    cls = type(module)
    jobj = JObjective(module.hparams)

    def jax_loss(p):
        v = {"params": p}
        q, raw_kl = module.apply(v, jnp.asarray(ids), get_kl=True,
                                 method=cls.posterior)
        z = q.loc + q.scale * jnp.asarray(eps)
        h = module.apply(v, jnp.asarray(ids), z,
                         method=cls.reconstruct_hidden)
        labels = TransformerLanguageModel.shifted_labels(jnp.asarray(ids))
        nll_sum, count = module.apply(v, h, labels,
                                      method=cls.sequence_nll)
        kl_sum, raw_sum, rows = j_kl_sums(raw_kl, jnp.asarray(num_tokens))
        sums = {"nll_sum": nll_sum, "kl_sum": kl_sum, "raw_kl_sum": raw_sum}
        loss, _ = jobj.compose_loss(
            sums, {"token_count": count, "row_count": rows}, ELBO_STEP)
        return loss, (nll_sum, count, kl_sum, raw_sum)

    (loss, sums), grads = jax.value_and_grad(jax_loss, has_aux=True)(params)
    return float(loss), sums, _leaf_grads(grads)


def _port_elbo(model, ids, num_tokens, eps):
    """The port's loss and sums; leaves the gradients on the model."""
    model.zero_grad(set_to_none=True)
    objective = VAEObjective(model.hparams)
    batch = {"token_ids": torch.from_numpy(ids),
             "num_tokens": torch.from_numpy(num_tokens)}
    sums, counts = objective.loss_sums(model, batch,
                                       {"eps": torch.from_numpy(eps)})
    loss, _ = objective.compose_loss(sums, counts, ELBO_STEP)
    loss.backward()
    return loss.item(), (sums["nll_sum"], counts["token_count"],
                         sums["kl_sum"], sums["raw_kl_sum"])


@pytest.fixture(scope="module")
def r5_elbo_fp32(r5_pair):
    """JAX's fp32 ELBO of r5 on `_elbo_inputs`: (loss, sums, grads)."""
    module, params, _ = r5_pair
    return _jax_elbo(module, params, *_elbo_inputs())


def test_r5_elbo_and_every_gradient_match_jax(r5_pair, r5_elbo_fp32):
    """Full-width r5 in fp32 on tokens [2, 512] with ragged lengths and the
    same eps: (nll_sum, count, kl_sum, raw_kl_sum) and the gradients of
    all 165 parameters of the ELBO at step 100 (KL weight 0.145)."""
    _, _, model = r5_pair
    _, want, grads = r5_elbo_fp32
    _, got = _port_elbo(model, *_elbo_inputs())
    for name, g, w in zip(("nll_sum", "count", "kl_sum", "raw_kl_sum"),
                          got, want):
        np.testing.assert_allclose(g.item(), float(w), rtol=SUM_RTOL,
                                   err_msg=name)
    _assert_grads_match(model, grads)


# The port's bf16 ELBO may be farther from JAX's fp32 one than JAX's bf16
# ELBO is by at most these margins: on the loss's relative error, and on
# the smallest per-parameter gradient cosine (the smallest fall on the
# encoder bottleneck, whose gradients are near zero). On this input JAX's
# bf16 sits 1.8e-4 (loss) and 1 - 0.9936 (cosine) from fp32; the two
# packages round at other places, so either may land nearer by chance,
# and each margin is about half of JAX's own distance.
BF16_LOSS_MARGIN = 1e-4
BF16_COS_MARGIN = 3e-3


def _cosines(grads: dict, want: dict) -> dict:
    out = {}
    for path, w in want.items():
        a, b = grads[path].astype(np.float64), w.astype(np.float64)
        out[path] = float((a * b).sum() / max(
            np.linalg.norm(a) * np.linalg.norm(b), 1e-300))
    return out


def test_r5_bf16_elbo_is_as_close_to_fp32_as_jax_bf16(r5_elbo_fp32):
    """r5 computing in bf16 over fp32 master weights, the form it was
    trained in, in both packages on the inputs of the fp32 test: the
    port's loss and its 165 gradients are no farther from JAX's fp32 ones
    than JAX's bf16 loss and gradients are, within BF16_LOSS_MARGIN on the
    loss's relative error and BF16_COS_MARGIN on the smallest gradient
    cosine."""
    ids, num_tokens, eps = _elbo_inputs()
    loss32, _, grads32 = r5_elbo_fp32
    module, params = jax_r5("bf16")
    jax_loss, _, jax_grads = _jax_elbo(module, params, ids, num_tokens, eps)
    model, _, _ = ckpt.load_run("real-prose-vae-r5", device="cpu",
                                dtype=torch.bfloat16, train=True)
    port_loss, _ = _port_elbo(model, ids, num_tokens, eps)
    port_grads = {}
    named = dict(model.named_parameters())
    for path in grads32:
        key, transpose = ckpt.torch_key(path)
        g = named[key].grad.float().numpy()
        port_grads[path] = g.T if transpose else g
    assert len(port_grads) == len(named) == 165
    jax_rel = abs(jax_loss - loss32) / abs(loss32)
    port_rel = abs(port_loss - loss32) / abs(loss32)
    jax_cos = min(_cosines(jax_grads, grads32).values())
    port_cos = min(_cosines(port_grads, grads32).values())
    assert np.isfinite(port_loss) and port_rel <= jax_rel + BF16_LOSS_MARGIN, \
        (port_rel, jax_rel)
    assert port_cos >= jax_cos - BF16_COS_MARGIN, (port_cos, jax_cos)


def test_r5_perceiver_and_posterior_match_jax(r5_pair):
    """The encoder bottleneck and the posterior (loc, scale, per-dim KL)
    alone, without gradients. Tolerance 2e-5 absolute on O(1) values after
    three Perceiver layers."""
    module, params, model = r5_pair
    cls = type(module)
    rng = np.random.default_rng(1)
    ids, _ = _documents(rng, [512, 77], 512, 32768)
    v = {"params": params}
    want_h = module.apply(v, jnp.asarray(ids), method=cls.encode)
    want_q, want_kl = module.apply(v, jnp.asarray(ids), get_kl=True,
                                   method=cls.posterior)
    with torch.no_grad():
        got_h = model.encode(torch.from_numpy(ids))
        got_q, got_kl = model.posterior(torch.from_numpy(ids), get_kl=True)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), atol=2e-5)
    for g, w in ((got_q.loc, want_q.loc), (got_q.scale, want_q.scale),
                 (got_kl, want_kl)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5)


@pytest.mark.parametrize("lamb", [False, True])
def test_radam_chain_matches_jax_for_eight_steps(lamb):
    """Clip + RAdam (or LAMB) on the cosine schedule for 8 steps, so steps
    5-8 take the rectified branch (rho_t > 4 from step 5). Gradient norms
    straddle the clip threshold, so some steps clip and some do not."""
    rng = np.random.default_rng(2 + lamb)
    shapes = {"w": (6, 5), "b": (5,), "ln": (7,)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: (scale * rng.standard_normal(s)).astype(np.float32)
              for k, s in shapes.items()}
             for scale in (0.3, 2.0, 0.5, 3.0, 0.2, 1.5, 0.7, 2.5)]
    kw = dict(lr=0.05, lr_decay_steps=20, grad_clip_threshold=4.0,
              weight_decay=0.01, lamb=lamb)
    opt = j_make_opt(**kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(jp)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in params.items()}
    topt = make_optimizer(list(tp.values()), **kw)
    for g in grads:
        updates, state = opt.update({k: jnp.asarray(v) for k, v in g.items()},
                                    state, jp)
        jp = {k: jp[k] + updates[k] for k in jp}
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        topt.step()
        for k in shapes:
            np.testing.assert_allclose(tp[k].detach().numpy(),
                                       np.asarray(jp[k]), atol=1e-6,
                                       err_msg=k)
    assert topt.count == 8


def _tiny_hparams():
    return dict(d_model=64, num_heads=2, num_layers=2, latent_depth=8,
                vocab_size=1024, num_encoder_latents=4, attn_window_size=2,
                attn_block_size=8, loss_chunk_size=16, precision="fp32",
                grad_clip_threshold=1.0, lr=3e-3, lr_decay_steps=100,
                kl_annealing_steps=10, kl_weight_start=0.1,
                kl_weight_end=1.0, free_bits=0.02,
                grad_checkpointing=False)


def test_two_microbatch_train_step_matches_jax():
    """One optimizer step over two micro-batches of a tiny random model
    against make_train_step (mesh=None): the metrics (mean over
    micro-batches, grad_norm of the unclipped mean gradient) and every
    parameter after the step. eps and the marginal-KL draws are the ones
    the JAX step draws from its rng. Tolerance: fp32 at a tiny size, 2e-5
    relative on the metrics plus 2e-6 absolute (the mutual information
    is kl - marginal_kl, a difference of O(1) terms, so its rounding is
    absolute), and 1e-6 absolute on the parameters."""
    overrides = _tiny_hparams()
    module, jhp, jobj = build_model("transformer-vae", overrides)
    rng = np.random.default_rng(3)
    mbs = [_documents(rng, lengths, 32, 1024)
           for lengths in ([32, 20, 11], [27, 32, 16])]
    params = module.init({"params": jax.random.PRNGKey(0),
                          "sample": jax.random.PRNGKey(1)},
                         jnp.asarray(mbs[0][0][:1]))["params"]
    leaves = {k: np.array(v) for k, v in _leaf_grads(params).items()}
    optimizer = j_make_opt(lr=jhp.lr, lr_decay_steps=jhp.lr_decay_steps,
                           grad_clip_threshold=jhp.grad_clip_threshold)
    opt_state = optimizer.init(params)
    key, step = jax.random.PRNGKey(5), 3
    batch = {"token_ids": jnp.asarray(np.stack([m[0] for m in mbs])),
             "num_tokens": jnp.asarray(np.stack([m[1] for m in mbs])),
             "num_bytes": jnp.asarray(np.stack([m[1] for m in mbs]))}
    cls = type(module)
    noise = []
    for r, (ids, _) in zip(jax.random.split(key, 2), mbs):
        drop, sample, mi = jax.random.split(r, 3)
        q, _, z = module.apply({"params": params}, jnp.asarray(ids),
                               rngs={"dropout": drop, "sample": sample},
                               method=cls.posterior_and_z)
        eps = (z - q.loc) / q.scale
        mi_eps = jax.random.normal(mi, (jobj.mi_samples, ids.shape[0],
                                        jhp.latent_depth))
        noise.append({"eps": torch.from_numpy(np.array(eps)),
                      "mi": torch.from_numpy(np.array(mi_eps))})
    # The step donates its params and optimizer state.
    step_fn = make_train_step(module, jobj, optimizer, mesh=None)
    new_params, _, metrics = step_fn(params, opt_state, batch, step, key)

    hp = TransformerVAEHparams(**{k: v for k, v in overrides.items()
                                  if k != "grad_checkpointing"})
    model = TransformerVAE(hp)
    model.load_state_dict(ckpt.state_from_leaves(leaves, hp), strict=True)
    topt = make_optimizer(model.parameters(), lr=hp.lr,
                          lr_decay_steps=hp.lr_decay_steps,
                          grad_clip_threshold=hp.grad_clip_threshold)
    got = train_step(model, VAEObjective(hp), topt,
                     [{"token_ids": torch.from_numpy(ids),
                       "num_tokens": torch.from_numpy(n)}
                      for ids, n in mbs], step, noise)
    for name in ("loss", "train_nll", "train_kl", "kl_weight",
                 "train_mc_mutual_info", "grad_norm"):
        np.testing.assert_allclose(got[name].item(), float(metrics[name]),
                                   rtol=2e-5, atol=2e-6, err_msg=name)
    named = dict(model.named_parameters())
    for path, want in _leaf_grads(new_params).items():
        key_, transpose = ckpt.torch_key(path)
        p = named[key_].detach().numpy()
        np.testing.assert_allclose(p.T if transpose else p, want, atol=1e-6,
                                   err_msg=path)


def test_multi_sample_training_with_experts_still_raises():
    """train_mc_samples > 1 is ported (tests/test_torch_eval*.py); with
    a mixture-of-experts decoder it still raises, naming the unported
    module."""
    hp = TransformerVAEHparams(train_mc_samples=4, num_experts=4)
    with pytest.raises(NotImplementedError, match="models/moe.py"):
        VAEObjective(hp)


def test_kl_sums_and_normalized_kl_match_jax():
    """Per-document KL normalisation with a filler row (num_tokens 0) that
    must count nowhere. Tolerance 1e-6 relative: fp32 sums of 3 x 64
    terms."""
    from sparse_vae_tpu.models.vae import normalized_kl as j_normalized
    from sparse_vae_tpu_torch.models.vae import kl_sums, normalized_kl
    rng = np.random.default_rng(4)
    raw = rng.random((3, 1, 64)).astype(np.float32)
    tokens = np.array([512, 0, 77])
    want = j_kl_sums(jnp.asarray(raw), jnp.asarray(tokens))
    got = kl_sums(torch.from_numpy(raw), torch.from_numpy(tokens))
    np.testing.assert_allclose([g.item() for g in got],
                               [float(w) for w in want], rtol=1e-6)
    want = j_normalized(jnp.asarray(raw), jnp.asarray(tokens))
    got = normalized_kl(torch.from_numpy(raw), torch.from_numpy(tokens))
    np.testing.assert_allclose([g.item() for g in got],
                               [float(w) for w in want], rtol=1e-6)


def test_full_logits_and_chunked_elbo_agree():
    """The objective's two forwards (full logits through `forward`, and
    `forward_chunked_nll`) give the same sums on a tiny model with the
    same eps. Tolerance 1e-5 relative: fp32 sums over 96 tokens."""
    hp = TransformerVAEHparams(**{k: v for k, v in _tiny_hparams().items()
                                  if k != "grad_checkpointing"})
    torch.manual_seed(0)
    model = TransformerVAE(hp)
    rng = np.random.default_rng(5)
    ids, n = _documents(rng, [32, 20, 9], 32, 1024)
    batch = {"token_ids": torch.from_numpy(ids),
             "num_tokens": torch.from_numpy(n)}
    noise = {"eps": torch.randn(3, 1, 8), "mi": torch.randn(10, 3, 8)}
    with torch.no_grad():
        chunked, counts = VAEObjective(hp).loss_sums(model, batch, noise)
        hp.loss_chunk_size = 0
        full, full_counts = VAEObjective(hp).loss_sums(model, batch, noise)
    for name in chunked:
        np.testing.assert_allclose(full[name].item(), chunked[name].item(),
                                   rtol=1e-5, err_msg=name)
    assert full_counts["token_count"].item() == counts["token_count"].item()


def test_train_entry_point_runs_on_the_cpu(capsys):
    """`python -m sparse_vae_tpu_torch.train` at a small size on the CPU:
    one step of r5 on random documents, one JSON line of finite
    metrics."""
    import json

    from sparse_vae_tpu_torch import train
    assert train.main(["train", "transformer-vae", "real-prose-vae-r5",
                       "steps=1", "batch=2", "seq=512", "accumulate=1",
                       "device=cpu"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["step"] == 0 and line["tokens"] == 1024
    assert all(np.isfinite(line[k]) for k in ("loss", "grad_norm"))
