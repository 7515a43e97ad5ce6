"""The port's lockstep sampling (models/generation.py `DecodeState`,
`process_logits`, `decode_loop`; `sample`, `sample_resumable` and
`decode_step_z` of both transformer families) against the JAX package
on the CPU, on the archived weights of real-prose-vae-r5 and
draft-tlm-r5 in fp32 and on tiny JAX-initialised models.

Tolerances: token buffers, positions and liveness are exact (token for
token); penalised logits 1e-6 relative (a divide or a multiply of the
same fp32 value). The JAX streams never agree with torch's, so a sampled
run replays JAX's per-step key splits as Gumbel noise handed to the
port's `process_logits(noise=...)`, and z is passed to both. The port
selects nucleus-only tokens through K4 by default (its plain version on
the CPU); the sampled parity pins `fused=False`, the bisection of the
JAX package's default path.

Worker time: about 50 s in one process (most of it JAX's compiles of
r5's decode loop).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_vae_tpu.models import generation as jgen
from sparse_vae_tpu_torch import checkpoint as ckpt
from sparse_vae_tpu_torch.models import generation as tgen
from sparse_vae_tpu_torch.models.transformer_lm import (
    TransformerHparams, TransformerLanguageModel)
from sparse_vae_tpu_torch.models.transformer_vae import (
    TransformerVAE, TransformerVAEHparams)
from tests.test_torch_checkpoint import (jax_params_from_archive, jax_r5,
                                         torch_r5)
from tests.test_torch_eval_train import _jax_params_of
from tests.test_torch_lm import RUN as LM_RUN, _archive, _jax_lm

GREEDY, J_GREEDY = tgen.SamplingParams(top_k=1), jgen.SamplingParams(top_k=1)
NUCLEUS, J_NUCLEUS = tgen.SamplingParams(), jgen.SamplingParams()


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread runs these batch-2 decodes about as fast and
    leaves the suite's other workers their cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def r5():
    module, params = jax_r5()
    return module, params, torch_r5()


def _z(b, latent=64, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (b, 1, latent)).astype(np.float32)


def _jax_sample(module, params, *args, **kw):
    return np.asarray(module.apply({"params": params}, *args,
                                   method=type(module).sample, **kw))


# -- the archived runs, token for token -------------------------------------

def test_greedy_sample_matches_jax_on_r5(r5):
    """Batch 2 x max_length 48, top_k 1 with the repetition penalty 1.2,
    an explicit z: `sample` token for token JAX's."""
    module, params, model = r5
    z = _z(2)
    want = _jax_sample(module, params, jax.random.PRNGKey(0), 48, 2,
                       jnp.asarray(z), J_GREEDY)
    got = model.sample(0, 48, 2, torch.from_numpy(z), GREEDY)
    assert got.shape == (2, 47)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != 0).sum() > 40


def test_greedy_sample_matches_jax_on_draft():
    module, _ = _jax_lm()
    params = jax_params_from_archive(_archive())
    model, _, _ = ckpt.load_run(LM_RUN, device="cpu", dtype=torch.float32)
    want = _jax_sample(module, params, jax.random.PRNGKey(0), 48, 2,
                       J_GREEDY)
    got = model.sample(0, 48, 2, GREEDY)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != 0).sum() > 40


def _replayed_noise(rng, steps, b, v):
    """JAX `sample`'s per-step Gumbel noise: its decode key (the second
    of split(rng) for the VAE) split each step into (carry, sample key),
    and categorical(sample key) = argmax(logits + gumbel(sample key))."""
    out = []
    for _ in range(steps):
        rng, sample_rng = jax.random.split(rng)
        out.append(torch.from_numpy(np.array(jax.random.gumbel(
            sample_rng, (b, v), jnp.float32))))
    return out


def test_sampled_run_replays_jax_noise_on_r5(r5):
    """Temperature 1, top_p 0.9, penalty 1.2 on r5 at batch 2 x 48: the
    port's lockstep steps (decode_step_z, process_logits) fed JAX's
    per-step noise give JAX's sample token for token."""
    module, params, model = r5
    b, ml = 2, 48
    z = _z(b, seed=1)
    key = jax.random.PRNGKey(3)
    want = _jax_sample(module, params, key, ml, b, jnp.asarray(z),
                       J_NUCLEUS)
    noise = _replayed_noise(jax.random.split(key)[1], ml, b,
                            model.hparams.vocab_size)
    state = tgen.init_decode_state(b, ml, 1, torch.Generator())
    caches = model.init_caches(b, ml)
    zt = torch.from_numpy(z)
    step = 0
    with torch.no_grad():
        while tgen.should_continue(state):
            logits, caches = model.decode_step_z(
                tgen.prev_tokens(state), caches, state.index - 1, zt)
            state = tgen.process_logits(logits, state, NUCLEUS, 2,
                                        fused=False, noise=noise[step])
            step += 1
    np.testing.assert_array_equal(tgen.final_output(state).numpy(), want)
    assert len(set(want[0].tolist())) > 10


# -- the step pieces ---------------------------------------------------------

@pytest.mark.parametrize("index", [1, 17, 30, 39])
@pytest.mark.parametrize("window", [16, 64])
def test_repetition_penalty_matches_jax(index, window):
    """One lookback window for every row, clamped at both ends of a
    40-slot buffer (window 64 is wider than the buffer)."""
    rng = np.random.default_rng(index + window)
    logits = rng.standard_normal((3, 64)).astype(np.float32) * 3
    tokens = rng.integers(0, 64, size=(3, 40))
    want = jgen.apply_repetition_penalty(
        jnp.asarray(logits), jnp.asarray(tokens), jnp.asarray(index), 1.2,
        window)
    got = tgen.apply_repetition_penalty(
        torch.from_numpy(logits), torch.from_numpy(tokens), index, 1.2,
        window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("params", ["greedy", "nucleus", "top_k"])
def test_process_logits_matches_jax(params):
    """Steps through a 12-slot buffer with an end token emitted by one
    row midway and the buffer's end: tokens, index, liveness and
    should_continue as JAX's, the sampled steps on JAX's noise."""
    sp = {"greedy": (GREEDY, J_GREEDY), "nucleus": (NUCLEUS, J_NUCLEUS),
          "top_k": (tgen.SamplingParams(top_k=5, top_p=1.0,
                                        temperature=0.8),
                    jgen.SamplingParams(top_k=5, top_p=1.0,
                                        temperature=0.8))}[params]
    b, ml, v, end = 3, 12, 50, 2
    rng = np.random.default_rng(11)
    j_state = jgen.init_decode_state(b, ml, 1, jax.random.PRNGKey(4))
    t_state = tgen.init_decode_state(b, ml, 1, torch.Generator())
    key = jax.random.PRNGKey(4)
    steps = 0
    while bool(jgen.should_continue(j_state)):
        assert tgen.should_continue(t_state)
        logits = rng.standard_normal((b, v)).astype(np.float32) * 2
        logits[:, end] = 30.0 if steps == 4 else -30.0
        logits[[0, 2], end] = -30.0
        key, sample_key = jax.random.split(key)
        noise = torch.from_numpy(np.array(jax.random.gumbel(
            sample_key, (b, v), jnp.float32)))
        j_state = jgen.process_logits(jnp.asarray(logits), j_state, sp[1],
                                      end)
        t_state = tgen.process_logits(torch.from_numpy(logits), t_state,
                                      sp[0], end, fused=False, noise=noise)
        np.testing.assert_array_equal(t_state.tokens.numpy(),
                                      np.asarray(j_state.tokens))
        np.testing.assert_array_equal(t_state.live.numpy(),
                                      np.asarray(j_state.live))
        assert t_state.index == int(j_state.index)
        steps += 1
    assert not tgen.should_continue(t_state)
    assert steps == ml - 2 and not bool(t_state.live[1])
    np.testing.assert_array_equal(tgen.final_output(t_state).numpy(),
                                  np.asarray(jgen.final_output(j_state)))


def test_decode_step_z_matches_the_rowwise_step():
    """decode_step_z at one index equals decode_step_z_rowwise with every
    row at that index, bit for bit, on a tiny model whose ring (2 blocks
    of 8) wraps three times in 56 positions."""
    model = _tiny_pair("transformer-vae")[2]
    b, ml = 3, 56
    gen = torch.Generator().manual_seed(5)
    z = torch.randn((b, 1, model.hparams.latent_depth), generator=gen)
    toks = torch.randint(3, model.hparams.vocab_size, (ml, b), generator=gen)
    one, rows = model.init_caches(b, ml), model.init_caches(b, ml)
    with torch.no_grad():
        for i in range(ml):
            got, one = model.decode_step_z(toks[i], one, i, z)
            want, rows = model.decode_step_z_rowwise(
                toks[i], rows, torch.full((b,), i), z)
            assert torch.equal(got, want), i


# -- resumable slices --------------------------------------------------------

TINY = dict(d_model=64, num_heads=2, num_layers=2, vocab_size=1024,
            attn_window_size=2, attn_block_size=8)


def _tiny_pair(family: str):
    """A tiny torch-initialised model of `family` (ring of 2 x 8
    positions) and the JAX module with the same parameters."""
    from sparse_vae_tpu import build_model
    torch.manual_seed(3)
    if family == "transformer-vae":
        hp = TransformerVAEHparams(**TINY, latent_depth=8,
                                   num_encoder_latents=4)
        model = TransformerVAE(hp)
        over = {**TINY, "latent_depth": 8, "num_encoder_latents": 4}
    else:
        model = TransformerLanguageModel(TransformerHparams(**TINY))
        over = dict(TINY)
    module, _, _ = build_model(family, {**over, "precision": "fp32",
                                        "grad_checkpointing": False})
    model.eval().requires_grad_(False)
    return module, _jax_params_of(model), model


def _port_slices(model, is_vae, z, ml, b, sampling, cuts):
    state = caches = None
    for steps in cuts:
        if is_vae:
            state, caches, z = model.sample_resumable(
                7, ml, b, z, sampling, end_token=-1, state=state,
                caches=caches, max_steps=steps)
        else:
            state, caches = model.sample_resumable(
                7, ml, b, sampling, end_token=-1, state=state,
                caches=caches, max_steps=steps)
    return state.tokens


def _jax_slices(module, params, is_vae, z, sampling, cuts):
    """JAX's sample_resumable over `cuts`, each slice jitted (slices after
    the first share one compile)."""
    @functools.partial(jax.jit, static_argnums=0)
    def run(steps, state, caches):
        args = (jax.random.PRNGKey(7), 80, 2) + ((z,) if is_vae else ())
        out = module.apply({"params": params}, *args, sampling=sampling,
                           end_token=-1, state=state, caches=caches,
                           max_steps=steps,
                           method=type(module).sample_resumable)
        return out[0], out[1]

    state = caches = None
    for steps in cuts:
        state, caches = run(steps, state, caches)
    return np.asarray(state.tokens)


@pytest.mark.parametrize("family", ["transformer-vae", "transformer-lm"])
def test_sample_resumable_in_three_slices_is_one_shot(family):
    """A tiny model of each family (ring of 2 x 8 positions), 78 positions
    without an end token: three slices of 26 give the one-shot buffer bit
    for bit, sampled (the generator carried in the state) and greedy in
    the port, sampled (the key carried in the state) in JAX; the greedy
    buffer is JAX's."""
    is_vae = family == "transformer-vae"
    module, params, model = _tiny_pair(family)
    b, ml, cuts = 2, 80, [26, 26, 26]
    z = _z(b, model.hparams.latent_depth, 2) if is_vae else None
    zt = None if z is None else torch.from_numpy(z)
    for sampling in (NUCLEUS, GREEDY):
        one = _port_slices(model, is_vae, zt, ml, b, sampling, [None])
        sliced = _port_slices(model, is_vae, zt, ml, b, sampling, cuts)
        assert torch.equal(one, sliced)
        assert int((one[:, 1:-1] != 0).sum()) == b * (ml - 2)
    j_z = None if z is None else jnp.asarray(z)
    np.testing.assert_array_equal(
        _jax_slices(module, params, is_vae, j_z, J_NUCLEUS, cuts),
        _jax_slices(module, params, is_vae, j_z, J_NUCLEUS, [None]))
    np.testing.assert_array_equal(
        one.numpy(), _jax_slices(module, params, is_vae, j_z, J_GREEDY,
                                 [None]))


def test_a_resumed_call_needs_the_first_z():
    model = _tiny_pair("transformer-vae")[2]
    state, caches, z = model.sample_resumable(1, 40, 2, max_steps=5)
    with pytest.raises(ValueError, match="first call's z"):
        model.sample_resumable(1, 40, 2, state=state, caches=caches)
    state, _, z2 = model.sample_resumable(1, 40, 2, z=z, state=state,
                                          caches=caches)
    assert z2 is z and state.index == 39


def test_the_seed_names_z_and_the_noise():
    """z comes from (seed, Z_STREAM) on the CPU whatever the device, the
    noise from (seed, DECODE_STREAM): two calls with one seed agree, and
    a conditional call with the prior's z is the unconditional one."""
    model = _tiny_pair("transformer-vae")[2]
    a = model.sample(9, 30, 3)
    assert torch.equal(a, model.sample(9, 30, 3))
    z = tgen.prior_z(9, 3, model.hparams.latent_depth, "cpu")
    assert torch.equal(a, model.sample(9, 30, 3, z))
    assert not torch.equal(a, model.sample(10, 30, 3))


@pytest.mark.parametrize("path", ["sample", "continuous", "callback",
                                  "unfused", "greedy"])
def test_nucleus_sampling_goes_through_k4_by_default(monkeypatch, path):
    """`sample`, `continuous_batch_sample` and the trainer's callback
    select nucleus-only tokens through K4's wrapper
    (`select_kernel.nucleus_gumbel_argmax`) once a sampled step without
    being asked; fused_select=False and greedy params never reach it."""
    from sparse_vae_tpu_torch.cli import make_sample_fns
    from sparse_vae_tpu_torch.serving import continuous_batch_sample
    shapes = []
    real = tgen.nucleus_gumbel_argmax

    def counted(s, noise, **kw):
        shapes.append(tuple(s.shape))
        return real(s, noise, **kw)

    monkeypatch.setattr(tgen, "nucleus_gumbel_argmax", counted)
    model = _tiny_pair("transformer-lm")[2]
    b, ml = 3, 20
    if path == "continuous":
        continuous_batch_sample(model, 4, b, ml, b, end_token=-1)
    elif path == "callback":
        b = 1
        make_sample_fns("transformer-lm", None, max_len=ml)[0](model, 4)
    else:
        model.sample(4, ml, b, end_token=-1, **{
            "sample": {}, "unfused": {"fused_select": False},
            "greedy": {"sampling": GREEDY}}[path])
    want = 0 if path in ("unfused", "greedy") else ml - 2
    assert shapes == [(b, model.hparams.vocab_size)] * want
