"""The LSTM family of the port (models/lstm_lm.py, models/lstm_vae.py, the
LSTM leaves of checkpoint.py and models/init.py's init_scale=None) against
the JAX package (sparse_vae_tpu/models/lstm_lm.py, lstm_vae.py) on the
CPU, on tiny JAX-initialised models carried across by
`checkpoint.params_from_numpy`, with numpy-seeded inputs.

No LSTM run has trained weights in the repository, so the models are
JAX-initialised; runs/arch-test/ckpt_bf16.npz (a 3-step tiny lstm-lm the
JAX archive tool wrote) checks the archive layout. Sampled runs replay
JAX's draws: its per-step key splits as the Gumbel noise of the lockstep
loop, its draft keys as the draft's noise, and `JaxPasses` (of
tests/test_torch_spec_decode.py) as the speculative loop's.

Tolerances: logits, posteriors, log-likelihoods and states 2e-5 (fp32 at
tiny widths, measured at ~1e-6); q_logp 2e-5; sampled tokens, drafts,
passes and accepted counts exact; initialisation statistics as
tests/test_torch_init.py states them.

Worker time: about 150 s in one process, most of it JAX's compiles of
its scans and decode loops.
"""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze
from flax.traverse_util import flatten_dict, unflatten_dict

from sparse_vae_tpu.models import generation as jgen
from sparse_vae_tpu.models.lstm_lm import LSTMLanguageModel as JLM
from sparse_vae_tpu.models.lstm_lm import LSTMLanguageModelHparams as JLMHp
from sparse_vae_tpu.models.lstm_vae import LSTMVAE as JVAE
from sparse_vae_tpu.models.lstm_vae import LSTMVAEHparams as JVAEHp
from sparse_vae_tpu_torch import checkpoint as ckpt
from sparse_vae_tpu_torch.models import generation as tgen
from sparse_vae_tpu_torch.models.lstm_lm import (LSTMLanguageModel,
                                                 LSTMLanguageModelHparams)
from sparse_vae_tpu_torch.models.lstm_vae import LSTMVAE, LSTMVAEHparams
from sparse_vae_tpu_torch.ops.cross_entropy import sequence_log_likelihood
from tests.test_torch_spec_decode import JaxPasses
from tests.test_torch_spec_decode import pair as transformer_pair

TOL = 2e-5
VOCAB = 64
GREEDY, J_GREEDY = tgen.SamplingParams(top_k=1), jgen.SamplingParams(top_k=1)
NUCLEUS, J_NUCLEUS = tgen.SamplingParams(), jgen.SamplingParams()


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def leaves(params) -> dict:
    return {k: np.asarray(v) for k, v in
            flatten_dict(unfreeze(params), sep="/").items()}


def lm_pair(seed: int = 0, **over):
    """(JAX module, params, the port's LSTM LM with them in eval form)."""
    cfg = {"vocab_size": VOCAB, "d_embedding": 8, "d_model": 16, **over}
    module = JLM(JLMHp(**cfg))
    params = module.init(jax.random.PRNGKey(seed),
                         jnp.ones((1, 8), jnp.int32))["params"]
    hp = LSTMLanguageModelHparams(**cfg)
    model = LSTMLanguageModel(hp)
    model.load_state_dict(ckpt.params_from_numpy(leaves(params), hp),
                          strict=True)
    return module, params, model.eval().requires_grad_(False)


def vae_pair(seed: int = 0, **over):
    cfg = {"vocab_size": VOCAB, "d_embedding": 64, "d_model": 32,
           "latent_depth": 4, **over}
    module = JVAE(JVAEHp(**cfg))
    params = module.init({"params": jax.random.PRNGKey(seed),
                          "sample": jax.random.PRNGKey(seed + 1)},
                         jnp.ones((1, 8), jnp.int32))["params"]
    hp = LSTMVAEHparams(**cfg)
    model = LSTMVAE(hp)
    model.load_state_dict(ckpt.params_from_numpy(leaves(params), hp),
                          strict=True)
    return module, params, model.eval().requires_grad_(False)


def documents(seed: int, lengths, width: int = 16, vocab: int = VOCAB):
    """[CLS] ids [SEP] rows of the given lengths, PAD after; a length of 0
    is a filler row of PAD only."""
    rng = np.random.default_rng(seed)
    ids = np.zeros((len(lengths), width), np.int64)
    for row, n in enumerate(lengths):
        if n:
            ids[row, :n] = np.r_[1, rng.integers(3, vocab, size=n - 2), 2]
    return ids


def close(got, want, tol=TOL, what=""):
    np.testing.assert_allclose(
        got.detach().numpy() if torch.is_tensor(got) else got,
        np.asarray(want), rtol=tol, atol=tol, err_msg=what)


LM_FORMS = {"tied": {"tie_logit_weights": True},
            "untied-2": {"num_layers": 2},
            "gru-tied-2": {"rnn_type": "GRU", "num_layers": 2,
                           "tie_logit_weights": True}}
VAE_FORMS = {
    "bilstm-2": {"bidirectional_encoder": True, "num_layers": 2,
                 "tie_logit_weights": True},
    "unidirectional": {},
    "perceiver-untied-embeddings": {"transformer_encoder": True,
                                    "tie_embedding_weights": False},
    "bilstm-untied-logits": {"bidirectional_encoder": True,
                             "tie_logit_weights": False},
    "perceiver-2-vectors": {"transformer_encoder": True,
                            "num_latent_vectors": 2}}


# -- the language model -----------------------------------------------------

@pytest.mark.parametrize("form", sorted(LM_FORMS))
def test_lm_logits_and_decode_steps_match_jax(form):
    """The teacher-forced logits on ragged rows at 2e-5 of JAX's; decode
    steps from `initial_rnn_state` give the same logits position by
    position."""
    module, params, model = lm_pair(1, **LM_FORMS[form])
    ids = documents(2, [16, 9, 3])
    want = module.apply({"params": params}, jnp.asarray(ids))
    got = model(torch.from_numpy(ids))
    close(got, want)
    states = model.initial_rnn_state(3)
    for t in range(ids.shape[1]):
        logits, states = model.decode_step(torch.from_numpy(ids[:, t]),
                                           states)
        close(logits, got[:, t].numpy(), what=f"step {t}")


def _replayed_noise(rng, steps, b, v=VOCAB):
    """JAX `sample`'s per-step Gumbel noise: its decode key split each
    step into (carry, sample key)."""
    out = []
    for _ in range(steps):
        rng, sample_rng = jax.random.split(rng)
        out.append(torch.from_numpy(np.array(jax.random.gumbel(
            sample_rng, (b, v), jnp.float32))))
    return out


def _feed_noise(monkeypatch, noise):
    """Hand the lockstep loop `noise` in order in place of its draws."""
    it = iter(noise)
    monkeypatch.setattr(tgen, "gumbel_noise", lambda shape, rng: next(it))


@pytest.mark.parametrize("form", ["tied", "gru-tied-2"])
@pytest.mark.parametrize("mode", ["greedy", "sampled"])
def test_lm_sample_matches_jax(form, mode, monkeypatch):
    """`sample` at batch 3 x 24, top_k 1 or temperature 1, top_p 0.9 and
    penalty 1.2 with JAX's per-step draws: JAX's tokens, token for
    token."""
    module, params, model = lm_pair(3, **LM_FORMS[form])
    key = jax.random.PRNGKey(4)
    sampling, j_sampling = ((GREEDY, J_GREEDY) if mode == "greedy"
                            else (NUCLEUS, J_NUCLEUS))
    want = module.apply({"params": params}, key, 24, 3, j_sampling,
                        method=JLM.sample)
    _feed_noise(monkeypatch, _replayed_noise(key, 24, 3))
    got = model.sample(0, 24, 3, sampling)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    if mode == "sampled":
        assert len(set(np.asarray(want).ravel().tolist())) > 4


class JaxDraft:
    """draft_propose's step i on JAX keys: categorical(split(key, k +
    1)[i], logp) is argmax(logp + gumbel(that key))."""

    def __init__(self, key, k):
        self.keys = jax.random.split(key, k + 1)

    def gumbel(self, i, shape):
        return torch.from_numpy(np.array(jax.random.gumbel(
            self.keys[i], tuple(shape), jnp.float32)))


@pytest.mark.parametrize("form", ["tied", "gru-tied-2"])
def test_draft_propose_matches_jax(form):
    """From the state after 5 consumed tokens, 4 drafts at batch 2:
    drafts exact, q_logp at 2e-5, and each entry of the state stack
    (`select(j)`) at 2e-5 of JAX's stacked state j."""
    module, params, model = lm_pair(5, **LM_FORMS[form])
    prefix = documents(6, [6, 6])[:, :6]
    states = model.initial_rnn_state(2)
    j_states = module.apply({"params": params}, 2,
                            method=JLM.initial_rnn_state)
    for t in range(5):
        _, states = model.decode_step(torch.from_numpy(prefix[:, t]), states)
        _, j_states = module.apply({"params": params},
                                   jnp.asarray(prefix[:, t]), j_states,
                                   method=JLM.decode_step)
    key, k = jax.random.PRNGKey(7), 4
    j_drafts, j_q, j_stack = module.apply(
        {"params": params}, j_states, jnp.asarray(prefix[:, 5]), key, k,
        method=JLM.draft_propose)
    drafts, q_logp, stack = model.draft_propose(
        states, torch.from_numpy(prefix[:, 5]), JaxDraft(key, k), k)
    np.testing.assert_array_equal(drafts.numpy(), np.asarray(j_drafts))
    close(q_logp, j_q)
    for j in range(k + 1):
        got = jax.tree_util.tree_leaves(stack.select(j))
        want = [leaf[j] for leaf in jax.tree_util.tree_leaves(j_stack)]
        for g, w in zip(got, want):
            close(g, w, what=f"state {j}")


@functools.lru_cache(maxsize=None)
def _lstm_draft():
    return lm_pair(8, d_model=16, num_layers=1)


@pytest.mark.parametrize("target", ["lm", "vae"])
@pytest.mark.parametrize("mode", ["greedy", "sampled"])
def test_lstm_draft_in_speculative_decoding_matches_jax(target, mode):
    """A one-layer LSTM LM drafting k = 4 for a tiny sparse transformer
    target over 32 positions (the JAX package's
    tests/test_spec_decode.py LSTM-draft cases), with JAX's per-pass
    draws: tokens, passes and accepted drafts exactly JAX's; greedy also
    the target's greedy `sample`."""
    module, params, model = transformer_pair(vae=target == "vae")
    dmod, dparams, dmodel = _lstm_draft()
    greedy = tgen.SamplingParams(temperature=0.0, repetition_penalty=1.2)
    sampling, j_sampling = (
        (greedy, jgen.SamplingParams(temperature=0.0,
                                     repetition_penalty=1.2))
        if mode == "greedy" else (NUCLEUS, J_NUCLEUS))
    k, length, key = 4, 32, jax.random.PRNGKey(13)

    def j_propose(state, last, rng):
        return dmod.apply({"params": dparams}, state, last, rng, k,
                          method=JLM.draft_propose)

    j_init = dmod.apply({"params": dparams}, 1,
                        method=JLM.initial_rnn_state)
    zs, tzs, noise_key = (), (), key
    if target == "vae":
        z = np.random.default_rng(0).standard_normal(
            (1, 1, model.hparams.latent_depth)).astype(np.float32)
        zs, tzs = (jnp.asarray(z),), (torch.from_numpy(z),)
        noise_key = jax.random.split(key)[1]
    want, want_it, want_acc = module.apply(
        {"params": params}, key, length, j_propose, j_init, *zs,
        sampling=j_sampling, draft_k=k,
        method=type(module).spec_draft_generate)
    got, it, acc = model.spec_draft_generate(
        0, length, lambda s, last, n: dmodel.draft_propose(s, last, n, k),
        dmodel.initial_rnn_state(1), *tzs, sampling=sampling, draft_k=k,
        noise=JaxPasses(noise_key, k))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (it, acc) == (int(want_it), int(want_acc))
    if mode == "greedy":
        assert torch.equal(got, model.sample(0, length, 1, *tzs, sampling))


# -- the VAE ------------------------------------------------------------------

@pytest.mark.parametrize("form", sorted(VAE_FORMS))
def test_vae_posterior_logits_and_ll_match_jax(form):
    """On ragged rows with a filler row of PAD only: the posterior's loc,
    scale and KL, the logits of `reconstruct` and `reconstruct_ll` (in
    chunks of 5) at 2e-5 of JAX's; `reconstruct_ll` at 2e-5 of the full
    logits' sequence log-likelihood, and the decode steps from z at 2e-5
    of `reconstruct`'s logits position by position."""
    module, params, model = vae_pair(9, **VAE_FORMS[form])
    ids = documents(10, [16, 7, 2, 0])
    z = np.random.default_rng(11).standard_normal(
        (4, model.hparams.latent_depth)).astype(np.float32)

    @jax.jit
    def jax_all(tokens, zz):
        v = {"params": params}
        q, kl = module.apply(v, tokens, get_kl=True, method=JVAE.posterior)
        return (q.loc, q.scale, kl,
                module.apply(v, tokens, zz, method=JVAE.reconstruct),
                module.apply(v, tokens, zz, 5, method=JVAE.reconstruct_ll))

    loc, scale, kl, want_logits, want_ll = jax_all(jnp.asarray(ids),
                                                   jnp.asarray(z))
    tq, tkl = model.posterior(torch.from_numpy(ids), get_kl=True)
    close(tq.loc, loc, what="loc")
    close(tq.scale, scale, what="scale")
    close(tkl, kl, what="kl")
    zt = torch.from_numpy(z)
    logits = model.reconstruct(torch.from_numpy(ids), zt)
    close(logits, want_logits, what="logits")
    ll = model.reconstruct_ll(torch.from_numpy(ids), zt, chunk_size=5)
    close(ll, want_ll, what="ll")
    close(ll, sequence_log_likelihood(logits[:, :-1],
                                      torch.from_numpy(ids[:, 1:])),
          what="ll vs logits")
    states = model._decoder_init(zt)
    for t in range(ids.shape[1]):
        step, states = model.decode_step(torch.from_numpy(ids[:, t]), states,
                                         zt)
        close(step, logits[:, t].numpy(), what=f"step {t}")


@pytest.mark.parametrize("mode", ["greedy", "sampled"])
def test_vae_sample_matches_jax(mode, monkeypatch):
    """`sample` from a given z at batch 2 x 24 with JAX's per-step draws
    (its decode key: the second of split(rng)): JAX's tokens."""
    module, params, model = vae_pair(12, bidirectional_encoder=True,
                                     tie_logit_weights=True)
    z = np.random.default_rng(13).standard_normal((2, 4)).astype(np.float32)
    key = jax.random.PRNGKey(14)
    sampling, j_sampling = ((GREEDY, J_GREEDY) if mode == "greedy"
                            else (NUCLEUS, J_NUCLEUS))
    want = module.apply({"params": params}, key, 24, 2, jnp.asarray(z),
                        j_sampling, method=JVAE.sample)
    _feed_noise(monkeypatch, _replayed_noise(jax.random.split(key)[1], 24,
                                             2))
    got = model.sample(0, 24, 2, torch.from_numpy(z), sampling)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_vae_sample_draws_z_from_the_seed():
    """Without z the prior draw is the seed's: two calls agree, another
    seed differs, and a given z [B, 1, latent] reads as [B, latent]."""
    _, _, model = vae_pair(15)
    a, b = model.sample(3, 12, 2), model.sample(3, 12, 2)
    assert torch.equal(a, b) and not torch.equal(a, model.sample(4, 12, 2))
    z = tgen.prior_z(3, 2, 4, "cpu")
    assert torch.equal(model.sample(3, 12, 2, z), a)


# -- initialisation and archives ----------------------------------------------

INIT_CASES = {
    "lstm-vae-benchmark-widths": (
        "lstm-vae", {"d_model": 256, "d_embedding": 128, "latent_depth": 32,
                     "vocab_size": 2048, "bidirectional_encoder": True,
                     "num_layers": 2, "tie_logit_weights": True,
                     "init_scale": None}),
    "lstm-vae-perceiver": (
        "lstm-vae", {"d_model": 256, "d_embedding": 128, "latent_depth": 32,
                     "vocab_size": 2048, "transformer_encoder": True,
                     "tie_embedding_weights": False, "init_scale": None}),
    "lstm-lm-draft-scale": (
        "lstm-lm", {"d_model": 256, "d_embedding": 128, "num_layers": 2,
                    "vocab_size": 2048, "tie_logit_weights": True,
                    "init_scale": 0.02}),
    "lstm-lm-gru-untied": (
        "lstm-lm", {"d_model": 256, "d_embedding": 128, "rnn_type": "GRU",
                    "vocab_size": 2048, "init_scale": None}),
}


def _jax_init(experiment: str, cfg: dict) -> dict:
    if experiment == "lstm-lm":
        module = JLM(JLMHp(**cfg))
        rngs = jax.random.PRNGKey(0)
    else:
        module = JVAE(JVAEHp(**cfg))
        rngs = {"params": jax.random.PRNGKey(0),
                "sample": jax.random.PRNGKey(1)}
    return leaves(module.init(rngs, jnp.ones((1, 8), jnp.int32))["params"])


@pytest.mark.parametrize("case", sorted(INIT_CASES))
def test_init_statistics_match_jax_per_leaf(case):
    """models/init.py against JAX's model.init, leaf by leaf: constant
    leaves equal, random ones with the same mean and standard deviation
    up to six standard errors (tests/test_torch_init.py's rule)."""
    experiment, cfg = INIT_CASES[case]
    want_leaves = _jax_init(experiment, cfg)
    hp_cls = ckpt.FAMILIES[experiment][0]
    model, _ = ckpt.model_from_hparams(hp_cls(**cfg),
                                       torch.Generator().manual_seed(0),
                                       device="cpu", train=True)
    named = dict(model.named_parameters())
    assert len(want_leaves) == len(named)
    for path, want in want_leaves.items():
        key, transpose = ckpt.torch_key(path)
        got = named[key].detach().numpy()
        got = got.T if transpose else got
        assert got.shape == want.shape, path
        n = want.size
        if want.std() == 0:
            assert got.std() == 0 and got.mean() == want.mean(), path
            continue
        s = float(want.std())
        assert abs(got.mean() - want.mean()) <= 6 * s * np.sqrt(2 / n), path
        assert abs(got.std() / s - 1) <= 6 / np.sqrt(n), path


def test_rnn_matrices_take_their_fan_in_from_the_gates():
    """flax's lecun_normal over a [4H, in] array takes fan_in from axis
    -2: the decoder's w_ih_0 at H 256, in 160 has standard deviation
    1 / sqrt(1024) = 0.03125, not 1 / sqrt(160); truncated at two of
    them. JAX's and the port's, each within 2%."""
    experiment, cfg = INIT_CASES["lstm-vae-benchmark-widths"]
    model, _ = ckpt.model_from_hparams(LSTMVAEHparams(**cfg),
                                       torch.Generator().manual_seed(1),
                                       device="cpu")
    w = model.decoder.w_ih_0.numpy()
    want = _jax_init(experiment, cfg)["decoder/w_ih_0"]
    assert w.shape == want.shape == (1024, 160)
    for arr in (w, want):
        assert abs(arr.std() / 0.03125 - 1) < 0.02
        assert np.abs(arr).max() <= 2 * 0.03125 / 0.8796256610342398 + 1e-7


def _jax_params_of_archive(path) -> dict:
    with np.load(path) as npz:
        flat = ckpt.decode_leaves({k: npz[k] for k in npz.files})
    return unflatten_dict({tuple(k.split("/")): jnp.asarray(v)
                           for k, v in flat.items()})


def test_the_arch_test_archive_loads_and_matches_jax():
    """runs/arch-test/ckpt_bf16.npz (the JAX archive tool's export of a
    3-step lstm-lm, meta in ckpt_meta.json): every leaf loads strictly,
    and the port's logits equal JAX's apply on the same decoded leaves
    at 2e-5."""
    run = ckpt.REPO_ROOT / "runs" / "arch-test"
    meta = json.loads((run / "ckpt_meta.json").read_text())["meta"]
    hp = ckpt.hparams_from_meta(meta)
    assert isinstance(hp, LSTMLanguageModelHparams) and hp.init_scale is None
    with np.load(run / "ckpt_bf16.npz") as npz:
        state = ckpt.params_from_numpy({k: npz[k] for k in npz.files}, hp)
    model = LSTMLanguageModel(hp)
    model.load_state_dict(state, strict=True)
    params = _jax_params_of_archive(run / "ckpt_bf16.npz")
    ids = documents(16, [24, 11], width=24, vocab=hp.vocab_size)
    want = JLM(JLMHp(**meta["model_hparams"])).apply(
        {"params": params}, jnp.asarray(ids))
    with torch.no_grad():
        close(model(torch.from_numpy(ids)), want)


@pytest.mark.parametrize("experiment,form", [
    ("lstm-vae", "bilstm-2"), ("lstm-vae", "perceiver-untied-embeddings"),
    ("lstm-lm", "gru-tied-2"), ("lstm-lm", "untied-2")])
def test_export_archive_round_trips_into_jax(experiment, form, tmp_path):
    """export_archive of a port model, then JAX's apply on the archive's
    decoded leaves (the exact leaf set of JAX's own init) equals the
    port's load_run of it at 2e-5; load_run's model computes in fp32,
    and use_kernels=False puts its RNNs on the step loop."""
    if experiment == "lstm-vae":
        module, params, model = vae_pair(17, **VAE_FORMS[form])
        cfg = {**model.hparams.__dict__}
    else:
        module, params, model = lm_pair(17, **LM_FORMS[form])
        cfg = {**model.hparams.__dict__}
    meta = {"experiment": experiment, "name": "tiny", "model_hparams": cfg}
    out = ckpt.export_archive(model, meta, tmp_path / "run", step=3)
    jparams = _jax_params_of_archive(out / "ckpt_bf16.npz")
    assert set(leaves(jparams)) == set(leaves(params))
    served, hp, _ = ckpt.load_run(str(out), device="cpu")
    assert type(hp) is type(model.hparams)
    assert next(served.parameters()).dtype == torch.float32
    plain, _, _ = ckpt.load_run(str(out), device="cpu", use_kernels=False,
                                train=True)
    assert plain.compute_dtype == torch.float32
    assert all(m.step_loop for m in plain.modules()
               if type(m).__name__ == "StackedRNN")
    ids = documents(18, [16, 5])
    v = {"params": jparams}
    if experiment == "lstm-vae":
        z = np.random.default_rng(19).standard_normal((2, 4)).astype(
            np.float32)
        want = module.apply(v, jnp.asarray(ids), jnp.asarray(z),
                            method=JVAE.reconstruct)
        with torch.no_grad():
            got = served.reconstruct(torch.from_numpy(ids),
                                     torch.from_numpy(z))
            loop = plain.reconstruct(torch.from_numpy(ids),
                                     torch.from_numpy(z))
    else:
        want = module.apply(v, jnp.asarray(ids))
        with torch.no_grad():
            got = served(torch.from_numpy(ids))
            loop = plain(torch.from_numpy(ids))
    close(got, want)
    close(loop, want)
