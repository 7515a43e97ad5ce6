"""The port's speculative verification and draft-model speculative
decoding (`decode_chunk` / `commit_chunk` of the attention, the layers
and both transformer families, their per-row forms, `decode_chunk_z`,
`draft_propose` / `draft_init_state` and models/spec_decode.py's
`chunk_speculative_decode` through `spec_draft_generate`; the `sample`
entry's spec_draft=) against the JAX package and against sequential
decode steps on the CPU, on tiny JAX-initialised models carried across by
`checkpoint.params_from_numpy` in fp32 (blocks of 4 in a window of 3:
chunks up to (3 - 1) * 4 + 1 = 9 positions are legal, and 24 positions
wrap the 12-slot ring twice).

A draft-model run draws afresh every pass: `JaxPasses` replays JAX's key
chain (each pass splits its carried key into the draft's, the coins' and
the selection's) as the port's noise source. Tolerances: logits and
caches 2e-5; tokens, passes and accepted counts exact.

Worker time: about 65 s in one process, 80 s in the suite's 6-worker
run; most of it JAX's compiles of its speculative loops.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_vae_tpu.models.generation import SamplingParams as JSampling
from sparse_vae_tpu.models.transformer_lm import \
    TransformerLanguageModel as JLM
from sparse_vae_tpu.ops.attention import Attention as JAttention
from sparse_vae_tpu_torch import sample as sample_entry
from sparse_vae_tpu_torch.data.tokenizer import (tokenizer_cache_path,
                                                 train_tokenizer)
from sparse_vae_tpu_torch.models import spec_decode
from sparse_vae_tpu_torch.models.generation import SamplingParams
from sparse_vae_tpu_torch.ops.attention import Attention
from tests.test_torch_parallel_decode import (  # noqa: F401 (fixtures)
    lm, one_thread, tiny_archives, tiny_pair, vae, z_of)

RING = dict(vocab_size=64, attn_block_size=4, attn_window_size=3)
GREEDY = SamplingParams(temperature=0.0, repetition_penalty=1.2)
J_GREEDY = JSampling(temperature=0.0, repetition_penalty=1.2)


def pair(sparse: bool = True, vae: bool = False, seed: int = 0, **over):
    return tiny_pair(vae=vae, seed=seed,
                     **{**RING, "sparse_self_attention": sparse, **over})


def _tree(caches):
    return [{k: np.asarray(v) for k, v in c.items()} for c in caches]


def _assert_caches(got, want):
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for name in g:
            np.testing.assert_allclose(g[name].numpy(), w[name], rtol=2e-5,
                                       atol=2e-5, err_msg=name)


def _steps(model, tokens, caches, start: int, z=None):
    """Sequential decode steps of tokens [B, T] from position start."""
    out = []
    for i in range(tokens.shape[1]):
        if z is None:
            logits, caches = model.decode_step(tokens[:, i], caches,
                                               start + i)
        else:
            logits, caches = model.decode_step_z(tokens[:, i], caches,
                                                 start + i, z)
        out.append(logits)
    return torch.stack(out, dim=1), caches


# -- the chunk peek and commit ------------------------------------------------

@pytest.mark.parametrize("sparse", [True, False])
def test_chunks_equal_sequential_steps_and_jax(sparse):
    """Four chunks of 6 with full commits over 24 positions (the ring
    wraps twice): the logits at 2e-5 of JAX's and of 24 sequential decode
    steps, and every cache leaf at 2e-5 of both."""
    module, params, model = pair(sparse)
    tokens = np.random.default_rng(1).integers(3, 64, size=(2, 24))
    j_caches = module.apply({"params": params}, 2, 32,
                            method=JLM.init_caches)
    caches = model.init_caches(2, 32)
    got, want = [], []
    for i in range(0, 24, 6):
        jl, jkv = module.apply({"params": params},
                               jnp.asarray(tokens[:, i:i + 6]), j_caches, i,
                               method=JLM.decode_chunk)
        j_caches = module.apply({"params": params}, j_caches, jkv, i, 6,
                                method=JLM.commit_chunk)
        logits, kvs = model.decode_chunk(torch.from_numpy(tokens[:, i:i + 6]),
                                         caches, i)
        caches = model.commit_chunk(caches, kvs, i, 6)
        got.append(logits)
        want.append(np.asarray(jl))
    np.testing.assert_allclose(torch.cat(got, 1).numpy(),
                               np.concatenate(want, 1), rtol=2e-5, atol=2e-5)
    _assert_caches(caches, _tree(j_caches))
    seq, seq_caches = _steps(model, torch.from_numpy(tokens),
                             model.init_caches(2, 32), 0)
    np.testing.assert_allclose(torch.cat(got, 1).numpy(), seq.numpy(),
                               rtol=2e-5, atol=2e-5)
    _assert_caches(caches, [{k: v.numpy() for k, v in c.items()}
                            for c in seq_caches])


@pytest.mark.parametrize("sparse", [True, False])
@pytest.mark.parametrize("m", [0, 2, 5])
def test_partial_commit_is_an_exact_rewind(sparse, m):
    """Peek a chunk of 5 at position 7 without writing the cache, commit m
    of it, go on one step at a time: every later logit and the caches
    equal a run that never saw the rejected tail (m = 0: the caches
    unchanged, bit for bit)."""
    model = pair(sparse)[2]
    rng = np.random.default_rng(2)
    prefix, chunk, cont = (torch.from_numpy(rng.integers(3, 64, size=(1, n)))
                           for n in (7, 5, 6))
    ref = torch.cat([prefix, chunk[:, :m], cont], dim=1)
    want, want_caches = _steps(model, ref, model.init_caches(1, 32), 0)
    _, caches = _steps(model, prefix, model.init_caches(1, 32), 0)
    before = [{k: v.clone() for k, v in c.items()} for c in caches]
    peek, kvs = model.decode_chunk(chunk, caches, 7)
    for c, b in zip(caches, before):
        assert all(torch.equal(c[k], b[k]) for k in c)
    np.testing.assert_allclose(peek[:, :m].numpy(), want[:, 7:7 + m].numpy(),
                               rtol=2e-5, atol=2e-5)
    caches = model.commit_chunk(caches, kvs, 7, m)
    if m == 0:
        for c, b in zip(caches, before):
            assert all(torch.equal(c[k], b[k]) for k in c)
    got, caches = _steps(model, cont, caches, 7 + m)
    np.testing.assert_allclose(got.numpy(), want[:, 7 + m:].numpy(),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("sparse", [True, False])
def test_rowwise_chunk_equals_each_rows_chunk_and_jax(sparse):
    """decode_chunk_rowwise / commit_chunk_rowwise at rows 5, 9 and 14
    (across block boundaries) with commits of 0, 3 and 5: each row equal
    to the scalar chunk at its own start, and to JAX's rowwise pair."""
    jattn = JAttention(d_model=32, num_heads=4, causal=True, sparse=sparse,
                       window_size=3, block_size=4, use_pallas_kernel=False)
    jparams = jattn.init(jax.random.PRNGKey(0), jnp.ones((1, 4, 32)),
                         jnp.ones((1, 4, 32)),
                         method=JAttention.__call__)["params"]
    attn = Attention(32, 4, causal=True, sparse=sparse, window_size=3,
                     block_size=4, use_kernel=False)
    with torch.no_grad():
        for name in ("q_linear", "k_linear", "v_linear", "output_linear"):
            getattr(attn, name).weight.copy_(torch.from_numpy(
                np.asarray(jparams[name]["kernel"]).T.copy()))
            getattr(attn, name).bias.copy_(torch.from_numpy(
                np.asarray(jparams[name]["bias"])))
    c, starts, commits = 5, [5, 9, 14], [0, 3, 5]
    gen = torch.Generator().manual_seed(3)
    x = torch.randn((3, 14 + c, 32), generator=gen)
    cache = attn.init_cache(3, 32)
    with torch.no_grad():
        for r, start in enumerate(starts):
            one = {k: v[r:r + 1] for k, v in cache.items()}
            for i in range(start):
                attn.decode(x[r:r + 1, i:i + 1], one, i)
        xs = torch.stack([x[r, s:s + c] for r, s in enumerate(starts)])
        before = {k: v.clone() for k, v in cache.items()}
        idx = torch.tensor(starts)
        out, kv = attn.decode_chunk_rowwise(xs, cache, idx)
        j_out, j_kv = jattn.apply(
            {"params": jparams}, jnp.asarray(xs.numpy()),
            {k: jnp.asarray(v.numpy()) for k, v in before.items()},
            jnp.asarray(starts, jnp.int32),
            method=JAttention.decode_chunk_rowwise)
        np.testing.assert_allclose(out.numpy(), np.asarray(j_out),
                                   rtol=2e-5, atol=2e-5)
        for r, start in enumerate(starts):
            one = {k: v[r:r + 1].clone() for k, v in before.items()}
            want, want_kv = attn.decode_chunk(xs[r:r + 1], one, start)
            torch.testing.assert_close(out[r:r + 1], want, rtol=2e-5,
                                       atol=2e-5)
        attn.commit_chunk_rowwise(cache, kv, idx, torch.tensor(commits))
        j_cache = jattn.apply(
            {"params": jparams},
            {k: jnp.asarray(v.numpy()) for k, v in before.items()}, j_kv,
            jnp.asarray(starts, jnp.int32), jnp.asarray(commits, jnp.int32),
            method=JAttention.commit_chunk_rowwise)
        _assert_caches([cache], _tree([j_cache]))
        for r, (start, m) in enumerate(zip(starts, commits)):
            one = {k: v[r:r + 1].clone() for k, v in before.items()}
            _, one_kv = attn.decode_chunk(xs[r:r + 1], one, start)
            attn.commit_chunk(one, one_kv, start, m)
            for k in one:
                assert torch.equal(cache[k][r:r + 1], one[k]), (r, k)


def test_chunk_z_equals_sequential_z_steps_and_jax():
    """decode_chunk_z in chunks of 4 with full commits over 12 positions:
    z enters at absolute position 0 only (the first chunk), as in
    decode_step_z; logits at 2e-5 of JAX's and of the sequential steps."""
    module, params, model = pair(vae=True, attn_window_size=2)
    z = z_of(1)
    tokens = np.random.default_rng(5).integers(3, 64, size=(1, 12))
    j_caches = module.apply({"params": params}, 1, 32,
                            method=type(module).init_caches)
    caches = model.init_caches(1, 32)
    got, want = [], []
    for i in range(0, 12, 4):
        jl, jkv = module.apply({"params": params},
                               jnp.asarray(tokens[:, i:i + 4]), j_caches, i,
                               jnp.asarray(z),
                               method=type(module).decode_chunk_z)
        j_caches = module.apply({"params": params}, j_caches, jkv, i, 4,
                                method=type(module).commit_chunk)
        logits, kvs = model.decode_chunk_z(
            torch.from_numpy(tokens[:, i:i + 4]), caches, i,
            torch.from_numpy(z))
        caches = model.commit_chunk(caches, kvs, i, 4)
        got.append(logits)
        want.append(np.asarray(jl))
    got = torch.cat(got, 1)
    np.testing.assert_allclose(got.numpy(), np.concatenate(want, 1),
                               rtol=2e-5, atol=2e-5)
    seq, _ = _steps(model, torch.from_numpy(tokens),
                    model.init_caches(1, 32), 0, torch.from_numpy(z))
    np.testing.assert_allclose(got.numpy(), seq.numpy(), rtol=2e-5,
                               atol=2e-5)


def test_chunk_longer_than_the_ring_allows_raises():
    model = pair()[2]
    with pytest.raises(ValueError, match="exceeds"):
        model.decode_chunk(torch.ones((1, 10), dtype=torch.int64),
                           model.init_caches(1, 32), 3)


# -- the draft's rewind -------------------------------------------------------

class _Gumbel:
    def __init__(self, seed):
        self.gen = torch.Generator().manual_seed(seed)

    def gumbel(self, i, shape):
        return -torch.log(-torch.log(torch.rand(shape, generator=self.gen)
                                     .clamp_(min=1e-38)))


@pytest.mark.parametrize("j", [0, 2, 5])
def test_draft_select_rewinds_a_ring_draft(j):
    """A sparse draft (ring of 2 blocks of 4) that has consumed positions
    0-4 proposes 5 tokens: its 6 steps at positions 5-10 cross into block 2
    and overwrite the ring slots of block 0, still in the band of
    positions 5-7. select(j) gives back caches bit for bit equal to
    sequential steps of the kept tokens."""
    model = pair(attn_window_size=2)[2]
    prefix = torch.from_numpy(np.random.default_rng(6).integers(
        3, 64, size=(1, 6)))
    caches, index = model.draft_init_state(1, 32)
    _, caches = _steps(model, prefix[:, :5], caches, index)
    drafts, q_logp, stack = model.draft_propose((caches, 5), prefix[:, 5],
                                                _Gumbel(0), 5)
    assert drafts.shape == (1, 5) and q_logp.shape == (1, 5, 64)
    caches, index = spec_decode.draft_select(stack, j)
    assert index == 5 + j + 1
    _, want = _steps(model, torch.cat([prefix, drafts[:, :j]], 1),
                     model.init_caches(1, 32), 0)
    for c, w in zip(caches, want):
        for k in c:
            assert torch.equal(c[k], w[k]), k


# -- draft-model speculative decoding, token for token ------------------------

class JaxPasses:
    """chunk_speculative_decode's draws on JAX keys: pass `it` splits the
    carried key into (carry, draft, coin, selection)."""

    def __init__(self, key, k: int):
        self.key, self.k, self.passes = key, k, []

    def fold(self, it: int):
        while len(self.passes) <= it:
            self.key, *keys = jax.random.split(self.key, 4)
            self.passes.append(keys)
        return _JaxPass(*self.passes[it], self.k)


class _JaxPass:
    def __init__(self, draft, coin, select, k):
        self.draft, self.coin, self.select, self.k = draft, coin, select, k

    def fold(self, key: int):
        assert key == spec_decode.DRAFT_KEY
        return _JaxDraft(jax.random.split(self.draft, self.k + 1))

    def uniform(self, key: int, shape):
        assert key == spec_decode.COIN_KEY
        return torch.from_numpy(np.array(jax.random.uniform(
            self.coin, tuple(shape), jnp.float32,
            minval=jnp.finfo(jnp.float32).tiny, maxval=1.0)))

    def gumbel(self, key: int, shape):
        assert key == spec_decode.SELECT_KEY
        return torch.from_numpy(np.array(jax.random.gumbel(
            self.select, tuple(shape), jnp.float32)))


class _JaxDraft:
    """draft_propose's step i: categorical(split(key, k + 1)[i], logp) is
    argmax(logp + gumbel(that key))."""

    def __init__(self, keys):
        self.keys = keys

    def gumbel(self, i: int, shape):
        return torch.from_numpy(np.array(jax.random.gumbel(
            self.keys[i], tuple(shape), jnp.float32)))


@pytest.fixture(scope="module")
def drafts():
    """A dense one-layer LM draft and a sparse one (ring of 2 blocks of 4,
    so 5 draft steps cross block boundaries)."""
    return {"dense": pair(False, num_layers=1, seed=1),
            "sparse": pair(True, num_layers=1, seed=2, attn_window_size=2)}


@pytest.mark.parametrize("target,draft", [("lm", "dense"), ("lm", "sparse"),
                                          ("vae", "sparse")])
@pytest.mark.parametrize("mode", ["greedy", "sampled"])
def test_spec_draft_generate_matches_jax(target, draft, mode, drafts):
    """spec_draft_generate with k = 4 over 40 positions, an LM target
    with each draft and a VAE target with the sparse one: the tokens, the
    pass count and the accepted count JAX's; greedy also the greedy
    `sample`."""
    module, params, model = pair(vae=target == "vae")
    dmod, dparams, dmodel = drafts[draft]
    sampling, j_sampling = ((GREEDY, J_GREEDY) if mode == "greedy"
                            else (SamplingParams(), JSampling()))
    k, length, key = 4, 40, jax.random.PRNGKey(13)

    def j_propose(state, last, rng):
        return dmod.apply({"params": dparams}, state, last, rng, k,
                          method=JLM.draft_propose)

    j_init = dmod.apply({"params": dparams}, 1, length + k + 2,
                        method=JLM.draft_init_state)
    zs, tzs, noise_key = (), (), key
    if target == "vae":
        z = z_of(1)
        zs, tzs = (jnp.asarray(z),), (torch.from_numpy(z),)
        noise_key = jax.random.split(key)[1]
    want, want_it, want_acc = module.apply(
        {"params": params}, key, length, j_propose, j_init, *zs,
        sampling=j_sampling, draft_k=k,
        method=type(module).spec_draft_generate)
    got, it, acc = model.spec_draft_generate(
        0, length, lambda s, last, n: dmodel.draft_propose(s, last, n, k),
        dmodel.draft_init_state(1, length + k + 2), *tzs, sampling=sampling,
        draft_k=k, noise=JaxPasses(noise_key, k))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (it, acc) == (int(want_it), int(want_acc))
    if mode == "greedy":
        assert torch.equal(got, model.sample(0, length, 1, *tzs, sampling))


def test_a_perfect_draft_accepts_nearly_everything():
    """The target as its own draft at temperature 1 without filters: q is
    p, so min(1, p / q) = 1 and a pass takes k + 1 tokens."""
    model = pair()[2]
    raw = SamplingParams(top_p=1.0, repetition_penalty=1.0)
    _, it, acc = model.spec_draft_generate(
        3, 41, lambda s, last, n: model.draft_propose(s, last, n, 4),
        model.draft_init_state(1, 47), sampling=raw, end_token=-1,
        draft_k=4)
    assert it == 8 and acc == 32


# -- the sample entry ---------------------------------------------------------

def test_sample_entry_with_a_spec_draft(tiny_archives, tmp_path,
                                        monkeypatch):
    """`sample ... spec_draft=transformer-lm:<dense LM> batch_size=1`, and
    with spec_draft=lstm-lm:<a tiny LSTM LM>: one speculative document
    per seed, as spec_draft_generate gives it with a fresh draft state;
    other batch sizes refuse."""
    monkeypatch.chdir(tmp_path)
    train_tokenizer(iter(["a stand-in tokenizer line"]), 128,
                    save_path=tokenizer_cache_path("local-prose"))
    vae = str(tiny_archives / "vae")
    draft = f"transformer-lm:{tiny_archives}/dense"
    out = sample_entry.main(["sample", "transformer-vae", vae,
                             "num_samples=2", "batch_size=1",
                             "max_length=24", f"spec_draft={draft}",
                             "spec_k=3", "ignore_end=1", "device=cpu"])
    assert out["splits"] == {"train": 2}
    from sparse_vae_tpu_torch.checkpoint import (export_archive,
                                                 load_draft, load_run)
    model = load_run(vae, device="cpu")[0]
    propose, fresh = load_draft(draft, 3, "cpu")
    for i, doc in enumerate(out["documents"]):
        want = model.spec_draft_generate(i, 24, propose, fresh(24),
                                         end_token=-1, draft_k=3)[0]
        np.testing.assert_array_equal(doc, want[0].numpy())
    with pytest.raises(SystemExit, match="batch-1"):
        sample_entry.main(["sample", "transformer-vae", vae,
                           f"spec_draft={draft}", "device=cpu"])
    from dataclasses import asdict

    from sparse_vae_tpu_torch.models.init import init_parameters
    from sparse_vae_tpu_torch.models.lstm_lm import (
        LSTMLanguageModel, LSTMLanguageModelHparams)
    hp = LSTMLanguageModelHparams(vocab_size=model.hparams.vocab_size,
                                  d_embedding=8, d_model=16,
                                  tie_logit_weights=True)
    lstm = init_parameters(LSTMLanguageModel(hp),
                           torch.Generator().manual_seed(0), None)
    lstm_draft = "lstm-lm:" + str(export_archive(lstm, {
        "experiment": "lstm-lm", "name": "lstm", "model_hparams":
        asdict(hp), "data_hparams": {}}, tiny_archives / "lstm"))
    out = sample_entry.main(["sample", "transformer-vae", vae,
                             "num_samples=2", "batch_size=1",
                             "max_length=24", f"spec_draft={lstm_draft}",
                             "spec_k=3", "ignore_end=1", "device=cpu"])
    propose, fresh = load_draft(lstm_draft, 3, "cpu")
    for i, doc in enumerate(out["documents"]):
        want = model.spec_draft_generate(i, 24, propose, fresh(24),
                                         end_token=-1, draft_k=3)[0]
        np.testing.assert_array_equal(doc, want[0].numpy())
