"""The port's parallel decoding (models/parallel_decode.py; the window
pass `window_hidden` / `window_hidden_z` and `push_window_blocks`; the
generators `frontier_generate`, `speculative_generate` and
`parallel_generate` of both transformer families; the `gen_bench` entry)
against the JAX package on the CPU, on tiny JAX-initialised models
(2 layers, d_model 32, blocks of 32) carried across by
`checkpoint.params_from_numpy` in fp32.

JAX's noise reaches the port through the decoders' noise source: `JaxKeyed`
draws jax.random.gumbel / uniform of fold_in(key, block or chunk), the
grid JAX's decoders use. Tolerances: tokens, pass counts, memberships
and buffers exact; hidden states 2e-5. Sampled selection goes through
K4's wrapper with fused_select (its plain version on the CPU, JAX's
Pallas kernel in interpret mode).

Worker time: about 90 s in one process, 117 s in the suite's 6-worker
run; most of it JAX's compiles of its decode loops.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from sparse_vae_tpu.models import parallel_decode as jpd
from sparse_vae_tpu.models.generation import SamplingParams as JSampling
from sparse_vae_tpu.models.transformer_lm import (
    TransformerHparams as JLMHparams, TransformerLanguageModel as JLM)
from sparse_vae_tpu.models.transformer_vae import (
    TransformerVAE as JVAE, TransformerVAEHparams as JVAEHparams)
from sparse_vae_tpu_torch import checkpoint as ckpt
from sparse_vae_tpu_torch import gen_bench
from sparse_vae_tpu_torch.models import parallel_decode as tpd
from sparse_vae_tpu_torch.models.generation import SamplingParams
from sparse_vae_tpu_torch.models.transformer_lm import (
    TransformerHparams, TransformerLanguageModel)
from sparse_vae_tpu_torch.models.transformer_vae import (
    TransformerVAE, TransformerVAEHparams)

GREEDY = SamplingParams(temperature=0.0, top_p=1.0, repetition_penalty=1.0)
J_GREEDY = JSampling(temperature=0.0, top_p=1.0, repetition_penalty=1.0)
NUCLEUS = SamplingParams(temperature=1.0, top_p=0.9, repetition_penalty=1.2)
J_NUCLEUS = JSampling(temperature=1.0, top_p=0.9, repetition_penalty=1.2)
TINY = dict(d_model=32, num_heads=4, num_layers=2, vocab_size=128,
            sparse_self_attention=True, attn_window_size=2,
            attn_block_size=32, use_pallas_kernel=False)
VAE = dict(latent_depth=8, num_encoder_latents=4)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class JaxKeyed:
    """A noise source on JAX keys: key k's draws are JAX's of
    fold_in(key, k), as its decoders key a block or chunk."""

    def __init__(self, key):
        self.key = key

    def fold(self, k: int):
        return JaxKeyed(jax.random.fold_in(self.key, k))

    def gumbel(self, k: int, shape):
        return torch.from_numpy(np.array(jax.random.gumbel(
            jax.random.fold_in(self.key, k), tuple(shape), jnp.float32)))

    def uniform(self, k: int, shape):
        return torch.from_numpy(np.array(jax.random.uniform(
            jax.random.fold_in(self.key, k), tuple(shape), jnp.float32,
            minval=jnp.finfo(jnp.float32).tiny, maxval=1.0)))


def tiny_pair(vae: bool = False, seed: int = 3, **over):
    """(JAX module, its params, the port model with them): the JAX
    package's initialisation, carried across as numpy leaves through
    `checkpoint.params_from_numpy`."""
    cfg = {**TINY, **(VAE if vae else {}), **over}
    if vae:
        module, hp = JVAE(JVAEHparams(**cfg)), TransformerVAEHparams(**cfg)
        rngs = {"params": jax.random.PRNGKey(seed),
                "sample": jax.random.PRNGKey(seed + 1)}
    else:
        module, hp = JLM(JLMHparams(**cfg)), TransformerHparams(**cfg)
        rngs = jax.random.PRNGKey(seed)
    params = module.init(rngs, jnp.ones((1, 64), jnp.int32))["params"]
    flat = {k: np.asarray(v) for k, v in
            flatten_dict(params, sep="/").items()}
    model = (TransformerVAE if vae else TransformerLanguageModel)(hp)
    model.load_state_dict(ckpt.params_from_numpy(flat, hp), strict=True)
    return module, params, model.eval().requires_grad_(False)


@pytest.fixture(scope="module")
def lm():
    return tiny_pair()


@pytest.fixture(scope="module")
def vae():
    return tiny_pair(vae=True)


def z_of(b: int, seed: int = 9):
    return np.random.default_rng(seed).standard_normal(
        (b, 1, VAE["latent_depth"])).astype(np.float32)


def jax_call(module, params, method, *args, **kw):
    out = module.apply({"params": params}, *args,
                       method=getattr(type(module), method), **kw)
    return tuple(np.asarray(o) for o in out) if isinstance(out, tuple) \
        else np.asarray(out)


# -- the pieces, exactly ------------------------------------------------------

@pytest.mark.parametrize("start,c,window", [(0, 8, 16), (5, 8, 16),
                                            (17, 12, 6), (30, 8, 64),
                                            (29, 1, 4)])
def test_chunk_membership_matches_jax(start, c, window):
    """Windows wider and narrower than the chunk, at the buffer's start,
    middle and end (where the chunk runs past it), with repeats."""
    rng = np.random.default_rng(start + c)
    tokens = rng.integers(0, 20, size=(3, 36))
    want = jpd._chunk_membership(jnp.asarray(tokens), start, c, window, 24)
    got = tpd._chunk_membership(torch.from_numpy(tokens), start, c, window,
                                24)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_mask_after_end_matches_jax():
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 6, size=(5, 14))
    tokens[:, 0] = 1
    want = jpd._mask_after_end(jnp.asarray(tokens), 2, 1)
    got = tpd._mask_after_end(torch.from_numpy(tokens), 2, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (np.asarray(want) == 0).sum() > (tokens == 0).sum()


@pytest.mark.parametrize("case", ["periodic", "no_match", "no_change",
                                  "rows", "random"])
def test_suffix_match_draft_matches_jax(case):
    """JAX's test cases (the latest match by a reversed argmax, a cyclic
    copy, no match, no change, rows on their own) and random buffers with
    many matches."""
    rng = np.random.default_rng(1)
    buffer = np.zeros((2, 24), np.int64)
    buffer[0, :10] = [5, 6, 7, 8, 5, 6, 7, 8, 5, 6]
    buffer[1] = np.arange(1, 25) if case in ("no_match", "rows") else \
        buffer[0]
    if case == "random":
        buffer = rng.integers(3, 7, size=(4, 40))
    frontier, ngram = (8, 2) if case != "random" else (12, 3)
    w = 8 if case != "random" else 16
    win_old = buffer[:, frontier:frontier + w].copy()
    if case == "random":
        win_old = rng.integers(3, 7, size=win_old.shape)
    elif case != "no_change":
        win_old[:, 1] = 99
    want = jpd._suffix_match_draft(jnp.asarray(buffer, jnp.int32),
                                   jnp.asarray(win_old, jnp.int32),
                                   jnp.asarray(frontier, jnp.int32), ngram)
    got = tpd._suffix_match_draft(torch.from_numpy(buffer),
                                  torch.from_numpy(win_old), frontier,
                                  ngram)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (case == "no_change") == np.array_equal(np.asarray(want), buffer)
    if case == "no_match":
        np.testing.assert_array_equal(got[1].numpy(), buffer[1])


def test_speculative_verify_is_unbiased():
    """For a filtered target p and a point-mass draft d, the operator's
    output (d when accepted, else the resample) has law p to Monte Carlo
    precision: drafts of high and low mass and outside the support."""
    v, n = 16, 200_000
    base = torch.tensor([2.0, 1.1, 0.3, -0.5, -1.2, 0.8, 1.9, -2.0, 0.0,
                         0.4, -0.9, 1.3, -np.inf, -np.inf, 0.6, -0.1])
    p = torch.softmax(base, dim=0).numpy()
    gen = torch.Generator().manual_seed(0)
    lf = base.expand(n, v)
    for d in (0, 7, 12):
        coins = torch.rand(n, generator=gen).clamp_(min=1e-38)
        noise = -torch.log(-torch.log(
            torch.rand((n, v), generator=gen).clamp_(min=1e-38)))
        accept, resample = tpd._speculative_verify(
            lf, torch.full((n,), d), coins, noise)
        out = torch.where(accept, d, resample)
        emp = np.bincount(out.numpy(), minlength=v) / n
        np.testing.assert_allclose(emp, p, atol=0.01, err_msg=f"draft={d}")


def test_speculative_verify_matches_jax():
    rng = np.random.default_rng(2)
    lf = rng.standard_normal((3, 5, 24)).astype(np.float32)
    lf[0, :, :4] = -np.inf
    draft = rng.integers(0, 24, size=(3, 5))
    coins = rng.uniform(1e-6, 1, size=(3, 5)).astype(np.float32)
    noise = rng.gumbel(size=(3, 5, 24)).astype(np.float32)
    want = jpd._speculative_verify(jnp.asarray(lf), jnp.asarray(draft),
                                   jnp.asarray(coins), jnp.asarray(noise))
    got = tpd._speculative_verify(*(torch.from_numpy(a) for a in
                                    (lf, draft, coins, noise)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# -- the window pass ----------------------------------------------------------

@pytest.mark.parametrize("family", ["lm", "vae"])
def test_window_hidden_and_push_match_jax(family, lm, vae):
    """Three windows of 64 at frontiers 0, 32 and 96 (the [CLS] store
    frozen, the context band rolled), each pushing its leading block:
    hidden states and every cache leaf at 2e-5 of JAX's."""
    module, params, model = vae if family == "vae" else lm
    b = 2
    tokens = np.random.default_rng(4).integers(3, 128, size=(b, 192))
    z = z_of(b)
    j_caches = module.apply({"params": params}, b,
                            method=type(module).init_window_caches)
    caches = model.init_window_caches(b)
    for f in (0, 32, 96):
        win = tokens[:, f:f + 64]
        if family == "vae":
            jh, jkv = module.apply({"params": params}, jnp.asarray(win),
                                   j_caches, jnp.asarray(f), jnp.asarray(z),
                                   method=JVAE.window_hidden_z)
            h, kv = model.window_hidden_z(torch.from_numpy(win), caches, f,
                                          torch.from_numpy(z))
        else:
            jh, jkv = module.apply({"params": params}, jnp.asarray(win),
                                   j_caches, jnp.asarray(f),
                                   method=JLM.window_hidden)
            h, kv = model.window_hidden(torch.from_numpy(win), caches, f)
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), rtol=2e-5,
                                   atol=2e-5)
        j_caches = jpd.push_window_blocks(j_caches, jkv, jnp.asarray(f), 32)
        caches = tpd.push_window_blocks(caches, kv, f, 32)
        for c, jc in zip(caches, j_caches):
            for name in c:
                np.testing.assert_allclose(c[name].numpy(),
                                           np.asarray(jc[name]), rtol=2e-5,
                                           atol=2e-5, err_msg=name)


# -- the generators, token for token ------------------------------------------

def _generate(pair, family, method, sampling, j_sampling, key, **kw):
    """JAX's and the port's (tokens, passes) of `method` at batch 2 on one
    key: the port gets JAX's decode key as its noise source and JAX's z."""
    module, params, model = pair
    b, length = 2, 128
    args, targs = (), ()
    noise_key = key
    if family == "vae":
        z = z_of(b)
        args, targs = (jnp.asarray(z),), (torch.from_numpy(z),)
        noise_key = jax.random.split(key)[1]
    want = jax_call(module, params, method, key, length, b, *args,
                    j_sampling, **kw)
    port_kw = dict(kw)
    port_kw.pop("interpret", None)
    got = getattr(model, method)(0, length, b, *targs, sampling,
                                 noise=JaxKeyed(noise_key), **port_kw)
    return want, got


CASES = [("frontier_generate", "greedy", {"window_tokens": 64}),
         ("frontier_generate", "greedy", {"window_tokens": 64,
                                           "draft_ngram": 3}),
         ("frontier_generate", "sampled", {"window_tokens": 64}),
         ("frontier_generate", "fused", {"window_tokens": 64,
                                          "fused_select": True,
                                          "interpret": True}),
         ("speculative_generate", "greedy", {"window_tokens": 64}),
         ("speculative_generate", "sampled", {"window_tokens": 64}),
         ("parallel_generate", "greedy", {"chunk_size": 32}),
         ("parallel_generate", "sampled", {"chunk_size": 32}),
         ("parallel_generate", "fused", {"chunk_size": 48,
                                          "fused_select": True,
                                          "interpret": True})]


@pytest.mark.parametrize("family", ["lm", "vae"])
@pytest.mark.parametrize("method,mode,kw", CASES)
def test_generators_match_jax(family, method, mode, kw, lm, vae):
    """Each generator of each family at batch 2 x 128 (4 blocks of 32):
    the tokens and the pass count JAX's, greedy, sampled (nucleus 0.9,
    penalty 1.2) and, with fused_select, through K4's wrapper."""
    sp = {"greedy": (GREEDY, J_GREEDY)}.get(mode, (NUCLEUS, J_NUCLEUS))
    key = jax.random.PRNGKey(5)
    (want, want_it), (got, got_it) = _generate(
        vae if family == "vae" else lm, family, method, sp[0], sp[1], key,
        **kw)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got_it == int(want_it)
    assert len(set(want[0].tolist())) > 5


@pytest.mark.parametrize("family", ["lm", "vae"])
def test_greedy_decoders_are_the_greedy_sample(family, lm, vae):
    """Greedy frontier = greedy parallel_generate = greedy speculative =
    greedy `sample` (the lockstep loop), with their own seeds' noise."""
    module, params, model = vae if family == "vae" else lm
    zs = (torch.from_numpy(z_of(2)),) if family == "vae" else ()
    want = model.sample(0, 128, 2, *zs, GREEDY)
    for got, _ in (model.frontier_generate(1, 128, 2, *zs, GREEDY,
                                           window_tokens=64),
                   model.parallel_generate(2, 128, 2, *zs, GREEDY,
                                           chunk_size=32),
                   model.speculative_generate(3, 128, 2, *zs, GREEDY,
                                              window_tokens=32)):
        assert torch.equal(got, want)


def test_sampled_fixed_point_is_window_invariant(lm):
    """The port's own noise (KeyedNoise) is keyed by block: any window
    reaches the same sample, and full-document Jacobi at chunk = block
    reaches it too, up to a row's first sampled [PAD]: the teacher-forcing
    forward masks [PAD] keys and the window pass does not, in both
    packages, and this untrained model samples [PAD] (id 0)."""
    model = lm[2]
    outs = [model.frontier_generate(7, 128, 2, sampling=NUCLEUS,
                                    window_tokens=w)[0]
            for w in (32, 64, 128)]
    for out in outs[1:]:
        assert torch.equal(out, outs[0])
    full = model.parallel_generate(7, 128, 2, sampling=NUCLEUS,
                                   chunk_size=32)[0]
    for row, want in zip(full, outs[0]):
        pads = (want == 0).nonzero()
        upto = int(pads[0]) + 1 if len(pads) else len(want)
        assert upto > 30
        assert torch.equal(row[:upto], want[:upto])
    assert not torch.equal(outs[0], model.frontier_generate(
        8, 128, 2, sampling=NUCLEUS, window_tokens=64)[0])


def test_end_token_stops_rows(lm):
    """With an end token the rows stop as JAX's do: [PAD] after the end,
    the same tokens and passes (frontier and full Jacobi)."""
    module, params, model = lm
    key = jax.random.PRNGKey(11)
    for method, kw in (("frontier_generate", {"window_tokens": 64}),
                       ("parallel_generate", {"chunk_size": 32})):
        want, want_it = jax_call(module, params, method, key, 128, 2,
                                 J_NUCLEUS, end_token=7, **kw)
        got, got_it = getattr(model, method)(0, 128, 2, NUCLEUS,
                                             end_token=7,
                                             noise=JaxKeyed(key), **kw)
        np.testing.assert_array_equal(got.numpy(), want)
        assert got_it == int(want_it)


def test_window_decoders_refuse_a_dense_model():
    model = tiny_pair(sparse_self_attention=False)[2]
    for method in ("frontier_generate", "speculative_generate"):
        with pytest.raises(ValueError, match="sparse"):
            getattr(model, method)(0, 64, 1)


# -- the gen_bench entry ------------------------------------------------------

@pytest.fixture(scope="module")
def tiny_archives(tmp_path_factory, lm, vae):
    """The tiny VAE and a tiny dense LM draft as archives a path names."""
    root = tmp_path_factory.mktemp("runs")
    from dataclasses import asdict
    dense = tiny_pair(sparse_self_attention=False, num_layers=1, seed=4)[2]
    for name, experiment, model in (("vae", "transformer-vae", vae[2]),
                                    ("lm", "transformer-lm", lm[2]),
                                    ("dense", "transformer-lm", dense)):
        ckpt.export_archive(model, {
            "experiment": experiment, "name": name,
            "model_hparams": asdict(model.hparams), "data_hparams": {}},
            root / name)
    return root


def test_gen_bench_entry_on_the_cpu(tiny_archives, capsys):
    """Every row of both modes on the tiny VAE archive with a dense LM
    draft, full=1 and check=1: the JAX script's rows and keys, greedy
    rows equal to `ar` token for token (the archive's bf16 weights in
    fp32 on the CPU: one arithmetic), every row seq - 1 tokens."""
    out = gen_bench.main(["gen_bench", "transformer-vae",
                          str(tiny_archives / "vae"), "seq=128", "batch=1",
                          "window=64", "full=1", "check=1", "spec_k=4",
                          f"spec_draft=transformer-lm:{tiny_archives}/dense",
                          "device=cpu"])
    greedy, sampled = out["runs"]
    assert set(greedy) == {
        "mode", "ar", "frontier", "frontier_draft3", "spec_model_k4",
        "jacobi_full", "spec_model_accepted", "spec_model_tokens_per_pass",
        "frontier_mismatch_tokens", "draft3_mismatch_tokens",
        "spec_model_mismatch_tokens", "spec_model_first_mismatch",
        "parallel_speedup_vs_ar"}
    assert set(sampled) == {
        "mode", "ar", "frontier", "frontier_fused", "speculative_draft3",
        "spec_model_k4", "jacobi_full", "spec_model_accepted",
        "spec_model_tokens_per_pass", "parallel_speedup_vs_ar"}
    for key in ("frontier_mismatch_tokens", "draft3_mismatch_tokens",
                "spec_model_mismatch_tokens"):
        assert greedy[key] == 0
    assert greedy["spec_model_first_mismatch"] is None
    for mode in out["detail"].values():
        for run in mode.values():
            assert run["tokens"].shape == (1, 127)
    printed = capsys.readouterr().out.strip().splitlines()[-1]
    assert '"metric": "trained_generation_equal_length"' in printed


def test_gen_bench_refuses_serve(tiny_archives):
    with pytest.raises(NotImplementedError, match="sample phase"):
        gen_bench.main(["gen_bench", "transformer-lm",
                        str(tiny_archives / "lm"), "serve=8", "device=cpu"])
    with pytest.raises(SystemExit, match="unknown keys"):
        gen_bench.main(["gen_bench", "transformer-lm",
                        str(tiny_archives / "lm"), "step=best",
                        "device=cpu"])
