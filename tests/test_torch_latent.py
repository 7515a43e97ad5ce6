"""The port's latent tooling (sparse_vae_tpu_torch/gather_latents.py,
knn.py, tsne.py, reconstruct.py, vae_console.py) against the JAX
package's scripts on the CPU, on a tiny Transformer-VAE from the JAX
initialisation (carried across by `checkpoint.state_from_leaves`, saved
as this package's trainer saves a run) over the seeded synthetic corpus
of 100 documents, in a scratch working directory. The JAX scripts run
as they are, their run loader swapped for one that hands them the same
parameters.

Tolerances: posterior means and scales fp32 against fp32, 2e-5 of the
largest |value| (the Perceiver's products over widths of 64); knn's
scores fp32 against knn.py's formulas in float64, 1e-5 of the largest
|score| plus 1e-6; titles, document indices, neighbour lists and
sampled tokens exact.

Worker time: about 45 s in one process, 43 s in the suite's 6-worker
run; most of it JAX's compiles and the two t-SNE/LDA fits.
"""
import dataclasses
import importlib.util
import os
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import sparse_vae_tpu
import sparse_vae_tpu.cli as jcli
from sparse_vae_tpu import build_model
from sparse_vae_tpu.models.generation import SamplingParams as JSampling
from sparse_vae_tpu_torch import checkpoint as ckpt
from sparse_vae_tpu_torch import gather_latents, knn, reconstruct, tsne
from sparse_vae_tpu_torch import vae_console
from sparse_vae_tpu_torch.data.text_data_module import (
    TextDataModule, TextDataModuleHparams)
from sparse_vae_tpu_torch.models import generation as tgen
from sparse_vae_tpu_torch.models.transformer_vae import (
    TransformerVAE, TransformerVAEHparams)
from sparse_vae_tpu_torch.training.checkpointing import CheckpointManager
from tests.test_torch_lm import _leaf_grads

REPO = Path(__file__).resolve().parent.parent
REL = 2e-5
DATA = TextDataModuleHparams(
    dataset_name="synthetic", synthetic_docs=100, vocab_size=1024,
    min_tokens_per_sample=16, max_tokens_per_sample=512,
    tokens_per_batch=4096)
MODEL = dict(d_model=64, num_heads=4, num_layers=2, latent_depth=8,
             num_encoder_latents=8, vocab_size=1024, loss_chunk_size=256,
             use_pallas_kernel=False, precision="fp32",
             grad_checkpointing=False)


def _script(name: str):
    """The JAX package's top-level script `name` as a module."""
    spec = importlib.util.spec_from_file_location(
        name.replace("-", "_") + "_jax", REPO / name)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Two working directories holding the same corpus, tokenizer and run
    "tiny" (saved by the port's CheckpointManager): in `port` this
    package's gather_latents wrote the latents, in `jax` the JAX
    package's gather_latents.py did. Returns a namespace of them, the
    JAX module and params, the port model and the data module."""
    port_dir = tmp_path_factory.mktemp("port")
    old = os.getcwd()
    os.chdir(port_dir)
    try:
        data = TextDataModule(DATA)
        data.prepare_data()
        module, _, objective = build_model("transformer-vae", MODEL)
        params = jax.jit(module.init)(
            {"params": jax.random.PRNGKey(0),
             "sample": jax.random.PRNGKey(1)},
            jnp.ones((1, 16), jnp.int32))["params"]
        hp = TransformerVAEHparams(**MODEL)
        model = TransformerVAE(hp)
        model.load_state_dict(ckpt.state_from_leaves(
            {k: np.array(v) for k, v in _leaf_grads(params).items()}, hp))
        model.eval().requires_grad_(False)
        meta = {"experiment": "transformer-vae", "name": "tiny",
                "model_hparams": dataclasses.asdict(hp),
                "data_hparams": dataclasses.asdict(DATA)}
        CheckpointManager("transformer-vae", "tiny").save(
            0, {"params": model.state_dict(), "step": 0}, meta)
        jax_dir = tmp_path_factory.mktemp("jax")
        shutil.copytree(port_dir, jax_dir, dirs_exist_ok=True)
        gather_latents.main(["gather_latents", "transformer-vae", "tiny",
                             "device=cpu"])
    finally:
        os.chdir(old)
    return dict(port=port_dir, jax=jax_dir, module=module, params=params,
                objective=objective, model=model, data=data, meta=meta)


@pytest.fixture
def jax_loader(run, monkeypatch):
    """The JAX scripts' run loader and platform set-up, swapped for the
    fixture's module and parameters."""
    def load(experiment, name):
        assert experiment == "transformer-vae"
        return (run["module"], None, run["objective"],
                {"params": run["params"]}, run["meta"])
    monkeypatch.setattr(sparse_vae_tpu, "load_checkpoint_for_name", load)
    monkeypatch.setattr(jcli, "apply_platform_env", lambda: None)


def _latents(directory):
    from datasets import Dataset
    return Dataset.load_from_disk(str(
        directory / "sparse-vae-datasets" / "latents" / "transformer-vae"
        / "tiny"))


def _gather_jax(run):
    path = (run["jax"] / "sparse-vae-datasets" / "latents"
            / "transformer-vae" / "tiny")
    if not path.exists():
        with pytest.MonkeyPatch.context() as mp:
            mp.chdir(run["jax"])
            _script("gather_latents.py").main(
                ["gather_latents.py", "transformer-vae", "tiny"])
    return _latents(run["jax"])


def _close(got, want, what):
    want = np.asarray(want)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= REL * float(np.abs(want).max()), f"{what}: {err:.3g}"


def test_gather_matches_jax_gather_latents(run, jax_loader):
    """The port's entry and the JAX script write the same columns: the
    titles and doc_index in train-then-test order, and loc and scale
    within REL; `gather` gives the entry's arrays."""
    want, got = _gather_jax(run), _latents(run["port"])
    assert got.column_names == want.column_names == [
        "title", "latent", "scale", "doc_index"]
    assert got["title"] == want["title"] and len(got) == 100
    assert got["doc_index"] == want["doc_index"] == list(range(100))
    loc, scale = np.asarray(got["latent"]), np.asarray(got["scale"])
    _close(loc, np.asarray(want["latent"]), "loc")
    _close(scale, np.asarray(want["scale"]), "scale")
    g_loc, g_scale, titles, index = gather_latents.gather(run["model"],
                                                          run["data"])
    np.testing.assert_array_equal(g_loc, loc.astype(np.float32))
    np.testing.assert_array_equal(g_scale, scale.astype(np.float32))
    assert titles == got["title"] and index.tolist() == got["doc_index"]


def test_knn_scores_match_knn_py_formulas(run):
    """knn_scores in fp32 against knn.py's numpy formulas in float64 on
    the gathered latents, for three documents."""
    loc = np.asarray(_latents(run["port"])["latent"], np.float64)
    scale = np.asarray(_latents(run["port"])["scale"], np.float64)
    for i in (0, 41, 99):
        got = knn.knn_scores(torch.tensor(loc, dtype=torch.float32),
                             torch.tensor(scale, dtype=torch.float32), i)
        d2 = np.sum((loc[i] - loc) ** 2, axis=-1)
        norms = np.linalg.norm(loc, axis=-1) * np.linalg.norm(loc[i])
        cos = loc @ loc[i] / np.maximum(norms, 1e-12)
        var_p, var_q = scale[i] ** 2, scale ** 2
        kl = 0.5 * np.sum(var_p / var_q + (loc[i] - loc) ** 2 / var_q - 1.0
                          + np.log(var_q / var_p), axis=-1)
        for name, g, w in zip(("l2", "cos", "kl"), got, (d2, cos, kl)):
            err = np.abs(g.numpy() - w).max()
            assert err <= 1e-5 * np.abs(w).max() + 1e-6, (name, i, err)


def _reader(lines):
    """A read(prompt) that answers with `lines` in turn."""
    answers = iter(lines)
    return lambda prompt: next(answers)


def _neighbours(out: str) -> list:
    """The titles of each printed top-10 list."""
    return [line.split(" - ")[0].strip() for line in out.splitlines()
            if " - " in line]


def test_either_packages_latents_read_by_the_others_knn(run, jax_loader,
                                                        capsys,
                                                        monkeypatch):
    """knn on each package's latents: the port's entry and knn.py print
    the same three top-10 lists; a missing title is refused."""
    _gather_jax(run)
    j_knn = _script("knn.py")
    queries = ["synthetic-41", "no such article", "q"]
    for directory in (run["port"], run["jax"]):
        monkeypatch.chdir(directory)
        monkeypatch.setattr("builtins.input", _reader(queries))
        knn.main(["knn", "transformer-vae", "tiny", "device=cpu"])
        port_out = capsys.readouterr().out
        monkeypatch.setattr("builtins.input", _reader(queries))
        j_knn.main(["knn.py", "transformer-vae", "tiny"])
        jax_out = capsys.readouterr().out
        assert len(_neighbours(port_out)) == 30
        assert _neighbours(port_out) == _neighbours(jax_out)
        assert "No article found" in port_out
        assert _neighbours(port_out)[0] == "synthetic-41"


def test_tsne_on_the_others_latents_writes_both_pngs(run, jax_loader,
                                                     monkeypatch):
    """The port's tsne on the latents the JAX script gathered, and
    tsne.py on the port's: each writes the monochrome and the LDA-coloured
    scatter, joining by doc_index."""
    _gather_jax(run)
    for directory, main in ((run["jax"], tsne.main),
                            (run["port"], _script("tsne.py").main)):
        monkeypatch.chdir(directory)
        for png in ("sparse-vae-tsne.png", "sparse-vae-tsne-lda.png"):
            Path(png).unlink(missing_ok=True)
        main(["tsne", "transformer-vae", "tiny"])
        for png in ("sparse-vae-tsne.png", "sparse-vae-tsne-lda.png"):
            assert Path(png).stat().st_size > 1000


def test_fit_lda_topics_joins_as_jax(run, monkeypatch):
    """fit_lda_topics' topics by doc_index and by the title fallback equal
    tsne.py's on the same corpus."""
    monkeypatch.chdir(run["port"])
    titles = _latents(run["port"])["title"]
    j_fit = _script("tsne.py").fit_lda_topics
    for index in (list(range(100)), None):
        got = tsne.fit_lda_topics("transformer-vae", "tiny", titles, [],
                                  doc_indices=index)
        want = j_fit("transformer-vae", "tiny", titles, [],
                     doc_indices=index)
        np.testing.assert_array_equal(got, want)


def _replayed_noise(rng, steps, v):
    """JAX `sample`'s per-step Gumbel draws at batch 1."""
    out = []
    for _ in range(steps):
        rng, sample_rng = jax.random.split(rng)
        out.append(torch.from_numpy(np.array(jax.random.gumbel(
            sample_rng, (1, v), jnp.float32))))
    return out


def test_reconstruct_matches_jax_on_the_same_noise(run, monkeypatch):
    """reconstruct.py's decode (the posterior mean, sample from
    PRNGKey(0) at temperature 0.7) against the port's `reconstruct` fed
    JAX's per-step noise, at max_length 64 with the unfused selection of
    JAX's default path: token for token."""
    module, params, model = run["module"], run["params"], run["model"]
    doc = run["data"].splits["test"].docs[0]
    ids = np.asarray(doc, np.int64)[None, :]
    ml = 64
    want = np.asarray(jax.jit(lambda p: module.apply(
        {"params": p}, jax.random.PRNGKey(0), ml, 1,
        module.apply({"params": p}, jnp.asarray(ids),
                     method=type(module).posterior).loc,
        JSampling(temperature=0.7), method=type(module).sample))(params))
    noise = iter(_replayed_noise(jax.random.split(jax.random.PRNGKey(0))[1],
                                 ml, 1024))
    monkeypatch.setattr(tgen, "gumbel_noise", lambda shape, rng: next(noise))
    got = reconstruct.reconstruct(model, torch.from_numpy(ids), 0, ml,
                                  fused_select=False)
    np.testing.assert_array_equal(got.numpy(), want)
    assert len(set(want[0].tolist())) > 10


def test_reconstruct_entry_prints_the_decoded_reconstruction(run, capsys,
                                                             monkeypatch):
    """`python -m sparse_vae_tpu_torch.reconstruct transformer-vae tiny
    device=cpu` on scripted queries: a title's reconstruction is the
    tokenizer's text of `reconstruct` (seed 0, max_length 1024) without
    [PAD]; an unknown title is refused; q quits."""
    monkeypatch.chdir(run["port"])
    corpus = run["data"].splits["test"]
    calls, decode = [], reconstruct.reconstruct

    def recorded(model, token_ids, *args, **kw):
        calls.append((token_ids, decode(model, token_ids, *args, **kw)))
        return calls[-1][1]

    monkeypatch.setattr(reconstruct, "reconstruct", recorded)
    monkeypatch.setattr("builtins.input",
                        _reader([corpus.titles[0], "nope", "q"]))
    reconstruct.main(["reconstruct", "transformer-vae", "tiny",
                      "device=cpu"])
    out = capsys.readouterr().out
    (token_ids, tokens), = calls
    np.testing.assert_array_equal(token_ids[0].numpy(), corpus.docs[0])
    assert tokens.shape == (1, 1023)
    again = decode(run["model"], token_ids, 0, 40)
    assert torch.equal(again, decode(run["model"], token_ids, 0, 40))
    text = run["data"].tokenizer.decode(
        [int(t) for t in tokens[0].tolist() if t != 0])
    assert "Reconstruction:\n\n" + text in out
    assert "No article found with that title" in out


def test_console_scripted_session(run, capsys, monkeypatch):
    """A scripted vae_console session: help, encode (the posterior of the
    text's ids, as JAX's posterior of them), an expression over the
    environment, a statement, an error, a reload, q."""
    monkeypatch.chdir(run["port"])
    lines = ["help", "encode the quick brown fox", "posterior.loc.shape",
             "x = 40", "x + 2", "1 / 0", "load tiny", "print('after')", "q",
             "never read"]
    console = vae_console.main(["vae_console", "tiny", "device=cpu"],
                               read=_reader(lines))
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "Loaded transformer VAE run 'tiny'."
    assert "['encode', 'load', 'help']" in out
    assert "torch.Size([1, 1, 8])" in out and "42" in out
    assert "ZeroDivisionError('division by zero')" in out
    assert out[-1] == "after"
    assert out.count("Loaded transformer VAE run 'tiny'.") == 2
    env = console.env
    ids = env["tokenizer"].encode("the quick brown fox").ids
    module, params = run["module"], run["params"]
    want = jax.jit(lambda p: module.apply(
        {"params": p}, jnp.asarray([ids]),
        method=type(module).posterior).loc)(params)
    _close(env["posterior"].loc.numpy(), want, "loc")
    assert env["x"] == 40 and env["meta"]["name"] == "tiny"
