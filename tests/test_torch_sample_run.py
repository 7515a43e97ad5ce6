"""The port's sampling entry points on the CPU: continuous-batch mass
sampling (serving.continuous_batch_sample) against the JAX package's on
real-prose-vae-r5 and against the port's own lockstep `sample`, the
mass-sampling sink (batch_generation.py) against the JAX package's, the
`sample` entry (dataset and split), and the trainer's sampling callback
(cli.make_sample_fns, Trainer._sampling_callback, MetricsWriter.text).

Documents are compared token for token. A lockstep row that never ends
keeps the buffer's unwritten last slot ([PAD]) where the row-wise
harvest stops before it, so lockstep and continuous documents are held
equal without their [PAD] tokens.

Worker time: about 60 s in one process.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_vae_tpu import build_model
from sparse_vae_tpu import batch_generation as jbatch
from sparse_vae_tpu import cli as jcli
from sparse_vae_tpu.models.generation import SamplingParams as JSampling
from sparse_vae_tpu.serving import continuous_batch_sample as j_continuous
from sparse_vae_tpu_torch import batch_generation as tbatch
from sparse_vae_tpu_torch import checkpoint as ckpt
from sparse_vae_tpu_torch import cli as tcli
from sparse_vae_tpu_torch import sample as sample_entry
from sparse_vae_tpu_torch.data.text_data_module import (
    TextDataModule, TextDataModuleHparams)
from sparse_vae_tpu_torch.data.tokenizer import (tokenizer_cache_path,
                                                 train_tokenizer)
from sparse_vae_tpu_torch.models import generation as tgen
from sparse_vae_tpu_torch.models.generation import SamplingParams
from sparse_vae_tpu_torch.serving import continuous_batch_sample
from sparse_vae_tpu_torch.training.trainer import Trainer
from sparse_vae_tpu_torch.utils.config import TrainerHparams
from sparse_vae_tpu_torch.utils.math_utils import bleu_score_corpus
from tests.test_torch_checkpoint import (jax_params_from_archive, jax_r5,
                                         torch_r5)
from tests.test_torch_lm import RUN as LM_RUN, _archive, _jax_lm

GREEDY = SamplingParams(top_k=1)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def r5_port():
    return torch_r5()


def _unpadded(doc):
    doc = np.asarray(doc)
    return doc[doc != 0]


# -- continuous batching -----------------------------------------------------

def _replay_jax_noise(monkeypatch, key):
    """Hand the port's row-wise steps JAX's per-step Gumbel noise: JAX's
    continuous_batch_sample decodes from the third of split(key, 3) and
    splits it each step into (carry, sample key); categorical(sample key)
    is argmax(logits + gumbel(sample key))."""
    rng = [jax.random.split(key, 3)[2]]

    def noise(shape, _generator):
        rng[0], sample_rng = jax.random.split(rng[0])
        return torch.from_numpy(np.array(jax.random.gumbel(
            sample_rng, shape, jnp.float32)))

    monkeypatch.setattr(tgen, "gumbel_noise", noise)


@pytest.mark.parametrize("family", ["transformer-vae", "transformer-lm"])
def test_continuous_batch_sample_matches_jax(r5_port, monkeypatch, family):
    """5 documents through 2 rows in fp32 (refills as documents end),
    the repetition penalty, slices of 8 steps: JAX's documents token for
    token. r5 is greedy with each document's z from a pool. draft-tlm-r5
    samples (temperature 1, top_p 0.9, the port's bisection) on JAX's
    replayed noise, so its documents differ and a refilled row's dense
    [B, H, max_len, Dh] cache holds another document's keys past its
    index."""
    if family == "transformer-vae":
        module, params = jax_r5()
        model = r5_port
        z = np.random.default_rng(3).standard_normal((5, 1, 64)).astype(
            np.float32)
        j_sampling, sampling = JSampling(top_k=1), GREEDY
    else:
        module, _ = _jax_lm()
        params = jax_params_from_archive(_archive())
        model, _, _ = ckpt.load_run(LM_RUN, device="cpu",
                                    dtype=torch.float32)
        z = None
        j_sampling, sampling = JSampling(), SamplingParams()
        _replay_jax_noise(monkeypatch, jax.random.PRNGKey(0))
    want = j_continuous(module, params, jax.random.PRNGKey(0), 5, 24, 2,
                        sampling=j_sampling, slice_steps=8, z_pool=z)
    got = continuous_batch_sample(model, 0, 5, 24, 2, sampling=sampling,
                                  slice_steps=8, z_pool=z,
                                  fused_select=False)
    assert len(got) == 5
    for g, w in zip(got, want):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    assert len({tuple(w) for w in want}) == 5


@pytest.mark.parametrize("slice_steps", [5, 256])
def test_continuous_is_lockstep_at_one_document_a_row(r5_port,
                                                    slice_steps):
    """num_samples == batch_size, the same seed and z: r5's sampled
    (temperature 1, top_p 0.9) continuous documents are the lockstep
    `sample`'s, trimmed after the end token."""
    model = r5_port
    b, ml = 4, 32
    z = torch.randn((b, 1, 64), generator=torch.Generator().manual_seed(1))
    lock = tbatch.batch_generate_samples(
        lambda i: model.sample(11, ml, b, z), b, ml, progress=False)
    cont = continuous_batch_sample(model, 11, b, ml, b,
                                   slice_steps=slice_steps, z_pool=z)
    for a, c in zip(lock, cont):
        np.testing.assert_array_equal(_unpadded(a), _unpadded(c))
    assert len({len(c) for c in cont}) > 1     # the rows end apart


def test_continuous_draws_each_documents_z_from_the_seed(r5_port):
    """Without a pool, document d's z is prior_z(seed, ..., d): the same
    documents whichever batch size carried them."""
    model = r5_port
    a = continuous_batch_sample(model, 2, 3, 12, 3, sampling=GREEDY)
    b = continuous_batch_sample(model, 2, 3, 12, 1, sampling=GREEDY)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_batch_generate_samples_trims_as_jax():
    """Batches of [3, 9] with end tokens at assorted positions, 7 samples
    (the last batch cut), with and without trimming."""
    rng = np.random.default_rng(4)
    batches = [rng.integers(0, 6, size=(3, 9)).astype(np.int32)
               for _ in range(3)]
    for end in (2, None):
        want = jbatch.batch_generate_samples(
            lambda i: batches[i], 7, 10, end_token=end, progress=False)
        got = tbatch.batch_generate_samples(
            lambda i: torch.from_numpy(batches[i]), 7, 10, end_token=end,
            progress=False)
        assert len(got) == 7
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


# -- the sample entry --------------------------------------------------------

def _stand_in_tokenizer():
    train_tokenizer(iter(["A stand-in tokenizer for sampled ids."]), 32768,
                    save_path=tokenizer_cache_path("local-prose"))


def _lines(path):
    return [json.loads(x) for x in path.read_text().splitlines()]


def test_sample_entry_writes_the_dataset(tmp_path, monkeypatch):
    """`python -m sparse_vae_tpu_torch.sample transformer-lm draft-tlm-r5
    num_samples=10 batch_size=4 max_length=16 device=cpu`: batch i is
    `sample(i, ...)` of the run's serving form, trimmed at [SEP]; the
    dataset holds every document once, 1 of them (min(50,000, 10 // 10))
    in the test split, each with its text and ids."""
    monkeypatch.chdir(tmp_path)
    _stand_in_tokenizer()
    out = sample_entry.main(["sample", "transformer-lm", LM_RUN,
                             "num_samples=10", "batch_size=4",
                             "max_length=16", "device=cpu"])
    model, _, _ = ckpt.load_run(LM_RUN, device="cpu")
    want = [row for i in range(3)
            for row in model.sample(i, 16, 4).numpy()]
    for got, row in zip(out["documents"], want[:10]):
        ends = np.flatnonzero(row == 2)
        np.testing.assert_array_equal(
            got, row[:ends[0] + 1] if len(ends) else row)
    path = tmp_path / "sparse-vae-datasets" / "samples" / LM_RUN
    assert out["path"] == path and out["splits"] == {"train": 9, "test": 1}
    rows = _lines(path / "train.jsonl") + _lines(path / "test.jsonl")
    assert sorted(tuple(r["token_ids"]) for r in rows) == sorted(
        tuple(int(t) for t in d) for d in out["documents"])
    assert all(isinstance(r["text"], str) for r in rows)
    assert out["new_tokens"] == sum(int(np.count_nonzero(d))
                                    for d in out["documents"])

    out = sample_entry.main(["sample", "transformer-vae",
                             "real-prose-vae-r5", "num_samples=3",
                             "batch_size=2", "max_length=12",
                             "continuous=1", "slice_steps=4",
                             "ignore_end=1", "device=cpu"])
    path = path.parent / "real-prose-vae-r5"
    assert out["splits"] == {"train": 3}
    assert not (path / "test.jsonl").exists()
    assert [len(d) for d in out["documents"]] == [10, 10, 10]


def test_sample_entry_refuses_what_it_does_not_run(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for experiment in ("lstm-vae", "lstm-lm"):
        with pytest.raises(SystemExit, match="unfused"):
            sample_entry.main(["sample", experiment, "x", "fused_select=1",
                               "device=cpu"])
    with pytest.raises(SystemExit, match="batch-1"):
        sample_entry.main(["sample", "transformer-vae", "real-prose-vae-r5",
                           "spec_draft=transformer-lm:draft-tlm-r5",
                           "device=cpu"])
    with pytest.raises(SystemExit, match="unknown keys"):
        sample_entry.main(["sample", "transformer-vae", "real-prose-vae-r5",
                           "step=best", "device=cpu"])
    with pytest.raises(SystemExit, match="not 'transformer-vae'"):
        sample_entry.main(["sample", "transformer-vae", LM_RUN,
                           "device=cpu"])


# -- the trainer's sampling callback ----------------------------------------

def _fit_with_callback(tmp_path, monkeypatch, experiment, model_kw,
                       max_steps):
    monkeypatch.chdir(tmp_path)
    dm = TextDataModule(TextDataModuleHparams(
        dataset_name="synthetic", synthetic_docs=200, vocab_size=1024,
        min_tokens_per_sample=16, max_tokens_per_sample=512,
        tokens_per_batch=4096))
    dm.prepare_data()
    hp, objective = tcli.build_hparams(experiment, {
        "d_model": 64, "num_heads": 4, "num_layers": 2, "vocab_size": 1024,
        "lr": 1e-3, "lr_decay_steps": 1000, **model_kw})
    sample_fn, reconstruct_fn = tcli.make_sample_fns(experiment, objective,
                                                     max_len=48)
    thp = TrainerHparams(max_steps=max_steps, sample_every_n_steps=2,
                         log_every_n_steps=100,
                         checkpoint_every_n_steps=100)
    trainer = Trainer(hp, objective, dm, thp, experiment=experiment,
                      name="cb", log_root=tmp_path / "logs", device="cpu",
                      sample_fn=sample_fn, reconstruct_fn=reconstruct_fn)
    trainer.fit()
    records = [json.loads(x) for x in (trainer.run_dir / "metrics.jsonl")
               .read_text().splitlines()]
    return objective, records


def _at(records, key):
    return {r["step"]: r[key] for r in records if key in r}


def test_vae_callback_refuses_before_kl_weight_1_and_logs_bleu(
        tmp_path, monkeypatch):
    """A tiny VAE annealing the KL weight from 0.1 to 1 over 4 steps,
    sampling every 2 steps of 6: no unconditional sample at step 2
    (kl_weight 0.55 < 1, as JAX's make_sample_fns refuses), one at steps
    4 and 6; a reconstruction and its train_bleu (BLEU-2 of the logged
    texts) at every callback; no sampling_error."""
    kw = {"latent_depth": 8, "num_encoder_latents": 8,
          "kl_annealing_steps": 4, "kl_weight_start": 0.1,
          "kl_weight_end": 1.0}
    objective, records = _fit_with_callback(tmp_path, monkeypatch,
                                            "transformer-vae", kw, 6)
    assert not _at(records, "text_sampling_error")
    _, _, j_objective = build_model("transformer-vae", {
        "d_model": 64, "num_heads": 4, "num_layers": 2, "vocab_size": 1024,
        **kw})
    j_sample_fn, _ = jcli.make_sample_fns("transformer-vae", j_objective)
    for step in (2, 4, 6):
        assert objective.kl_weight(step) == pytest.approx(
            float(j_objective.kl_weight(step)))
    assert j_sample_fn(None, None, None, step=2) is None
    assert sorted(_at(records, "text_unconditional_sample")) == [4, 6]
    recon, bleu = (_at(records, "text_reconstruction"),
                   _at(records, "train_bleu"))
    assert sorted(recon) == sorted(bleu) == [2, 4, 6]
    for step, msg in recon.items():
        original, reconstruction = msg.split("  \n**Reconstruction 1**:  \n")
        original = original.removeprefix("**Original**:  \n")
        assert bleu[step] == pytest.approx(bleu_score_corpus(
            [reconstruction.split(" ")], [[original.split(" ")]], max_n=2))


def test_lm_callback_logs_a_sample_and_no_bleu(tmp_path, monkeypatch):
    _, records = _fit_with_callback(
        tmp_path, monkeypatch, "transformer-lm",
        {"sparse_self_attention": False}, 2)
    assert sorted(_at(records, "text_unconditional_sample")) == [2]
    for key in ("text_sampling_error", "text_reconstruction", "train_bleu"):
        assert not _at(records, key)


def test_a_sampling_exception_is_logged_and_training_goes_on(tmp_path,
                                                             monkeypatch):
    """The reference's behaviour: the callback's exception becomes a
    sampling_error text and fit reaches max_steps."""
    monkeypatch.setattr(tcli, "make_sample_fns", lambda *a, **k: (
        lambda *a, **k: 1 / 0, None))
    objective, records = _fit_with_callback(
        tmp_path, monkeypatch, "transformer-lm",
        {"sparse_self_attention": False}, 2)
    assert "ZeroDivisionError" in _at(records, "text_sampling_error")[2]
