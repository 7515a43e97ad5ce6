"""Training, evaluation and the entry points of the port's LSTM family
against the JAX package on the CPU: the LSTM-VAE's ELBO (free bits,
dropout) and its K-sample DReG bound with every gradient, the IWAE
estimate on `reconstruct_ll`, the LSTM LM's ARObjective, one RAdam step
of each against JAX's train step, a tiny `Trainer.fit` of each family
with its sampling callback and a resume, and the `test`, `sample` and
`gen_bench` entries on the fitted runs.

Models are tiny and JAX-initialised, carried across by
`checkpoint.params_from_numpy`. JAX's random streams are not torch's, so
the noise of every comparison is read off JAX's own rng splits: eps as
(z - loc) / scale of JAX's sampled z, the marginal-KL draws, the DReG and
IWAE draws, and dropout masks as the non-zero pattern of JAX's dropped
activations (flax's captured intermediates).

Tolerances: losses and metrics 2e-5 relative (+ 2e-6 absolute: the
mutual information is a difference of O(1) terms); gradients 2e-3 of each
tensor's largest entry; parameters after a step 1e-6 absolute (lr-sized
updates); IWAE log p(x) 2e-5 relative.

Worker time: about 140 s in one process, most of it JAX's compiles.
"""
import json
import os
from dataclasses import asdict

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_vae_tpu.models import vae as jvae
from sparse_vae_tpu.models.lstm_vae import LSTMVAE as JVAE
from sparse_vae_tpu.parallel.spmd import make_train_step
from sparse_vae_tpu.training.objectives import ARObjective as JARObjective
from sparse_vae_tpu.training.optimizer import make_optimizer as j_make_opt
from sparse_vae_tpu_torch import checkpoint as ckpt
from sparse_vae_tpu_torch import cli as tcli
from sparse_vae_tpu_torch import gen_bench
from sparse_vae_tpu_torch import load_checkpoint_for_name
from sparse_vae_tpu_torch import sample as sample_entry
from sparse_vae_tpu_torch import test as test_entry
from sparse_vae_tpu_torch.data.text_data_module import (TextDataModule,
                                                        TextDataModuleHparams)
from sparse_vae_tpu_torch.data.tokenizer import (tokenizer_cache_path,
                                                 train_tokenizer)
from sparse_vae_tpu_torch.models import vae as tvae
from sparse_vae_tpu_torch.training.objectives import ARObjective
from sparse_vae_tpu_torch.training.optimizer import make_optimizer
from sparse_vae_tpu_torch.training.train_step import train_step
from sparse_vae_tpu_torch.training.trainer import Trainer
from sparse_vae_tpu_torch.utils.config import TrainerHparams
from tests.test_torch_eval import _iw_eps
from tests.test_torch_lstm import (LM_FORMS, VAE_FORMS, documents,
                                   lm_pair, vae_pair)
from tests.test_torch_train import _assert_grads_match, _leaf_grads

RTOL, ATOL = 2e-5, 2e-6
STEP = 3
VAE_KW = {"kl_annealing_steps": 10, "kl_weight_start": 0.2,
          "kl_weight_end": 1.0}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _batch(ids):
    num_tokens = (ids != 0).sum(1)
    return ({"token_ids": jnp.asarray(ids), "num_tokens":
             jnp.asarray(num_tokens), "num_bytes": jnp.asarray(num_tokens)},
            {"token_ids": torch.from_numpy(ids),
             "num_tokens": torch.from_numpy(num_tokens),
             "num_bytes": torch.from_numpy(num_tokens)})


def _elbo_noise(module, params, ids, rng, mi_samples: int) -> dict:
    """The draws of JAX's VAEObjective.loss_sums under `rng`, as the
    port's noise: eps of its z, its marginal-KL draws and, with dropout,
    the keep masks of its two dropouts."""
    drop, sample, mi = jax.random.split(rng, 3)
    (_, _, q, z), state = module.apply(
        {"params": params}, jnp.asarray(ids),
        rngs={"dropout": drop, "sample": sample},
        capture_intermediates=True, mutable=["intermediates"])
    noise = {"eps": torch.from_numpy(np.array((z - q.loc) / q.scale)),
             "mi": torch.from_numpy(np.array(jax.random.normal(
                 mi, (mi_samples, ids.shape[0], q.loc.shape[-1]))))}
    if module.hparams.dropout > 0:
        outs = state["intermediates"]["drop"]["__call__"]
        noise["dropout"] = tuple(torch.from_numpy(np.array(o != 0))
                                 for o in outs)
    return noise


ELBO_CASES = {
    "bilstm-2-free-bits": {**VAE_FORMS["bilstm-2"], "free_bits": 0.05},
    "perceiver": VAE_FORMS["perceiver-untied-embeddings"],
    "dropout": {"bidirectional_encoder": True, "dropout": 0.3},
}


@pytest.mark.parametrize("case", sorted(ELBO_CASES))
def test_elbo_and_every_gradient_match_jax(case):
    """VAEObjective.loss of the LSTM-VAE on ragged rows with a filler
    row at step 3 of a KL annealing (weight 0.44), with JAX's draws:
    the loss and every metric at 2e-5, every gradient at 2e-3 of its
    largest entry (the free-bits floor clamps some dimensions; dropout
    at 0.3 on the decoder's embeddings and outputs)."""
    module, params, model = vae_pair(20, **{**VAE_KW, **ELBO_CASES[case]})
    model.train().requires_grad_(True)
    ids = documents(21, [16, 11, 4, 0])
    jb, tb = _batch(ids)
    jobj, tobj = jvae.VAEObjective(module.hparams), tvae.VAEObjective(
        model.hparams)
    rng = jax.random.PRNGKey(22)
    (want, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: jobj.loss(module, p, jb, STEP, rng), has_aux=True))(
        params)
    loss, got = tobj.loss(model, tb, STEP, _elbo_noise(
        module, params, ids, rng, tobj.mi_samples))
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=RTOL)
    assert set(got) == set(metrics)
    for name, value in metrics.items():
        np.testing.assert_allclose(float(got[name]), float(value), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    _assert_grads_match(model, _leaf_grads(grads))
    if case.endswith("free-bits"):
        kl = model.posterior(tb["token_ids"], get_kl=True)[1]
        assert bool((kl[:3] < 0.05).any())


def test_dreg_bound_and_every_gradient_match_jax():
    """train_mc_samples 3 (the K-sample IWAE bound with the DReG
    gradient) on the LSTM-VAE, whose hparams have no loss_chunk_size or
    sp_size: full logits, as in JAX. The loss, train_iwae_log_prob and
    every gradient against JAX's with its eps (normal(sample key, [K, B,
    latent]))."""
    module, params, model = vae_pair(23, train_mc_samples=3,
                                     bidirectional_encoder=True)
    model.train().requires_grad_(True)
    ids = documents(24, [16, 9, 5, 0])
    jb, tb = _batch(ids)
    jobj, tobj = jvae.VAEObjective(module.hparams), tvae.VAEObjective(
        model.hparams)
    rng = jax.random.PRNGKey(25)
    (want, metrics), grads = jax.jit(jax.value_and_grad(
        lambda p: jobj.loss(module, p, jb, STEP, rng), has_aux=True))(
        params)
    _, sample, _ = jax.random.split(rng, 3)
    eps = torch.from_numpy(np.array(jax.random.normal(sample, (3, 4, 4))))
    loss, got = tobj.loss(model, tb, STEP, {"eps": eps})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=RTOL)
    np.testing.assert_allclose(float(got["train_iwae_log_prob"]),
                               float(metrics["train_iwae_log_prob"]),
                               rtol=RTOL)
    _assert_grads_match(model, _leaf_grads(grads))


@pytest.mark.parametrize("method", ["reconstruct_ll", "reconstruct"])
def test_iwae_estimate_matches_jax(method):
    """estimate_log_prob_iw of the LSTM-VAE, 6 samples in 3 chunks, on
    ragged rows: log p(x) at 2e-5 of JAX's with its draws (through the
    chunked log-likelihood and through the full logits)."""
    module, params, model = vae_pair(26, bidirectional_encoder=True,
                                     num_layers=2)
    ids = documents(27, [16, 12, 3])
    v = {"params": params}
    posterior = module.apply(v, jnp.asarray(ids), method=JVAE.posterior)
    rng = jax.random.PRNGKey(28)
    want = jvae.estimate_log_prob_iw(
        lambda z: module.apply(v, jnp.asarray(ids), z,
                               method=getattr(JVAE, method)),
        posterior, jnp.asarray(ids), rng, 6, 3)
    eps = torch.from_numpy(_iw_eps(rng, posterior.loc.shape, 6, 3))
    with torch.no_grad():
        ids_t = torch.from_numpy(ids)
        got = tvae.estimate_log_prob_iw(getattr(model, method),
                                        model.posterior(ids_t), ids_t, 6, 3,
                                        eps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)


@pytest.mark.parametrize("form", ["tied", "gru-tied-2"])
def test_ar_loss_eval_stats_and_gradients_match_jax(form):
    """ARObjective on the LSTM LM (the full-logits branch: the LSTM LM has
    no forward_hidden): the loss and every gradient, and eval_stats,
    against JAX's."""
    module, params, model = lm_pair(29, **LM_FORMS[form])
    model.train().requires_grad_(True)
    ids = documents(30, [16, 10, 0])
    jb, tb = _batch(ids)
    jobj, tobj = JARObjective(module.hparams), ARObjective(model.hparams)
    (want, _), grads = jax.jit(jax.value_and_grad(
        lambda p: jobj.loss(module, p, jb, STEP, jax.random.PRNGKey(0)),
        has_aux=True))(params)
    loss, _ = tobj.loss(model, tb, STEP)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=RTOL)
    _assert_grads_match(model, _leaf_grads(grads))
    j_stats = jobj.eval_stats(module, params, jb, jax.random.PRNGKey(0))
    with torch.no_grad():
        t_stats = tobj.eval_stats(model, tb)
    for name in ("nll_sum", "token_count", "byte_count", "loss_sum"):
        np.testing.assert_allclose(float(t_stats[name]),
                                   float(j_stats[name]), rtol=RTOL)


@pytest.mark.parametrize("experiment", ["lstm-vae", "lstm-lm"])
def test_one_radam_step_matches_jax(experiment):
    """One optimizer step of JAX's make_train_step (mesh=None) and the
    port's train_step on the same micro-batch with JAX's draws: the
    metrics at 2e-5 and every parameter after the step at 1e-6."""
    if experiment == "lstm-vae":
        module, params, model = vae_pair(31, bidirectional_encoder=True,
                                         **VAE_KW)
        jobj, tobj = (jvae.VAEObjective(module.hparams),
                      tvae.VAEObjective(model.hparams))
    else:
        module, params, model = lm_pair(31, num_layers=2,
                                        tie_logit_weights=True)
        jobj, tobj = JARObjective(module.hparams), ARObjective(model.hparams)
    model.train().requires_grad_(True)
    ids = documents(32, [16, 13, 6])
    jb, tb = _batch(ids)
    key = jax.random.PRNGKey(33)
    noise = None
    if experiment == "lstm-vae":
        noise = [_elbo_noise(module, params, ids,
                             jax.random.split(key, 1)[0], tobj.mi_samples)]
    kw = dict(lr=1e-2, lr_decay_steps=100, grad_clip_threshold=1.0)
    optimizer = j_make_opt(**kw)
    step_fn = make_train_step(module, jobj, optimizer, mesh=None)
    new_params, _, metrics = step_fn(
        params, optimizer.init(params),
        {k: v[None] for k, v in jb.items()}, STEP, key)
    got = train_step(model, tobj, make_optimizer(model.parameters(), **kw),
                     [tb], STEP, noise)
    assert set(got) == set(metrics)
    for name, value in metrics.items():
        np.testing.assert_allclose(float(got[name]), float(value), rtol=RTOL,
                                   atol=ATOL, err_msg=name)
    named = dict(model.named_parameters())
    for path, want in _leaf_grads(new_params).items():
        key_, transpose = ckpt.torch_key(path)
        p = named[key_].detach().numpy()
        np.testing.assert_allclose(p.T if transpose else p, want, atol=1e-6,
                                   err_msg=path)


# -- the fitted runs and the entry points -------------------------------------

FIT_MODELS = {
    "lstm-vae": {"d_model": 64, "d_embedding": 32, "latent_depth": 8,
                 "vocab_size": 1024, "bidirectional_encoder": True,
                 "tie_logit_weights": True, "lr": 1e-3,
                 "lr_decay_steps": 1000},
    "lstm-lm": {"d_model": 64, "d_embedding": 32, "num_layers": 2,
                "vocab_size": 1024, "tie_logit_weights": True, "lr": 1e-3,
                "lr_decay_steps": 1000},
}


def _fit(experiment: str, max_steps: int, resume: bool):
    dm = TextDataModule(TextDataModuleHparams(
        dataset_name="synthetic", synthetic_docs=120, vocab_size=1024,
        min_tokens_per_sample=16, max_tokens_per_sample=256,
        tokens_per_batch=2048))
    dm.prepare_data()
    hp, objective = tcli.build_hparams(experiment, FIT_MODELS[experiment])
    sample_fn, reconstruct_fn = tcli.make_sample_fns(experiment, objective,
                                                     max_len=24)
    trainer = Trainer(hp, objective, dm, TrainerHparams(
        max_steps=max_steps, log_every_n_steps=1, checkpoint_every_n_steps=2,
        sample_every_n_steps=2, val_check_interval=1.5 / max(
            1, dm.num_batches("train"))),
        experiment=experiment, name="tiny", device="cpu",
        sample_fn=sample_fn, reconstruct_fn=reconstruct_fn)
    return trainer, trainer.fit(resume=resume)


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    """Both families fitted for 2 steps (a checkpoint and the sampling
    callback at step 2), then resumed to step 3, in a scratch working
    directory: {experiment: (trainer, first outcome, resumed outcome)};
    and the working directory."""
    cwd = tmp_path_factory.mktemp("lstm_runs")
    old = os.getcwd()
    os.chdir(cwd)
    try:
        runs = {}
        for experiment in FIT_MODELS:
            trainer, first = _fit(experiment, 2, False)
            again, resumed = _fit(experiment, 3, True)
            runs[experiment] = (trainer, first, again, resumed)
    finally:
        os.chdir(old)
    return runs, cwd


@pytest.mark.parametrize("experiment", sorted(FIT_MODELS))
def test_fit_trains_resumes_and_samples(fitted, experiment):
    """Trainer.fit from the JAX initialisation: finite losses at every
    step, a validation, the step-2 checkpoint, the sampling callback's
    records (an unconditional sample; for the VAE a reconstruction with
    its BLEU), no sampling error; the resumed fit restarts at step 2 and
    stops at 3."""
    runs, _ = fitted
    trainer, first, again, resumed = runs[experiment]
    assert (first.step, first.stopped_reason) == (2, "max_steps")
    assert (resumed.step, resumed.stopped_reason) == (3, "max_steps")
    records = [json.loads(x) for x in (trainer.run_dir / "metrics.jsonl")
               .read_text().splitlines()]
    steps = {r["step"] for r in records if "loss" in r}
    assert steps == {1, 2, 3}
    assert all(np.isfinite(r["loss"]) for r in records if "loss" in r)
    keys = set().union(*records)
    assert "val_nll" in keys and "text_sampling_error" not in keys
    assert "text_unconditional_sample" in keys or experiment == "lstm-vae"
    if experiment == "lstm-vae":
        assert {"text_reconstruction", "train_bleu", "val_kl"} <= keys


@pytest.mark.parametrize("experiment", sorted(FIT_MODELS))
def test_test_entry_runs_the_lstm_families(fitted, experiment, capsys):
    """`test <experiment> tiny` on the fitted run: each batch's line is
    the model's own per-batch NLL (the IWAE through reconstruct_ll with
    batch i's generator for the VAE, 4 samples in 2 chunks;
    eval_stats for the LM), and the average a finite, positive mean of
    them. num_iter defaults to 20 for both (JAX's test.py)."""
    runs, cwd = fitted
    old = os.getcwd()
    os.chdir(cwd)
    try:
        average = test_entry.main(["test", experiment, "tiny",
                                   "num_samples=4", "num_iter=2",
                                   "device=cpu"])
        model, hp, objective, _, meta = load_checkpoint_for_name(
            experiment, "tiny", device="cpu")
        data = TextDataModule(TextDataModuleHparams(**meta["data_hparams"]))
        data.prepare_data()
    finally:
        os.chdir(old)
    lines = [x for x in capsys.readouterr().out.splitlines()
             if x.startswith("batch ")]
    assert lines and 0 < average < 20
    want = []
    with torch.no_grad():
        for i, batch in enumerate(data.epoch_batches("test", seed=0)):
            if not (np.asarray(batch.num_tokens) > 0).any():
                continue
            arrays = {k: torch.from_numpy(np.asarray(v)).long()
                      for k, v in batch._asdict().items()}
            if experiment == "lstm-vae":
                want.append(test_entry.batch_nll(
                    model, arrays, 4, 2,
                    generator=torch.Generator().manual_seed(i)))
            else:
                want.append(test_entry.lm_batch_nll(model, objective,
                                                    arrays))
    got = [float(x.split("last=")[1].split()[0]) for x in lines]
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def _archive(runs, experiment, root):
    trainer, _, again, resumed = runs[experiment]
    return ckpt.export_archive(resumed.model, again.meta(), root / experiment,
                               step=resumed.step)


def test_sample_entry_runs_the_lstm_families(fitted, tmp_path, monkeypatch):
    """`sample lstm-vae|lstm-lm <archive>`: batch i is the run's
    `sample(i, ...)`, trimmed at [SEP], through the lockstep loop's
    unfused selection; fused_select=1 and continuous=1 refuse, naming
    why."""
    runs, _ = fitted
    monkeypatch.chdir(tmp_path)
    train_tokenizer(iter(["A stand-in tokenizer for sampled ids."]), 1024,
                    save_path=tokenizer_cache_path("synthetic"))
    for experiment in FIT_MODELS:
        run = str(_archive(runs, experiment, tmp_path))
        out = sample_entry.main(["sample", experiment, run, "num_samples=5",
                                 "batch_size=3", "max_length=12",
                                 "device=cpu"])
        model, _, _ = ckpt.load_run(run, device="cpu")
        want = [row for i in range(2) for row in model.sample(i, 12, 3)]
        assert len(out["documents"]) == 5
        for got, row in zip(out["documents"], want):
            row = row.numpy()
            ends = np.flatnonzero(row == 2)
            np.testing.assert_array_equal(
                got, row[:ends[0] + 1] if len(ends) else row)
        with pytest.raises(SystemExit, match="unfused"):
            sample_entry.main(["sample", experiment, run, "fused_select=1",
                               "device=cpu"])
        with pytest.raises(ValueError, match="lockstep"):
            sample_entry.main(["sample", experiment, run, "continuous=1",
                               "num_samples=2", "batch_size=2",
                               "device=cpu"])


def test_gen_bench_takes_an_lstm_draft(fitted, tmp_path):
    """gen_bench's spec_draft row with an lstm-lm draft (a tiny sparse
    transformer target at batch 1 x 48): the row's tokens equal the
    target's spec_draft_generate with checkpoint.load_draft's pair, and
    greedily the target's `ar` row."""
    from tests.test_torch_spec_decode import pair
    runs, _ = fitted
    target = pair(vocab_size=1024)[2]
    tdir = ckpt.export_archive(target, {
        "experiment": "transformer-lm", "name": "target",
        "model_hparams": asdict(target.hparams), "data_hparams": {}},
        tmp_path / "target")
    draft = f"lstm-lm:{_archive(runs, 'lstm-lm', tmp_path)}"
    out = gen_bench.main(["gen_bench", "transformer-lm", str(tdir),
                          "seq=48", "window=16", "spec_k=3", "check=1",
                          "modes=greedy", f"spec_draft={draft}",
                          "device=cpu"])
    row = out["runs"][0]
    assert row["spec_model_mismatch_tokens"] == 0
    assert row["spec_model_accepted"] >= 0
    propose, fresh = ckpt.load_draft(draft, 3, "cpu")
    assert len(fresh(48)) == 2          # the LM's two layers' states
    vae = f"lstm-vae:{_archive(runs, 'lstm-vae', tmp_path)}"
    with pytest.raises(SystemExit, match="cannot draft"):
        ckpt.load_draft(vae, 3, "cpu")
