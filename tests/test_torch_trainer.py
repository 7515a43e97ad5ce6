"""The port's trainer loop (training/trainer.py, training/checkpointing.py,
the validation statistics of models/vae.py and the archive export of
checkpoint.py) on the CPU, against the JAX package where it has the same
function.

Tolerances, each stated where it is used:
- accumulation groups, early-stopping arming, val_every and checkpoint
  state: exact (integer bookkeeping; restored tensors bit for bit);
- eval_stats + reduce_eval on a tiny fp32 VAE with the JAX parameters
  and the JAX draw's eps: 2e-5 relative (fp32 summation order over a
  1,024-way softmax and two layers);
- the archive: r5's ckpt_bf16.npz reproduced bit for bit, and an
  exported model's bf16 logits equal to its own.
"""
import contextlib
import json
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze
from flax.traverse_util import flatten_dict

from sparse_vae_tpu import build_model
from sparse_vae_tpu.data import batching as jb
from sparse_vae_tpu.data import datasets as jd
from sparse_vae_tpu.models.vae import VAEObjective as JObjective
from sparse_vae_tpu.training import trainer as jtrainer
from sparse_vae_tpu.utils.config import TrainerHparams as JTrainerHparams
from sparse_vae_tpu_torch import checkpoint as ckpt
from sparse_vae_tpu_torch.cli import build_hparams
from sparse_vae_tpu_torch.data.text_data_module import (
    TextDataModule, TextDataModuleHparams)
from sparse_vae_tpu_torch.models.transformer_vae import (
    TransformerVAE, TransformerVAEHparams)
from sparse_vae_tpu_torch.models.vae import VAEObjective
from sparse_vae_tpu_torch.training import trainer as ttrainer
from sparse_vae_tpu_torch.training.checkpointing import latest_checkpoint_step
from sparse_vae_tpu_torch.utils.config import TrainerHparams
from tests.test_torch_checkpoint import r5_archive
from tests.test_torch_data import ragged_docs

EVAL_RTOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The models here are tiny: one intra-op thread runs them as fast
    and does not contend with the suite's other workers for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# -- accumulation groups and early stopping --------------------------------

def _drain(groups):
    return [(stacked, last) for stacked, last in groups]


@pytest.mark.parametrize("k", [1, 2, 3])
def test_defer_accum_groups_is_the_same(k):
    """The same stream of batches (a ragged corpus's epochs) grouped over
    three epochs by both packages: the same groups in the same order and
    the same partial groups left pending after each epoch."""
    docs, num_bytes, _, _ = ragged_docs(11, 90, 20_000)
    corpus = jd.TokenizedCorpus(docs=docs, num_bytes=num_bytes)
    got_pending, want_pending = {}, {}
    deferred = 0
    for epoch in range(3):
        batches = list(jb.iterate_epoch(corpus, 30_000, 512,
                                        np.random.default_rng(epoch)))
        got = _drain(ttrainer.defer_accum_groups(iter(batches), k,
                                                 got_pending))
        want = _drain(jtrainer.defer_accum_groups(iter(batches), k,
                                                  want_pending))
        assert len(got) == len(want)
        for (gs, gl), (ws, wl) in zip(got, want):
            assert sorted(gs) == sorted(ws)
            for name in ws:
                assert gs[name].shape[0] == k
                np.testing.assert_array_equal(gs[name], ws[name])
            assert gl is wl
        assert got_pending.keys() == want_pending.keys()
        for key in want_pending:
            assert [b is w for b, w in zip(got_pending[key],
                                           want_pending[key])] \
                == [True] * len(want_pending[key])
        deferred += sum(len(g) for g in want_pending.values())
    if k > 1:
        assert deferred, "no partial group was deferred"


EARLY_STOP_CASES = [
    # (early_stopping_start_step, kl_weight_start, kl_weight_end,
    #  kl_annealing_steps)
    (None, 0.1, 1.0, 2000),
    (None, 1.0, 1.0, 2000),
    (None, 0.1, 1.0, 0),
    (None, 0.1, 1.0, None),
    (None, None, None, None),
    (0, 0.1, 1.0, 2000),
    (500, 0.1, 1.0, 2000),
    (500, None, None, None),
]


@pytest.mark.parametrize("case", EARLY_STOP_CASES)
def test_early_stop_start_step_is_the_same(case):
    start, ws, we, steps = case
    hp = SimpleNamespace(**{k: v for k, v in (
        ("kl_weight_start", ws), ("kl_weight_end", we),
        ("kl_annealing_steps", steps)) if v is not None})
    got = ttrainer.early_stop_start_step(
        TrainerHparams(early_stopping_start_step=start), hp)
    want = jtrainer.early_stop_start_step(
        JTrainerHparams(early_stopping_start_step=start), hp)
    assert got == want


# -- validation statistics -------------------------------------------------

def _tiny_overrides(**kw):
    return {**dict(d_model=64, num_heads=2, num_layers=2, latent_depth=8,
                   vocab_size=1024, num_encoder_latents=4,
                   attn_window_size=2, attn_block_size=8,
                   loss_chunk_size=16, precision="fp32",
                   kl_annealing_steps=10, kl_weight_start=0.1,
                   kl_weight_end=1.0, free_bits=0.02,
                   grad_checkpointing=False), **kw}


def _eval_batches():
    rng = np.random.default_rng(5)
    out = []
    for lengths in ([32, 20, 11, 0], [27, 32, 16, 9]):
        ids = np.zeros((len(lengths), 32), np.int32)
        for row, n in enumerate(lengths):
            if n:
                ids[row, 0], ids[row, n - 1] = 1, 2
                ids[row, 1:n - 1] = rng.integers(3, 1024, size=n - 2)
        num_bytes = np.array([4 * n + row for row, n in enumerate(lengths)],
                             np.int32)
        out.append({"token_ids": ids,
                    "num_tokens": np.array(lengths, np.int32),
                    "num_bytes": num_bytes})
    return out


@pytest.mark.parametrize("loss_chunk_size", [16, 0])
def test_eval_stats_and_reduce_eval_match_jax(loss_chunk_size):
    """Two validation batches (one with a [PAD] row) through JAX's
    eval_stats with its rng and the port's with the eps that rng draws,
    summed and reduced. Both sides take their plain paths
    (use_pallas_kernel off: XLA in JAX, PyTorch here). The posterior's
    projection is scaled up 30 times in both, so the KL is of order 1:
    at initialisation it is ~1e-4 per token, the difference of O(1)
    terms of the closed form, and its relative error there is fp32
    rounding, not the function."""
    overrides = _tiny_overrides(loss_chunk_size=loss_chunk_size,
                                use_pallas_kernel=False)
    module, jhp, jobj = build_model("transformer-vae", overrides)
    batches = _eval_batches()
    params = jax.jit(module.init)(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
        jnp.asarray(batches[0]["token_ids"][:1]))["params"]
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: v * 30.0 if "q_of_z_given_x" in jax.tree_util
        .keystr(path) else v, params)
    leaves = {"/".join(k): np.array(v)
              for k, v in flatten_dict(unfreeze(params)).items()}
    hp, objective = build_hparams("transformer-vae", overrides)
    model = TransformerVAE(hp)
    model.load_state_dict(ckpt.state_from_leaves(leaves, hp), strict=True)
    eval_stats = jax.jit(lambda p, b, r: jobj.eval_stats(module, p, b, r))
    posterior_and_z = jax.jit(lambda p, ids, r: module.apply(
        {"params": p}, ids, rngs={"sample": r},
        method=type(module).posterior_and_z))
    want_totals, got_totals = {}, {}
    for i, batch in enumerate(batches):
        rng = jax.random.fold_in(jax.random.PRNGKey(7), i)
        stats = eval_stats(params, {
            k: jnp.asarray(v) for k, v in batch.items()}, rng)
        sample_rng, _ = jax.random.split(rng)
        q, _, z = posterior_and_z(params, jnp.asarray(batch["token_ids"]),
                                  sample_rng)
        eps = torch.from_numpy(np.array((z - q.loc) / q.scale))
        with torch.no_grad():
            got = objective.eval_stats(
                model, {k: torch.from_numpy(v).long()
                        for k, v in batch.items()}, {"eps": eps})
        assert sorted(got) == sorted(stats)
        for k in stats:
            want_totals[k] = want_totals.get(k, 0.0) + float(stats[k])
            got_totals[k] = got_totals.get(k, 0.0) + float(got[k])
    for k in want_totals:
        np.testing.assert_allclose(got_totals[k], want_totals[k],
                                   rtol=EVAL_RTOL, err_msg=k)
    got, want = objective.reduce_eval(got_totals), JObjective.reduce_eval(
        want_totals)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=EVAL_RTOL,
                                   err_msg=k)


# -- fit --------------------------------------------------------------------

def _data(tmp_path, monkeypatch, **kw):
    monkeypatch.chdir(tmp_path)
    dm = TextDataModule(TextDataModuleHparams(**{
        **dict(dataset_name="synthetic", synthetic_docs=200,
               vocab_size=1024, min_tokens_per_sample=16,
               max_tokens_per_sample=512, tokens_per_batch=4096), **kw}))
    dm.prepare_data()
    return dm


def _trainer(dm, tmp_path, model_kw=None, trainer_kw=None, cls=None):
    hp, objective = build_hparams("transformer-vae", {
        **dict(d_model=64, num_heads=4, num_layers=2, latent_depth=8,
               num_encoder_latents=8, vocab_size=1024, lr=1e-3,
               lr_decay_steps=1000), **(model_kw or {})})
    thp = TrainerHparams(**{**dict(max_steps=3, log_every_n_steps=1,
                                   checkpoint_every_n_steps=2,
                                   accumulate_grad_batches=2),
                            **(trainer_kw or {})})
    return (cls or ttrainer.Trainer)(hp, objective, dm, thp, name="tiny",
                                     log_root=tmp_path / "logs",
                                     device="cpu")


def _jax_names():
    """The JAX package's train and validation metric names: its
    compose_loss on sums with the marginal-KL term, plus the step's loss
    and grad_norm and fit's tokens_per_sec; its reduce_eval."""
    _, jhp, jobj = build_model("transformer-vae", _tiny_overrides())
    one = jnp.asarray(1.0)
    sums = {"nll_sum": one, "kl_sum": one, "raw_kl_sum": one,
            "marginal_kl_rows": one}
    _, metrics = jobj.compose_loss(sums, {"token_count": one,
                                          "row_count": one}, 0)
    train = set(metrics) | {"loss", "grad_norm", "tokens_per_sec"}
    val = set(JObjective.reduce_eval({
        "nll_sum": 1.0, "token_count": 1.0, "byte_count": 1.0,
        "kl_weighted_rows": 1.0, "row_count": 1.0}))
    return train, val


def _metric_names(run_dir):
    names = set()
    for line in (run_dir / "metrics.jsonl").read_text().splitlines():
        names |= set(json.loads(line)) - {"t", "step"}
    return names


def test_fit_stops_at_max_steps_with_jax_metric_names(tmp_path,
                                                      monkeypatch):
    dm = _data(tmp_path, monkeypatch)
    trainer = _trainer(dm, tmp_path, trainer_kw=dict(
        max_steps=4, val_check_interval=0.2))
    outcome = trainer.fit()
    assert (outcome.step, outcome.stopped_reason) == (4, "max_steps")
    k = trainer.thp.accumulate_grad_batches
    assert trainer.val_every == max(1, int(
        max(1, dm.num_batches("train")) * 0.2 / k))
    train, val = _jax_names()
    assert _metric_names(trainer.run_dir) == train | val
    assert [h["step"] for h in outcome.metrics_history] == list(
        range(trainer.val_every, 5, trainer.val_every))
    assert latest_checkpoint_step(trainer.ckpt.dir) == 4
    meta = json.loads((trainer.ckpt.dir / "meta.json").read_text())
    assert meta["model_hparams"]["d_model"] == 64
    assert meta["trainer_hparams"]["max_steps"] == 4


def test_val_every_is_the_jax_formula(tmp_path, monkeypatch):
    """val_every from the port's data module equals the JAX formula on
    the JAX package's data module of the same hparams."""
    from sparse_vae_tpu.data.text_data_module import (
        TextDataModule as JDataModule, TextDataModuleHparams as JDataHp)
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    dm = _data(tmp_path / "t", monkeypatch)
    monkeypatch.chdir(tmp_path / "j")
    jdm = JDataModule(JDataHp(**vars(dm.hparams)))
    jdm.prepare_data()
    for vci, k in ((1.0, 2), (0.25, 2), (0.1, 1), (0.5, 4)):
        trainer = _trainer(dm, tmp_path, trainer_kw=dict(
            max_steps=1, val_check_interval=vci, accumulate_grad_batches=k))
        trainer.fit()
        want = max(1, int(max(1, jdm.num_batches("train")) * vci / k))
        assert trainer.val_every == want


def test_fit_stops_when_the_lr_schedule_completes(tmp_path, monkeypatch):
    dm = _data(tmp_path, monkeypatch)
    trainer = _trainer(dm, tmp_path, model_kw=dict(lr_decay_steps=3),
                       trainer_kw=dict(max_steps=None))
    outcome = trainer.fit()
    assert (outcome.step, outcome.stopped_reason) == (
        3, "lr_schedule_complete")


def test_fit_stops_early(tmp_path, monkeypatch):
    """lr 0: the parameters never move, so val_nll moves with the
    validation noise alone and stops improving within a few validations;
    patience 1 then stops the run. The best step's checkpoint is kept."""
    dm = _data(tmp_path, monkeypatch)
    trainer = _trainer(dm, tmp_path, model_kw=dict(lr=0.0), trainer_kw=dict(
        max_steps=40, val_check_interval=0.01, early_stopping_patience=1,
        accumulate_grad_batches=1))
    outcome = trainer.fit()
    assert outcome.stopped_reason == "early_stopping"
    nll = [h["val_nll"] for h in outcome.metrics_history]
    assert nll[-1] >= min(nll[:-1]) and outcome.best_metric == min(nll)
    best = trainer.ckpt.best_step()
    assert best == outcome.metrics_history[int(np.argmin(nll))]["step"]
    assert (trainer.ckpt.dir / f"step_{best}").is_dir()


def test_early_stopping_waits_for_the_kl_annealing(tmp_path, monkeypatch):
    dm = _data(tmp_path, monkeypatch)
    trainer = _trainer(dm, tmp_path, model_kw=dict(
        lr=0.0, kl_weight_start=0.1, kl_annealing_steps=30),
        trainer_kw=dict(max_steps=6, val_check_interval=0.01,
                        early_stopping_patience=1,
                        accumulate_grad_batches=1))
    outcome = trainer.fit()
    assert (outcome.step, outcome.stopped_reason) == (6, "max_steps")
    assert outcome.best_metric is None
    assert trainer.ckpt.best_step() is None


def test_profile_steps_writes_a_trace(tmp_path, monkeypatch):
    dm = _data(tmp_path, monkeypatch)
    trainer = _trainer(dm, tmp_path, trainer_kw=dict(
        max_steps=5, profile_steps=1, accumulate_grad_batches=1))
    trainer.fit()
    traces = list(trainer.run_dir.glob("trace_steps_*.json"))
    assert [p.name for p in traces] == ["trace_steps_3-4.json"]
    assert json.loads(traces[0].read_text())["traceEvents"]


def test_validation_is_a_function_of_params_and_step(tmp_path, monkeypatch):
    dm = _data(tmp_path, monkeypatch)
    trainer = _trainer(dm, tmp_path)
    model, _ = trainer.init_state(torch.Generator().manual_seed(0))
    a = trainer.validate(model, step=5)
    assert trainer.validate(model, step=5) == a
    assert trainer.validate(model, step=6) != a
    assert set(a) == {"val_nll", "val_bpb", "val_kl", "val_loss"}


def test_unported_configurations_raise(tmp_path, monkeypatch):
    dm = _data(tmp_path, monkeypatch)
    for kw in (dict(num_devices=2), dict(seq_parallel=4),
               dict(model_parallel=2), dict(expert_parallel=2)):
        with pytest.raises(NotImplementedError):
            _trainer(dm, tmp_path, trainer_kw=kw)


# -- resume -----------------------------------------------------------------

class _Capturing(ttrainer.Trainer):
    """Keeps a CPU copy of every state it saves."""
    saved = None

    def _save(self, model, optimizer, step, generator, best=False):
        super()._save(model, optimizer, step, generator, best)
        if self.saved is None:
            self.saved = {}
        state = self.state(model, optimizer, step, generator)
        self.saved[step] = {
            "params": {k: v.detach().clone()
                       for k, v in state["params"].items()},
            "optimizer": {
                "count": state["optimizer"]["count"],
                "exp_avg": [m.clone() for m in state["optimizer"]["exp_avg"]],
                "exp_avg_sq": [v.clone() for v in
                               state["optimizer"]["exp_avg_sq"]]},
            "step": step, "generator": state["generator"].clone()}


def _assert_state_equal(got, want):
    assert got["step"] == want["step"]
    assert torch.equal(got["generator"], want["generator"])
    assert got["params"].keys() == want["params"].keys()
    for k in want["params"]:
        assert torch.equal(got["params"][k], want["params"][k]), k
    assert got["optimizer"]["count"] == want["optimizer"]["count"]
    for name in ("exp_avg", "exp_avg_sq"):
        assert len(got["optimizer"][name]) == len(want["optimizer"][name])
        for a, b in zip(got["optimizer"][name], want["optimizer"][name]):
            assert torch.equal(a, b), name


def test_resume_restores_the_state_and_the_next_step(tmp_path,
                                                     monkeypatch):
    """The step-2 checkpoint restores params, both moments, the step
    count and the noise generator bit for bit; one optimizer step from
    the restored state equals the same step from the saved one. (A
    resumed fit restarts the data stream at epoch 0, as the JAX trainer
    does, so it is not compared with an unbroken run step for step.)"""
    dm = _data(tmp_path, monkeypatch)
    trainer = _trainer(dm, tmp_path, trainer_kw=dict(max_steps=4),
                       cls=_Capturing)
    trainer.fit()
    saved = trainer.saved[2]
    model, optimizer = trainer.init_state(torch.Generator().manual_seed(1))
    generator = torch.Generator().manual_seed(1)
    assert trainer.restore(model, optimizer, generator, step=2) == 2
    _assert_state_equal(trainer.state(model, optimizer, 2, generator),
                        saved)

    twin, twin_opt = trainer.init_state(torch.Generator().manual_seed(2))
    twin.load_state_dict(saved["params"])
    twin_opt.load_state_tensors(saved["optimizer"])
    twin_gen = torch.Generator().manual_seed(3)
    twin_gen.set_state(saved["generator"])
    group = next(iter(dm.epoch_batches("train", seed=5)))
    stacked = ttrainer.stack_microbatches([group, group])
    trainer._step(model, optimizer, stacked, 2, generator)
    trainer._step(twin, twin_opt, stacked, 2, twin_gen)
    _assert_state_equal(trainer.state(model, optimizer, 3, generator),
                        trainer.state(twin, twin_opt, 3, twin_gen))


def test_fit_resumes_from_the_newest_checkpoint(tmp_path, monkeypatch):
    dm = _data(tmp_path, monkeypatch)
    first = _trainer(dm, tmp_path, trainer_kw=dict(max_steps=2),
                     cls=_Capturing)
    first.fit()
    second = _trainer(dm, tmp_path, trainer_kw=dict(max_steps=5),
                      cls=_Capturing)
    outcome = second.fit(resume=True)
    assert (outcome.step, outcome.stopped_reason) == (5, "max_steps")
    steps = [json.loads(line)["step"] for line in
             (second.run_dir / "metrics.jsonl").read_text().splitlines()
             if "loss" in json.loads(line)]
    assert steps == [1, 2, 3, 4, 5]
    # Saved at steps 2, 4 and 5 (every 2 steps and at the end); keep = 3.
    assert sorted(int(p.name[5:]) for p in second.ckpt.dir.glob("step_*")) \
        == [2, 4, 5]


def test_checkpoint_keeps_the_best_and_the_newest(tmp_path):
    from sparse_vae_tpu_torch.training.checkpointing import CheckpointManager
    mgr = CheckpointManager("transformer-vae", "gc", tmp_path, keep=2)
    for step in (1, 2, 3, 4, 5):
        mgr.save(step, {"step": step}, meta={"m": 1}, best=step == 2)
    assert sorted(int(p.name[5:]) for p in mgr.dir.glob("step_*")) == [
        2, 4, 5]
    assert mgr.best_step() == 2 and mgr.restore()["step"] == 5
    assert mgr.restore(2)["step"] == 2
    assert json.loads((mgr.dir / "meta.json").read_text()) == {"m": 1}


# -- archive ----------------------------------------------------------------

def test_export_archive_reproduces_r5(tmp_path):
    """load_run("real-prose-vae-r5") then export_archive: every entry of
    r5's ckpt_bf16.npz bit for bit with the same key set, the same leaf
    dtypes and meta, and load_run(<dir>) reads it back equal."""
    model, _, meta = ckpt.load_run("real-prose-vae-r5", device="cpu")
    out = ckpt.export_archive(model, meta, tmp_path / "r5", step=2769)
    want = r5_archive()
    with np.load(out / "ckpt_bf16.npz") as npz:
        got = {k: npz[k] for k in npz.files}
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    r5_dir = ckpt.REPO_ROOT / "runs" / "real-prose-vae-r5"
    want_meta = json.loads((r5_dir / "ckpt_meta.json").read_text())
    got_meta = json.loads((out / "ckpt_meta.json").read_text())
    assert got_meta == want_meta
    assert json.loads((out / "meta.json").read_text()) == meta
    again, _, _ = ckpt.load_run(str(out), device="cpu")
    for (k, a), b in zip(model.state_dict().items(),
                         again.state_dict().values()):
        assert torch.equal(a, b), k


def test_exported_model_serves_the_same_logits(tmp_path, monkeypatch):
    """A trained tiny model's archive, loaded in the serving form, gives
    the bf16 logits of the model's own serving form."""
    dm = _data(tmp_path, monkeypatch)
    trainer = _trainer(dm, tmp_path, model_kw=dict(precision="bf16"),
                       trainer_kw=dict(max_steps=2))
    outcome = trainer.fit()
    out = ckpt.export_archive(outcome.model, trainer.meta(), tmp_path / "a",
                              step=outcome.step)
    served, _, _ = ckpt.load_run(str(out), device="cpu")
    own = ckpt.serving_form(outcome.model)
    ids = torch.from_numpy(np.random.default_rng(0).integers(
        3, 1024, size=(2, 64)))
    ids[:, 0] = 1
    eps = torch.zeros((2, 1, 8))
    with torch.no_grad():
        got = served(ids, eps)[0]
        want = own(ids, eps)[0]
    assert got.dtype == want.dtype == torch.float32
    assert torch.equal(got, want)


@pytest.mark.parametrize("name", ["real-prose-vae-r5",
                                  "real-prose-pg19-fb8"])
def test_a_bare_run_name_is_the_repo_run_whatever_the_cwd(
        tmp_path, monkeypatch, name):
    """A directory of the working directory named like a run, holding an
    archive's meta.json, does not shadow runs/<name>; a path to it does
    name it."""
    monkeypatch.chdir(tmp_path)
    (tmp_path / name).mkdir()
    (tmp_path / name / "meta.json").write_text("{}")
    repo_run = ckpt.REPO_ROOT / "runs" / name
    assert ckpt.run_directory(name) == repo_run
    assert ckpt.run_directory(f"./{name}") == Path(name)
    assert ckpt.run_directory(tmp_path / name) == tmp_path / name
    _, _, meta = ckpt.load_run(name, device="cpu")
    assert meta == json.loads((repo_run / "meta.json").read_text())


@pytest.mark.parametrize("grad_checkpointing", [True, False])
def test_fit_says_that_remat_is_not_applied(tmp_path, monkeypatch, capsys,
                                            grad_checkpointing):
    dm = _data(tmp_path, monkeypatch)
    trainer = _trainer(dm, tmp_path, model_kw=dict(
        grad_checkpointing=grad_checkpointing,
        remat_policy="dots_attn_qkv"), trainer_kw=dict(max_steps=1))
    trainer.fit()
    said = [line for line in capsys.readouterr().out.splitlines()
            if "grad_checkpointing" in line]
    assert len(said) == int(grad_checkpointing)
    if grad_checkpointing:
        assert "'dots_attn_qkv'" in said[0] and "not applied" in said[0]


def test_the_stand_in_validation_sees_the_attention_band():
    """chip_smoke.py holds validation through the kernels against the
    plain versions on r5's trained weights, val_nll within
    TRAIN_LOSS_RTOL, on documents that repeat a segment of VAL_PERIOD ids
    (fit_corpus with a period). There val_nll depends on the attention
    band: on the plain path in fp32, dropping each query block's older
    band block (band_without_block("older"), the cut the card run also
    makes) moves val_nll by at least VAL_POWER x TRAIN_LOSS_RTOL, so the
    check can fail a K1 with a wrong band."""
    import chip_smoke as cs
    model, hp, _ = ckpt.load_run(cs.RUN, device="cpu", train=True,
                                 use_kernels=False, dtype=torch.float32)
    objective = VAEObjective(hp)
    eps = torch.randn((2, 1, hp.latent_depth),
                      generator=torch.Generator().manual_seed(0))
    corpus = cs.fit_corpus(2, 1536, 1536, hp.vocab_size, cs.FIT_SEED,
                           period=cs.VAL_PERIOD)
    batch = {"token_ids": torch.from_numpy(
                 np.stack(corpus.docs).astype(np.int64)),
             "num_tokens": torch.full((2,), 1536),
             "num_bytes": torch.from_numpy(corpus.num_bytes)}

    def val_nll(cut):
        with torch.no_grad(), (cs.band_without_block("older") if cut
                               else contextlib.nullcontext()):
            stats = objective.eval_stats(model, batch, {"eps": eps})
        return float(stats["nll_sum"] / stats["token_count"])

    right, cut = val_nll(False), val_nll(True)
    assert abs(cut - right) / right >= cs.VAL_POWER * cs.TRAIN_LOSS_RTOL


def test_torch_key_inverts_flax_path():
    hp = TransformerVAEHparams(d_model=64, num_heads=2, num_layers=3,
                               vocab_size=1024, num_encoder_latents=4)
    model = TransformerVAE(hp)
    for key in model.state_dict():
        path, transpose = ckpt.flax_path(model, key)
        assert ckpt.torch_key(path) == (key, transpose)
