"""The multi-sample (IWAE/DReG) branch of the port's VAEObjective in a
whole train step and in `Trainer.fit`, `load_checkpoint_for_name` and
the `test` entry, against the JAX package on the CPU
(tests/test_torch_eval.py holds the estimators themselves).

JAX draws its own noise; each test rebuilds its draws and hands them to
the port as eps, as tests/test_torch_eval.py says. Tolerances are
stated at each test.
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
from sparse_vae_tpu.parallel.spmd import make_train_step
from sparse_vae_tpu.training.optimizer import make_optimizer as j_make_opt
from sparse_vae_tpu_torch import checkpoint as ckpt
from sparse_vae_tpu_torch import load_checkpoint_for_name
from sparse_vae_tpu_torch.models import vae as tvae
from sparse_vae_tpu_torch.models.transformer_vae import (
    TransformerVAE, TransformerVAEHparams)
from sparse_vae_tpu_torch.training.optimizer import make_optimizer
from sparse_vae_tpu_torch.training.train_step import train_step
from tests.test_torch_eval import (LL_RTOL, _dreg_eps, _iw_eps, _tiny,
                                   _tiny_pair)
from tests.test_torch_train import _documents, _leaf_grads


# -- VAEObjective's multi-sample branch ------------------------------------

def test_two_microbatch_dreg_train_step_matches_jax():
    """One optimizer step over two micro-batches of a tiny random model
    with train_mc_samples 4 against make_train_step (mesh=None): loss,
    train_iwae_log_prob and grad_norm (2e-5 relative + 2e-6), and every
    parameter after the step (1e-6 absolute), as
    tests/test_torch_train.py::test_two_microbatch_train_step_matches_jax.
    eps is read off the JAX step's rng: per micro-batch split(key, 2),
    then the sample key of split(r, 3), normal(sample, (4, B, 1,
    latent))."""
    module, jhp, jobj, hp = _tiny(train_mc_samples=4)
    rng = np.random.default_rng(9)
    mbs = [_documents(rng, lengths, 32, hp.vocab_size)
           for lengths in ([32, 20, 11], [27, 32, 16])]
    params = module.init({"params": jax.random.PRNGKey(0),
                          "sample": jax.random.PRNGKey(1)},
                         jnp.asarray(mbs[0][0][:1]))["params"]
    leaves = {k: np.array(v) for k, v in _leaf_grads(params).items()}
    optimizer = j_make_opt(lr=jhp.lr, lr_decay_steps=jhp.lr_decay_steps,
                           grad_clip_threshold=jhp.grad_clip_threshold)
    key, step = jax.random.PRNGKey(5), 3
    noise = []
    for r in jax.random.split(key, 2):
        _, sample, _ = jax.random.split(r, 3)
        noise.append({"eps": _dreg_eps(sample, 4, 3, hp.latent_depth)})
    batch = {"token_ids": jnp.asarray(np.stack([m[0] for m in mbs])),
             "num_tokens": jnp.asarray(np.stack([m[1] for m in mbs])),
             "num_bytes": jnp.asarray(np.stack([m[1] for m in mbs]))}
    step_fn = make_train_step(module, jobj, optimizer, mesh=None)
    new_params, _, metrics = step_fn(params, optimizer.init(params), batch,
                                     step, key)

    model = TransformerVAE(hp)
    model.load_state_dict(ckpt.state_from_leaves(leaves, hp), strict=True)
    topt = make_optimizer(model.parameters(), lr=hp.lr,
                          lr_decay_steps=hp.lr_decay_steps,
                          grad_clip_threshold=hp.grad_clip_threshold)
    got = train_step(model, tvae.VAEObjective(hp), topt,
                     [{"token_ids": torch.from_numpy(ids),
                       "num_tokens": torch.from_numpy(n)}
                      for ids, n in mbs], step, noise)
    assert set(got) == set(metrics)
    for name in ("loss", "train_iwae_log_prob", "grad_norm"):
        np.testing.assert_allclose(got[name].item(), float(metrics[name]),
                                   rtol=2e-5, atol=2e-6, err_msg=name)
    named = dict(model.named_parameters())
    for path, want in _leaf_grads(new_params).items():
        key_, transpose = ckpt.torch_key(path)
        p = named[key_].detach().numpy()
        np.testing.assert_allclose(p.T if transpose else p, want, atol=1e-6,
                                   err_msg=path)


def test_dreg_compose_loss_is_linear_in_its_sums_and_matches_jax():
    """The sharded step's contract (parallel/spmd.py): the gradient of
    compose_loss in the sums is the same at two points, and the value
    and metric equal JAX's (tests/test_parallel.py's linearity check of
    the DReG branch)."""
    objective = tvae.VAEObjective(TransformerVAEHparams(train_mc_samples=4))
    jobj = jvae.VAEObjective(jvae.ContinuousVAEHparams(train_mc_samples=4))
    counts = {"token_count": torch.tensor(0.0), "row_count": torch.tensor(4.0)}
    grads = []
    for scale in (1.0, 3.0):
        sums = {"neg_bound_sum": torch.tensor(-12.0 * scale + 1.0,
                                              requires_grad=True),
                "bound_sum": torch.tensor(12.0 * scale, requires_grad=True)}
        loss, metrics = objective.compose_loss(sums, counts, 0)
        grads.append(torch.autograd.grad(loss, list(sums.values()),
                                         allow_unused=True))
        want, want_metrics = jobj.compose_loss(
            {k: jnp.asarray(v.item()) for k, v in sums.items()},
            {k: jnp.asarray(v.item()) for k, v in counts.items()}, 0)
        assert loss.item() == pytest.approx(float(want), rel=1e-7)
        assert set(metrics) == set(want_metrics)
        assert metrics["train_iwae_log_prob"].item() == pytest.approx(
            float(want_metrics["train_iwae_log_prob"]), rel=1e-7)
    assert grads[0][0].item() == grads[1][0].item() == 0.25
    assert grads[0][1] is None and grads[1][1] is None


def test_multi_sample_training_refuses_free_bits_and_a_seq_mesh_without_ll():
    """As the reference: free bits with K > 1 is a ValueError (the bound
    has no KL term to floor); a length-sharded model needs the chunked
    reconstruct_ll path."""
    module, params, model, ids, num_tokens = _tiny_pair(10)
    batch = {"token_ids": torch.from_numpy(ids),
             "num_tokens": torch.from_numpy(num_tokens)}
    objective = tvae.VAEObjective(TransformerVAEHparams(
        **{**vars(model.hparams), "train_mc_samples": 2, "free_bits": 0.5}))
    with pytest.raises(ValueError, match="free_bits"):
        objective.loss_sums(model, batch)
    hp = TransformerVAEHparams(**{**vars(model.hparams),
                                  "train_mc_samples": 2,
                                  "loss_chunk_size": 0})
    model.hparams = TransformerVAEHparams(**{**vars(hp), "sp_size": 4})
    with pytest.raises(ValueError, match="seq"):
        tvae.VAEObjective(hp).loss_sums(model, batch)


# -- fit, the checkpoint loader and the test entry -------------------------

@pytest.fixture(scope="module")
def tiny_run(tmp_path_factory):
    """A tiny model trained by Trainer.fit with train_mc_samples 2 on the
    synthetic corpus (3 steps, checkpoints at steps 2 and 3, the best
    at the step-2 validation) in a scratch working directory; returns
    (working directory, the fit's outcome, its trainer)."""
    from sparse_vae_tpu_torch.cli import build_hparams
    from sparse_vae_tpu_torch.data.text_data_module import (
        TextDataModule, TextDataModuleHparams)
    from sparse_vae_tpu_torch.training.trainer import Trainer
    from sparse_vae_tpu_torch.utils.config import TrainerHparams

    cwd = tmp_path_factory.mktemp("run")
    old, threads = os.getcwd(), torch.get_num_threads()
    os.chdir(cwd)
    torch.set_num_threads(1)
    try:
        dm = TextDataModule(TextDataModuleHparams(
            dataset_name="synthetic", synthetic_docs=200, vocab_size=1024,
            min_tokens_per_sample=16, max_tokens_per_sample=512,
            tokens_per_batch=4096))
        dm.prepare_data()
        hp, objective = build_hparams("transformer-vae", dict(
            d_model=64, num_heads=4, num_layers=2, latent_depth=8,
            num_encoder_latents=8, vocab_size=1024, lr=1e-3,
            lr_decay_steps=1000, train_mc_samples=2, loss_chunk_size=256))
        trainer = Trainer(hp, objective, dm, TrainerHparams(
            max_steps=3, log_every_n_steps=1, checkpoint_every_n_steps=2,
            accumulate_grad_batches=1, val_check_interval=2.5 / max(
                1, dm.num_batches("train"))), name="tiny", device="cpu")
        outcome = trainer.fit()
    finally:
        os.chdir(old)
        torch.set_num_threads(threads)
    return cwd, outcome, trainer


def test_fit_trains_the_dreg_bound(tiny_run):
    """Trainer.fit with train_mc_samples 2: every step logs a finite
    loss, the reference's train_iwae_log_prob and grad_norm, and
    tokens_per_sec from the batches' own token counts."""
    cwd, outcome, trainer = tiny_run
    assert (outcome.step, outcome.stopped_reason) == (3, "max_steps")
    by_step = {}
    for line in (trainer.run_dir / "metrics.jsonl").read_text().splitlines():
        record = json.loads(line)
        by_step.setdefault(record["step"], {}).update(record)
    assert sorted(by_step) == [1, 2, 3]
    assert "val_nll" in by_step[2]
    for m in by_step.values():
        assert {"loss", "train_iwae_log_prob", "grad_norm",
                "tokens_per_sec"} <= set(m)
        assert "train_nll" not in m
        assert all(np.isfinite(m[k]) for k in ("loss", "train_iwae_log_prob",
                                              "grad_norm", "tokens_per_sec"))
        assert m["tokens_per_sec"] > 0


@pytest.mark.parametrize("step,want", [(None, 3), (2, 2), ("best", 2)])
def test_load_checkpoint_for_name_restores_the_saved_step(tiny_run, step,
                                                          want):
    cwd, _, trainer = tiny_run
    root = cwd / "sparse-vae-logs"
    model, hp, objective, state, meta = load_checkpoint_for_name(
        "transformer-vae", "tiny", root=root, step=step, device="cpu")
    assert state["step"] == want and hp.train_mc_samples == 2
    assert meta["model_hparams"]["d_model"] == 64
    assert isinstance(objective, tvae.VAEObjective)
    saved = torch.load(root / "transformer-vae" / "tiny" / "checkpoints"
                       / f"step_{want}" / "state.pt", weights_only=True)
    for name, p in model.state_dict().items():
        assert p.device.type == "cpu" and torch.equal(p,
                                                      saved["params"][name])


def test_best_without_best_json_warns_and_takes_the_newest(tiny_run,
                                                           tmp_path):
    import shutil
    cwd, _, _ = tiny_run
    root = tmp_path / "logs"
    shutil.copytree(cwd / "sparse-vae-logs", root)
    (root / "transformer-vae" / "tiny" / "checkpoints" / "best.json").unlink()
    with pytest.warns(UserWarning, match="best.json"):
        _, _, _, state, _ = load_checkpoint_for_name(
            "transformer-vae", "tiny", root=root, step="best", device="cpu")
    assert state["step"] == 3


def _jax_params_of(model):
    """The port model's parameters as the JAX package's fp32 tree."""
    params = {}
    for key, value in model.state_dict().items():
        path, transpose = ckpt.flax_path(model, key)
        arr = value.float().numpy()
        node = params
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = jnp.asarray(arr.T if transpose else arr)
    return params


def test_test_entry_matches_jax_test_py_logic(tiny_run, capsys,
                                              monkeypatch):
    """`python -m sparse_vae_tpu_torch.test` on the tiny run's newest
    checkpoint on the CPU, num_samples=4 num_iter=2: its lines are JAX
    test.py's lines (per batch `batch i: last=... avg=...`, then `Average
    test loss:`), each batch's value is `batch_nll` with a generator
    seeded from the batch index, and `batch_nll` equals JAX test.py's
    per-batch computation on the same weights and eps (2e-5 relative)."""
    from sparse_vae_tpu_torch import test as entry
    from sparse_vae_tpu_torch.cli import build_data, assemble_config
    from sparse_vae_tpu_torch.data.text_data_module import (
        TextDataModuleHparams)

    cwd, _, _ = tiny_run
    monkeypatch.chdir(cwd)
    average = entry.main(["test", "transformer-vae", "tiny", "num_samples=4",
                          "num_iter=2", "device=cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-1] == f"Average test loss: {average}"

    model, hp, _, _, meta = load_checkpoint_for_name(
        "transformer-vae", "tiny", device="cpu")
    cfg = assemble_config("transformer-vae", [])
    cfg.data = TextDataModuleHparams(**meta["data_hparams"])
    data = build_data(cfg)
    jax_hp = {k: v for k, v in meta["model_hparams"].items()
              if k not in ("ep_size",)}
    module, _, _ = build_model("transformer-vae", jax_hp)
    params = _jax_params_of(model)
    cls = type(module)
    want_lines, losses = [], []
    for i, batch in enumerate(data.epoch_batches("test", seed=0)):
        real = np.asarray(batch.num_tokens) > 0
        if not real.any():
            continue
        arrays = {k: torch.from_numpy(np.asarray(v)).long()
                  for k, v in batch._asdict().items()}
        with torch.no_grad():
            nll = entry.batch_nll(model, arrays, 4, 2,
                                  generator=torch.Generator().manual_seed(i))
        losses.append(nll)
        want_lines.append(f"batch {i}: last={nll:.4f} "
                          f"avg={sum(losses) / len(losses):.4f}")
        # JAX test.py's loop body on the same weights, its PRNGKey(i)
        # draws handed to the port.
        ids = jnp.asarray(batch.token_ids)
        posterior = module.apply({"params": params}, ids,
                                 method=cls.posterior)
        lp = jvae.estimate_log_prob_iw(
            lambda z: module.apply({"params": params}, ids, z,
                                   method=cls.reconstruct_ll),
            posterior, ids, jax.random.PRNGKey(i), 4, 2)
        jax_nll = float((-np.asarray(lp)[real]
                         / np.asarray(batch.num_tokens)[real]).mean())
        eps = _iw_eps(jax.random.PRNGKey(i), posterior.loc.shape, 4, 2)
        with torch.no_grad():
            port_nll = entry.batch_nll(model, arrays, 4, 2,
                                       eps=torch.from_numpy(eps))
        np.testing.assert_allclose(port_nll, jax_nll, rtol=LL_RTOL)
    assert lines[:-1] == want_lines and len(want_lines) >= 1
    assert average == pytest.approx(sum(losses) / len(losses), rel=1e-12)
    assert 0 < average < 20


@pytest.mark.parametrize("experiment,names", [
    ("lstm-lm", "ARObjective"), ("lstm-vae", "VAEObjective")])
def test_test_entry_refuses_the_unported_families(experiment, names,
                                                  tmp_path, monkeypatch):
    """The LSTM families are ported since the LSTM slice: the entry
    evaluates them through their objective (`names`) and refuses only a
    run that has no checkpoint (tests/test_torch_lstm_train.py runs it
    on fitted runs)."""
    from sparse_vae_tpu_torch import test as entry
    from sparse_vae_tpu_torch.cli import build_hparams
    assert type(build_hparams(experiment)[1]).__name__ == names
    monkeypatch.chdir(tmp_path)
    with pytest.raises(FileNotFoundError):
        entry.main(["test", experiment, "any", "device=cpu"])
