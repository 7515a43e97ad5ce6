"""The port's mesh (sparse_vae_tpu_torch/parallel/mesh.py, spmd.py) and
Trainer.fit on it, on the CPU.

One spawn of 4 gloo ranks on the CPU runs, in tests/torch_mesh_worker.py
(which imports no JAX):
- `create_mesh`'s layouts as each rank sees them (data x model, data x
  expert, data alone, model alone), and a sum over each rows group;
- data-parallel steps (data 4) of an r5-shaped Transformer-VAE (explicit
  global eps) and of an LSTM LM, each against the port's unsharded step
  on the same batches: loss 1e-5 relative, each gradient within 1e-4 of
  its tensor's largest |value|; the unsharded steps are held against
  JAX by tests/test_torch_train.py and tests/test_torch_lstm_train.py;
- the mesh's eval statistics (data 2 x model 2) against the unsharded
  eval_stats on the same batch and eps (1e-5 relative);
- Trainer.fit on data 2 x model 2: 2 steps of a tiny Transformer-VAE
  with a validation each step and a checkpoint each step. Its gathered
  checkpoint, loaded on one CPU device by load_checkpoint_for_name, gives
  the trained model's logits exactly; the step-1 checkpoint restored and
  stepped on the run's second group equals the run's step-2 checkpoint
  bit for bit (parameters, both moments, the noise generator).
`create_mesh`'s guards and the row padding run in this process.

Worker time: about 30 s (4 ranks); nothing here runs JAX.
"""
import numpy as np
import pytest
import torch

from sparse_vae_tpu_torch import checkpoint as ckpt
from sparse_vae_tpu_torch import load_checkpoint_for_name
from sparse_vae_tpu_torch.cli import objective_for
from sparse_vae_tpu_torch.models.lstm_lm import LSTMLanguageModelHparams
from sparse_vae_tpu_torch.models.transformer_vae import TransformerVAEHparams
from sparse_vae_tpu_torch.parallel.group import AxisGroup, spawn
from sparse_vae_tpu_torch.parallel.mesh import (Mesh, create_mesh,
                                                pad_batch_rows, shard_rows)
from sparse_vae_tpu_torch.parallel.spmd import assert_compose_loss_linear
from sparse_vae_tpu_torch.training.objectives import ARObjective
from tests.test_torch_tp import (R5_SHAPED, _documents,
                                 assert_matches_single, vae_case)
from tests.torch_mesh_worker import full_model, run_steps, single_step

WORLD = 4
RANK_TIMEOUT_S = 600
EVAL_RTOL = 1e-5
FIT_MODEL = dict(d_model=128, num_heads=2, num_layers=2, latent_depth=8,
                 num_encoder_latents=8, vocab_size=1024, lr=1e-3,
                 lr_decay_steps=1000, loss_chunk_size=64, log_samples=False)
FIT_TRAINER = dict(max_steps=2, log_every_n_steps=1,
                   checkpoint_every_n_steps=1, accumulate_grad_batches=2,
                   val_check_interval=1e-3, limit_val_batches=2,
                   num_devices=4, model_parallel=2)
FIT_DATA = dict(dataset_name="synthetic", synthetic_docs=200,
                vocab_size=1024, min_tokens_per_sample=16,
                max_tokens_per_sample=512, tokens_per_batch=4096)


def _lstm_case(seed=5, k=2, b=4, length=48):
    hp = LSTMLanguageModelHparams(d_embedding=16, d_model=32, vocab_size=64,
                                  num_layers=2)
    model, _ = ckpt.model_from_hparams(hp, torch.Generator().manual_seed(
        seed), "cpu")
    tokens, lengths = _documents(seed, k, b, length, hp.vocab_size)
    return {"hparams": hp,
            "state": {n: v.float().clone()
                      for n, v in model.state_dict().items()},
            "batches": [{"token_ids": torch.tensor(t),
                         "num_tokens": torch.tensor(n)}
                        for t, n in zip(tokens, lengths)],
            "noise": None, "step": 0}


def _logits_ids():
    tokens, _ = _documents(9, 1, 2, 64, FIT_MODEL["vocab_size"])
    return tokens[0]


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("mesh_fit")
    vae = vae_case({**R5_SHAPED, "num_layers": 2})
    lstm = _lstm_case()
    evaluated = vae_case({**R5_SHAPED, "num_layers": 2}, seed=7,
                         mesh={"tp": 2, "eval": True})
    hp = TransformerVAEHparams(**FIT_MODEL)
    records = spawn(run_steps, WORLD, "cpu",
                    ([vae, lstm, evaluated], None,
                     (str(workdir), hp, FIT_TRAINER, FIT_DATA,
                      _logits_ids()), True),
                    timeout=RANK_TIMEOUT_S)
    return {"records": records, "vae": (vae, single_step(vae)),
            "lstm": (lstm, single_step(lstm)), "eval": evaluated,
            "workdir": workdir, "fit_hparams": hp}


def test_layouts_follow_the_jax_package(mesh_run):
    """model / expert innermost: rank r at data r // m and model r % m;
    the rows shard over data (x expert)."""
    for rank, rec in enumerate(mesh_run["records"]):
        tp_mesh, ep_mesh, dp_mesh, model_mesh = rec["layouts"]
        assert tp_mesh["shape"] == {"data": 2, "model": 2}
        assert tp_mesh["coords"] == {"data": rank // 2, "model": rank % 2}
        assert tp_mesh["groups"]["model"] == [rank // 2 * 2,
                                              rank // 2 * 2 + 1]
        assert tp_mesh["groups"]["data"] == [rank % 2, rank % 2 + 2]
        assert tp_mesh["row_shard"] == rank // 2
        assert tp_mesh["sum"] == (rank % 2 + 1) + (rank % 2 + 3)
        assert ep_mesh["shape"] == {"data": 2, "expert": 2}
        assert ep_mesh["row_shard"] == rank and ep_mesh["sum"] == 10.0
        assert dp_mesh["shape"] == {"data": 4, "model": 1}
        assert dp_mesh["row_shard"] == rank and dp_mesh["sum"] == 10.0
        assert model_mesh["shape"] == {"data": 1, "model": 4}
        assert model_mesh["row_shard"] == 0
        assert model_mesh["sum"] == rank + 1.0


def test_mesh_guards_raise():
    world = AxisGroup(0, 4, torch.device("cpu"), "gloo")
    with pytest.raises(ValueError, match="do not factor"):
        create_mesh(world, model_axis=3)
    with pytest.raises(NotImplementedError, match="'data' axis only"):
        create_mesh(world, model_axis=2, expert_axis=2)
    with pytest.raises(NotImplementedError, match="'data' axis only"):
        create_mesh(world, seq_axis=2, expert_axis=2)
    with pytest.raises(NotImplementedError, match="'data' axis only"):
        create_mesh(world, pipe_axis=2, model_axis=2)
    with pytest.raises(NotImplementedError, match="'data' axis only"):
        create_mesh(world, pipe_axis=2, seq_axis=2)


@pytest.mark.parametrize("stacked", [False, True])
def test_rows_are_padded_with_pad_rows_and_sharded(stacked):
    world = AxisGroup(3, 4, torch.device("cpu"), "gloo")
    mesh = Mesh(world, {"data": 2, "expert": 2},
                {"data": AxisGroup(1, 2, world.device, "gloo"),
                 "expert": AxisGroup(1, 2, world.device, "gloo")})
    ids = np.arange(1, 31).reshape(6, 5)
    arrays = {"token_ids": ids, "num_tokens": np.full(6, 5)}
    padded = pad_batch_rows(arrays, 4)
    assert padded["token_ids"].shape == (8, 5)
    assert not padded["token_ids"][6:].any()
    assert list(padded["num_tokens"]) == [5] * 6 + [0, 0]
    if stacked:
        arrays = {k: np.stack([v, v + 100]) for k, v in arrays.items()}
    rows = shard_rows(arrays, mesh, stacked=stacked)
    got = rows["token_ids"][1] if stacked else rows["token_ids"]
    assert got.shape == (2, 5) and not got.any()   # row shard 3: padding
    assert (rows["num_tokens"] == 0).all()


@pytest.mark.parametrize("family", ["vae", "lstm"])
def test_data_parallel_step_matches_the_unsharded_step(mesh_run, family):
    _, single = mesh_run[family]
    index = 0 if family == "vae" else 1
    for rec in mesh_run["records"]:
        assert_matches_single(rec["steps"][index], single)


def test_mesh_eval_stats_match_the_unsharded_eval(mesh_run):
    case = mesh_run["eval"]
    model = full_model(case["hparams"], case["state"])
    with torch.no_grad():
        want = objective_for(case["hparams"]).eval_stats(
            model, case["batches"][0], {"eps": case["noise"][0]["eps"]})
    for rec in mesh_run["records"]:
        got = rec["evals"][0]
        assert got.keys() == want.keys()
        for name, w in want.items():
            w = float(w)
            assert abs(got[name] - w) <= EVAL_RTOL * max(abs(w), 1.0), name


def test_fit_on_the_mesh_validates_and_saves(mesh_run):
    fit = mesh_run["records"][0]["fit"]
    assert fit["step"] == 2
    assert [h["step"] for h in fit["history"]] == [1, 2]
    assert all(np.isfinite(h["val_loss"]) for h in fit["history"])
    assert all(r["fit"]["history"] == fit["history"]
               for r in mesh_run["records"])


def test_mesh_checkpoint_loads_on_one_device_with_the_trained_logits(
        mesh_run):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        model, hp, _, state, _ = load_checkpoint_for_name(
            "transformer-vae", "mesh", root=mesh_run["workdir"] / "logs",
            device="cpu")
        assert state["step"] == 2 and hp.tp_size == 1
        with torch.no_grad():
            logits = model(torch.tensor(_logits_ids()),
                           torch.zeros(2, 1, hp.latent_depth))[0]
    finally:
        torch.set_num_threads(threads)
    assert torch.equal(logits, mesh_run["records"][0]["fit"]["logits"])


def test_resumed_mesh_step_equals_the_unbroken_one(mesh_run):
    for rec in mesh_run["records"]:
        assert rec["fit"]["resumed_equal"]
        assert rec["fit"]["generator_equal"]


@pytest.mark.parametrize("objective", ["ar", "vae", "nonlinear"])
def test_compose_loss_linearity_check(objective):
    one = torch.tensor(1.0)
    if objective == "ar":
        assert_compose_loss_linear(ARObjective(), {"nll_sum": 37.5 * one},
                                   {"token_count": 13.0 * one}, step=5)
        return
    if objective == "vae":
        hp = TransformerVAEHparams(kl_annealing_steps=100,
                                   kl_weight_start=0.1)
        sums = {"nll_sum": 37.5 * one, "kl_sum": 2.5 * one,
                "raw_kl_sum": 60.0 * one, "marginal_kl_rows": 1.25 * one}
        assert_compose_loss_linear(
            objective_for(hp), sums,
            {"token_count": 13.0 * one, "row_count": 4.0 * one}, step=50)
        return

    class Bad:
        def compose_loss(self, sums, counts, step):
            return torch.log(sums["s"]) / counts["n"], {}

    with pytest.raises(AssertionError, match="NOT linear"):
        assert_compose_loss_linear(Bad(), {"s": 3.0 * one},
                                   {"n": 2.0 * one}, step=0)
