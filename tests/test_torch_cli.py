"""The port's configuration and training CLI (cli.py, hparam_presets.py,
utils/config.py, train.py's training-run form) against the JAX package's
on the CPU. Configurations are compared exactly (`to_dict` equality);
the CLI run is checked for what it writes and for resuming.
"""
import json

import pytest
import torch

from sparse_vae_tpu import build_model as jax_build_model
from sparse_vae_tpu import cli as jcli
from sparse_vae_tpu.hparam_presets import hparam_presets as jax_presets
from sparse_vae_tpu.utils import config as jconfig
from sparse_vae_tpu_torch import cli as tcli
from sparse_vae_tpu_torch import train
from sparse_vae_tpu_torch.hparam_presets import hparam_presets
from sparse_vae_tpu_torch.utils import config as tconfig
from tests.test_torch_checkpoint import r5_meta

DOTLIST = ["model.d_model=256", "model.lr=1e-3", "model.free_bits=0.5",
           "model.lr_decay_steps=none", "data.tokens_per_batch=20_000",
           "data.dataset_name=local-prose", "data.test_size=12",
           "trainer.max_steps=100", "trainer.val_check_interval=0.25",
           "trainer.early_stopping_start_step=null", "name=run-a",
           "no_log=true", "anomaly_detection=1"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The models here are tiny: one intra-op thread runs them as fast
    and does not contend with the suite's other workers for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _same_config(experiment, dotlist, base_meta=None):
    got = tcli.assemble_config(experiment, dotlist, base_meta)
    want = jcli.assemble_config(experiment, dotlist, base_meta)
    assert tconfig.to_dict(got) == jconfig.to_dict(want)
    return got


def test_preset_table_is_a_copy():
    assert hparam_presets == jax_presets


@pytest.mark.parametrize("preset", sorted(jax_presets))
def test_every_preset_assembles_the_same(preset):
    _same_config("transformer-vae", [f"preset={preset}"])
    _same_config("transformer-vae", [f"preset={preset}"] + DOTLIST)


def test_dotlist_and_resume_meta_assemble_the_same():
    cfg = _same_config("transformer-vae", DOTLIST)
    assert cfg.name == "run-a" and cfg.no_log and cfg.anomaly_detection
    assert cfg.data.tokens_per_batch == 20_000
    cfg = _same_config("transformer-vae",
                       ["from_checkpoint=real-prose-vae-r5",
                        "trainer.max_steps=8000"], base_meta=r5_meta())
    assert cfg.name == "real-prose-vae-r5"
    assert cfg.trainer.max_steps == 8000
    assert cfg.data.max_tokens_per_sample == 50_000


@pytest.mark.parametrize("bad", [["model_d=3"], ["data.no_such_key=1"],
                                 ["trainer.no_such_key=1"], ["oops"],
                                 ["trainer.max_steps=many"]])
def test_bad_dotlists_raise_in_both(bad):
    with pytest.raises(ValueError):
        jcli.assemble_config("transformer-vae", bad)
    with pytest.raises(ValueError):
        tcli.assemble_config("transformer-vae", bad)


def test_unknown_preset_raises_in_both():
    with pytest.raises(AssertionError):
        jcli.assemble_config("transformer-vae", ["preset=nope"])
    with pytest.raises(ValueError, match="not recognized"):
        tcli.assemble_config("transformer-vae", ["preset=nope"])


@pytest.mark.parametrize("preset", ["wikipedia", "pg19", "sparse-benchmark",
                                    "dense-benchmark", None])
def test_model_hparams_are_the_same(preset):
    """The Transformer-VAE's hparams from a preset and a dotlist: the
    port's dataclass equals the JAX package's field for field."""
    dotlist = (["model.d_model=256"]
               + ([f"preset={preset}"] if preset else []))
    cfg = tcli.assemble_config("transformer-vae", dotlist)
    overrides = {**cfg.model_overrides, "vocab_size": cfg.data.vocab_size}
    hp, _ = tcli.build_hparams("transformer-vae", overrides)
    _, jhp, _ = jax_build_model("transformer-vae", overrides)
    assert tconfig.to_dict(hp) == jconfig.to_dict(jhp)
    with pytest.raises(ValueError, match="Unknown hparam"):
        tcli.build_hparams("transformer-vae", {"no_such": 1})


@pytest.mark.parametrize("experiment", ["lstm-lm", "lstm-vae"])
def test_unported_families_raise(experiment):
    """The LSTM families build since the LSTM slice: at the lstm-benchmark
    preset their hparams are JAX's build_model's, field for field, with
    JAX's objective class; only an unknown family raises."""
    cfg = tcli.assemble_config(experiment, ["preset=lstm-benchmark"])
    overrides = {k: v for k, v in cfg.model_overrides.items()
                 if experiment == "lstm-vae" or k in LSTM_LM_FIELDS}
    hp, objective = tcli.build_hparams(experiment, overrides)
    _, jhp, jobjective = jax_build_model(experiment, overrides)
    assert tconfig.to_dict(hp) == jconfig.to_dict(jhp)
    assert type(objective).__name__ == type(jobjective).__name__
    assert hp.init_scale is None
    with pytest.raises(ValueError, match="Unrecognized model"):
        tcli.build_hparams("gpt", {})


# The lstm-benchmark preset's keys an LSTM LM has (the preset is the
# LSTM-VAE's: its latent and encoder keys belong to no LM).
LSTM_LM_FIELDS = {"d_model", "d_embedding", "grad_clip_threshold",
                  "init_scale", "lr", "tie_logit_weights"}


def test_coerce_value_is_the_same():
    from typing import Optional
    for raw, tp in (("3", int), ("1_000", int), ("2.5", float),
                    ("true", bool), ("No", bool), ("none", Optional[int]),
                    ("[1, 2]", list), ("x", str), (4, float), ("{", dict)):
        assert tconfig.coerce_value(raw, tp) == jconfig.coerce_value(raw, tp)


TINY = ["data.dataset_name=synthetic", "data.synthetic_docs=200",
        "data.tokens_per_batch=4096", "data.max_tokens_per_sample=512",
        "data.vocab_size=1024", "model.d_model=64", "model.num_heads=4",
        "model.num_layers=2", "model.latent_depth=8",
        "model.num_encoder_latents=8", "model.vocab_size=1024",
        "trainer.log_every_n_steps=1", "trainer.checkpoint_every_n_steps=2",
        "trainer.val_check_interval=0.1", "device=cpu"]


def _records(run):
    return [json.loads(line) for line in
            (run / "metrics.jsonl").read_text().splitlines()]


def test_train_cli_trains_validates_checkpoints_and_resumes(tmp_path,
                                                            monkeypatch,
                                                            capsys):
    """`python -m sparse_vae_tpu_torch.train transformer-vae <dotlist>` on
    the CPU: 3 steps with validation, checkpoints and, at step 2, the
    sampling callback (a sample, a reconstruction and its train_bleu),
    then from_checkpoint= takes the run on to step 5 with its saved
    hparams."""
    monkeypatch.chdir(tmp_path)
    assert train.main(["train", "transformer-vae", *TINY,
                       "trainer.max_steps=3", "name=cli",
                       "trainer.sample_every_n_steps=2"]) == 0
    out = capsys.readouterr().out
    assert "Done: step=3 stopped=max_steps" in out
    assert "not ported" not in out
    run = tmp_path / "sparse-vae-logs" / "transformer-vae" / "cli"
    ckpts = run / "checkpoints"
    # Every 2 steps, at the end, and at the best validation (step 1).
    assert sorted(p.name for p in ckpts.glob("step_*")) == [
        "step_1", "step_2", "step_3"]
    assert json.loads((ckpts / "best.json").read_text())["step"] in (1, 2, 3)
    meta = json.loads((ckpts / "meta.json").read_text())
    assert meta["model_hparams"]["d_model"] == 64
    assert meta["trainer_hparams"]["max_steps"] == 3
    records = _records(run)
    assert {r["step"] for r in records if "val_nll" in r} == {1, 2, 3}
    for key in ("text_unconditional_sample", "text_reconstruction",
                "train_bleu"):
        assert [r["step"] for r in records if key in r] == [2], key
    assert not [r for r in records if "text_sampling_error" in r]
    assert (tmp_path / "sparse-vae-pretrained" / "tokenizers"
            / "synthetic.json").exists()

    # Resume: only the step cap on the command line; the rest from meta.
    assert train.main(["train", "transformer-vae", "from_checkpoint=cli",
                       "trainer.max_steps=5", "device=cpu"]) == 0
    assert "Done: step=5 stopped=max_steps" in capsys.readouterr().out
    steps = [r["step"] for r in _records(run) if "loss" in r]
    assert steps == [1, 2, 3, 4, 5]
    meta = json.loads((ckpts / "meta.json").read_text())
    assert meta["trainer_hparams"]["max_steps"] == 5
    assert meta["model_hparams"]["d_model"] == 64


def test_train_cli_refuses_a_seq_mesh(tmp_path, monkeypatch):
    """A seq axis beside an expert axis: the JAX package's refusal, before
    any rank starts."""
    monkeypatch.chdir(tmp_path)
    lm = [x for x in TINY if "latent" not in x]
    with pytest.raises(NotImplementedError, match="'data' axis only"):
        train.main(["train", "transformer-lm", *lm,
                    "model.num_experts=4", "trainer.num_devices=4",
                    "trainer.seq_parallel=2", "trainer.expert_parallel=2",
                    "no_log=true"])


MESH_LAYOUTS = {
    "model": ("transformer-vae", ["model.d_model=128", "model.num_heads=2",
                                  "model.loss_chunk_size=256",
                                  "trainer.model_parallel=2"]),
    "expert": ("transformer-lm", ["model.num_experts=4",
                                  "model.sparse_self_attention=false",
                                  "trainer.expert_parallel=2"])}


@pytest.mark.parametrize("layout", sorted(MESH_LAYOUTS))
def test_train_cli_runs_on_a_mesh(tmp_path, monkeypatch, capfd, layout):
    """`train <experiment> <dotlist> trainer.num_devices=2
    trainer.<axis>_parallel=2 device=cpu` spawns 2 gloo ranks (data 1 x
    model 2, or data 1 x expert 2): 2 steps with validation, a
    checkpoint and the sampling callback; rank 0 reports, and the
    gathered checkpoint loads on one device with the run's hparams."""
    from sparse_vae_tpu_torch import load_checkpoint_for_name
    monkeypatch.chdir(tmp_path)
    experiment, extra = MESH_LAYOUTS[layout]
    dotlist = [x for x in TINY if experiment == "transformer-vae"
               or "latent" not in x]
    assert train.main(["train", experiment, *dotlist, *extra,
                       "trainer.max_steps=2", "trainer.num_devices=2",
                       f"name=mesh-{layout}"]) == 0
    out = capfd.readouterr().out
    assert f"mesh {{'data': 1, '{layout}': 2}} (gloo)" in out
    assert "Done: step=2 stopped=max_steps" in out
    model, hp, _, state, _ = load_checkpoint_for_name(
        experiment, f"mesh-{layout}", device="cpu")
    assert state["step"] == 2 and (hp.tp_size, hp.ep_size) == (1, 1)
    assert all(torch.isfinite(p).all() for p in model.parameters())



def test_train_cli_runs_the_lm_on_a_seq_mesh(tmp_path, monkeypatch, capfd):
    """`train transformer-lm <dotlist> trainer.num_devices=2
    trainer.seq_parallel=2 device=cpu`: the sparse LM's fit over data 1 x
    seq 2 (each rank half of every document), 2 steps with validation and
    a checkpoint that loads on one device."""
    from sparse_vae_tpu_torch import load_checkpoint_for_name
    monkeypatch.chdir(tmp_path)
    dotlist = [x for x in TINY if "latent" not in x]
    assert train.main(["train", "transformer-lm", *dotlist,
                       "model.loss_chunk_size=256", "trainer.max_steps=2",
                       "trainer.num_devices=2", "trainer.seq_parallel=2",
                       "name=mesh-seq"]) == 0
    out = capfd.readouterr().out
    assert "mesh {'data': 1, 'seq': 2, 'model': 1} (gloo)" in out
    assert "Done: step=2 stopped=max_steps" in out
    model, hp, _, state, _ = load_checkpoint_for_name(
        "transformer-lm", "mesh-seq", device="cpu")
    assert state["step"] == 2 and hp.sp_size == 1
    assert all(torch.isfinite(p).all() for p in model.parameters())


def test_train_cli_under_torchrun_takes_a_data_parallel_step(tmp_path):
    """torchrun's rendezvous is the counterpart of the JAX package's
    initialize_distributed: `python -m torch.distributed.run --standalone
    --nproc_per_node 2 -m sparse_vae_tpu_torch.train transformer-vae
    <dotlist> trainer.num_devices=2 device=cpu` starts 2 ranks that meet
    through group.from_environment (RANK, WORLD_SIZE, the rendezvous on
    localhost) and train over data 2."""
    import os
    import subprocess
    import sys
    from pathlib import Path
    repo = Path(__file__).resolve().parents[1]
    env = {**os.environ, "PYTHONPATH": str(repo), "OMP_NUM_THREADS": "1"}
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "sparse_vae_tpu_torch.train",
         "transformer-vae", *TINY, "trainer.max_steps=1",
         "trainer.num_devices=2", "trainer.val_check_interval=1.0",
         "name=torchrun"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "mesh {'data': 2, 'model': 1} (gloo)" in proc.stdout
    assert "Done: step=1 stopped=max_steps" in proc.stdout
    ckpts = tmp_path / "sparse-vae-logs" / "transformer-vae" / "torchrun"
    assert (ckpts / "checkpoints" / "step_1").exists()
