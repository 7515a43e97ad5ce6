"""Pipeline parallelism in the port (sparse_vae_tpu_torch/parallel/pp.py, the
`pipe` axis of parallel/mesh.py) against the JAX package on the CPU.

In this process: `pp_split_params` / `pp_merge_params` round-trip a full
state dict, and the split's leaves are JAX's `pp_split_params` of the
same parameters (transposed where the layouts differ); every refusal of
tests/test_pp.py and tests/test_moe.py's pipeline guard raises with the
JAX package's message, and LAMB is refused.

One spawn of 4 gloo ranks on the CPU (data 2 x pipe 2) runs, in
tests/torch_seq_mesh_worker.py (which imports no JAX), two pipelined
steps of three cases at tests/test_pp.py's configurations (4 layers, 2 a
stage; the micro-batches of accumulation are the pipeline's):
- the sparse Transformer LM (M = 3 micro-batches of [4, 32], no dropout);
- the Transformer-VAE with free bits 0 and 0.25 (M = 4 of [4, 64]), the
  eps and marginal-KL draws read off JAX's rng splits (the step rng
  folded by the data shard, split per micro-batch, then into (dropout,
  sample, mi));
- the LM again with its FFN dropout on (the port's masks: no JAX twin),
  and that run once more with grad_checkpointing (remat_policy
  dots_attn_qkv), which must equal it bit for bit.
Step 1 of each is held against JAX's `make_pp_train_step` on 4 of
conftest's virtual CPU devices (an optax transformation that keeps the
gradients as its state, so JAX's gradients come out exact): loss 2e-5
relative, grad_norm 1e-4, every gradient within 2e-3 of its tensor's
largest |value| (+1e-7). Both steps are held against the port's
unsharded train_step on the same batches and noise: the metrics 1e-5
relative, every parameter after each step within 2e-4 relative and 2e-6
absolute (tests/test_pp.py's own bound); data peers hold their stage's
parameters bit for bit.

Worker time: about 25 s (4 ranks); the JAX steps about 30 s here.
"""
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_vae_tpu import build_model
from sparse_vae_tpu.parallel import pp as jpp
from sparse_vae_tpu.parallel.spmd import shard_batch
from sparse_vae_tpu_torch import checkpoint as ckpt
from sparse_vae_tpu_torch.cli import objective_for
from sparse_vae_tpu_torch.models.lstm_vae import LSTMVAE, LSTMVAEHparams
from sparse_vae_tpu_torch.models.transformer_lm import (
    TransformerHparams, TransformerLanguageModel)
from sparse_vae_tpu_torch.models.transformer_vae import (
    TransformerVAE, TransformerVAEHparams)
from sparse_vae_tpu_torch.models.vae import VAEObjective
from sparse_vae_tpu_torch.parallel import pp
from sparse_vae_tpu_torch.parallel.group import AxisGroup, spawn
from sparse_vae_tpu_torch.parallel.mesh import Mesh
from sparse_vae_tpu_torch.training.objectives import ARObjective
from sparse_vae_tpu_torch.training.optimizer import make_optimizer
from sparse_vae_tpu_torch.training.train_step import train_step
from tests.test_torch_seq_mesh import _cpu_mesh, grads_keeper
from tests.test_torch_tp import (GRAD_ATOL, GRAD_REL, LOSS_RTOL, NORM_RTOL,
                                 _documents, _leaves, _template)
from tests.torch_mesh_worker import OPTIMIZER, full_model
from tests.torch_seq_mesh_worker import run_pp

RANK_TIMEOUT_S = 600
STEPS = 2
PARAM_RTOL, PARAM_ATOL = 2e-4, 2e-6
SELF_METRIC_RTOL = 1e-5
# tests/test_pp.py's _setup and _vae_setup.
LM = dict(d_model=32, num_heads=2, num_layers=4, vocab_size=64,
          sparse_self_attention=True, attn_window_size=2, attn_block_size=8,
          use_pallas_kernel=False, loss_chunk_size=16, precision="fp32",
          grad_checkpointing=False)
VAE = dict(LM, latent_depth=8, num_encoder_latents=8)
# name: (config, micro-batches M, rows, length, seed)
CASES = {"lm": (LM, 3, 4, 32, 1),
         "vae": (VAE, 4, 4, 64, 3),
         "vae_free_bits": ({**VAE, "free_bits": 0.25}, 4, 4, 64, 5)}


def _jax_noise(module, jobj, params, tokens, step_rng, latent):
    """Per micro-batch the global {"eps", "mi"} of JAX's pipelined VAE
    step: for data shard d, split(fold_in(rng, d), M)[m] split into
    (dropout, sample, mi); eps from posterior_and_z's sample stream."""
    k, b = tokens.shape[:2]
    per = b // 2
    noise = [{"eps": [], "mi": []} for _ in range(k)]
    for d in range(2):
        rngs = jax.random.split(jax.random.fold_in(step_rng, d), k)
        for m in range(k):
            _, sample, mi = jax.random.split(rngs[m], 3)
            ids = jnp.asarray(tokens[m][d * per:(d + 1) * per])
            q, _, z = module.apply({"params": params}, ids,
                                   rngs={"sample": sample},
                                   method=type(module).posterior_and_z)
            noise[m]["eps"].append(np.array((z - q.loc) / q.scale))
            noise[m]["mi"].append(np.array(jax.random.normal(
                mi, (jobj.mi_samples, per, latent))))
    return [{"eps": torch.tensor(np.concatenate(n["eps"], 0)),
             "mi": torch.tensor(np.concatenate(n["mi"], 1))} for n in noise]


def _port_hparams(cfg):
    kw = dict(cfg, use_pallas_kernel=True)
    return (TransformerVAEHparams if "latent_depth" in cfg
            else TransformerHparams)(**kw)


def prepare(name):
    """JAX's pipelined step 1 of the case (metrics, exact gradients in the
    full tree's layout) and the port's case of it."""
    cfg, k, b, length, seed = CASES[name]
    vae = "latent_depth" in cfg
    module, jhp, jobj = build_model(
        "transformer-vae" if vae else "transformer-lm", cfg)
    tokens, lengths = _documents(seed, k, b, length, jhp.vocab_size)
    key = jax.random.PRNGKey(seed)
    params = module.init({"params": key, "sample": key},
                         jnp.asarray(tokens[0][:1]))["params"]
    mesh = _cpu_mesh(num_devices=4, pipe_axis=2)
    opt = grads_keeper()
    split = jpp.pp_split_params(params, jhp.num_layers)
    step_rng = jax.random.PRNGKey(seed + 7)
    step_fn = jpp.make_pp_train_step(module, jobj, opt, mesh,
                                     deterministic=True)
    batch = {"token_ids": jnp.asarray(tokens, jnp.int32),
             "num_tokens": jnp.asarray(lengths, jnp.int32),
             "num_bytes": jnp.asarray(lengths, jnp.int32)}
    _, grads, metrics = step_fn(jax.tree.map(jnp.array, split),
                                opt.init(split),
                                shard_batch(batch, mesh, stacked=True),
                                jnp.asarray(0), step_rng)
    noise = (_jax_noise(module, jobj, params, tokens, step_rng,
                        jhp.latent_depth) if vae else None)
    hp = _port_hparams(cfg)
    case = {"hparams": hp,
            "state": ckpt.state_from_leaves(_leaves(params), hp),
            "batches": [{"token_ids": torch.tensor(t),
                         "num_tokens": torch.tensor(n)}
                        for t, n in zip(tokens, lengths)],
            "noise": noise, "step": 0}
    return case, {"metrics": {n: float(v) for n, v in metrics.items()},
                  "grads": _leaves(jpp.pp_merge_params(grads))}


def unsharded(case) -> list:
    """The port's unsharded train_step, STEPS times on the case's batches
    and noise: [(metrics, state)] a step."""
    hp = case["hparams"]
    model = full_model(hp, case["state"])
    opt = make_optimizer(model.parameters(), **OPTIMIZER)
    out = []
    for i in range(STEPS):
        metrics = train_step(model, objective_for(hp), opt, case["batches"],
                             case["step"] + i, case["noise"])
        out.append(({k: float(v) for k, v in metrics.items()},
                    {k: v.detach().clone()
                     for k, v in model.state_dict().items()}))
    return out


@pytest.fixture(scope="module")
def pp_run():
    prepared = {name: prepare(name) for name in CASES}
    cases = [prepared[n][0] for n in CASES]
    dropout = {**cases[0], "dropout": True}
    # The same dropout run with every layer rematerialised.
    remat = {**dropout, "hparams": replace(
        dropout["hparams"], grad_checkpointing=True,
        remat_policy="dots_attn_qkv")}
    records = spawn(run_pp, 4, "cpu", (cases + [dropout, remat], STEPS),
                    timeout=RANK_TIMEOUT_S)
    return {"records": records, "jax": {n: prepared[n][1] for n in CASES},
            "cases": dict(zip(CASES, cases)),
            "single": {n: unsharded(c) for n, c in zip(CASES, cases)}}


def test_pp_lm_step_with_dropout_moves_every_stage_alike(pp_run):
    """The LM's pipelined step with its FFN dropout on (masks from
    generators keyed by row shard, micro-batch and global layer): finite
    losses that differ from the deterministic step's, every rank's
    metrics equal, data peers holding their stage bit for bit."""
    recs = [r["steps"][len(CASES)] for r in pp_run["records"]]
    plain = pp_run["records"][0]["steps"][0]["metrics"]
    for rec in recs:
        assert rec["metrics"] == recs[0]["metrics"]
        assert all(np.isfinite(m["loss"]) for m in rec["metrics"])
    assert recs[0]["metrics"][0]["loss"] != plain[0]["loss"]
    for a, b in ((0, 2), (1, 3)):
        for key, value in recs[a]["params"][-1].items():
            assert torch.equal(value, recs[b]["params"][-1][key]), key


def test_pp_step_under_remat_equals_the_step_without(pp_run):
    """grad_checkpointing (remat_policy dots_attn_qkv) on every stage's
    layers, FFN dropout on: two pipelined steps give the metrics, the
    step-1 gradients and the parameters of the step without remat bit for
    bit (JAX's tests/test_pp.py holds its remat step to its plain one)."""
    for rec in pp_run["records"]:
        plain, remat = rec["steps"][len(CASES)], rec["steps"][-1]
        assert remat["metrics"] == plain["metrics"]
        for key, value in plain["grads"].items():
            assert torch.equal(remat["grads"][key], value), key
        for i, params in enumerate(plain["params"]):
            for key, value in params.items():
                assert torch.equal(remat["params"][i][key], value), key


def _full_grads(records, index) -> dict:
    """The step-1 gradients of the full model: the shared leaves from
    rank 0, each stage's layers from its ranks."""
    out = {}
    for rec in records:
        out.update(rec["steps"][index]["grads"])
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_pp_step_matches_the_jax_pipelined_step(pp_run, name):
    index = list(CASES).index(name)
    jax_out = pp_run["jax"][name]
    hp = pp_run["cases"][name]["hparams"]
    for rec in pp_run["records"]:
        got = rec["steps"][index]["metrics"][0]
        want = jax_out["metrics"]
        assert abs(got["loss"] - want["loss"]) <= LOSS_RTOL * abs(
            want["loss"]), (got["loss"], want["loss"])
        assert abs(got["grad_norm"] - want["grad_norm"]) <= NORM_RTOL * \
            want["grad_norm"]
    template = _template(hp)
    got = {}
    for key, g in _full_grads(pp_run["records"], index).items():
        path, transpose = ckpt.flax_path(template, key)
        g = g.float().numpy()
        got[path] = g.T if transpose else g
    assert set(got) == set(jax_out["grads"])
    for path, w in jax_out["grads"].items():
        bound = GRAD_REL * np.abs(w).max() + GRAD_ATOL
        err = np.abs(got[path] - w).max()
        assert err <= bound, f"{path}: max err {err:.3g} > {bound:.3g}"


@pytest.mark.parametrize("name", list(CASES))
def test_two_pp_steps_stay_exact_against_the_unsharded_steps(pp_run, name):
    index = list(CASES).index(name)
    single = pp_run["single"][name]
    for rec in pp_run["records"]:
        run = rec["steps"][index]
        for i, (metrics, state) in enumerate(single):
            for key in ("loss", "grad_norm"):
                assert abs(run["metrics"][i][key] - metrics[key]) <= \
                    SELF_METRIC_RTOL * abs(metrics[key]), (i, key)
            for key, value in run["params"][i].items():
                torch.testing.assert_close(value, state[key],
                                           rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                           msg=f"step {i + 1} {key}")
    # Data peers (ranks 0 and 2, 1 and 3) hold one stage bit for bit.
    recs = pp_run["records"]
    for a, b in ((0, 2), (1, 3)):
        for key, value in recs[a]["steps"][index]["params"][-1].items():
            assert torch.equal(value, recs[b]["steps"][index]["params"][-1][
                key]), key


def test_each_stage_holds_its_layers_and_times_its_schedule(pp_run):
    """Stage s holds layers 2s and 2s + 1 (and the VAE's z projections);
    every rank's timed schedule took longer than its own work; an untimed
    step (the dropout run) records no timing."""
    for rank, rec in enumerate(pp_run["records"]):
        assert rec["layouts"][0]["coords"] == {"data": rank // 2,
                                               "pipe": rank % 2}
        for run in rec["steps"]:
            assert run["stage"] == (rank % 2, 2, 2)
            layers = {int(k.split(".")[1]) for k in run["params"][0]
                      if k.startswith(("decoder_layers.", "z_projections."))}
            assert layers == {2 * (rank % 2), 2 * (rank % 2) + 1}
        for run in rec["steps"][:len(CASES)]:
            for t in run["timing"]:
                assert 0.0 < t["busy_s"] < t["schedule_s"]
        for run in rec["steps"][len(CASES):]:
            assert run["timing"] == [None] * STEPS


def test_split_and_merge_round_trip_and_match_the_jax_split():
    hp = _port_hparams(VAE)
    module, jhp, _ = build_model("transformer-vae", VAE)
    key = jax.random.PRNGKey(0)
    params = module.init({"params": key, "sample": key},
                         jnp.ones((1, 32), jnp.int32))["params"]
    state = ckpt.state_from_leaves(_leaves(params), hp)
    split = pp.pp_split_params(state, hp.num_layers)
    merged = pp.pp_merge_params(split)
    assert merged.keys() == state.keys()
    assert all(torch.equal(merged[k], state[k]) for k in state)
    want = _leaves(jpp.pp_split_params(params, jhp.num_layers))
    assert {p.split("/")[0] for p in want} == set(split) == {
        "shared", "layers", "z_projections"}
    for path, value in want.items():
        group, rest = path.split("/", 1)
        if group == "shared":
            name, transpose = ckpt.torch_key(rest)
            got = split["shared"][name]
        else:
            numbered = {"layers": "layer_0", "z_projections":
                        "z_projection_0"}[group]
            name, transpose = ckpt.torch_key(f"{numbered}/{rest}")
            got = split[group][name.split(".", 2)[2]]
        got = got.transpose(-1, -2) if transpose else got
        np.testing.assert_array_equal(got.numpy(), value, err_msg=path)


def test_stage_names_map_to_the_full_model():
    assert pp.global_name("decoder_layers.1.ffn_in.weight", 1, 3) == \
        "decoder_layers.4.ffn_in.weight"
    assert pp.global_name("z_projections.0.bias", 2, 2) == \
        "z_projections.4.bias"
    assert pp.global_name("encoder.first_layer.ffn_in.bias", 1, 3) == \
        "encoder.first_layer.ffn_in.bias"


# -- refusals: JAX's messages -------------------------------------------------
def _pipe_mesh(pipe=2):
    world = AxisGroup(0, 4, torch.device("cpu"), "gloo")
    return Mesh(world, {"data": 4 // pipe, "pipe": pipe}, {})


def _jax_error(module, objective, mesh_kw):
    from sparse_vae_tpu.parallel.mesh import create_mesh
    mesh = create_mesh(num_devices=4, devices=jax.devices("cpu"), **mesh_kw)
    opt = jpp.make_pp_optimizer(lr=1e-2, lr_decay_steps=None,
                                grad_clip_threshold=5.0)
    with pytest.raises(Exception) as err:
        jpp.make_pp_train_step(module, objective, opt, mesh)
    return err


def _port_error(model, objective, mesh):
    with pytest.raises(Exception) as err:
        pp.make_pp_train_step(model, objective, None, mesh)
    return err


def _refusal(name):
    """(port model, objective, mesh), (JAX module, objective, mesh kw)."""
    lm_cfg, vae_cfg = LM, VAE
    if name == "objective":
        class Other:
            pass
        return ((TransformerLanguageModel(_port_hparams(lm_cfg)), Other(),
                 _pipe_mesh()),
                (build_model("transformer-lm", lm_cfg)[0], Other(),
                 dict(pipe_axis=2)))
    if name == "stageable":
        hp = LSTMVAEHparams(d_model=32, latent_depth=8, vocab_size=64)
        from sparse_vae_tpu.models.lstm_vae import (LSTMVAE as JLSTMVAE,
                                                    LSTMVAEHparams as JHp)
        from sparse_vae_tpu.models.vae import VAEObjective as JVAEObjective
        jhp = JHp(d_model=32, latent_depth=8, vocab_size=64)
        return ((LSTMVAE(hp), VAEObjective(hp), _pipe_mesh()),
                (JLSTMVAE(jhp), JVAEObjective(jhp), dict(pipe_axis=2)))
    cfg = {"multi_sample": {**vae_cfg, "train_mc_samples": 4},
           "tp": {**lm_cfg, "tp_size": 2}, "moe": {**lm_cfg,
                                                   "num_experts": 4},
           "no_pipe": lm_cfg, "not_divisible": {**lm_cfg, "num_layers": 3}
           }[name]
    vae = "latent_depth" in cfg
    experiment = "transformer-vae" if vae else "transformer-lm"
    module, _, jobj = build_model(experiment, cfg)
    hp = _port_hparams(cfg)
    with torch.device("meta"):
        model = (TransformerVAE if vae else TransformerLanguageModel)(hp)
    mesh_kw = {} if name == "no_pipe" else dict(pipe_axis=2)
    mesh = (Mesh(_pipe_mesh().world, {"data": 4, "model": 1}, {})
            if name == "no_pipe" else _pipe_mesh())
    return (model, objective_for(hp), mesh), (module, jobj, mesh_kw)


@pytest.mark.parametrize("name", ["objective", "stageable", "multi_sample",
                                  "tp", "moe", "no_pipe", "not_divisible"])
def test_pp_refusals_raise_as_jax(name):
    (model, objective, mesh), (module, jobj, mesh_kw) = _refusal(name)
    port = _port_error(model, objective, mesh)
    want = _jax_error(module, jobj, mesh_kw)
    assert type(port.value) is type(want.value)
    assert str(port.value) == str(want.value)


def test_pp_optimizer_refuses_lamb():
    hp = _port_hparams(LM)
    model = TransformerLanguageModel(hp)
    model.pipe_stage, model.mesh = (0, 2, 2), _pipe_mesh()
    with pytest.raises(NotImplementedError, match="LAMB"):
        pp.make_pp_optimizer(model, lr=1e-3, lr_decay_steps=None,
                             grad_clip_threshold=1.0, lamb=True)


def test_pp_needs_the_localized_stage():
    hp = _port_hparams(LM)
    with pytest.raises(ValueError, match="pp_localize"):
        pp.make_pp_train_step(TransformerLanguageModel(hp), ARObjective(hp),
                              None, _pipe_mesh())


@pytest.mark.parametrize("name,rows", [("lm", 2), ("vae", 1), ("vae", 2),
                                       ("vae_free_bits", 2)])
def test_objective_names_the_sums_its_loss_composes(name, rows):
    """The sums' names every stage composes (`sum_names`) are the ones the
    unsharded objective's loss_sums returns on the same layout."""
    cfg, _, _, length, seed = CASES[name]
    hp = _port_hparams(cfg)
    torch.manual_seed(seed)
    model = (TransformerVAE if "latent_depth" in cfg
             else TransformerLanguageModel)(hp)
    objective = objective_for(hp)
    tokens, lengths = _documents(seed, 1, rows, length, hp.vocab_size)
    batch = {"token_ids": torch.tensor(tokens[0]),
             "num_tokens": torch.tensor(lengths[0])}
    sums, counts = objective.loss_sums(
        model, batch, generator=torch.Generator().manual_seed(seed))
    s_names, c_names = objective.sum_names(rows)
    assert (sorted(s_names), sorted(c_names)) == (sorted(sums),
                                                  sorted(counts))
