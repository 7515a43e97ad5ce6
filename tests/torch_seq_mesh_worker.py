"""Rank functions for tests/test_torch_seq_mesh.py and test_torch_pp.py, in
a module that imports torch and the port only: every rank the tests spawn
imports it, and must not load JAX.

Each function runs on every rank of a world of gloo ranks on the CPU and
returns what the tests check: the seq and pipe meshes as each rank sees
them, the sharded steps and eval statistics of tests/torch_mesh_worker.py
on a seq mesh, a Trainer.fit over data x seq with its resume, each
rank's dropped MoE dispatches on an expert mesh, and the pipelined steps
of parallel/pp.py.
"""
import torch

from sparse_vae_tpu_torch.cli import objective_for
from sparse_vae_tpu_torch.ops import launches
from sparse_vae_tpu_torch.parallel import pp, spmd
from sparse_vae_tpu_torch.parallel.mesh import create_mesh, shard_batch
from tests.torch_mesh_worker import (OPTIMIZER, full_model, run_fit,
                                     run_steps)


def _layout(mesh) -> dict:
    return {"shape": dict(mesh.shape),
            "coords": {a: mesh.coord(a) for a in mesh.shape},
            "groups": {a: [g.world_rank(i) for i in range(g.size)]
                       for a, g in mesh.groups.items()},
            "row_shard": mesh.row_shard,
            "sums": float(spmd.all_reduce_sum(
                torch.tensor(float(mesh.world.rank + 1)), mesh.sums_group))}


def run_seq(world, cases: list) -> dict:
    """The seq and pipe layouts of this world (data x seq 2 x model 2 and
    data x pipe 2), then each case's step and eval statistics
    (tests/torch_mesh_worker.run_steps; a case's "sp" and "tp" name its
    mesh)."""
    torch.set_num_threads(1)
    layouts = [_layout(create_mesh(world, seq_axis=2, model_axis=2)),
               _layout(create_mesh(world, pipe_axis=2))]
    return {"layouts": layouts, **run_steps(world, cases)}


def ep_drops(world, hparams, state: dict, batch: dict,
             capacity_factor: float) -> list:
    """Each MoE layer's dropped dispatches on this rank's rows of `batch`
    on a data 2 x expert 2 mesh at `capacity_factor`: [valid dispatches,
    kept dispatches] a layer."""
    torch.set_num_threads(1)
    mesh = create_mesh(world, expert_axis=2)
    model = spmd.localize(full_model(hparams, state), mesh)
    for layer in model.decoder_layers:
        layer.moe.capacity_factor = capacity_factor
    ids = shard_batch(batch, mesh)["token_ids"]
    stats = []
    with torch.no_grad():
        model.forward_hidden(ids, moe_stats=stats)
    valid = int((ids != 0).sum()) * hparams.moe_top_k
    return [[valid, int(s["keep"].sum())] for s in stats]


def pp_steps(world, case: dict, steps: int) -> dict:
    """`steps` pipelined steps of the case on data 2 x pipe 2 (noise and
    batches the same each step; with the case's "dropout", the LM's FFN
    dropout at 0.1 from a seeded generator): the metrics, this stage's
    gradients of the first step and its parameters after each step under
    the full model's names, the schedule's timing and the launch
    counts."""
    mesh = create_mesh(world, pipe_axis=2)
    hp = case["hparams"]
    stage = pp.pp_localize(full_model(hp, case["state"]), mesh)
    opt = pp.make_pp_optimizer(stage, **OPTIMIZER)
    dropout = case.get("dropout", False)
    if dropout:
        for layer in stage.decoder_layers:
            layer.dropout_rate = 0.1
    step_fn = pp.make_pp_train_step(stage, objective_for(hp), opt, mesh,
                                    deterministic=not dropout,
                                    timed=not dropout)
    generator = torch.Generator().manual_seed(case["step"])
    mbs = [shard_batch(b, mesh) for b in case["batches"]]
    out = {"metrics": [], "params": [], "timing": []}
    launches.reset()
    for i in range(steps):
        metrics = step_fn(mbs, case["step"] + i, case["noise"], generator)
        out["metrics"].append({k: float(v) for k, v in metrics.items()})
        if i == 0:
            s, _, per = stage.pipe_stage
            out["grads"] = {pp.global_name(n, s, per): p.grad.clone()
                            for n, p in stage.named_parameters()}
        out["params"].append({k: v.clone() for k, v in
                              pp.stage_state(stage).items()})
        out["timing"].append(step_fn.timing)
    out["launches"] = launches.read()
    out["stage"] = stage.pipe_stage
    return out


def run_pp(world, cases: list, steps: int) -> dict:
    """The pipe mesh's layout, then each case's `pp_steps`."""
    torch.set_num_threads(1)
    return {"layouts": [_layout(create_mesh(world, pipe_axis=2))],
            "steps": [pp_steps(world, case, steps) for case in cases]}


def run_four(world, fit: tuple, drops: tuple) -> dict:
    """The 4-rank cases of tests/test_torch_seq_mesh.py: fit over data 2 x
    seq 2, and the expert mesh's dropped dispatches."""
    return {"fit": run_fit(world, *fit, mesh_kw={"seq_axis": 2}),
            "drops": ep_drops(world, *drops)}
