"""Rank functions for tests/test_torch_tp.py, test_torch_ep.py,
test_torch_mesh.py and test_torch_seq_mesh.py, in a module that imports
torch and the port only: every rank the tests spawn imports it, and must
not load JAX.

Each function runs on every rank of a world of gloo ranks on the CPU,
builds the mesh its case names (parallel/mesh.py) and returns what the
tests check: the collectives' values and adjoints on seeded inputs, a
sharded optimizer step's metrics with its full (gathered) gradients and
parameters, the mesh's eval statistics, and a Trainer.fit on the mesh.
"""
import os
from pathlib import Path

import numpy as np
import torch

from sparse_vae_tpu_torch.checkpoint import model_class
from sparse_vae_tpu_torch.cli import objective_for
from sparse_vae_tpu_torch.parallel import spmd, tp
from sparse_vae_tpu_torch.parallel.group import barrier
from sparse_vae_tpu_torch.parallel.mesh import MODEL, create_mesh, shard_batch
from sparse_vae_tpu_torch.training.optimizer import make_optimizer
from sparse_vae_tpu_torch.training.train_step import train_step

OPTIMIZER = dict(lr=1e-2, lr_decay_steps=1000, grad_clip_threshold=5.0)


def without_dropout(model):
    """The model with the Transformer LM's training dropout at rate 0."""
    if hasattr(model.hparams, "input_dropout"):
        model.hparams.input_dropout = 0.0
    for layer in getattr(model, "decoder_layers", ()):
        layer.dropout_rate = 0.0
    return model


def full_model(hparams, state: dict):
    """The single-device model of `hparams` holding `state`, in fp32,
    without dropout."""
    model = model_class(hparams)(hparams)
    model.load_state_dict(state, strict=True)
    return without_dropout(model)


def single_step(case: dict) -> dict:
    """The case's step on one process: the unsharded reference."""
    model = full_model(case["hparams"], case["state"])
    opt = make_optimizer(model.parameters(), **OPTIMIZER)
    metrics = train_step(model, objective_for(case["hparams"]), opt,
                         case["batches"], case["step"], case["noise"])
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": {n: p.grad.detach().clone()
                      for n, p in model.named_parameters()},
            "params": {k: v.detach().clone()
                       for k, v in model.state_dict().items()}}


def _collectives(mesh, inp: dict) -> dict:
    """f, g, the vocab-parallel embedding and NLL over the model group,
    each value with its adjoints (module docstring of parallel/tp.py)."""
    group = mesh.groups[MODEL]
    r = group.rank
    out = {}
    x = torch.tensor(inp["x"][r], requires_grad=True)
    y = tp.reduce_activations(x, group)
    (y * torch.tensor(inp["cot"][0])).sum().backward()
    out["f"] = (y.detach(), x.grad)
    x = torch.tensor(inp["x"][0], requires_grad=True)
    y = tp.replicate_gradient(x, group)
    (y * torch.tensor(inp["cot"][r])).sum().backward()
    out["g"] = (y.detach(), x.grad)
    rows = inp["table"].shape[0] // group.size
    table = torch.tensor(inp["table"][r * rows:(r + 1) * rows],
                         requires_grad=True)
    y = tp.vocab_parallel_embed(table, torch.tensor(inp["ids"]), group)
    (y * torch.tensor(inp["embed_cot"])).sum().backward()
    out["embed"] = (y.detach(), table.grad)
    g = torch.tensor(inp["g"], requires_grad=True)
    table = torch.tensor(inp["table"][r * rows:(r + 1) * rows],
                         requires_grad=True)
    bias = torch.tensor(inp["bias"][r * rows:(r + 1) * rows],
                        requires_grad=True)
    nll = tp.tied_vocab_parallel_nll(g, table, bias,
                                     torch.tensor(inp["labels"]), group)
    (nll * torch.tensor(inp["dnll"])).sum().backward()
    out["nll"] = (nll.detach(), g.grad, table.grad, bias.grad)
    full = {"w": torch.tensor(inp["table"])}
    out["norm"] = float(tp.sharded_global_norm(
        [tp.shard_state(full, {"w": 0}, r, group.size)["w"],
         torch.tensor(inp["bias"])], [True, False], group))
    return out


def mesh_step(mesh, case: dict) -> dict:
    """The case's step on this rank's shard: metrics, the full (gathered)
    gradients and parameters after the step, and this rank's parameters."""
    model = without_dropout(spmd.localize(
        full_model(case["hparams"], case["state"]), mesh))
    sizes = {"tp_size": mesh.size("model"), "ep_size": mesh.size("expert")}
    opt = make_optimizer(model.parameters(), **OPTIMIZER, **sizes,
                         norm_fn=spmd.mesh_norm_fn(model, mesh))
    mbs = [shard_batch(b, mesh) for b in case["batches"]]
    metrics = train_step(model, objective_for(case["hparams"]), opt, mbs,
                         case["step"], case["noise"])
    specs, group = spmd.shard_layout(model, mesh)
    grads = tp.gather_state({n: p.grad for n, p in model.named_parameters()},
                            specs, group)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "grads": grads, "params": spmd.gather_full_state(model, mesh),
            "local": {n: p.detach().clone()
                      for n, p in model.named_parameters()}}


def mesh_eval(mesh, case: dict) -> dict:
    model = spmd.localize(full_model(case["hparams"], case["state"]), mesh)
    with torch.no_grad():
        stats = spmd.mesh_eval_stats(
            objective_for(case["hparams"]), model,
            shard_batch(case["batches"][0], mesh), mesh,
            noise=case["noise"][0] if case["noise"] else None)
    return {k: float(v) for k, v in stats.items()}


def layouts(world) -> list:
    """Each layout's mesh as this rank sees it: the shape, its
    coordinates, each axis group's world ranks, and its row shard."""
    out = []
    for kw in (dict(model_axis=2), dict(expert_axis=2), dict(),
               dict(model_axis=4)):
        mesh = create_mesh(world, **kw)
        out.append({"shape": dict(mesh.shape),
                    "coords": {a: mesh.coord(a) for a in mesh.shape},
                    "groups": {a: [g.world_rank(i) for i in range(g.size)]
                               for a, g in mesh.groups.items()},
                    "row_shard": mesh.row_shard,
                    "sum": float(spmd.all_reduce_sum(
                        torch.tensor(float(world.rank + 1)),
                        mesh.rows_group))})
    return out


def run_steps(world, cases: list, inputs=None, fit=None,
              with_layouts: bool = False) -> dict:
    """Each case's step (and, with `eval`, its eval statistics) on its
    mesh; with `inputs`, the collective checks on a data 2 x model 2
    mesh; with `fit`, `run_fit(world, *fit)` last; with `with_layouts`,
    `layouts`."""
    torch.set_num_threads(1)
    out = {"steps": [], "evals": []}
    if with_layouts:
        out["layouts"] = layouts(world)
    if inputs is not None:
        out["collectives"] = _collectives(create_mesh(world, model_axis=2),
                                          inputs)
    for case in cases:
        mesh = create_mesh(world, model_axis=case.get("tp", 1),
                           seq_axis=case.get("sp", 1),
                           expert_axis=case.get("ep", 1))
        out["steps"].append(mesh_step(mesh, case))
        if case.get("eval"):
            out["evals"].append(mesh_eval(mesh, case))
    if fit is not None:
        out["fit"] = run_fit(world, *fit)
    return out


def run_fit(world, workdir: str, hparams, trainer_kw: dict,
            data_kw: dict, logits_ids, mesh_kw=None) -> dict:
    """Trainer.fit on a mesh (`create_mesh`'s mesh_kw; data 2 x model 2 by
    default) in `workdir` (rank 0 prepares the corpus), then the step-1
    checkpoint restored into a new trainer's state and one step taken
    from it on the run's second group. Returns the trained (gathered)
    model's logits on `logits_ids`, the outcome, whether the restored
    step equals the unbroken run's step-2 checkpoint bit for bit, the
    trainer's bucket quantum override and its first two groups' shapes."""
    from sparse_vae_tpu_torch.data.text_data_module import (
        TextDataModule, TextDataModuleHparams)
    from sparse_vae_tpu_torch.training.trainer import Trainer
    from sparse_vae_tpu_torch.utils.config import TrainerHparams
    from sparse_vae_tpu_torch.utils.seeds import derived_seed

    torch.set_num_threads(1)
    os.chdir(workdir)
    mesh = create_mesh(world, **(mesh_kw or {"model_axis": 2}))
    dhp = TextDataModuleHparams(**data_kw)
    if world.rank == 0:
        TextDataModule(dhp).prepare_data()
    barrier(world)
    dm = TextDataModule(dhp)
    dm.prepare_data()
    thp = TrainerHparams(**trainer_kw)

    def trainer():
        return Trainer(hparams, objective_for(hparams), dm, thp,
                       name="mesh", log_root=Path(workdir) / "logs",
                       device="cpu", mesh=mesh)

    outcome = trainer().fit()
    with torch.no_grad():
        logits = outcome.model(torch.tensor(logits_ids),
                               torch.zeros(len(logits_ids), 1,
                                           hparams.latent_depth))[0]
    # Resume: the step-1 checkpoint, then the unbroken run's second step.
    again = trainer()
    model, optimizer = again.init_state(torch.Generator().manual_seed(
        derived_seed(thp.seed, 0)))
    generator = torch.Generator().manual_seed(0)
    step = again.restore(model, optimizer, generator, step=1)
    groups = again._accum_groups(thp.seed)
    first, _ = next(groups)
    stacked, _ = next(groups)
    again._step(model, optimizer, stacked, step, generator)
    got = again.state(model, optimizer, step + 1, generator)
    want = again.ckpt.restore(2)
    same = all(torch.equal(got["params"][k], want["params"][k])
               for k in want["params"])
    same = same and all(
        torch.equal(a, b) for key in ("exp_avg", "exp_avg_sq")
        for a, b in zip(got["optimizer"][key], want["optimizer"][key]))
    return {"logits": logits, "step": outcome.step,
            "history": outcome.metrics_history,
            "resumed_equal": bool(same),
            "pad_multiple": again._pad_multiple,
            "group_shapes": [tuple(first["token_ids"].shape),
                             tuple(stacked["token_ids"].shape)],
            "generator_equal": bool(torch.equal(got["generator"],
                                                want["generator"]))}
