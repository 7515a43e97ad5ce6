"""One optimizer step (port of sparse_vae_tpu/parallel/spmd.py::
make_train_step).

Each micro-batch's loss is its own composition of sums and counts; the
step's gradient is the mean of the micro-batch gradients (Lightning's
accumulation), `grad_norm` is the norm of that unclipped mean, and the
metrics are averaged over the micro-batches.

A model bound to a seq group (parallel.sp.sp_localize) takes the
sequence-parallel step of parallel/spmd.py: each micro-batch is this
rank's slice of the length axis, its loss the global composition of the
all-reduced sums, and the gradients are summed over the group once,
before the mean and the optimizer step. A model localized on a mesh
(parallel.spmd.localize) takes the mesh step: each micro-batch is this
rank's rows, the noise the global batch's (each rank keeps its rows),
the loss the global composition of the sums summed over the rows group,
and the gradients are summed per leaf by the mesh's rule
(`spmd.reduce_mesh_grads`) once, before the mean and the optimizer step.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch


def train_step(model, objective, optimizer, microbatches: Sequence[dict],
               step: int, noise: Optional[Sequence[dict]] = None,
               generator: Optional[torch.Generator] = None) -> dict:
    """Forward and backward over each micro-batch, then one optimizer
    step. microbatches: [{"token_ids": [B, L], "num_tokens": [B]}, ...]
    (under sequence parallelism token_ids is this rank's [B, L / n], on
    a mesh this rank's rows); noise: one {"eps", "mi"} dict per
    micro-batch (models/vae.py; on a mesh the global batch's), or None to
    draw from `generator`. Returns {name: fp32 scalar tensor}."""
    group = getattr(model, "seq_group", None)
    mesh = getattr(model, "mesh", None)
    if group is not None or mesh is not None:
        from ..parallel import spmd
    k = len(microbatches)
    optimizer.zero_grad(set_to_none=True)
    totals = {}
    for i, mb in enumerate(microbatches):
        mb_noise = noise[i] if noise else None
        if mesh is not None:
            loss, metrics = spmd.mesh_loss(objective, model, mb, step,
                                           mb_noise, generator, mesh)
        elif group is None:
            loss, metrics = objective.loss(model, mb, step, mb_noise,
                                           generator)
        else:
            loss, metrics = spmd.seq_loss(objective, model, mb, step,
                                          mb_noise, generator, group)
        loss.backward()
        metrics["loss"] = loss
        for name, value in metrics.items():
            value = value.detach().float().to(loss.device)
            totals[name] = totals[name] + value if name in totals else value
    if mesh is not None:
        spmd.reduce_mesh_grads(model, mesh)
    elif group is not None:
        spmd.all_reduce_grads(model, group)
    if k > 1:
        for p in model.parameters():
            if p.grad is not None:
                p.grad.div_(k)
    out = {name: value / k for name, value in totals.items()}
    out["grad_norm"] = optimizer.step()
    return out
