"""One optimizer step (port of the single-device path of
sparse_vae_tpu/parallel/spmd.py::make_train_step).

Each micro-batch's loss is its own composition of sums and counts; the
step's gradient is the mean of the micro-batch gradients (Lightning's
accumulation), `grad_norm` is the norm of that unclipped mean, and the
metrics are averaged over the micro-batches.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch


def train_step(model, objective, optimizer, microbatches: Sequence[dict],
               step: int, noise: Optional[Sequence[dict]] = None,
               generator: Optional[torch.Generator] = None) -> dict:
    """Forward and backward over each micro-batch, then one optimizer
    step. microbatches: [{"token_ids": [B, L], "num_tokens": [B]}, ...];
    noise: one {"eps", "mi"} dict per micro-batch (models/vae.py), or None
    to draw from `generator`. Returns {name: fp32 scalar tensor}."""
    k = len(microbatches)
    optimizer.zero_grad(set_to_none=True)
    totals = {}
    for i, mb in enumerate(microbatches):
        loss, metrics = objective.loss(model, mb, step,
                                       noise[i] if noise else None,
                                       generator)
        loss.backward()
        metrics["loss"] = loss
        for name, value in metrics.items():
            value = value.detach().float().to(loss.device)
            totals[name] = totals[name] + value if name in totals else value
    if k > 1:
        for p in model.parameters():
            if p.grad is not None:
                p.grad.div_(k)
    out = {name: value / k for name, value in totals.items()}
    out["grad_norm"] = optimizer.step()
    return out
