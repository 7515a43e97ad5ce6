"""The sequence-parallel parts of the train step (port of the `seq` axis
of sparse_vae_tpu/parallel/spmd.py: `_SeqOnceObjective`, `_seq_setup` and
the step's sharded loss and gradient).

training/train_step.py calls these when its model is bound to a seq group
(parallel.sp.sp_localize):

- `SeqOnceObjective` counts the objective's per-ROW statistics
  (ROW_SUMS / ROW_COUNTS: KL, the IWAE bound's sums, row counts) on
  shard 0 only, since they are the same on every shard; token sums stay
  local. The IWAE bound is not linear in a shard's partial
  log-likelihoods, so its per-document log p(x | z) is summed over the
  shards inside `reconstruct_ll` before the bound, which is then a per-row
  statistic like the KL. It needs the chunked
  loss: the full-logits branch shifts labels locally and would mislabel
  the shard boundaries.
- `seq_loss` differentiates the LOCAL sums with the cotangent taken at the
  all-reduced GLOBAL sums. compose_loss is linear in the sums, so
  compose_loss(global + (local - local.detach()), global counts) has
  exactly the global value, the same on every rank, and the right
  gradient for this shard's terms; the all-reduce itself is never
  differentiated.
- `all_reduce_grads` sums the flattened gradients over the group in one
  collective; clip and RAdam then run on every rank on identical
  gradients, so the parameters stay identical on every rank.
"""
from __future__ import annotations

import torch

from .group import SeqGroup
from .sp import all_reduce_sum, broadcast_from_first


class SeqOnceObjective:
    """An objective whose per-ROW statistics count on shard 0 only: on
    the other shards they are multiplied by 0, which keeps every rank's
    graph the same."""

    def __init__(self, inner, group: SeqGroup):
        if not getattr(inner.hp, "loss_chunk_size", 0):
            raise ValueError(
                "sequence parallelism requires the chunked loss path "
                "(loss_chunk_size > 0): the full-logits branch shifts "
                "labels locally and would mislabel shard boundaries")
        self.inner, self.group = inner, group

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def _once(self, stats: dict, keys) -> dict:
        on_first = float(self.group.rank == 0)
        return {k: v * on_first if k in keys else v
                for k, v in stats.items()}

    def loss_sums(self, model, batch, noise=None, generator=None):
        sums, counts = self.inner.loss_sums(model, batch, noise, generator)
        return (self._once(sums, self.inner.ROW_SUMS),
                self._once(counts, self.inner.ROW_COUNTS))


def seq_noise(objective, model, batch: dict, noise, generator,
              group: SeqGroup) -> dict:
    """The posterior noise of one micro-batch, the same on every rank:
    what `noise` gives, and draws from `generator` broadcast from rank 0
    for what it lacks. With train_mc_samples K > 1, eps [K, rows, 1,
    latent] alone: every shard of a row must decode the same K samples of
    z, or the sum of reconstruct_ll over the shards mixes samples."""
    noise = dict(noise or {})
    rows = batch["token_ids"].shape[0]
    latent = model.hparams.latent_depth
    device = batch["token_ids"].device
    k = getattr(objective.hp, "train_mc_samples", 1)
    shapes = ({"eps": (k, rows, 1, latent)} if k > 1 else
              {"eps": (rows, 1, latent),
               "mi": (objective.mi_samples, rows, latent)})
    for name, shape in shapes.items():
        if name not in noise:
            drawn = torch.randn(shape, generator=generator, device=device)
            noise[name] = broadcast_from_first(drawn, group)
    return noise


def seq_loss(objective, model, batch: dict, step: int, noise, generator,
             group: SeqGroup):
    """(loss, metrics) of one length-sharded micro-batch: the global
    values on every rank, with this shard's gradient."""
    objective = SeqOnceObjective(objective, group)
    noise = seq_noise(objective, model, batch, noise, generator, group)
    sums, counts = objective.loss_sums(model, batch, noise)
    s_names, c_names = sorted(sums), sorted(counts)
    local = torch.stack([sums[k].detach().float() for k in s_names]
                        + [counts[k].detach().float() for k in c_names])
    total = all_reduce_sum(local, group)
    g_sums = dict(zip(s_names, total[:len(s_names)]))
    g_counts = dict(zip(c_names, total[len(s_names):]))
    mixed = {k: g_sums[k] + (sums[k] - sums[k].detach()) for k in s_names}
    return objective.compose_loss(mixed, g_counts, step)


def all_reduce_grads(model, group: SeqGroup) -> None:
    """Sum every parameter's gradient over the group, in place, in one
    collective over the flattened fp32 gradients."""
    params = [p for p in model.parameters() if p.requires_grad]
    flat = torch.cat([(p.grad if p.grad is not None
                       else torch.zeros_like(p)).reshape(-1).float()
                      for p in params])
    flat = all_reduce_sum(flat, group)
    offset = 0
    for p in params:
        n = p.numel()
        p.grad = flat[offset:offset + n].view_as(p).to(p.dtype)
        offset += n
