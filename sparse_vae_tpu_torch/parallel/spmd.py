"""The sharded parts of the train and eval steps (port of
sparse_vae_tpu/parallel/spmd.py: `_SeqOnceObjective`, `_seq_setup`, the
mesh branch of `make_train_step` and `make_eval_step`, and
`assert_compose_loss_linear`).

training/train_step.py calls these when its model is bound to a seq group
(parallel.sp.sp_localize) or localized on a mesh (`localize`,
parallel/mesh.py):

- `sharded_loss` differentiates the LOCAL sums with the cotangent taken
  at the all-reduced GLOBAL sums. compose_loss is linear in the sums, so
  compose_loss(global + (local - local.detach()), global counts) has
  exactly the global value, the same on every rank, and the right
  gradient for this shard's terms; the all-reduce itself is never
  differentiated. `assert_compose_loss_linear` checks that contract for
  an objective. The sums are summed over the seq group, or over the
  mesh's `sums_group`: `data`, `data` x `expert` on an expert mesh,
  `data` x `seq` on a seq mesh.
- `SeqOnceObjective` counts the objective's per-ROW statistics
  (ROW_SUMS / ROW_COUNTS: KL, the IWAE bound's sums, row counts) on
  shard 0 only, since they are the same on every length shard; token
  sums stay local. The IWAE bound is not linear in a shard's partial
  log-likelihoods, so its per-document log p(x | z) is summed over the
  shards inside `reconstruct_ll` before the bound, which is then a
  per-row statistic like the KL. It needs the chunked loss: the
  full-logits branch shifts labels locally and would mislabel the shard
  boundaries. On a seq mesh (`seq_once`) it wraps the objective of the
  train and the eval statistics alike.
- Noise. Under sequence parallelism every shard of a row decodes the same
  z: `seq_noise` broadcasts rank 0's draws. On a mesh the posterior noise
  is drawn for the GLOBAL batch, the same on every rank, and each rank
  keeps its rows (`mesh_noise`), so that a sharded step and an unsharded
  one can be given the same eps; the language models' dropout draws from
  the generator folded with the row shard (`fold_generator`, JAX's
  fold_in of the step rng with the data (x expert) index).
- Gradients: `all_reduce_grads` sums a set of parameters' gradients over
  a group in one collective over the flattened fp32 gradients.
  `reduce_mesh_grads` applies the mesh's rule per leaf: replicated
  leaves over `data` (x `expert` on an expert mesh), model-sharded leaves
  and expert stacks over `data` alone, every leaf over `data` x `seq` on
  a seq mesh; no sum ever crosses `model`. Clip
  and RAdam then run on every rank on identical gradients (the clip's
  norm from `mesh_norm_fn`), so the parameters stay identical wherever
  they are replicated.
- `mesh_eval_stats` sums the objective's eval statistics over the sums
  group.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from .group import AxisGroup, SeqGroup, all_reduce_sum, broadcast_from_first
from .mesh import DATA, EXPERT, MODEL, SEQ, Mesh


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

    def eval_stats(self, model, batch, noise=None, generator=None):
        return self._once(self.inner.eval_stats(model, batch, noise,
                                                generator),
                          self.inner.ROW_EVAL)


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


def sharded_loss(objective, model, batch: dict, step: int, noise,
                 generator, group: AxisGroup):
    """(loss, metrics) of one sharded micro-batch: the composition of the
    sums and counts summed over `group`, the same on every rank, with
    this shard's gradient."""
    sums, counts = objective.loss_sums(model, batch, noise, generator)
    s_names, c_names = sorted(sums), sorted(counts)
    parts = [sums[k] for k in s_names] + [counts[k] for k in c_names]
    local = torch.cat([p.detach().float().reshape(-1) for p in parts])
    total = all_reduce_sum(local, group)
    reduced, offset = [], 0
    for p in parts:
        reduced.append(total[offset:offset + p.numel()].view(p.shape))
        offset += p.numel()
    g_sums = dict(zip(s_names, reduced[:len(s_names)]))
    g_counts = dict(zip(c_names, reduced[len(s_names):]))
    mixed = {k: g_sums[k] + (sums[k] - sums[k].detach()) for k in s_names}
    return objective.compose_loss(mixed, g_counts, step)


def seq_loss(objective, model, batch: dict, step: int, noise, generator,
             group: SeqGroup):
    """(loss, metrics) of one length-sharded micro-batch: the global
    values on every rank, with this shard's gradient."""
    objective = SeqOnceObjective(objective, group)
    if not hasattr(objective, "mi_samples"):
        # A language model draws no latent noise; its dropout generator
        # folds by the shard inside the objective.
        return sharded_loss(objective, model, batch, step, noise, generator,
                            group)
    noise = seq_noise(objective, model, batch, noise, generator, group)
    return sharded_loss(objective, model, batch, step, noise, None, group)


def assert_compose_loss_linear(objective, sums: dict, counts: dict,
                               step: int, atol: float = 1e-5):
    """The sharded-gradient contract: compose_loss must be LINEAR in
    `sums` at fixed counts, since `sharded_loss` takes the cotangent of
    the local sums at the global ones. Checks that the gradient of the
    loss in the sums is the same at `sums` and at 1 + 2 * sums; raises
    AssertionError where it is not."""
    def grads(point):
        leaves = {k: v.detach().clone().float().requires_grad_()
                  for k, v in point.items()}
        loss = objective.compose_loss(leaves, counts, step)[0]
        return torch.autograd.grad(loss, list(leaves.values()),
                                   allow_unused=True)

    g1 = grads(sums)
    g2 = grads({k: 1.0 + 2.0 * v for k, v in sums.items()})
    for name, a, b in zip(sums, g1, g2):
        a = torch.zeros(()) if a is None else a
        b = torch.zeros(()) if b is None else b
        if not torch.allclose(a, b, atol=atol, rtol=0.0):
            raise AssertionError(
                f"compose_loss is NOT linear in sums[{name!r}]: the "
                "sharded gradient would be wrong (see "
                "assert_compose_loss_linear)")


# -- the mesh ---------------------------------------------------------------------
def localize(model, mesh: Mesh):
    """`model`'s twin on this rank of the mesh: tensor-parallel over
    `model`, expert-parallel over `expert`, or `model` itself for data
    parallelism; bound to the `seq` group on a seq mesh
    (parallel.sp.sp_localize), and to the mesh (`model.mesh`) for
    train_step."""
    from .ep import ep_localize
    from .sp import sp_localize
    from .tp import tp_localize
    if mesh.size(MODEL) > 1:
        twin = tp_localize(model, mesh.groups[MODEL])
    elif mesh.size(EXPERT) > 1:
        twin = ep_localize(model, mesh.groups[EXPERT])
    else:
        twin = model
    if mesh.size(SEQ) > 1:
        sp_localize(twin, mesh.groups[SEQ])
    twin.mesh = mesh
    return twin


def shard_layout(model, mesh: Mesh):
    """({parameter name: dim} of the sharded parameters, their group) of a
    localized model: the model-sharded leaves over `model`, the expert
    stacks over `expert`, none for data parallelism."""
    from . import ep, tp
    if mesh.size(MODEL) > 1:
        return tp.param_specs(model, model.shard_vocab), mesh.groups[MODEL]
    if mesh.size(EXPERT) > 1:
        return ep.param_specs(model), mesh.groups[EXPERT]
    return {}, mesh.groups[DATA]


def mesh_norm_fn(model, mesh: Mesh) -> Optional[Callable]:
    """The clip's exact global norm over a localized model's gradients
    (in parameter order): the sharded leaves' squares summed over their
    group. None under data parallelism (every leaf whole)."""
    from .tp import sharded_global_norm
    specs, group = shard_layout(model, mesh)
    if not specs:
        return None
    flags = [name in specs for name, _ in model.named_parameters()]
    return lambda grads: sharded_global_norm(grads, flags, group)


def fold_generator(generator: torch.Generator, shard: int
                   ) -> torch.Generator:
    """A generator for row shard `shard`, seeded from one draw of
    `generator` (the same draw on every rank, which advances it alike)
    and the shard."""
    from ..utils.seeds import derived_seed
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                             device=generator.device))
    return torch.Generator(device=generator.device).manual_seed(
        derived_seed(seed, shard))


def mesh_noise(objective, model, rows: int, noise, generator,
               mesh: Mesh) -> Optional[dict]:
    """This rank's rows of a VAE micro-batch's posterior noise: `noise`
    holds the GLOBAL batch's {"eps", "mi"} (whatever it lacks is drawn
    from `generator`, eps first, in the global shapes, the same on every
    rank), and each rank keeps rows row_shard * rows .. + rows. eps is
    [R, 1, latent] ([R, latent] for the LSTM-VAE; [K, R, ...] with
    train_mc_samples K > 1), mi [S, R, latent]. A language model draws no
    noise: None."""
    if not hasattr(objective, "mi_samples"):
        return None
    noise = dict(noise or {})
    if "dropout" in noise:
        raise NotImplementedError("explicit dropout masks on a mesh")
    hp = model.hparams
    latent = hp.latent_depth
    total = rows * mesh.row_shards
    tail = (1, latent) if hasattr(hp, "num_encoder_latents") else (latent,)
    k = getattr(hp, "train_mc_samples", 1)
    shapes = ({"eps": ((k, total, *tail), 1)} if k > 1 else
              {"eps": ((total, *tail), 0),
               "mi": ((objective.mi_samples, total, latent), 1)})
    lo = mesh.row_shard * rows
    out = {}
    for name, (shape, dim) in shapes.items():
        value = noise.get(name)
        if value is None:
            value = torch.randn(shape, generator=generator,
                                device=mesh.device)
        out[name] = value.to(mesh.device).narrow(dim, lo, rows)
    return out


def seq_once(objective, mesh: Mesh):
    """The objective as a seq mesh needs it: per-row statistics counted on
    seq shard 0 (`SeqOnceObjective`); itself elsewhere."""
    if mesh.size(SEQ) > 1:
        return SeqOnceObjective(objective, mesh.groups[SEQ])
    return objective


def mesh_loss(objective, model, batch: dict, step: int, noise, generator,
              mesh: Mesh):
    """(loss, metrics) of this rank's part of one micro-batch on the mesh
    (its rows; on a seq mesh its slice of their length): the global
    values on every rank, with this shard's gradient, the sums summed
    over `mesh.sums_group`. noise: the global micro-batch's
    (`mesh_noise`; every seq shard of a row decodes the same z). The
    dropout generator folds by the row shard here and by the seq shard in
    the objective."""
    rows = batch["token_ids"].shape[0]
    noise = mesh_noise(objective, model, rows, noise, generator, mesh)
    folded = (None if generator is None
              else fold_generator(generator, mesh.row_shard))
    return sharded_loss(seq_once(objective, mesh), model, batch, step, noise,
                        folded, mesh.sums_group)


def all_reduce_grads(params, group: AxisGroup) -> None:
    """Sum the gradients of `params` (a model or a list) over the group,
    in place, in one collective over the flattened fp32 gradients."""
    if hasattr(params, "parameters"):
        params = params.parameters()
    params = [p for p in params if p.requires_grad]
    if group.size <= 1 or not params:
        return
    flat = torch.cat([(p.grad if p.grad is not None
                       else torch.zeros_like(p)).reshape(-1).float()
                      for p in params])
    flat = all_reduce_sum(flat, group)
    offset = 0
    for p in params:
        n = p.numel()
        p.grad = flat[offset:offset + n].view_as(p).to(p.dtype)
        offset += n


def reduce_mesh_grads(model, mesh: Mesh) -> None:
    """Each gradient summed over the ranks whose tokens it has not seen:
    `data` for every leaf, and `seq` too on a seq mesh; on an expert mesh
    also `expert` for all but the expert stacks, whose gradients the
    exchange already made complete over it."""
    if mesh.size(EXPERT) <= 1:
        all_reduce_grads(model, mesh.sums_group)
        return
    from .ep import is_expert_leaf
    named = list(model.named_parameters())
    all_reduce_grads([p for n, p in named if is_expert_leaf(n)],
                     mesh.groups[DATA])
    all_reduce_grads([p for n, p in named if not is_expert_leaf(n)],
                     mesh.world)


def mesh_eval_stats(objective, model, batch: dict, mesh: Mesh, noise=None,
                    generator=None) -> dict:
    """The objective's eval statistics of this rank's rows of a batch,
    summed over the rows group: the global batch's, the same on every
    rank. noise: the global batch's {"eps"} (or drawn from `generator`
    in the global shape). Call under torch.no_grad."""
    rows = batch["token_ids"].shape[0]
    local_noise = mesh_noise(objective, model, rows, noise, generator, mesh)
    if local_noise is not None:
        local_noise = {"eps": local_noise["eps"]}
    stats = seq_once(objective, mesh).eval_stats(model, batch, local_noise,
                                                 generator)
    names = sorted(stats)
    total = all_reduce_sum(torch.stack(
        [stats[k].detach().float() for k in names]), mesh.sums_group)
    return dict(zip(names, total))


def gather_full_state(model, mesh: Mesh) -> dict:
    """The full (single-device) state dict of a localized model, on every
    rank: each sharded leaf gathered over its group."""
    from .tp import gather_state
    specs, group = shard_layout(model, mesh)
    return gather_state(model.state_dict(), specs, group)


def shard_full_state(model, mesh: Mesh, state: dict) -> dict:
    """This rank's shard of a full state dict, for the localized `model`."""
    from .tp import shard_state
    specs, group = shard_layout(model, mesh)
    return shard_state(state, specs, group.rank, group.size)


def _moment_names(model) -> list:
    return [name for name, _ in model.named_parameters()]


def gather_optimizer_state(model, mesh: Mesh, state: dict) -> dict:
    """An RAdam `state_tensors()` of a localized model with every moment
    of a sharded parameter gathered: the full model's optimizer state."""
    from .tp import gather_state
    specs, group = shard_layout(model, mesh)
    names = _moment_names(model)
    out = {"count": state["count"]}
    for key in ("exp_avg", "exp_avg_sq"):
        moments = dict(zip(names, state[key])) if state[key] else {}
        full = gather_state(moments, specs, group)
        out[key] = [full[n] for n in names] if moments else []
    return out


def shard_optimizer_state(model, mesh: Mesh, state: dict) -> dict:
    """The reverse of `gather_optimizer_state`: this rank's moments."""
    from .tp import shard_state
    specs, group = shard_layout(model, mesh)
    names = _moment_names(model)
    out = {"count": state["count"]}
    for key in ("exp_avg", "exp_avg_sq"):
        if not state[key]:
            out[key] = []
            continue
        local = shard_state(dict(zip(names, state[key])), specs, group.rank,
                            group.size)
        out[key] = [local[n] for n in names]
    return out
