"""Pipeline parallelism: the decoder layers sharded over a `pipe` axis
(port of sparse_vae_tpu/parallel/pp.py).

On a (data, pipe) mesh (parallel/mesh.py, `pipe` innermost) each stage
holds num_layers / pipe consecutive decoder layers and, for the
Transformer-VAE, the matching z projections (`pp_localize`); everything
else (the embedding, the head, the encoder and posterior) is replicated.
The gradient-accumulation micro-batches are the pipeline's micro-batches,
streamed GPipe-style through the stages in one optimizer step
(`make_pp_train_step`).

The JAX package differentiates through a `lax.scan` of M + P - 1 ticks
and its `ppermute`; torch has no such transform, so the step runs the two
schedules itself, each a point-to-point `shift` along the pipe group a
tick (parallel/group.py; every rank calls every shift, an idle stage with
zeros):
- forward, M + P - 1 ticks: at tick t stage s runs micro-batch t - s on
  the activation stage s - 1 handed it (stage 0: the embedding), keeps
  that micro-batch's graph, and hands its output on; the last stage runs
  the head and the loss sums;
- backward, reversed: at tick u stage s takes micro-batch M - 1 - (u -
  (P - 1 - s)); the last stage starts from its loss, every other stage
  from the output cotangent stage s + 1 sent it, and each stage past the
  first sends its input's cotangent back to stage s - 1.
Unlike the JAX package's masked SPMD, the embedding runs on stage 0 only
and the head and its loss (K3/K3b) on the last stage only; the sums are
the same. The Transformer-VAE's encoder and posterior run on every stage
with the same per-micro-batch noise, so every stage injects the same z;
each stage's partial encoder gradient (through its own z projections;
the KL's on the last stage) is summed over `pipe`.

Exactness follows parallel/spmd.py's contract: each micro-batch's sums
(the last stage's) are summed over the world (data x pipe) in one
collective, each micro-batch's loss is composed at the global sums, and
the gradient of their mean is taken through the local sums. The shared
leaves' gradients are then summed over data x pipe, the stages' over
`data`; the clip's norm crosses stages (`pp_global_norm`), so RAdam steps
every rank on the same global norm. LAMB is refused, as in the JAX
package (its per-leaf trust ratios would be the stage's).

Layout: `pp_split_params` turns a full state dict into {"shared": ...,
"layers": {name: [num_layers, ...]}[, "z_projections": ...]} and
`pp_merge_params` turns it back; `stage_state` names a stage's leaves as
the full model's.

Scope, as the JAX package's: the AR objective (the Transformer LM) and
the single-sample ELBO (the Transformer-VAE), on data x pipe only; no
MoE, no multi-sample bound. No trainer setting and no entry point
reaches it: it is a library path.
"""
from __future__ import annotations

import time
from typing import Optional, Sequence

import torch
import torch.nn as nn

from .group import AxisGroup, all_reduce_sum, shift
from .mesh import DATA, PIPE, Mesh
from .spmd import all_reduce_grads, mesh_noise

_STAGED = ("decoder_layers", "z_projections")
_STACKED_KEYS = {"decoder_layers": "layers", "z_projections": "z_projections"}


def pipe_size(mesh: Optional[Mesh]) -> int:
    return mesh.size(PIPE) if mesh is not None else 1


# -- parameter layout ---------------------------------------------------------
def _staged(name: str) -> bool:
    return name.split(".", 1)[0] in _STAGED


def pp_split_params(state: dict, num_layers: int) -> dict:
    """A full state dict -> {"shared": {name: tensor}, "layers": {name
    within a layer: [num_layers, ...] stacked}, and, for the
    Transformer-VAE, "z_projections" likewise}."""
    out = {"shared": {k: v for k, v in state.items() if not _staged(k)}}
    for prefix, key in _STACKED_KEYS.items():
        first = f"{prefix}.0."
        names = [k[len(first):] for k in state if k.startswith(first)]
        if names:
            out[key] = {n: torch.stack([state[f"{prefix}.{i}.{n}"]
                                        for i in range(num_layers)])
                        for n in names}
    return out


def pp_merge_params(pp_state: dict) -> dict:
    """The inverse of `pp_split_params`."""
    out = dict(pp_state["shared"])
    for prefix, key in _STACKED_KEYS.items():
        for n, stacked in pp_state.get(key, {}).items():
            for i in range(stacked.shape[0]):
                out[f"{prefix}.{i}.{n}"] = stacked[i]
    return out


def global_name(name: str, stage: int, per_stage: int) -> str:
    """A stage's parameter name as the full model's: local layer i of
    stage s is layer s * per_stage + i."""
    head, _, rest = name.partition(".")
    if head not in _STAGED:
        return name
    index, _, leaf = rest.partition(".")
    return f"{head}.{stage * per_stage + int(index)}.{leaf}"


def stage_state(stage_model) -> dict:
    """A stage's state dict under the full model's names."""
    s, _, per = stage_model.pipe_stage
    return {global_name(k, s, per): v
            for k, v in stage_model.state_dict().items()}


# -- the stage ----------------------------------------------------------------
def _check_pipe(hp, mesh: Mesh) -> int:
    pp = pipe_size(mesh)
    if pp <= 1:
        raise ValueError("mesh has no 'pipe' axis > 1 — use "
                         "parallel.spmd.make_train_step")
    if hp.num_layers % pp:
        raise ValueError(f"num_layers {hp.num_layers} not divisible by "
                         f"pipe={pp}")
    return hp.num_layers // pp


def pp_localize(model, mesh: Mesh):
    """This rank's stage of `model` (a transformer family's full model)
    on a (data, pipe) mesh: the model with only its num_layers / pipe
    decoder layers (and z projections), in place. `pipe_stage` = (stage,
    stages, layers a stage); `mesh` bound."""
    per = _check_pipe(model.hparams, mesh)
    s = mesh.coord(PIPE)
    keep = slice(s * per, (s + 1) * per)
    model.decoder_layers = nn.ModuleList(list(model.decoder_layers)[keep])
    if hasattr(model, "z_projections"):
        model.z_projections = nn.ModuleList(list(model.z_projections)[keep])
    model.pipe_stage = (s, mesh.size(PIPE), per)
    model.mesh = mesh
    return model


def _staged_flags(stage_model) -> list:
    return [_staged(n) for n, _ in stage_model.named_parameters()]


def pp_global_norm(grads, staged, group: AxisGroup):
    """The exact global l2 norm of a stage's gradients (in parameter
    order; staged[i] True for its layers' leaves): the stages' squares
    summed over `pipe`, the shared leaves (the same on every stage after
    the step's sum) counted once."""
    from .tp import sharded_global_norm
    return sharded_global_norm(grads, staged, group)


def make_pp_optimizer(stage_model, lr: float, lr_decay_steps,
                      grad_clip_threshold: float, weight_decay: float = 0.01,
                      warmup_steps: int = 0, lamb: bool = False):
    """training.optimizer.make_optimizer over a stage's parameters with the
    pipe-aware global-norm clip (`pp_global_norm`). RAdam is elementwise,
    so a stage's slice steps as the full model's layers would; LAMB's
    per-tensor trust ratios would not: refused."""
    from ..training.optimizer import make_optimizer
    if lamb:
        raise NotImplementedError(
            "LAMB trust ratios are per-param norms and would be wrong on "
            "pipe-sharded layers; use lamb=False with pipeline parallelism")
    flags = _staged_flags(stage_model)
    group = stage_model.mesh.groups[PIPE]
    return make_optimizer(
        stage_model.parameters(), lr=lr, lr_decay_steps=lr_decay_steps,
        grad_clip_threshold=grad_clip_threshold, weight_decay=weight_decay,
        warmup_steps=warmup_steps,
        norm_fn=lambda grads: pp_global_norm(grads, flags, group))


# -- the pipelined step -------------------------------------------------------
def _check(model, objective, mesh: Mesh):
    """The JAX package's refusals, in its order and with its messages."""
    from ..models.vae import VAEObjective
    from ..training.objectives import ARObjective
    is_vae = isinstance(objective, VAEObjective)
    if not (isinstance(objective, ARObjective) or is_vae):
        raise NotImplementedError(
            "pipeline parallelism supports the AR objective and the "
            "single-sample VAE objective; got "
            f"{type(objective).__name__}")
    hp = model.hparams
    if is_vae:
        if not hasattr(model, "z_projections"):
            raise NotImplementedError(
                "the pipelined VAE path needs the transformer decoder "
                "stack (per-layer z injection); this module has no "
                "stageable layers")
        if getattr(objective.hp, "train_mc_samples", 1) > 1:
            raise NotImplementedError(
                "multi-sample IWAE/DReG training is not pipelined (K "
                "reconstruct passes per microbatch); use "
                "train_mc_samples=1 or the data-parallel step")
    if getattr(hp, "tp_size", 1) > 1 or getattr(hp, "sp_size", 1) > 1:
        raise NotImplementedError("pp composes with 'data' only for now — "
                                  "pass the plain (non-tp/sp) module")
    if getattr(hp, "num_experts", 0) > 1:
        raise NotImplementedError(
            "MoE decoders are not pipelined (the staged scan does not "
            "collect the sown balance losses); use the data- or "
            "expert-parallel step (parallel/ep.py)")
    _check_pipe(hp, mesh)
    return is_vae


def _layer_generator(seed: int, row_shard: int, mb: int, layer: int,
                     device) -> torch.Generator:
    """The dropout stream of one (row shard, micro-batch, global layer):
    layout independent along `pipe`, as the JAX package folds its
    dropout rng by the global layer."""
    from ..utils.seeds import derived_seed
    return torch.Generator(device=device).manual_seed(
        derived_seed(seed, row_shard, mb, layer))


def make_pp_train_step(model, objective, optimizer, mesh: Mesh,
                       deterministic: bool = False, timed: bool = False):
    """The pipelined optimizer step of a stage (`pp_localize`), its
    optimizer from `make_pp_optimizer`:

        step_fn(microbatches, step, noise=None, generator=None) -> metrics

    microbatches: M dicts of this rank's rows {"token_ids": [b, L],
    "num_tokens": [b]}, one shape; noise: per micro-batch the GLOBAL
    batch's {"eps", "mi"} (a VAE; drawn from `generator` where missing,
    as parallel.spmd.mesh_noise draws it); `generator` also seeds the LM's
    dropout (off with deterministic=True; the VAE's forwards are
    deterministic). The metrics are the mean over the micro-batches of
    each composed at the global sums, as train_step's, plus grad_norm.
    With `timed`, `step_fn.timing` holds the last step's seconds: the
    schedule's, and this stage's busy seconds (its own forward and
    backward work, bracketed by device synchronisations, which serialise
    the schedule); else None."""
    is_vae = _check(model, objective, mesh)
    if not hasattr(model, "pipe_stage"):
        raise ValueError("pass the pp_localize'd stage (parallel/pp.py)")
    s, P, per = model.pipe_stage
    group = mesh.groups[PIPE]
    hp = model.hparams
    det = True if is_vae else deterministic
    first, last = s == 0, s == P - 1

    def run_stage(x, mask, z, gens):
        for i, layer in enumerate(model.decoder_layers):
            if z is not None:
                proj = model.z_projections[i]
                z_hidden = proj(z.to(x.dtype)).expand(x.shape[0], 1,
                                                      x.shape[-1])
                x = torch.cat([z_hidden, x[:, 1:]], dim=1)
            x = layer(x, mask, deterministic=det,
                      generator=None if det else gens[i])
        return x

    def sync():
        if timed and mesh.device.type == "cuda":
            torch.cuda.synchronize(mesh.device)

    def step_fn(microbatches: Sequence[dict], step: int, noise=None,
                generator: Optional[torch.Generator] = None) -> dict:
        M = len(microbatches)
        rows, length = microbatches[0]["token_ids"].shape
        device = mesh.device
        t_start, busy = time.perf_counter(), 0.0
        optimizer.zero_grad(set_to_none=True)
        if is_vae:
            noises = [mesh_noise(objective, model, rows,
                                 noise[m] if noise else None, generator,
                                 mesh) for m in range(M)]
        seed = None
        if not det:
            seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator,
                                     device=generator.device))
        saved, local = [None] * M, [None] * M
        recv = torch.zeros(rows, length, hp.d_model, dtype=model.dtype,
                           device=device)
        for t in range(M + P - 1):
            m = t - s
            send = torch.zeros_like(recv)
            if 0 <= m < M:
                sync()
                t0 = time.perf_counter()
                mb = microbatches[m]
                ids = mb["token_ids"]
                gens = None if det else [
                    _layer_generator(seed, mesh.coord(DATA), m,
                                     s * per + i, device)
                    for i in range(per + 1)]
                z = posterior = raw_kl = None
                if is_vae:
                    posterior, raw_kl = model.posterior(ids, get_kl=True)
                    z = posterior.sample(noises[m]["eps"])
                if first:
                    x_in = model.embed(ids, det, None if det else gens[per])
                else:
                    x_in = recv.detach().requires_grad_()
                x_out = run_stage(x_in, ids != 0, z, gens)
                saved[m] = (x_in, x_out)
                if last:
                    nll_sum, count = model.sequence_nll(
                        x_out, model.shifted_labels(ids))
                    sums, counts = {"nll_sum": nll_sum}, {
                        "token_count": count.float()}
                    if is_vae:
                        kl, rc = objective.latent_sums(raw_kl, posterior, mb,
                                                       noises[m])
                        sums.update(kl)
                        counts.update(rc)
                    local[m] = (sums, counts)
                send = x_out.detach()
                sync()
                busy += time.perf_counter() - t0
            if t < M + P - 2:
                recv = shift(send, group, 1)
        # The sums' names: the last stage's, known to every stage.
        s_names, c_names = (sorted(x) for x in objective.sum_names(rows))
        vec = torch.zeros(M, len(s_names) + len(c_names),
                          dtype=torch.float32, device=device)
        if last:
            for m, (sums, counts) in enumerate(local):
                if (sorted(sums), sorted(counts)) != (s_names, c_names):
                    raise RuntimeError(
                        f"the stage computed sums {sorted(sums)} and counts "
                        f"{sorted(counts)}; the objective names {s_names} "
                        f"and {c_names}")
                vec[m] = torch.stack([sums[k].detach().float()
                                      for k in s_names]
                                     + [counts[k].detach().float()
                                        for k in c_names])
        total = all_reduce_sum(vec, mesh.world)
        losses, metrics = [], {}
        for m in range(M):
            g_sums = dict(zip(s_names, total[m, :len(s_names)]))
            g_counts = dict(zip(c_names, total[m, len(s_names):]))
            if last:
                sums = local[m][0]
                g_sums = {k: g_sums[k] + (sums[k] - sums[k].detach())
                          for k in s_names}
            loss, mb_metrics = objective.compose_loss(g_sums, g_counts, step)
            losses.append(loss)
            for k, v in mb_metrics.items():
                metrics[k] = metrics.get(k, 0.0) + v.detach().float() / M
        for u in range(M + P - 1):
            m = M - 1 - (u - (P - 1 - s))
            send = None
            if 0 <= m < M:
                sync()
                t0 = time.perf_counter()
                x_in, x_out = saved[m]
                if last:
                    (losses[m] / M).backward()
                else:
                    torch.autograd.backward(x_out, grad_tensors=ct)
                if not first:
                    send = x_in.grad
                saved[m] = None
                sync()
                busy += time.perf_counter() - t0
            if u < M + P - 2:
                ct = shift(send if send is not None else torch.zeros_like(
                    recv), group, -1)
        named = list(model.named_parameters())
        all_reduce_grads([p for n, p in named if not _staged(n)],
                         mesh.world)
        all_reduce_grads([p for n, p in named if _staged(n)],
                         mesh.groups[DATA])
        metrics["loss"] = torch.stack([x.detach().float()
                                       for x in losses]).mean()
        metrics["grad_norm"] = optimizer.step()
        sync()
        if timed:
            step_fn.timing = {"schedule_s": time.perf_counter() - t_start,
                              "busy_s": busy}
        return metrics

    step_fn.timing = None
    return step_fn
