"""The device mesh of the data, seq, model, expert and pipe axes (port of
sparse_vae_tpu/parallel/mesh.py: `create_mesh`, `pad_batch_rows`, and the
placement of parallel/spmd.py's `batch_specs` / `shard_batch`).

A `Mesh` is a set of torch.distributed process groups, one `AxisGroup`
(parallel/group.py) an axis, over a world of ranks started by torchrun or
by `group.spawn`. The axes follow the JAX package's layout, the last axis
innermost: world rank r sits at the row-major coordinates of r in the
grid, so the per-layer tensor-parallel all-reduces, the experts'
all-to-all and the pipeline's hand-offs join neighbouring ranks.

- `data` x `seq` x `model` (seq or model 1 where absent): the batch rows
  shard over `data`, the length of token_ids over `seq` (sequence
  parallelism, parallel/sp.py), the heads, FFNs and tied vocabulary over
  `model` (parallel/tp.py). Every seq and model shard of a data
  coordinate holds the same rows; the loss sums and the gradients are
  summed over `data` x `seq` (`sums_group`).
- `data` x `expert`: expert parallelism (parallel/ep.py). The batch rows
  shard over `data` x `expert` jointly, every rank its own rows.
- `data` x `pipe`: pipeline parallelism (parallel/pp.py), `pipe`
  innermost: the decoder layers shard over `pipe`, the rows over `data`.
- `data` alone: data parallelism.

Every rank builds the same global batch from the same seed and keeps its
part (`shard_batch`), after `pad_batch_rows` has padded the rows to a
multiple of the row shards with all-[PAD] rows, which every loss masks
(num_tokens 0). The layouts the JAX package refuses raise with its
messages: an expert axis beside any other, a pipe axis beside model or
seq.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from .group import AxisGroup, sub_group

DATA, SEQ, MODEL, EXPERT, PIPE = "data", "seq", "model", "expert", "pipe"
# The group over which a seq mesh sums its loss sums and gradients.
DATA_SEQ = "data_seq"


@dataclass(frozen=True)
class Mesh:
    """This rank's view of the mesh: the world group, each axis's size and
    this rank's coordinate on it, and each axis's AxisGroup (with
    `DATA_SEQ`, data x seq jointly, on a seq mesh)."""
    world: AxisGroup
    shape: Dict[str, int]
    groups: Dict[str, AxisGroup] = field(default_factory=dict)

    def size(self, axis: str) -> int:
        return self.shape.get(axis, 1)

    def coord(self, axis: str) -> int:
        return self.groups[axis].rank if axis in self.groups else 0

    @property
    def device(self) -> torch.device:
        return self.world.device

    @property
    def rows_group(self) -> AxisGroup:
        """The ranks the batch rows shard over: `data`, and on an expert
        mesh `data` x `expert` (the world)."""
        return self.world if self.size(EXPERT) > 1 else self.groups[DATA]

    @property
    def sums_group(self) -> AxisGroup:
        """The ranks whose loss sums (and gradients of replicated leaves)
        are summed: the rows group, and on a seq mesh `data` x `seq`."""
        if self.size(SEQ) > 1:
            return self.groups[DATA_SEQ]
        return self.rows_group

    @property
    def row_shards(self) -> int:
        return self.size(DATA) * self.size(EXPERT)

    @property
    def row_shard(self) -> int:
        """This rank's index among the row shards, data-major."""
        return self.coord(DATA) * self.size(EXPERT) + self.coord(EXPERT)


def mesh_axes(n: int, model_axis: int, seq_axis: int, pipe_axis: int,
              expert_axis: int):
    """The mesh's axes, outermost first, with their sizes; JAX's refusals
    and its messages."""
    if n % (model_axis * seq_axis * pipe_axis * expert_axis):
        raise ValueError(
            f"{n} ranks do not factor into model {model_axis} x seq "
            f"{seq_axis} x pipe {pipe_axis} x expert {expert_axis}")
    if expert_axis > 1:
        if model_axis > 1 or seq_axis > 1 or pipe_axis > 1:
            raise NotImplementedError(
                "expert parallelism composes with the 'data' axis only "
                "(parallel/ep.py scope note)")
        return ((DATA, n // expert_axis), (EXPERT, expert_axis))
    if pipe_axis > 1:
        if model_axis > 1 or seq_axis > 1:
            raise NotImplementedError(
                "the pipeline step composes with the 'data' axis only "
                "(parallel/pp.py scope note)")
        return ((DATA, n // pipe_axis), (PIPE, pipe_axis))
    if seq_axis > 1:
        return ((DATA, n // (model_axis * seq_axis)), (SEQ, seq_axis),
                (MODEL, model_axis))
    return ((DATA, n // model_axis), (MODEL, model_axis))


def create_mesh(world: AxisGroup, model_axis: int = 1, seq_axis: int = 1,
                pipe_axis: int = 1, expert_axis: int = 1) -> Mesh:
    """The (data, model), (data, seq, model), (data, expert) or (data,
    pipe) mesh over the world's ranks, the last axis innermost; data =
    the world size / the others. Every rank makes every group, in one
    order: each axis's lines in turn, then on a seq mesh the data x seq
    planes."""
    axes = mesh_axes(world.size, model_axis, seq_axis, pipe_axis,
                     expert_axis)
    names = [a for a, _ in axes]
    grid = np.arange(world.size).reshape([size for _, size in axes])
    lines = [(axis, np.moveaxis(grid, i, -1).reshape(-1, grid.shape[i]))
             for i, axis in enumerate(names)]
    if SEQ in names:
        planes = grid.reshape(-1, grid.shape[-1]).T   # per model coordinate
        lines.append((DATA_SEQ, planes))
    groups = {}
    for axis, members_of in lines:
        if members_of.shape[1] == 1:
            continue
        for members in members_of:
            members = [int(r) for r in members]
            pg = dist.new_group(members) if len(members) < world.size \
                else None
            if world.rank in members:
                groups[axis] = sub_group(world, members, pg)
    if DATA not in groups:
        groups[DATA] = AxisGroup(0, 1, world.device, world.backend, None,
                                 (world.rank,))
    return Mesh(world, dict(axes), groups)


def pad_batch_rows(arrays: dict, multiple: int, dim: int = 0) -> dict:
    """Pad the batch dim (`dim`: 1 for stacked [k, rows, ...] arrays) up
    to a multiple of `multiple` with all-[PAD] rows (num_tokens 0: masked
    by every loss). numpy or torch arrays."""
    rows = arrays["token_ids"].shape[dim]
    rem = (-rows) % multiple
    if rem == 0:
        return arrays
    out = {}
    for name, v in arrays.items():
        if isinstance(v, torch.Tensor):
            pad = list(v.shape)
            pad[dim] = rem
            out[name] = torch.cat([v, v.new_zeros(pad)], dim=dim)
        else:
            width = [(0, 0)] * v.ndim
            width[dim] = (0, rem)
            out[name] = np.pad(v, width)
    return out


def shard_rows(arrays: dict, mesh: Mesh, stacked: bool = False) -> dict:
    """This rank's rows of a global batch dict (numpy or torch, rows on
    dim 0, or on dim 1 of stacked [k, rows, ...] arrays), padded first to
    a multiple of the row shards."""
    dim = 1 if stacked else 0
    arrays = pad_batch_rows(arrays, mesh.row_shards, dim)
    per = arrays["token_ids"].shape[dim] // mesh.row_shards
    lo = mesh.row_shard * per
    out = {}
    for name, v in arrays.items():
        index = [slice(None)] * v.ndim
        index[dim] = slice(lo, lo + per)
        out[name] = v[tuple(index)]
    return out


def shard_batch(arrays: dict, mesh: Mesh, stacked: bool = False) -> dict:
    """This rank's part of a global batch dict: its rows (`shard_rows`)
    and, on a seq mesh, its slice of token_ids' length (the last dim),
    rank s of `seq` holding positions s * L / seq .. (s + 1) * L / seq - 1.
    The per-row num_tokens and num_bytes stay whole."""
    arrays = shard_rows(arrays, mesh, stacked)
    n = mesh.size(SEQ)
    if n <= 1:
        return arrays
    ids = arrays["token_ids"]
    length = ids.shape[-1]
    if length % n:
        raise ValueError(f"length {length} does not split over {n} seq "
                         "shards")
    per = length // n
    lo = mesh.coord(SEQ) * per
    return {**arrays, "token_ids": ids[..., lo:lo + per]}
