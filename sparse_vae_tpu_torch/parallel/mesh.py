"""The device mesh of the data, model and expert axes (port of
sparse_vae_tpu/parallel/mesh.py: `create_mesh`, `pad_batch_rows`, and the
row placement of parallel/spmd.py's `batch_specs` / `shard_batch`).

A `Mesh` is a set of torch.distributed process groups, one `AxisGroup`
(parallel/group.py) an axis, over a world of ranks started by torchrun or
by `group.spawn`. The axes follow the JAX package's layout, `model` or
`expert` innermost: world rank r sits at data coordinate r // m and
model (or expert) coordinate r % m, so the per-layer tensor-parallel
all-reduces and the experts' all-to-all join neighbouring ranks.

- `data` x `model`: tensor parallelism (parallel/tp.py). The batch rows
  shard over `data`; every model shard of a data coordinate holds the
  same rows.
- `data` x `expert`: expert parallelism (parallel/ep.py). The batch rows
  shard over `data` x `expert` jointly, every rank its own rows.
- `data` alone (model = expert = 1): data parallelism.

Every rank builds the same global batch from the same seed and keeps its
rows (`shard_rows`), after `pad_batch_rows` has padded the rows to a
multiple of the row shards with all-[PAD] rows, which every loss masks
(num_tokens 0). The layouts the JAX package refuses raise with its
messages (an expert axis beside any other, a pipe axis beside another);
those left for a later slice raise naming ROADMAP Queue 1 item 8 (the
`pipe` axis, `seq` in a mesh).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

import numpy as np
import torch
import torch.distributed as dist

from .group import AxisGroup, sub_group

DATA, MODEL, EXPERT = "data", "model", "expert"


@dataclass(frozen=True)
class Mesh:
    """This rank's view of the mesh: the world group, each axis's size and
    this rank's coordinate on it, and each axis's AxisGroup."""
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
        """The ranks the batch rows shard over, whose loss sums are summed:
        `data`, and on an expert mesh `data` x `expert` (the world)."""
        return self.world if self.size(EXPERT) > 1 else self.groups[DATA]

    @property
    def row_shards(self) -> int:
        return self.size(DATA) * self.size(EXPERT)

    @property
    def row_shard(self) -> int:
        """This rank's index among the row shards, data-major."""
        return self.coord(DATA) * self.size(EXPERT) + self.coord(EXPERT)


def create_mesh(world: AxisGroup, model_axis: int = 1, seq_axis: int = 1,
                pipe_axis: int = 1, expert_axis: int = 1) -> Mesh:
    """The (data, model) or (data, expert) mesh over the world's ranks:
    data = world size / (model * expert). Every rank makes every group,
    in one order."""
    n = world.size
    if n % (model_axis * seq_axis * pipe_axis * expert_axis):
        raise ValueError(
            f"{n} ranks do not factor into model {model_axis} x seq "
            f"{seq_axis} x pipe {pipe_axis} x expert {expert_axis}")
    if expert_axis > 1 and (model_axis > 1 or seq_axis > 1
                            or pipe_axis > 1):
        raise NotImplementedError(
            "expert parallelism composes with the 'data' axis only "
            "(parallel/ep.py scope note)")
    if pipe_axis > 1:
        if model_axis > 1 or seq_axis > 1:
            raise NotImplementedError(
                "the pipeline step composes with the 'data' axis only "
                "(parallel/pp.py scope note)")
        raise NotImplementedError(
            "the 'pipe' axis (sparse_vae_tpu/parallel/pp.py) is not ported "
            "yet: ROADMAP Queue 1 item 8")
    if seq_axis > 1:
        raise NotImplementedError(
            "a 'seq' axis in a mesh (data x seq x model, fit over a seq "
            "mesh) is not ported yet: ROADMAP Queue 1 item 8; train "
            "sequence-parallel steps with `python -m sparse_vae_tpu_torch."
            "train transformer-vae <run-name> sp=N`")
    inner_name = EXPERT if expert_axis > 1 else MODEL
    inner = expert_axis if expert_axis > 1 else model_axis
    data = n // inner
    grid = np.arange(n).reshape(data, inner)
    groups = {}
    for axis, lines in ((DATA, grid.T), (inner_name, grid)):
        if lines.shape[1] == 1:
            continue
        for members in lines:
            members = [int(r) for r in members]
            pg = dist.new_group(members) if len(members) < n else None
            if world.rank in members:
                groups[axis] = sub_group(world, members, pg)
    if DATA not in groups:
        groups[DATA] = AxisGroup(0, 1, world.device, world.backend, None,
                                 (world.rank,))
    return Mesh(world, {DATA: data, inner_name: inner}, groups)


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
