"""Expert parallelism over the `expert` axis (port of
sparse_vae_tpu/parallel/ep.py).

On a (data, expert) mesh (parallel/mesh.py) the MoE expert stacks
(models/moe.py) are sharded over `expert`: each rank holds
num_experts / ep full experts, while the batch rows shard over `data` x
`expert` jointly, so everything outside the experts is data parallelism
over every rank. Inside each MoE layer the [E, C, D] dispatch buffer
crosses the `expert` axis with one all-to-all each way
(`exchange_to_experts` / `exchange_from_experts`, the GShard exchange):
[E, C, D] -> [E / ep, ep * C, D] and back.

Gradient reductions (parallel/spmd.py): the replicated leaves see a slice
of the global batch on every rank and are summed over `data` x `expert`;
an expert stack's gradient already covers every expert peer's tokens (the
all-to-all routed them through this rank's experts), so it is summed over
`data` alone. The balance losses stay exact: their sums and counts are
summed over every rank before the linear composition. The one
layout-dependent behaviour is capacity: C comes from each rank's own
token count, so the drop pool is per (shard, expert), as in the JAX
package.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from .group import AxisGroup, all_to_all
from .tp import localized_twin, shard_state

# The MoEFFN leaves stacked over experts, cut on dim 0.
_EXPERT_STACKS = ("w_in", "b_in", "w_out")


def is_expert_leaf(name: str) -> bool:
    parts = name.split(".")
    return len(parts) >= 2 and parts[-2] == "moe" and \
        parts[-1] in _EXPERT_STACKS


def param_specs(model) -> Dict[str, int]:
    """{parameter name: 0} of the expert stacks of `model`."""
    return {name: 0 for name, _ in model.named_parameters()
            if is_expert_leaf(name)}


def _to_experts(buf, group: AxisGroup):
    e, c, d = buf.shape
    ep = group.size
    out = all_to_all(buf.reshape(ep, e // ep, c, d), group)
    return out.transpose(0, 1).reshape(e // ep, ep * c, d)


def _from_experts(out, group: AxisGroup):
    el, epc, d = out.shape
    ep = group.size
    send = out.reshape(el, ep, epc // ep, d).transpose(0, 1).contiguous()
    return all_to_all(send, group).reshape(el * ep, epc // ep, d)


class _ToExperts(torch.autograd.Function):
    @staticmethod
    def forward(ctx, buf, group):
        ctx.group = group
        return _to_experts(buf, group)

    @staticmethod
    def backward(ctx, ct):
        return _from_experts(ct, ctx.group), None


class _FromExperts(torch.autograd.Function):
    @staticmethod
    def forward(ctx, out, group):
        ctx.group = group
        return _from_experts(out, group)

    @staticmethod
    def backward(ctx, ct):
        return _to_experts(ct, ctx.group), None


def exchange_to_experts(buf, group: AxisGroup):
    """[E, C, D] -> [E / ep, ep * C, D]: expert block j of every rank goes
    to rank j, the blocks from rank r at [:, r * C:(r + 1) * C] (JAX's
    tiled all_to_all, split 0, concat 1). Adjoint: the reverse exchange."""
    return _ToExperts.apply(buf, group)


def exchange_from_experts(out, group: AxisGroup):
    """The reverse of `exchange_to_experts`: [E / ep, ep * C, D] ->
    [E, C, D]."""
    return _FromExperts.apply(out, group)


def ep_localize(model, group: AxisGroup):
    """The per-shard twin over the `expert` group: hparams with ep_size =
    group.size, each MoE layer holding its local experts ([E / ep, ...]),
    the exchange bound to `group`. The caller's model is not changed."""
    if group.size <= 1:
        return model
    hp = model.hparams
    if getattr(hp, "num_experts", 0) <= 1:
        raise ValueError(
            "expert parallelism requires an MoE config (num_experts > 1)")
    if hp.num_experts % group.size:
        raise ValueError(
            f"num_experts={hp.num_experts} not divisible by "
            f"ep_size={group.size}")
    state = shard_state(model.state_dict(), param_specs(model), group.rank,
                        group.size)
    twin = localized_twin(model, dataclasses.replace(hp,
                                                     ep_size=group.size),
                          state)
    twin.bind_expert_group(group)
    return twin
