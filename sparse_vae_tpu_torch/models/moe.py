"""Mixture-of-experts FFN (port of sparse_vae_tpu/models/moe.py).

A decoder layer with num_experts > 1 replaces its dense 4x GELU FFN by E
expert FFNs behind a learned top-k router, GShard/Switch style:

- Capacity: each expert has C = ceil(k * N * capacity_factor / E) slots,
  N = B * L of the call, pads included, so a decode step, a chunk peek
  and a full forward each have their own C (`expert_capacity`).
- Router: a bias-free fp32 Linear on x.float(); probabilities are its
  softmax; the top-k gates are renormalised to sum 1 when k > 1. Ties
  go to the lower expert index, as jax.lax.top_k gives them (a stable
  descending sort: torch.topk promises no order on CUDA).
- Dispatch: k-major, first come first served. All first choices of the
  call outrank every second choice, and earlier tokens outrank later
  ones; a token past its expert's C slots is dropped and gets zero MoE
  output (it rides the residual). Pad tokens (mask False) take no slot
  and count in no statistic.
- The [E, C, D] buffer is filled in the compute dtype, one slot after
  the other, as the reference's scatter-add: a dropped or pad token adds
  zeros into slot 0. The experts are batched products
  (`einsum("ecd,edh->ech")` in the reference, which runs them outside
  any Pallas kernel), + b_in, tanh-GELU, then the output product; the
  combine adds each slot's output times its gate, slot by slot.

Expert parallelism (ep_size > 1, parallel/ep.py): the module holds its
E / ep local experts, and once `expert_group` is bound the [E, C, D]
buffer crosses the `expert` group with one all-to-all each way around
them. Tensor parallelism (tp_size > 1, parallel/tp.py): every expert's
hidden dimension is sharded, w_in and b_in column-parallel, w_out
row-parallel, and once `model_group` is bound the buffer passes
`replicate_gradient` and the partial outputs `reduce_activations`. The
router and the dispatch stay replicated (every shard routes the same
tokens the same way). The two axes do not compose with each other, as in
the JAX package. Capacity comes from this rank's own token count, so
under expert parallelism the drop pool is per (shard, expert).

The balance statistics are returned, not stored on the module:
imp [E] (the probabilities summed over valid tokens; differentiable),
load [E] (valid first choices an expert; a constant), z (the squared
router logsumexp summed over valid tokens) and nv (the valid-token
count). `collect_moe_stats` stacks a forward's layers, `moe_loss_terms`
puts them into an objective's sums and counts, and `compose_moe_losses`
makes aux = E * sum(load * imp) / (nL * nv^2) and z / (nL * nv): linear
in the sums at fixed counts, as every objective's composition is.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from .base import Linear
from .remat import bmm


def expert_capacity(num_tokens: int, num_experts: int, top_k: int,
                    capacity_factor: float) -> int:
    """Slots an expert: the even-routing load top_k * N / E scaled by the
    capacity factor."""
    return max(1, int(math.ceil(
        top_k * num_tokens * capacity_factor / num_experts)))


def top_k_lowest_first(probs, k: int):
    """(values, indices) [N, k] of each row's k largest entries in
    descending order, a tie going to the lower index (jax.lax.top_k's
    order)."""
    values, indices = torch.sort(probs, dim=-1, descending=True,
                                 stable=True)
    return values[:, :k], indices[:, :k]


class MoEFFN(nn.Module):
    """The FFN body of a TransformerLayer (the caller adds the residual and
    the dropout): forward(x [B, L, D], mask [B, L] or None) -> (y
    [B, L, D] in x's dtype, stats). Dropped and pad tokens give zeros.

    stats: {"imp" [E], "load" [E], "z" [], "nv" []} (module docstring),
    and for diagnostics "assign" [N, k] (each token's experts, first
    choice first) and "keep" [k, N] (whether each dispatch got its slot),
    both without gradients."""

    def __init__(self, d_model: int, d_hidden: int, num_experts: int,
                 top_k: int = 2, capacity_factor: float = 1.25,
                 ep_size: int = 1, tp_size: int = 1):
        super().__init__()
        if top_k > num_experts:
            raise ValueError(f"top_k={top_k} > E={num_experts}")
        if num_experts % ep_size:
            raise ValueError(f"num_experts={num_experts} not divisible by "
                             f"ep_size={ep_size}")
        if d_hidden % tp_size:
            raise ValueError(f"d_hidden={d_hidden} not divisible by "
                             f"tp_size={tp_size}")
        if ep_size > 1 and tp_size > 1:
            raise NotImplementedError(
                "expert x tensor parallelism is not composed: shard experts "
                "over 'expert' OR their hidden dim over 'model', not both "
                "(parallel/ep.py, parallel/tp.py scope notes)")
        self.num_experts, self.top_k = num_experts, top_k
        self.capacity_factor = capacity_factor
        self.expert_group = None    # the `expert` AxisGroup under ep_size > 1
        self.model_group = None     # the `model` AxisGroup under tp_size > 1
        e_loc, h_loc = num_experts // ep_size, d_hidden // tp_size
        self.router = Linear(d_model, num_experts, bias=False)
        # The JAX initialisation's N(0, 0.02) (models/init.py draws it
        # again from its generator).
        self.w_in = nn.Parameter(nn.init.normal_(
            torch.empty(e_loc, d_model, h_loc), std=0.02))
        self.b_in = nn.Parameter(torch.zeros(e_loc, h_loc))
        self.w_out = nn.Parameter(nn.init.normal_(
            torch.empty(e_loc, h_loc, d_model), std=0.02))

    def experts(self, buf):
        """[E, C, D] capacity buffer -> the expert FFNs' outputs [E, C, D],
        the fp32 masters cast to the buffer's dtype at use; across the
        `expert` group around the local experts, and through the f/g pair
        of the `model` group around the split hidden dimension."""
        if self.expert_group is not None:
            from ..parallel.ep import exchange_to_experts
            buf = exchange_to_experts(buf, self.expert_group)
        if self.model_group is not None:
            from ..parallel.tp import replicate_gradient
            buf = replicate_gradient(buf, self.model_group)
        dt = buf.dtype
        h = bmm(buf, self.w_in.to(dt)) + self.b_in.to(dt)[:, None, :]
        out = bmm(F.gelu(h, approximate="tanh"), self.w_out.to(dt))
        if self.model_group is not None:
            from ..parallel.tp import reduce_activations
            out = reduce_activations(out, self.model_group)
        if self.expert_group is not None:
            from ..parallel.ep import exchange_from_experts
            out = exchange_from_experts(out, self.expert_group)
        return out

    def forward(self, x, mask: Optional[torch.Tensor] = None):
        b, length, d = x.shape
        n, e, k = b * length, self.num_experts, self.top_k
        cap = expert_capacity(n, e, k, self.capacity_factor)
        x_flat = x.reshape(n, d)
        valid = (torch.ones(n, dtype=torch.bool, device=x.device)
                 if mask is None else mask.reshape(n))

        logits = self.router(x_flat.float())                     # [N, E]
        probs = torch.softmax(logits, dim=-1)
        gate_vals, assign = top_k_lowest_first(probs, k)         # [N, k]
        if k > 1:
            gate_vals = gate_vals / gate_vals.sum(
                -1, keepdim=True).clamp_min(1e-9)

        # Joint capacity positions, k-major: slot 0 of every token, then
        # slot 1, each in token order: each dispatch's count of earlier
        # dispatches to its expert. One flat scan over the expert-major
        # one-hot [E, kN], less each expert's offset (a scan along the
        # outer dim of [kN, E] runs one thread a column on CUDA: 16.8 ms
        # a call at kN = 98,304 on an NVIDIA H100 80GB HBM3 at 700 W).
        assign_kn = assign.t().reshape(k * n)
        valid_kn = valid.repeat(k)
        onehot = (F.one_hot(assign_kn, e) * valid_kn[:, None]).t()
        flat = torch.cumsum(onehot.reshape(-1), dim=0).view(e, k * n)
        pos = flat - F.pad(flat[:-1, -1], (1, 0))[:, None] - onehot
        pos_a = pos.gather(0, assign_kn[None, :])[0]
        keep = valid_kn & (pos_a < cap)
        dest = torch.where(keep, assign_kn * cap + pos_a, 0)

        dest_k, keep_k = dest.view(k, n), keep.view(k, n)
        buf = x.new_zeros(e * cap, d)
        for s in range(k):
            buf = buf.index_add(0, dest_k[s],
                                x_flat * keep_k[s].to(x.dtype)[:, None])
        out_buf = self.experts(buf.view(e, cap, d)).reshape(e * cap, d)

        # index_select, whose backward adds each row's gradient into its
        # slot (slot 0 takes the exact zeros of dropped and pad tokens
        # too); advanced indexing's sorts first: 1.3 ms a call at
        # N = 49,152 on an NVIDIA H100 80GB HBM3 at 700 W.
        y = x.new_zeros(n, d)
        gates = gate_vals.t()                                    # [k, N]
        for s in range(k):
            g = (gates[s] * keep_k[s]).to(x.dtype)[:, None]
            y = y + out_buf.index_select(0, dest_k[s]) * g

        vf = valid.float()
        stats = {
            "imp": (probs * vf[:, None]).sum(0),
            "load": (F.one_hot(assign[:, 0], e).float()
                     * vf[:, None]).sum(0),
            "z": (torch.logsumexp(logits, dim=-1).square() * vf).sum(),
            "nv": vf.sum(),
            "assign": assign.detach(), "keep": keep_k.detach()}
        return y.view(b, length, d), stats


def collect_moe_stats(per_layer: list) -> Optional[dict]:
    """A forward's per-layer statistics (in layer order) -> {"imp" [nL, E],
    "load" [nL, E], "z" (summed over layers), "nv" (the first layer's)},
    or None when the model has no MoE layer."""
    if not per_layer:
        return None
    return {"imp": torch.stack([s["imp"] for s in per_layer]),
            "load": torch.stack([s["load"] for s in per_layer]),
            "z": sum(s["z"] for s in per_layer),
            "nv": per_layer[0]["nv"]}


def moe_loss_terms(stats: dict, sums: dict, counts: dict) -> None:
    """Differentiable numerators into `sums`, constants into `counts`: the
    split that keeps compose_moe_losses linear in the sums."""
    sums["moe_imp_sum"] = stats["imp"]
    sums["moe_z_sum"] = stats["z"]
    counts["moe_load"] = stats["load"]
    counts["moe_nv"] = stats["nv"]


def compose_moe_losses(sums: dict, counts: dict, aux_weight: float,
                       z_weight: float):
    """(aux_weight * aux + z_weight * z, {"train_moe_aux", "train_moe_z"}):

    aux = mean over layers of E * sum_e (load_e / nv) * (imp_e / nv)
    z   = mean over layers of sum_n lse(logits_n)^2 / nv
    """
    imp = sums["moe_imp_sum"]                                  # [nL, E]
    n_layers, e = imp.shape
    nv = counts["moe_nv"].clamp_min(1.0)
    aux = e * (counts["moe_load"] * imp).sum() / (n_layers * nv * nv)
    z = sums["moe_z_sum"] / (n_layers * nv)
    return (aux_weight * aux + z_weight * z,
            {"train_moe_aux": aux, "train_moe_z": z})
