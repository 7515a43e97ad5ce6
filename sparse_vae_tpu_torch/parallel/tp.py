"""Tensor parallelism over the `model` axis (port of
sparse_vae_tpu/parallel/tp.py).

Megatron-style: attention heads, the FFN inner dimension, the Perceiver's
learned-query banks and each expert's hidden dimension are sharded over
the ranks of a `model` AxisGroup (parallel/group.py); activations stay
replicated over `model` (sharded over `data`), and one all-reduce a block
closes the partial sums. The kernels run untouched on per-shard shapes
(num_heads / tp_size heads a rank).

The collective pair (the classic f/g), each a torch.autograd.Function:
- `reduce_activations` (f): all-reduce forward, identity backward. It
  closes a row-parallel product whose output cotangent is replicated.
- `replicate_gradient` (g): identity forward, all-reduce backward. It
  marks a replicated activation that feeds column-parallel layers, whose
  weight slices each give a partial input cotangent.

With tied weights and the chunked loss (`shards_vocab`), the tied
embedding and its output bias are sharded over the vocabulary too:
`vocab_parallel_embed` looks rows up on the shard that owns them (one
all-reduce), and `tied_vocab_parallel_nll` is the Megatron
vocab-parallel cross-entropy: each shard's [N, V / m] logits slice, a max
and a sum of exponentials over the shards, the label logit from the shard
that owns it; its backward sums only dg over the shards, the table's and
the bias's gradients stay local. (The JAX package computes this loss in
XLA, outside its fused CE kernel; here in torch products.)

Parameter layout (`param_specs`, by state-dict name; each entry the dim
the leaf is cut on):
- column-parallel, cut on the output features: q/k/v_linear and ffn_in
  (weight dim 0, bias dim 0), the learned-query bank (dim 2), the MoE
  w_in (dim 2) and b_in (dim 1);
- row-parallel, cut on the input features: output_linear and ffn_out
  (weight dim 1; output_linear's bias is replicated and added once), the
  MoE w_out (dim 1);
- with `shards_vocab`: the tied input_embedding (dim 0) and output_bias
  (dim 0);
- everything else (LayerNorms, the head, the router, the VAE's latent
  parts): replicated.
`shard_state` cuts a full state dict into one rank's shard and
`gather_state` joins the shards back into the full one. `tp_localize`
makes a model's per-shard twin: hparams with tp_size set, every
parameter at its local shape, the model group bound.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from .group import AxisGroup, all_gather, all_reduce

_COLUMN_PARALLEL = ("q_linear", "k_linear", "v_linear", "ffn_in")
_ROW_PARALLEL = ("output_linear", "ffn_out")
_MOE_HIDDEN = {"w_in": 2, "b_in": 1, "w_out": 1}


# -- the f/g pair -------------------------------------------------------------------
class _ReduceActivations(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, ct):
        return ct, None


def reduce_activations(x, group: AxisGroup):
    """f: all-reduce partial activations forward; identity backward."""
    return _ReduceActivations.apply(x, group)


class _ReplicateGradient(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, ct):
        return all_reduce(ct, ctx.group), None


def replicate_gradient(x, group: AxisGroup):
    """g: identity forward; all-reduce the cotangent backward."""
    return _ReplicateGradient.apply(x, group)


# -- the vocabulary split -----------------------------------------------------------
def shards_vocab(hparams, tp_size: int) -> bool:
    """Whether the tensor-parallel twin also shards the tied embedding and
    head over the vocabulary: tied weights (logits = h @ E^T), the chunked
    loss (full [.., V] logits never exist, so per-shard softmax statistics
    can replace them) and a vocabulary that splits evenly."""
    if tp_size <= 1 or not hasattr(hparams, "tie_embedding_weights"):
        return False
    d_emb = getattr(hparams, "d_embedding", None) or hparams.d_model
    return (hparams.tie_embedding_weights
            and d_emb == hparams.d_model
            and getattr(hparams, "loss_chunk_size", 0) > 0
            and hparams.vocab_size % tp_size == 0)


def _vocab_slice(ids, rows: int, group: AxisGroup):
    """(ids local to this shard, their row in the shard's table)."""
    off = group.rank * rows
    local = (ids >= off) & (ids < off + rows)
    return local, (ids - off).clamp(0, rows - 1)


def vocab_parallel_embed(table, ids, group: AxisGroup):
    """Embedding lookup with the table [V / m, D] sharded over the
    vocabulary: each shard gives its rows (zeros elsewhere), and
    `reduce_activations` assembles [..., D]. Backward: each shard's
    gradient covers its own rows, with no collective (the cotangent is
    replicated); the rows accumulate through the embedding's own
    backward, in a fixed order, as nn.Embedding's do."""
    local, row = _vocab_slice(ids, table.shape[0], group)
    rows = torch.where(local[..., None], F.embedding(row, table), 0.0)
    return reduce_activations(rows, group)


def _shard_logits(g, table, bias):
    """fp32 [N, V / m]: products of g and the table, accumulated in fp32,
    plus the bias."""
    return g.float() @ table.float().t() + bias.float()[None, :]


class _TiedVocabParallelNLL(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, table, bias, labels, group):
        s = _shard_logits(g, table, bias)
        m = all_reduce(s.amax(dim=-1), group, dist.ReduceOp.MAX)
        local, col = _vocab_slice(labels, table.shape[0], group)
        lab = torch.where(local, s.gather(1, col[:, None])[:, 0], 0.0)
        both = all_reduce(torch.stack(
            [torch.exp(s - m[:, None]).sum(dim=-1), lab]), group)
        lse = m + torch.log(both[0])
        ctx.save_for_backward(g, table, bias, labels, lse)
        ctx.group = group
        return lse - both[1]

    @staticmethod
    def backward(ctx, dnll):
        g, table, bias, labels, lse = ctx.saved_tensors
        rows = table.shape[0]
        off = ctx.group.rank * rows
        s = _shard_logits(g, table, bias)
        hit = (torch.arange(rows, device=s.device)[None, :] + off
               == labels[:, None])
        dl = (torch.exp(s - lse[:, None]) - hit.float()) * dnll[:, None]
        dg = all_reduce(dl.to(table.dtype) @ table, ctx.group)
        dtable = dl.to(g.dtype).t() @ g
        return (dg.to(g.dtype), dtable.to(table.dtype),
                dl.sum(dim=0).to(bias.dtype), None, None)


def tied_vocab_parallel_nll(g, table, bias, labels, group: AxisGroup):
    """Per-token NLL [N] of logits = g @ table^T + bias with table [V / m,
    D] and bias [V / m] sharded over the vocabulary (the Megatron
    vocab-parallel cross-entropy). g: [N, D]; labels: [N]."""
    return _TiedVocabParallelNLL.apply(g, table, bias, labels, group)


# -- the parameter layout -------------------------------------------------------------
def param_dim(name: str, shard_vocab: bool) -> Optional[int]:
    """The dim a model-sharded leaf is cut on, or None for a replicated
    one (module docstring)."""
    parts = name.split(".")
    leaf = parts[-1]
    parent = parts[-2] if len(parts) > 1 else ""
    if leaf == "learned_queries":
        return 2
    if parent in _COLUMN_PARALLEL:
        return 0
    if parent in _ROW_PARALLEL and leaf == "weight":
        return 1
    if parent == "moe" and leaf in _MOE_HIDDEN:
        return _MOE_HIDDEN[leaf]
    if shard_vocab and name in ("input_embedding.weight", "output_bias"):
        return 0
    return None


def param_specs(model, shard_vocab: bool) -> Dict[str, int]:
    """{parameter name: the dim it is cut on} of the model-sharded
    parameters of `model` (whose names are a full model's)."""
    specs = {}
    for name, _ in model.named_parameters():
        dim = param_dim(name, shard_vocab)
        if dim is not None:
            specs[name] = dim
    return specs


def shard_state(state: dict, specs: Dict[str, int], coord: int,
                size: int) -> dict:
    """A full state dict cut to the shard `coord` of `size` along each
    sharded leaf's dim; replicated leaves as they are."""
    out = {}
    for name, v in state.items():
        dim = specs.get(name)
        if dim is None:
            out[name] = v
            continue
        if v.shape[dim] % size:
            raise ValueError(f"{name}: dim {dim} of {tuple(v.shape)} does "
                             f"not split over {size} shards")
        width = v.shape[dim] // size
        out[name] = v.narrow(dim, coord * width, width).clone()
    return out


def gather_state(state: dict, specs: Dict[str, int],
                 group: AxisGroup) -> dict:
    """The full state dict from every shard's: each sharded leaf gathered
    over `group` along its dim (every member of the group calls this with
    the same names in the same order)."""
    return {name: (all_gather(v.detach(), group, specs[name])
                   if name in specs else v.detach().clone())
            for name, v in state.items()}


def sharded_global_norm(tensors, sharded, group: AxisGroup):
    """The global l2 norm, in fp32, of tensors partly sharded over
    `group` (`sharded[i]` True where tensors[i] is a shard): the sharded
    squares are summed over the group, the replicated ones counted once.
    Exact: the norm of the full tree, the same on every rank."""
    rep = torch.zeros((), dtype=torch.float32, device=group.device)
    part = torch.zeros((), dtype=torch.float32, device=group.device)
    for t, is_shard in zip(tensors, sharded):
        sq = t.float().square().sum()
        if is_shard:
            part = part + sq
        else:
            rep = rep + sq
    return torch.sqrt(rep + all_reduce(part, group))


def localized_twin(model, hparams, state: dict):
    """A new model of `model`'s class at `hparams` on its device, holding
    `state`, in its form (parameter dtype, compute dtype, mode, grads)."""
    dtype = next(model.parameters()).dtype
    with torch.device("meta"):
        twin = type(model)(hparams)
    twin = twin.to_empty(device=model.device).to(dtype)
    twin.load_state_dict(state, strict=True)
    twin.compute_dtype = model.compute_dtype
    twin.train(model.training)
    twin.requires_grad_(any(p.requires_grad for p in model.parameters()))
    return twin


def tp_localize(model, group: AxisGroup):
    """The per-shard twin of a transformer model over the `model` group:
    hparams with tp_size = group.size, each parameter this rank's slice of
    `model`'s, the f/g collectives bound to `group`. The caller's model is
    not changed (it stays the full one)."""
    hp = model.hparams
    if not hasattr(hp, "tp_size"):
        raise ValueError(
            f"{type(model).__name__} does not support tensor parallelism "
            "(model axis > 1); LSTM families are data-parallel only")
    if group.size <= 1:
        return model
    specs = param_specs(model, shards_vocab(hp, group.size))
    state = shard_state(model.state_dict(), specs, group.rank, group.size)
    twin = localized_twin(model, dataclasses.replace(hp,
                                                     tp_size=group.size),
                          state)
    twin.bind_model_group(group)
    return twin
