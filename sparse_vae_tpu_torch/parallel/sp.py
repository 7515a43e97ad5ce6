"""Sequence (context) parallelism for the sparse long-document models
(port of sparse_vae_tpu/parallel/sp.py over a torch.distributed group).

The pg19 configuration trains on ONE document of up to 102,400 tokens per
micro-batch; at batch 1 only the length axis can scale. Every [B, L] batch
is sharded over the ranks of a `SeqGroup` (parallel/group.py), rank r
holding positions r*S..r*S+S-1, and only what the math needs crosses:

- decoder self-attention: each shard needs its left neighbour's trailing
  window - 1 blocks of K/V (one halo per layer, `halo_from_left`) plus the
  global [CLS] block 0 (a `sum_over_shards` broadcast from shard 0);
- the Perceiver's learned-query and cross-attention over the whole
  document: a distributed softmax (`seq_parallel_cross_attention`), local
  partials combined with one max and two sums over the group;
- the next-token labels: each shard's last label is its right
  neighbour's first token (`sp_shifted_labels`);
- per-ROW loss statistics (KL, row counts) are the same on every shard and
  count once, on shard 0 (parallel/spmd.py).

Adjoint convention: the train step sums GRADIENTS over the group, each
shard's backward carrying the partial gradient of its own loss terms. The
adjoint of a value that crosses shards is then the true adjoint of the
transfer: an all-reduce transposes to an all-reduce (`sum_over_shards`),
a shift to the right transposes to a shift to the left (`halo_from_left`).
Each is a torch.autograd.Function.

Ordering. Collectives pair up by the order in which ranks call them, and
autograd gives no order between two nodes that become ready together: two
same-shaped all-reduces (the [CLS] keys and values) were seen to pair
across ranks the wrong way round. So every backward collective of one
attention call lives in ONE autograd node (`exchange_kv` for the decoder,
one `sum_over_shards` of the packed numerator and denominator for the
distributed softmax), and the data dependencies between those nodes order
them the same on every rank. Every rank also keeps the same graph: the
branches that differ by rank select with tensors (torch.where) or stay
inside one node, so that each rank runs every node's backward.

`windowed_attention_ctx` is the blocked plain oracle of one shard's
decoder attention, and the path for shapes outside the kernel gate;
ops/sp_kernel.py holds the kernel path (K6).
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from .group import SeqGroup, all_reduce, shift

NEG_INF = -1e9


# -- collectives with pinned adjoints ------------------------------------------
class _SumOverShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, ct):
        return all_reduce(ct, ctx.group), None


def sum_over_shards(x, group: SeqGroup):
    """All-reduce whose output feeds different per-shard loss terms; the
    true adjoint sums the cotangents: all-reduce forward and backward."""
    return _SumOverShards.apply(x, group)


class _MaxOverShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group, dist.ReduceOp.MAX)

    @staticmethod
    def backward(ctx, ct):
        return torch.zeros_like(ct), None


def max_over_shards(x, group: SeqGroup):
    """All-reduce max with a zero adjoint: used only for the softmax's
    stabilising shift, which carries no gradient by shift invariance."""
    return _MaxOverShards.apply(x, group)


class _HaloFromLeft(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return shift(x, group, 1)

    @staticmethod
    def backward(ctx, ct):
        return shift(ct, ctx.group, -1), None


def halo_from_left(x, group: SeqGroup):
    """Each shard receives its LEFT neighbour's x (zeros on shard 0), the
    window-band halo. Adjoint: the cotangents travel back to the left."""
    return _HaloFromLeft.apply(x, group)


class _ExchangeKV(torch.autograd.Function):
    @staticmethod
    def forward(ctx, k, v, halo_rows, block_size, group):
        ctx.meta = (halo_rows, block_size, group)
        length = k.shape[2]
        tail = torch.stack([k[:, :, length - halo_rows:],
                            v[:, :, length - halo_rows:]])
        halo = shift(tail, group, 1) if halo_rows else tail
        head = torch.stack([k[:, :, :block_size], v[:, :, :block_size]])
        cls = all_reduce(head if group.rank == 0
                          else torch.zeros_like(head), group)
        return (torch.cat([halo[0], k], dim=2),
                torch.cat([halo[1], v], dim=2), cls[0], cls[1])

    @staticmethod
    def backward(ctx, dk_ext, dv_ext, dcls_k, dcls_v):
        halo_rows, block_size, group = ctx.meta
        dk = dk_ext[:, :, halo_rows:].clone()
        dv = dv_ext[:, :, halo_rows:].clone()
        length = dk.shape[2]
        if halo_rows:
            back = shift(torch.stack([dk_ext[:, :, :halo_rows],
                                       dv_ext[:, :, :halo_rows]]),
                          group, -1)
            dk[:, :, length - halo_rows:] += back[0]
            dv[:, :, length - halo_rows:] += back[1]
        dcls = all_reduce(torch.stack([dcls_k, dcls_v]), group)
        if group.rank == 0:
            dk[:, :, :block_size] += dcls[0]
            dv[:, :, :block_size] += dcls[1]
        return dk, dv, None, None, None


def exchange_kv(k, v, window_size: int, block_size: int, group: SeqGroup):
    """The K/V traffic of one decoder attention over a length shard, in one
    autograd node: (k_ext, v_ext, cls_k, cls_v) with k_ext = [left
    neighbour's trailing halo_blocks(window) blocks | k] (zeros on shard
    0) and cls_k = shard 0's block 0, the same on every rank. The adjoint:
    the halo's cotangent travels back to the left, and the [CLS]
    cotangents are summed over the shards (in fp32) into shard 0's block
    0. k, v: [B, H, S, D]."""
    return _ExchangeKV.apply(k, v, halo_blocks(window_size) * block_size,
                             block_size, group)


def sp_shifted_labels(token_ids, group: SeqGroup):
    """Next-token labels of a length shard: each shard's last column is
    its RIGHT neighbour's first token, the last shard's [PAD] = 0, as the
    unsharded end-padded shift gives. token_ids: [rows, S_local]."""
    nxt = shift(token_ids[:, :1], group, -1)
    return torch.cat([token_ids[:, 1:], nxt], dim=1)


# -- attention compute -----------------------------------------------------------
def halo_blocks(window_size: int) -> int:
    """Blocks of left-neighbour K/V a shard needs: the band of its first
    query block covers global blocks qb - window + 1 .. qb, the window - 1
    blocks before the shard."""
    return window_size - 1


def windowed_attention_ctx(q, k_ext, v_ext, cls_k, cls_v, start: int,
                           kv_mask_ext=None, cls_mask=None, *,
                           window_size: int, block_size: int):
    """Blocked causal sliding-window + [CLS] attention for one length shard.

    q: [B, H, S, D] at absolute positions start..start+S-1 (start a block
    multiple). k_ext/v_ext: [B, H, ctx+S, D] at positions start-ctx..
    start+S-1, ctx = halo_blocks(window_size) * block_size (the leading
    ctx rows are the left halo; rows at positions < 0 are masked by block
    validity). cls_k/cls_v: [B, H, block_size, D], the global block 0.
    kv_mask_ext: [B, ctx+S] bool key padding of k_ext; cls_mask:
    [B, block_size] of the [CLS] block.

    Equals the global sliding-window token mask restricted to this shard's
    query rows: query block qb attends key blocks qb-window+1..qb plus
    block 0, causal inside the diagonal block; the [CLS] slot counts only
    once block 0 has left the band (qb >= window). A query with no valid
    key averages its masked scores, as the reference's -1e9 fill does.
    """
    b, h, S, d = q.shape
    ws, bs = window_size, block_size
    hb = halo_blocks(ws)
    if S % bs:
        raise ValueError(f"shard length {S} is not a multiple of {bs}")
    nb = S // bs
    if k_ext.shape[2] != hb * bs + S:
        raise ValueError(f"k_ext holds {k_ext.shape[2]} keys, not "
                         f"{hb * bs} + {S}")
    dev = q.device
    kb = k_ext.reshape(b, h, nb + hb, bs, d)
    vb = v_ext.reshape(b, h, nb + hb, bs, d)
    # Local query block i sits at ext block i + hb; its band is ext blocks
    # i..i+ws-1 (global key blocks qb-ws+1..qb).
    band_idx = (torch.arange(nb, device=dev)[:, None]
                + torch.arange(ws, device=dev)[None, :]).reshape(-1)
    k_band = kb[:, :, band_idx].reshape(b, h, nb, ws, bs, d)
    v_band = vb[:, :, band_idx].reshape(b, h, nb, ws, bs, d)
    k_all = torch.cat([cls_k[:, :, None, None].expand(b, h, nb, 1, bs, d),
                       k_band], dim=3)                      # [b,h,nb,s,bs,d]
    v_all = torch.cat([cls_v[:, :, None, None].expand(b, h, nb, 1, bs, d),
                       v_band], dim=3)
    s = ws + 1
    scores = torch.einsum("bhnqd,bhnskd->bhnqsk",
                          q.reshape(b, h, nb, bs, d).float(),
                          k_all.float()) * d ** -0.5

    qb_global = start // bs + torch.arange(nb, device=dev)      # [nb]
    g = qb_global[:, None] + torch.arange(ws, device=dev)[None, :] - hb
    slot_ok = torch.cat([(qb_global >= ws)[:, None], g >= 0], dim=1)
    mask = slot_ok[:, None, :, None].expand(nb, bs, s, bs)
    # The causal triangle inside the diagonal slot (the last band slot).
    ar = torch.arange(bs, device=dev)
    tri = ar[None, :] <= ar[:, None]                            # [q, k]
    diag = torch.zeros(s, dtype=torch.bool, device=dev)
    diag[s - 1] = True
    mask = mask & torch.where(diag[None, None, :, None], tri[None, :, None, :],
                              True)
    full = mask[None, None]                                  # [1,1,nb,bs,s,bs]
    if kv_mask_ext is not None:
        pm_band = kv_mask_ext.reshape(b, nb + hb, bs)[:, band_idx].reshape(
            b, nb, ws, bs)
        pm_all = torch.cat([cls_mask[:, None, None].expand(b, nb, 1, bs),
                            pm_band], dim=2)                  # [b, nb, s, bs]
        full = full & pm_all[:, None, :, None, :, :]

    flat = scores.masked_fill(~full, NEG_INF).reshape(b, h, nb, bs, s * bs)
    weights = torch.softmax(flat, dim=-1).to(v_ext.dtype)
    out = torch.einsum("bhnqsk,bhnskd->bhnqd",
                       weights.reshape(b, h, nb, bs, s, bs), v_all)
    return out.reshape(b, h, S, d)


def seq_parallel_cross_attention(q, k, v, kv_mask, group: SeqGroup):
    """Attention of replicated queries over a length-sharded key axis (the
    Perceiver's learned-query and cross-attention over the whole
    document): local partials combined with one max (no gradient: the
    softmax is shift invariant) and two sums over the group.

    q: [B, H, Q, D], the same on every rank; k/v: [B, H, S_local, D];
    kv_mask: [B, S_local] bool or None. Returns [B, H, Q, D], the same on
    every rank."""
    scale = q.shape[-1] ** -0.5
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if kv_mask is not None:
        scores = scores.masked_fill(~kv_mask[:, None, None, :], NEG_INF)
    m = max_over_shards(scores.amax(dim=-1), group)             # [B, H, Q]
    e = torch.exp(scores - m[..., None])                        # fp32, <= 1
    # The numerator [B, H, Q, D] and the denominator [B, H, Q] summed in
    # one node (see "Ordering" above).
    both = sum_over_shards(
        torch.cat([torch.matmul(e.to(v.dtype), v).float(),
                   e.sum(dim=-1, keepdim=True)], dim=-1), group)
    num, den = both[..., :-1], both[..., -1:]
    return (num / den.clamp_min(1e-30)).to(v.dtype)


# -- module localisation -----------------------------------------------------------
def sp_localize(model, group: SeqGroup):
    """Bind `model` to `group` for a length-sharded batch: its hparams get
    sp_size = group.size, and the attention layers take the halo / [CLS]
    broadcast and distributed-softmax paths, the labels shift across
    shards. Parameters are untouched, so every rank holds the same model.
    A group of one rank leaves the model as it is."""
    if group.size <= 1:
        return model
    check_seq_parallel(model.hparams, type(model).__name__)
    model.bind_seq_group(group)
    return model


def sp_pad_multiple(hp, sp: int, pad_to_multiple_of: int = 512) -> int:
    """The row-length multiple of a batch sharded over `sp` ranks (the
    JAX package's Trainer): lcm(pad_to_multiple_of, sp x window x block),
    so that every length shard is a whole number of window bands."""
    need = (sp * getattr(hp, "attn_window_size", 1)
            * getattr(hp, "attn_block_size", 1))
    return math.lcm(pad_to_multiple_of, need)


def check_seq_parallel(hparams, model_name: str):
    """Raise the JAX package's ValueError where a model of `hparams`
    cannot shard its length axis: not a transformer family, or dense
    attention."""
    if not hasattr(hparams, "sp_size"):
        raise ValueError(
            f"{model_name} does not support sequence parallelism; "
            "only the transformer families shard the length axis")
    if not getattr(hparams, "sparse_self_attention", False):
        raise ValueError(
            "sequence parallelism requires the sparse sliding-window "
            "decoder (dense causal self-attention has no bounded halo); "
            "set sparse_self_attention=true")


def shard_length(x, group: SeqGroup, dim: int = 1):
    """This rank's slice of the length axis `dim` of a global tensor."""
    length = x.shape[dim]
    if length % group.size:
        raise ValueError(f"length {length} does not split over "
                         f"{group.size} shards")
    size = length // group.size
    return x.narrow(dim, group.rank * size, size)
