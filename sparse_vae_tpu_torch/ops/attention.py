"""Multi-head attention with the sliding-window masks and the decode caches
(port of sparse_vae_tpu/ops/attention.py, the parts the serving slice runs).

Ported: the masks, `dense_attention`, head split/merge, and `Attention`'s
projection (with the learned-query bank), full-sequence self- and
cross-attention (the blocked sparse path, its masked-dense fallback, the
dense causal path and the dense non-causal masked path the Perceiver
takes), the block-ring and dense decode caches with `decode` (one
position for every row), `_decode_ring` and `decode_rowwise`, plus
`row_cache_write` and `fill_cache_row`, the speculative-verification
chunk peek and commit (`decode_chunk`, `commit_chunk` and their
per-row forms), the frontier window (`init_window_cache`,
`window_attend`, `push_window_block`), the packed-layout branch
(Dh = 128: the projections feed K5/K5b without head-major copies), and the
sequence-parallel branch (`Attention._sp_call`, parallel/sp.py: the halo
and [CLS] broadcast into K6, or the distributed softmax of replicated
queries), and the tensor-parallel branch (`tp_size` > 1, parallel/tp.py:
a shard of the heads, the f/g collectives at entry and close), the two
composed on a data x seq x model mesh. The chunk
and window attentions are plain tensor code, as in the reference (XLA
there, no Pallas kernel).

Unlike the reference, whose arrays are immutable, the decode caches are
updated in place: a step writes one position per row instead of copying
every cache. A chunk peek writes nothing; a commit writes only the
accepted positions; a window push rolls the context band of the cache
its caller owns.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from ..models.base import Linear
from ..models.remat import keep_qkv, linear
from . import sp_kernel, swa_kernel
from .rotary import apply_rotary
from .sliding_window_attention import (SlidingWindowAttentionPackedFn,
                                       merge_heads, sliding_window_attention,
                                       split_heads)

NEG_INF = -1e9
# The JAX package's dense causal kernel gate: lq a multiple of this.
DENSE_KERNEL_MULTIPLE = 512


def row_cache_write(buf, idx, val):
    """Write val [B, H, Dh] into buf [B, H, L, Dh] at per-row position
    idx [B], in place. Rows whose idx is outside [0, L) are left as they
    are (the [CLS] store routes positions past block 0 to idx == L)."""
    length = buf.shape[2]
    rows = torch.arange(buf.shape[0], device=buf.device)
    ok = (idx >= 0) & (idx < length)
    pos = idx.clamp(0, length - 1)
    cur = buf[rows, :, pos]                                    # [B, H, Dh]
    buf[rows, :, pos] = torch.where(ok[:, None, None], val.to(buf.dtype),
                                    cur)
    return buf


def sliding_window_block_mask(num_q: int, num_k: int, block_size: int,
                              window_size: int, causal: bool = True,
                              include_cls: bool = True, q_offset: int = 0,
                              device=None):
    """[num_q, num_k] bool block mask (True = may attend): the band of
    `window_size` blocks (ending at the diagonal when causal, split
    ceil-left / floor-right otherwise) plus the [CLS] column."""
    qb = torch.arange(num_q, device=device) + q_offset
    kb = torch.arange(num_k, device=device)
    delta = qb[:, None] - kb[None, :]
    num_sides = 1 if causal else 2
    left = (window_size + num_sides - 1) // num_sides
    right = window_size - left
    mask = (delta >= -right) & (delta < left)
    if include_cls:
        mask = mask | (kb[None, :] == 0)
    if causal:
        mask = mask & (delta >= 0)
    return mask


def sliding_window_token_mask(q_len: int, k_len: int, block_size: int,
                              window_size: int, causal: bool = True,
                              include_cls: bool = True, device=None):
    """Token-level [q_len, k_len] expansion of the block mask, with the
    causal triangle inside diagonal blocks."""
    nq, nk = -(-q_len // block_size), -(-k_len // block_size)
    blocks = sliding_window_block_mask(nq, nk, block_size, window_size,
                                       causal, include_cls, device=device)
    mask = blocks.repeat_interleave(block_size, 0).repeat_interleave(
        block_size, 1)[:q_len, :k_len]
    if causal:
        qi = torch.arange(q_len, device=device)[:, None]
        ki = torch.arange(k_len, device=device)[None, :]
        mask = mask & (ki <= qi)
    return mask


def dense_attention(q, k, v, mask=None):
    """Masked scaled-dot-product attention. q: [B, H, Lq, D], k/v:
    [B, H, Lk, D]; mask broadcastable to [B, H, Lq, Lk], True = attend.
    Scores and softmax in fp32; weights cast to v's dtype for the value
    product."""
    scale = q.shape[-1] ** -0.5
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        scores = scores.masked_fill(~mask, NEG_INF)
    weights = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.matmul(weights, v)


class Attention(nn.Module):
    """Rotary multi-head attention, optionally sliding-window sparse.

    Rotary base: 2 * window_size * block_size on the sparse path, else
    max_length (10,000), as in the reference. With `learned_queries` = n a
    bank of n learned queries [1, n, D] (no rotary) replaces the projected
    queries, the Perceiver's pattern. use_kernel (the JAX package's
    use_pallas_kernel) lets the blocked sparse path take a kernel family,
    chosen by `swa_kernel.route`: the packed Function on the
    [B, L, H * Dh] projections (K5/K5b, or the generic pair of
    csrc/swa_generic.cu at another Dh % 128 == 0 or block), or the
    head-major one (K1/K2, or the generic pair); off, or outside the JAX
    package's gates, autograd differentiates the plain forward. Inside a
    gate beyond Dh 512, where no CUDA kernel takes the shape, the plain
    forward runs on the CPU and a CUDA input raises.

    Dense causal self-attention (sparse=False, causal, its own queries: the
    Transformer LM's runs and a Transformer-VAE built with
    sparse_self_attention=False, such as the dense-benchmark preset's)
    takes the JAX package's flash-attention gate: use_kernel, lq == lk and
    lq % 512 == 0. There the JAX package calls the JAX library's Pallas
    flash attention on the TPU; here the same function is a causal band of
    lq / 128 blocks of 128 without a [CLS] slot, which is dense causal
    attention with the key mask as per-row lengths (`_dense_route`): the
    dense causal pair of ops/causal_kernel.py at head-major Dh 64 and 128,
    the generic pair at the other widths (its launches count in
    `swa_kernel`'s dense counters at Dh 64 and 128). Outside that
    gate the masked dense path runs, as in JAX. At pad query positions the
    two paths differ, as JAX's two do: the losses mask those positions.

    Sequence parallelism: once `seq_group` is set (parallel.sp.sp_localize)
    the keys are this rank's slice of a length-sharded document and
    `_sp_call` runs instead. sp_replicated_q declares that the queries are
    the same on every rank (a cross-attention from the Perceiver's
    latents), which the distributed softmax needs.

    Tensor parallelism (tp_size > 1, the twin parallel.tp.tp_localize
    makes): q/k/v and the learned-query bank hold num_heads / tp_size
    heads (`d_model` is then the shard's width, `d_out` the model's), the
    output projection is row-parallel, and once `model_group` is bound the
    input passes `replicate_gradient` and the output projection's partial
    product `reduce_activations` before its replicated bias is added once.
    The packed layout is off, as in the JAX package (`_packed_ok`). Both
    groups bound (data x seq x model): the inputs pass
    `replicate_gradient` first, then `_sp_call` runs on the shard's heads.
    """

    def __init__(self, d_model: int, num_heads: int, causal: bool = False,
                 sparse: bool = False, window_size: int = 2,
                 block_size: int = 128, max_length: int = 10_000,
                 learned_queries: Optional[int] = None,
                 use_kernel: bool = True, sp_replicated_q: bool = False,
                 tp_size: int = 1):
        super().__init__()
        if d_model % num_heads:
            raise ValueError("d_model must be a multiple of num_heads")
        if num_heads % tp_size:
            raise ValueError(f"num_heads {num_heads} not divisible by "
                             f"tp_size {tp_size}")
        self.d_out, self.tp_size = d_model, tp_size
        d_model, num_heads = d_model // tp_size, num_heads // tp_size
        self.d_model, self.num_heads = d_model, num_heads
        self.causal, self.sparse = causal, sparse
        self.window_size, self.block_size = window_size, block_size
        self.max_length = max_length
        self.num_queries = learned_queries
        self.use_kernel = use_kernel
        self.sp_replicated_q = sp_replicated_q
        self.seq_group = None       # a parallel.group.SeqGroup when bound
        self.model_group = None     # the `model` AxisGroup under tp_size > 1
        if learned_queries:
            self.learned_queries = nn.Parameter(
                torch.randn(1, learned_queries, d_model))
        else:
            self.q_linear = Linear(self.d_out, d_model)
        self.k_linear = Linear(self.d_out, d_model)
        self.v_linear = Linear(self.d_out, d_model)
        self.output_linear = Linear(d_model, self.d_out)

    @property
    def rotary_base(self) -> float:
        if self.sparse:
            return float(2 * self.window_size * self.block_size)
        return float(self.max_length)

    def _project(self, x, pos_offset=0, x_kv=None, k_pos_offset=None):
        """Head-major rotary q, k and plain v [B, H, L, Dh]; queries from x
        (or the learned bank) at pos_offset, keys and values from x_kv
        (default x), the keys at k_pos_offset (default pos_offset)."""
        h, base = self.num_heads, self.rotary_base
        x_kv = x if x_kv is None else x_kv
        if self.num_queries:
            bank = self.learned_queries.to(x_kv.dtype)
            q = split_heads(bank.expand(x_kv.shape[0], -1, -1), h)
        else:
            q = apply_rotary(split_heads(self.q_linear(x), h), base,
                             pos_offset)
        k = apply_rotary(split_heads(self.k_linear(x_kv), h), base,
                         pos_offset if k_pos_offset is None
                         else k_pos_offset)
        v = split_heads(self.v_linear(x_kv), h)
        return q, k, v

    def _finalize(self, out_heads):
        """Merge heads and close the output projection."""
        return self._close(merge_heads(out_heads))

    def _close(self, merged):
        """The output projection; row-parallel under tensor parallelism:
        the shards' partial products summed over the model group, the
        replicated bias added once."""
        if self.model_group is None:
            return self.output_linear(merged)
        from ..parallel.tp import reduce_activations
        weight = self.output_linear.weight.to(merged.dtype)
        y = reduce_activations(linear(merged, weight), self.model_group)
        return y + self.output_linear.bias.to(merged.dtype)

    def _replicated_inputs(self, x, x_kv):
        """x and x_kv through `replicate_gradient` (once where they are the
        same tensor): replicated activations feeding column-parallel
        projections."""
        from ..parallel.tp import replicate_gradient
        group = self.model_group
        if x_kv is None or x_kv is x:
            return replicate_gradient(x, group), None
        return (replicate_gradient(x, group),
                replicate_gradient(x_kv, group))

    def _route(self, lq: int, lk: int) -> Optional[str]:
        """None for the dense masked path; "dense" or "dense_plain" for the
        dense causal gate (`_dense_route`); else the blocked sparse path's
        `swa_kernel.route` ("outside" with the kernels off)."""
        dense = self._dense_route(lq, lk)
        if dense is not None:
            return dense
        if not (self.sparse and not self.num_queries and lq == lk
                and lq % self.block_size == 0):
            return None
        if not self.use_kernel:
            return "outside"
        # The packed layout is single-shard only (the JAX package's
        # _packed_ok): under tensor parallelism the head-major families.
        return swa_kernel.route(self.d_model // self.num_heads,
                                self.block_size,
                                packed_ok=self.tp_size == 1)

    def _dense_route(self, lq: int, lk: int) -> Optional[str]:
        """The dense causal gate of the JAX package (ops/attention.py: its
        flash-attention branch): dense, causal, its own queries, kernels
        on, lq == lk and lq % DENSE_KERNEL_MULTIPLE == 0. Inside it
        "dense" (on the card the dense causal pair at head-major Dh 64 or
        128, or the generic pair at another Dh % 8 == 0 up to 512; on the
        CPU the band plain version), else "dense_plain" (the plain version on the CPU;
        `take_plain_route` raises on the card). None outside it."""
        if not (not self.sparse and self.causal and not self.num_queries
                and self.use_kernel and lq == lk
                and lq % DENSE_KERNEL_MULTIPLE == 0):
            return None
        head_dim = self.d_model // self.num_heads
        block = swa_kernel.BLOCK_SIZE
        return "dense" if swa_kernel.in_range(head_dim, block) \
            else "dense_plain"

    def _packed_forward(self, x, kv_mask, return_kv: bool):
        """Self-attention through K5/K5b (or the generic pair) on the
        packed [B, L, H * Dh] projections: rotary on a [B, L, H, Dh]
        view, as the reference rotates split heads and merges them back.
        Only with return_kv are head-major k/v made (the bulk-prefill
        cache seed)."""
        b, length, d = x.shape
        h, base = self.num_heads, self.rotary_base
        q = apply_rotary(self.q_linear(x).view(b, length, h, d // h), base,
                         seq_dim=-3)
        k = apply_rotary(self.k_linear(x).view(b, length, h, d // h), base,
                         seq_dim=-3)
        v = self.v_linear(x)
        if kv_mask is None:
            lengths = torch.full((b,), length, dtype=torch.int32,
                                 device=x.device)
        else:
            lengths = kv_mask.sum(dim=-1, dtype=torch.int32)
        q_p, k_p, v_p = keep_qkv(q.reshape(b, length, d),
                                 k.reshape(b, length, d), v)
        out = SlidingWindowAttentionPackedFn.apply(
            q_p, k_p, v_p, lengths, h, self.window_size, self.block_size,
            self.causal, True)
        y = self._close(out)
        if not return_kv:
            return y
        return y, (k.transpose(1, 2), split_heads(v, h))

    def _sp_call(self, x, kv_mask, x_kv):
        """Sequence-parallel attention (parallel/sp.py): the keys are this
        rank's slice of the length axis, at absolute positions
        rank * S .. rank * S + S - 1.

        - learned-query or replicated-query cross-attention: the
          replicated queries over the sharded keys, combined by the
          distributed softmax;
        - sparse causal self-attention: one halo of the left neighbour's
          trailing window - 1 blocks and one [CLS] block broadcast, then K6
          (ops/sp_kernel.py) or, outside its gate, the blocked plain
          `windowed_attention_ctx`; per-shard cost O(S * window), traffic
          independent of the document's length.
        """
        from ..parallel.sp import (exchange_kv, halo_blocks, halo_from_left,
                                   seq_parallel_cross_attention,
                                   sum_over_shards, windowed_attention_ctx)
        group = self.seq_group
        x_kv = x if x_kv is None else x_kv
        S = x_kv.shape[1]
        start = group.rank * S
        if self.num_queries or self.sp_replicated_q:
            q, k, v = self._project(x, x_kv=x_kv, k_pos_offset=start)
            out = seq_parallel_cross_attention(q, k, v, kv_mask, group)
            return self._finalize(out)

        if not (self.sparse and self.causal):
            raise ValueError(
                "sequence parallelism supports the sparse causal "
                "sliding-window decoder (window-band halo) and "
                "replicated-query cross/learned-query attention "
                "(sp_replicated_q); this configuration "
                f"(sparse={self.sparse}, causal={self.causal}) would sum "
                "partials of sharded queries")
        bs, ws = self.block_size, self.window_size
        ctx = halo_blocks(ws) * bs
        if S % bs:
            raise ValueError(f"shard length {S} not a multiple of the "
                             f"attention block size {bs}")
        if S < ws * bs:
            raise ValueError(
                f"shard length {S} must cover the window span ({ws} x {bs} "
                "tokens): one left-neighbour halo must suffice, and K6 "
                "assumes block 0 is behind every non-first shard's band; "
                "use fewer shards or a smaller window")
        head_dim = self.d_model // self.num_heads
        route = (sp_kernel.route(head_dim, bs) if self.use_kernel
                 else "outside")
        if route == "plain":
            swa_kernel.take_plain_route(x.device, head_dim, bs)
        q, k, v = self._project(x, pos_offset=start)
        # The halo (a window-1 band has none) and shard 0's block 0, in one
        # autograd node.
        k_ext, v_ext, cls_k, cls_v = exchange_kv(k, v, ws, bs, group)
        # The q/k/v save point after the exchange, as in JAX.
        q, k_ext, v_ext, cls_k, cls_v = keep_qkv(q, k_ext, v_ext, cls_k,
                                                 cls_v)
        kv_mask_ext = cls_mask = None
        if kv_mask is not None:   # integers: no gradient, no backward
            m = kv_mask.to(torch.int32)
            halo_m = (halo_from_left(m[:, -ctx:], group) if ctx
                      else m[:, :0])
            kv_mask_ext = torch.cat([halo_m, m], dim=1) > 0
            cls_mask = sum_over_shards(
                m[:, :bs] if group.rank == 0 else torch.zeros_like(
                    m[:, :bs]), group) > 0
        if route == "outside":
            out = windowed_attention_ctx(
                q, k_ext, v_ext, cls_k, cls_v, start, kv_mask_ext, cls_mask,
                window_size=ws, block_size=bs)
            return self._finalize(out)
        rows = q.shape[0]
        if kv_mask_ext is None:
            ext_len = torch.full((rows,), S if start == 0 else ctx + S,
                                 dtype=torch.int32, device=x.device)
            cls_len = torch.full((rows,), bs, dtype=torch.int32,
                                 device=x.device)
        else:
            ext_len = kv_mask_ext.sum(dim=1, dtype=torch.int32)
            cls_len = cls_mask.sum(dim=1, dtype=torch.int32)
        out = sp_kernel.sp_windowed_attention(
            q.contiguous(), k_ext, v_ext, cls_k, cls_v, start, ext_len,
            cls_len, ws, bs)
        return self._finalize(out)

    def forward(self, x, kv_mask=None, return_kv: bool = False,
                x_kv=None):
        """Full-sequence attention. x: [B, Lq, D] queries (ignored with
        learned queries); x_kv: [B, Lk, D] keys and values, default x;
        kv_mask: [B, Lk] bool (True = valid key). With return_kv, also
        returns the head-major rotary (k, v) — the bulk-prefill cache seed
        (fill_cache_row). Inside a rematerialised layer the q/k/v it
        reads are a save point (models/remat.py `keep_qkv`)."""
        if self.model_group is not None:
            x, x_kv = self._replicated_inputs(x, x_kv)
        if self.seq_group is not None:
            if return_kv:
                raise NotImplementedError("sequence-parallel attention "
                                          "returns no decode cache seed")
            return self._sp_call(x, kv_mask, x_kv)
        route = self._route(x.shape[1],
                            (x if x_kv is None else x_kv).shape[1])
        if route in ("packed", "packed_generic"):
            return self._packed_forward(x, kv_mask, return_kv)
        block = swa_kernel.BLOCK_SIZE   # the dense route's band block
        if route in ("plain", "dense_plain"):
            swa_kernel.take_plain_route(
                x.device, self.d_model // self.num_heads,
                block if route == "dense_plain" else self.block_size)
        q, k, v = self._project(x, x_kv=x_kv)
        q, k, v = keep_qkv(q, k, v)
        lq, lk = q.shape[2], k.shape[2]
        own_queries = not self.num_queries
        mask = None
        if route in ("dense", "dense_plain"):
            # Dense causal attention as a causal band of every block.
            out = sliding_window_attention(
                q.contiguous(), k.contiguous(), v.contiguous(), kv_mask,
                window_size=lq // block, block_size=block, causal=True,
                include_cls=False, dense=True)
        elif route is not None:
            out = sliding_window_attention(
                q.contiguous(), k.contiguous(), v.contiguous(), kv_mask,
                window_size=self.window_size, block_size=self.block_size,
                causal=self.causal,
                use_kernel=route in ("head_major", "generic"))
        else:
            if self.sparse and own_queries:
                mask = sliding_window_token_mask(
                    lq, lk, self.block_size, self.window_size,
                    self.causal, device=k.device)[None, None]
            elif self.causal and own_queries:
                mask = (torch.arange(lk, device=k.device)[None, :]
                        <= torch.arange(lq, device=k.device)[:, None]
                        )[None, None]
            if kv_mask is not None:
                pad = kv_mask[:, None, None, :]
                mask = pad if mask is None else (mask & pad)
            out = dense_attention(q, k, v, mask)
        y = self._finalize(out)
        return (y, (k, v)) if return_kv else y

    # -- incremental decoding ----------------------------------------------
    def init_cache(self, batch_size: int, max_length: int, device=None,
                   dtype=torch.float32) -> dict:
        """Decode-time KV cache: a block ring of `window_size` blocks plus a
        copy of the [CLS] block when sparse, the full [B, H, max_length,
        Dh] buffer when dense."""
        head_dim = self.d_model // self.num_heads
        if self.sparse:
            ring = (batch_size, self.num_heads,
                    self.window_size * self.block_size, head_dim)
            cls = (batch_size, self.num_heads, self.block_size, head_dim)
            return {name: torch.zeros(shape, dtype=dtype, device=device)
                    for name, shape in (("k_ring", ring), ("v_ring", ring),
                                        ("k_cls", cls), ("v_cls", cls))}
        shape = (batch_size, self.num_heads, max_length, head_dim)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}

    def _ring_valid(self, index):
        """[B, bs + ring] validity of [CLS store | ring] for per-row
        positions index [B]. Ring slot s holds block
        qb - ((qb % w - s) % w); an entry is attendable iff its absolute
        position is <= index and its block >= 0. The [CLS] store is read
        only once block 0 has left the ring band (qb >= w)."""
        bs, w = self.block_size, self.window_size
        ring_len = w * bs
        qb = index // bs                                           # [B]
        j = torch.arange(ring_len, device=index.device)
        slot, offs = j // bs, j % bs
        b_s = qb[:, None] - torch.remainder(
            torch.remainder(qb[:, None], w) - slot[None, :], w)
        pos = b_s * bs + offs[None, :]
        ring_valid = (pos <= index[:, None]) & (b_s >= 0)
        cls_valid = (qb >= w)[:, None].expand(index.shape[0], bs)
        return torch.cat([cls_valid, ring_valid], dim=1)

    def _decode_ring(self, q, k_t, v_t, cache: dict, index: int):
        """Sliding-window decode against the block-ring cache, every row
        at the same position `index` (int). Position index goes to ring
        offset index % (window * bs) and, while index < bs, to the [CLS]
        store. Equals the full-cache masked attention."""
        bs = self.block_size
        ring_idx = index % cache["k_ring"].shape[2]
        dt = cache["k_ring"].dtype
        cache["k_ring"][:, :, ring_idx] = k_t[:, :, 0].to(dt)
        cache["v_ring"][:, :, ring_idx] = v_t[:, :, 0].to(dt)
        if index < bs:
            cache["k_cls"][:, :, index] = k_t[:, :, 0].to(dt)
            cache["v_cls"][:, :, index] = v_t[:, :, 0].to(dt)
        rows = q.shape[0]
        valid = self._ring_valid(
            torch.full((rows,), index, dtype=torch.int64, device=q.device))
        k_all = torch.cat([cache["k_cls"], cache["k_ring"]], dim=2)
        v_all = torch.cat([cache["v_cls"], cache["v_ring"]], dim=2)
        out = dense_attention(q, k_all, v_all, valid[:, None, None, :])
        return self._finalize(out), cache

    def decode(self, x_t, cache: dict, index: int):
        """One-token attention (x_t: [B, 1, D]) at position `index` (int),
        every row at it: against the block-ring cache when sparse, else the
        dense cache, whose position `index` is written and whose positions
        <= index are attended."""
        q, k_t, v_t = self._project(x_t, index)
        if "k_ring" in cache:
            return self._decode_ring(q, k_t, v_t, cache, index)
        cache["k"][:, :, index] = k_t[:, :, 0].to(cache["k"].dtype)
        cache["v"][:, :, index] = v_t[:, :, 0].to(cache["v"].dtype)
        positions = torch.arange(cache["k"].shape[2], device=q.device)
        valid = positions <= index
        if self.sparse:
            qb, kb = index // self.block_size, positions // self.block_size
            valid = valid & ((kb > qb - self.window_size) | (kb == 0))
        out = dense_attention(q, cache["k"], cache["v"],
                              valid[None, None, None, :])
        return self._finalize(out), cache

    def decode_rowwise(self, x_t, cache: dict, index):
        """One-token attention with PER-ROW positions index [B] (int64):
        each row writes its new K/V at its own position and attends its
        own window. Per row this equals `decode` at that row's index."""
        q, k_t, v_t = self._project(x_t, index)
        k_new, v_new = k_t[:, :, 0], v_t[:, :, 0]
        if "k_ring" in cache:
            bs = self.block_size
            ring_idx = torch.remainder(index, cache["k_ring"].shape[2])
            row_cache_write(cache["k_ring"], ring_idx, k_new)
            row_cache_write(cache["v_ring"], ring_idx, v_new)
            cls_pos = torch.where(index < bs, index, bs)
            row_cache_write(cache["k_cls"], cls_pos, k_new)
            row_cache_write(cache["v_cls"], cls_pos, v_new)
            valid = self._ring_valid(index)
            k_all = torch.cat([cache["k_cls"], cache["k_ring"]], dim=2)
            v_all = torch.cat([cache["v_cls"], cache["v_ring"]], dim=2)
            out = dense_attention(q, k_all, v_all, valid[:, None, None, :])
            return self._finalize(out), cache

        row_cache_write(cache["k"], index, k_new)
        row_cache_write(cache["v"], index, v_new)
        positions = torch.arange(cache["k"].shape[2], device=index.device)
        valid = positions[None, :] <= index[:, None]
        if self.sparse:
            qb = index // self.block_size
            kb = positions // self.block_size
            valid = valid & ((kb[None, :] > (qb[:, None] - self.window_size))
                             | (kb[None, :] == 0))
        out = dense_attention(q, cache["k"], cache["v"],
                              valid[:, None, None, :])
        return self._finalize(out), cache

    # -- speculative verification: chunk peek and commit -------------------
    def _chunk_limit(self, c: int):
        """The chunk may not reach past the [CLS] store's lifetime: a query
        with qb >= w while block 0 is still being written would need the
        half-filled store. So c <= (w - 1) * bs + 1."""
        bs, w = self.block_size, self.window_size
        if c > (w - 1) * bs + 1:
            raise ValueError(f"a ring-cache chunk of {c} positions exceeds "
                             f"(window - 1) * block + 1 = {(w - 1) * bs + 1}")

    def _ring_chunk_valid(self, index, c: int):
        """[B, C, bs + ring] validity of [CLS store | ring] for chunks at
        per-row starts index [B], the cache committed through index - 1:
        the slot-to-block map of `_ring_valid` anchored at the last
        written block, each query's band from its own block."""
        bs, w = self.block_size, self.window_size
        ring_len = w * bs
        ci = torch.arange(c, device=index.device)
        qb = torch.div(index[:, None] + ci[None, :], bs,
                       rounding_mode="floor")                       # [B, C]
        qb_old = torch.div(index - 1, bs, rounding_mode="floor")    # [B]
        j = torch.arange(ring_len, device=index.device)
        slot, offs = j // bs, j % bs
        b_old = qb_old[:, None] - torch.remainder(
            torch.remainder(qb_old[:, None], w) - slot[None, :], w)
        pos_old = b_old * bs + offs[None, :]
        written = (pos_old <= (index - 1)[:, None]) & (b_old >= 0)
        ring_valid = written[:, None, :] & (b_old[:, None, :]
                                            > (qb[:, :, None] - w))
        cls_valid = (qb >= w)[:, :, None].expand(-1, -1, bs)
        return torch.cat([cls_valid, ring_valid], dim=2)

    def _dense_chunk_valid(self, index, c: int, length: int):
        """[B, C, length] validity of the committed dense cache for chunks
        at per-row starts index [B]: positions <= index - 1, in the band
        (and block 0) when sparse."""
        positions = torch.arange(length, device=index.device)
        valid = (positions[None, :] <= (index - 1)[:, None])[:, None, :]
        valid = valid.expand(-1, c, -1)
        if self.sparse:
            ci = torch.arange(c, device=index.device)
            qb = torch.div(index[:, None] + ci[None, :], self.block_size,
                           rounding_mode="floor")
            kb = positions // self.block_size
            valid = valid & ((kb[None, None, :] > (qb[:, :, None]
                                                   - self.window_size))
                             | (kb[None, None, :] == 0))
        return valid

    def _chunk_attend(self, x, cache: dict, index):
        """The chunk peek at per-row starts index [B] (int64): query i
        attends the committed cache and chunk keys j <= i."""
        c = x.shape[1]
        q, k_c, v_c = self._project(x, index)
        intra = torch.ones((c, c), dtype=torch.bool,
                           device=x.device).tril()[None].expand(
                               x.shape[0], -1, -1)
        if "k_ring" in cache:
            self._chunk_limit(c)
            old = self._ring_chunk_valid(index, c)
            keys = (cache["k_cls"], cache["k_ring"])
            values = (cache["v_cls"], cache["v_ring"])
        else:
            old = self._dense_chunk_valid(index, c, cache["k"].shape[2])
            keys, values = (cache["k"],), (cache["v"],)
        dt = keys[0].dtype
        k_all = torch.cat([*keys, k_c.to(dt)], dim=2)
        v_all = torch.cat([*values, v_c.to(dt)], dim=2)
        valid = torch.cat([old, intra], dim=2)
        out = dense_attention(q, k_all, v_all, valid[:, None])
        return self._finalize(out), (k_c, v_c)

    def decode_chunk(self, x, cache: dict, index: int):
        """C-token attention against the cache WITHOUT writing it: the
        speculative-verification peek. x: [B, C, D] at absolute positions
        index .. index + C - 1 (int index; the cache committed through
        index - 1). Equals C sequential `decode` calls; the caller commits
        the accepted prefix with `commit_chunk`. Returns (out [B, C, D],
        (k_c, v_c) [B, H, C, Dh])."""
        return self._chunk_attend(x, cache, torch.full(
            (x.shape[0],), index, dtype=torch.int64, device=x.device))

    def decode_chunk_rowwise(self, x, cache: dict, index):
        """`decode_chunk` at PER-ROW starts index [B] (int64): row r equals
        decode_chunk at index[r]. Commit with `commit_chunk_rowwise`."""
        return self._chunk_attend(x, cache, index)

    def commit_chunk(self, cache: dict, kv, index: int, m: int) -> dict:
        """Write the first m (0 <= m <= C) positions of a `decode_chunk`
        peek into the cache, in place: positions index .. index + m - 1
        become committed and the rejected tail is never written."""
        k_c, v_c = kv
        c = k_c.shape[2]
        m = min(m, c)
        if "k_ring" in cache:
            ring_len = cache["k_ring"].shape[2]
            if ring_len < c:
                raise ValueError(f"a chunk of {c} positions exceeds the "
                                 f"ring of {ring_len}")
            slots = torch.remainder(
                torch.arange(index, index + m, device=k_c.device), ring_len)
            dt = cache["k_ring"].dtype
            cache["k_ring"][:, :, slots] = k_c[:, :, :m].to(dt)
            cache["v_ring"][:, :, slots] = v_c[:, :, :m].to(dt)
            bs = cache["k_cls"].shape[2]
            n_cls = max(0, min(index + m, bs) - index)
            if n_cls:
                cache["k_cls"][:, :, index:index + n_cls] = \
                    k_c[:, :, :n_cls].to(dt)
                cache["v_cls"][:, :, index:index + n_cls] = \
                    v_c[:, :, :n_cls].to(dt)
            return cache
        dt = cache["k"].dtype
        cache["k"][:, :, index:index + m] = k_c[:, :, :m].to(dt)
        cache["v"][:, :, index:index + m] = v_c[:, :, :m].to(dt)
        return cache

    def commit_chunk_rowwise(self, cache: dict, kv, index, m) -> dict:
        """`commit_chunk` at PER-ROW starts index [B] and PER-ROW accepted
        lengths m [B], in place."""
        k_c, v_c = kv
        c = k_c.shape[2]
        ci = torch.arange(c, device=k_c.device)
        take = ci[None, :] < torch.clamp(m, max=c)[:, None]          # [B, C]
        pos = index[:, None] + ci[None, :]                           # [B, C]
        if "k_ring" in cache:
            ring_len = cache["k_ring"].shape[2]
            if ring_len < c:
                raise ValueError(f"a chunk of {c} positions exceeds the "
                                 f"ring of {ring_len}")
            bs = cache["k_cls"].shape[2]
            targets = (("k_ring", "v_ring", torch.remainder(pos, ring_len),
                        take),
                       ("k_cls", "v_cls", pos.clamp(max=bs - 1),
                        take & (pos < bs)))
        else:
            length = cache["k"].shape[2]
            targets = (("k", "v", pos.clamp(max=length - 1),
                        take & (pos < length)),)
        for k_name, v_name, where, ok in targets:
            for name, new in ((k_name, k_c), (v_name, v_c)):
                for i in range(c):
                    row_cache_write(cache[name],
                                    torch.where(ok[:, i], where[:, i],
                                                cache[name].shape[2]),
                                    new[:, :, i])
        return cache

    # -- frontier-window decoding (models/parallel_decode.py) --------------
    def init_window_cache(self, batch_size: int, device=None,
                          dtype=torch.float32) -> dict:
        """K/V stores of frontier-windowed decoding (sparse only): the
        [CLS] block and the `window_size`-block band of frozen context
        just left of the frontier. Which entries are valid follows from the
        frontier (`_window_mask`), so zeros suffice."""
        if not self.sparse:
            raise ValueError("frontier windowing needs the sparse band")
        head_dim = self.d_model // self.num_heads
        cls = (batch_size, self.num_heads, self.block_size, head_dim)
        ctx = (batch_size, self.num_heads,
               self.window_size * self.block_size, head_dim)
        return {name: torch.zeros(shape, dtype=dtype, device=device)
                for name, shape in (("cls_k", cls), ("cls_v", cls),
                                    ("ctx_k", ctx), ("ctx_v", ctx))}

    def _window_mask(self, start: int, num_q: int, device=None):
        """[num_q, bs + ctx + num_q] validity of [CLS store | context band |
        window] for queries at absolute positions start + i (start a block
        multiple): block qb attends blocks qb - window + 1 .. qb and block
        0, causal inside its own block, as the training mask."""
        bs, ws = self.block_size, self.window_size
        ctx_len = ws * bs
        q_abs = start + torch.arange(num_q, device=device)
        qb = q_abs // bs
        # The [CLS] store holds block 0 once it is frozen.
        cls_ok = torch.full((num_q, bs), start >= bs, dtype=torch.bool,
                            device=device)
        # Context slot j holds absolute position start - ctx_len + j: valid
        # where it exists, is not block 0 and lies in the query's band.
        ctx_abs = start - ctx_len + torch.arange(ctx_len, device=device)
        ctx_b = torch.div(ctx_abs, bs, rounding_mode="floor")
        ctx_ok = ((ctx_abs[None, :] >= 0) & (ctx_b[None, :] >= 1)
                  & (ctx_b[None, :] > qb[:, None] - ws))
        kb = qb
        win_ok = ((q_abs[None, :] <= q_abs[:, None])
                  & ((kb[None, :] > qb[:, None] - ws) | (kb[None, :] == 0)))
        return torch.cat([cls_ok, ctx_ok, win_ok], dim=1)

    def window_attend(self, x, cache: dict, start: int):
        """Attention of the active window x [B, W, D] at absolute positions
        start .. start + W - 1 over the frozen prefix's window cache and
        the window itself. Returns (out [B, W, D], the window's (k, v)),
        which the caller freezes block by block (`push_window_block`)."""
        q, k_w, v_w = self._project(x, start)
        dt = cache["ctx_k"].dtype
        k_all = torch.cat([cache["cls_k"], cache["ctx_k"], k_w.to(dt)],
                          dim=2)
        v_all = torch.cat([cache["cls_v"], cache["ctx_v"], v_w.to(dt)],
                          dim=2)
        mask = self._window_mask(start, x.shape[1], x.device)
        out = dense_attention(q, k_all, v_all, mask[None, None])
        return self._finalize(out), (k_w, v_w)

    @staticmethod
    def push_window_block(cache: dict, kv, start: int, block_size: int):
        """Freeze the window's leading block into the cache, in place: its
        K/V become the [CLS] store when it is block 0 (start < block_size),
        else enter the context band, rolled left one block."""
        k_w, v_w = kv
        for name, new in (("k", k_w), ("v", v_w)):
            block = new[:, :, :block_size].to(cache[f"ctx_{name}"].dtype)
            if start < block_size:
                cache[f"cls_{name}"].copy_(block)
                continue
            ctx = cache[f"ctx_{name}"]
            ctx[:, :, :-block_size] = ctx[:, :, block_size:].clone()
            ctx[:, :, -block_size:] = block
        return cache


def fill_cache_row(cache: dict, row: int, k, v, length: int) -> dict:
    """Write ONE row of a decode cache from full-prefix K/V, in place — the
    bulk-prefill primitive: equals `length` sequential decode writes of
    positions 0..length-1.

    k, v: [H, Lp, Dh] head-major rotary K/V of the prefix, Lp >= length;
    length: count of real positions. Pad positions never enter.
    """
    last = length - 1
    if "k_ring" in cache:
        ring_len = cache["k_ring"].shape[2]
        bs = cache["k_cls"].shape[2]
        dt = cache["k_ring"].dtype
        o = torch.arange(ring_len, device=k.device)
        # Final occupant of ring offset o after writes 0..last: the largest
        # pos <= last with pos % ring_len == o (none when pos < 0).
        pos_o = last - torch.remainder(last - o, ring_len)
        sel = pos_o.clamp(0, k.shape[1] - 1)
        ring_ok = (pos_o >= 0)[None, :, None]
        cache["k_ring"][row] = torch.where(ring_ok, k[:, sel], 0).to(dt)
        cache["v_ring"][row] = torch.where(ring_ok, v[:, sel], 0).to(dt)
        c = torch.arange(bs, device=k.device)
        cls_ok = (c <= last)[None, :, None]
        csel = c.clamp(0, k.shape[1] - 1)
        cache["k_cls"][row] = torch.where(cls_ok, k[:, csel], 0).to(dt)
        cache["v_cls"][row] = torch.where(cls_ok, v[:, csel], 0).to(dt)
        return cache
    lp = min(k.shape[1], cache["k"].shape[2])
    cache["k"][row, :, :lp] = k[:, :lp].to(cache["k"].dtype)
    cache["v"][row, :, :lp] = v[:, :lp].to(cache["v"].dtype)
    return cache
