"""Pre-LN transformer layer (port of sparse_vae_tpu/models/transformer_layer.py):
self-attention, optional cross-attention (separate LayerNorms for the
queries and the context), then a 4x tanh-GELU FFN whose output projection
has no bias or, with num_experts > 1, a mixture-of-experts FFN
(models/moe.py). A learned-query layer (the Perceiver's) keeps no
residual around its attention: the query bank replaced x.
The FFN output's dropout (the reference's rate 0.1) applies only to a
forward called with deterministic=False and a generator: the Transformer
LM's training forward, as the JAX package's ARObjective runs it. The VAE
trains without it in both packages.

The token mask ([B, L], True = a real token) reaches the FFN on every
path, the decode steps, the chunk peek and the frontier window included:
an MoE FFN dispatches only real tokens, so [PAD] rows and guesses take no
expert slot. A forward given a `moe_stats` list appends the MoE FFN's
balance statistics to it; nothing is kept on the module.

Tensor parallelism (tp_size > 1, parallel/tp.py): the attention holds a
shard of the heads, ffn_in is column-parallel and ffn_out row-parallel
(bias-free, so one all-reduce closes it), and an MoE FFN splits each
expert's hidden dimension; `bind_model_group` hands them the `model`
group. Expert parallelism (ep_size > 1, parallel/ep.py): the MoE FFN
holds its local experts, `bind_expert_group` binds its exchange.

Sequence parallelism (parallel/sp.py): `bind_seq_group` hands the group to
the attention that reads the length-sharded document. With sp_cross_only
(the Perceiver's middle layers) that is the cross-attention alone, whose
queries, the latents, are the same on every rank; the self-attention then
runs on those replicated latents.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.attention import Attention
from .base import LAYER_NORM_EPS, LayerNorm, Linear, dropout
from .moe import MoEFFN
from .remat import checkpoint_layer

# The reference's dropout on the FFN output (transformer_layer.py).
DROPOUT_RATE = 0.1


class TransformerLayer(nn.Module):
    def __init__(self, d_model: int, num_heads: int, causal: bool = False,
                 sparse_self_attention: bool = False, window_size: int = 2,
                 block_size: int = 128, use_cross_attention: bool = False,
                 learned_queries: Optional[int] = None,
                 use_kernel: bool = True, sp_cross_only: bool = False,
                 num_experts: int = 0, moe_top_k: int = 2,
                 moe_capacity_factor: float = 1.25, tp_size: int = 1,
                 ep_size: int = 1):
        super().__init__()
        self.learned_queries = learned_queries
        self.dropout_rate = DROPOUT_RATE
        self.sp_cross_only = sp_cross_only
        self.model_group = None     # the `model` AxisGroup under tp_size > 1
        self.attention = Attention(d_model, num_heads, causal=causal,
                                   sparse=sparse_self_attention,
                                   window_size=window_size,
                                   block_size=block_size,
                                   learned_queries=learned_queries,
                                   use_kernel=use_kernel, tp_size=tp_size)
        self.is_moe = num_experts > 1
        if self.is_moe:
            self.moe = MoEFFN(d_model, 4 * d_model, num_experts, moe_top_k,
                              moe_capacity_factor, ep_size=ep_size,
                              tp_size=tp_size)
        else:
            if (4 * d_model) % tp_size:
                raise ValueError(f"d_hidden={4 * d_model} not divisible by "
                                 f"tp_size={tp_size}")
            self.ffn_in = Linear(d_model, 4 * d_model // tp_size)
            self.ffn_out = Linear(4 * d_model // tp_size, d_model,
                                  bias=False)
        self.attn_layer_norm = LayerNorm(d_model, eps=LAYER_NORM_EPS)
        self.ffn_layer_norm = LayerNorm(d_model, eps=LAYER_NORM_EPS)
        self.use_cross_attention = use_cross_attention
        # The rematerialisation policy (models/remat.py) when the model
        # sets grad_checkpointing; None keeps every activation.
        self.remat = None
        if use_cross_attention:
            self.cross_attention = Attention(d_model, num_heads,
                                             use_kernel=use_kernel,
                                             sp_replicated_q=sp_cross_only,
                                             tp_size=tp_size)
            self.cross_attn_layer_norm = LayerNorm(d_model,
                                                   eps=LAYER_NORM_EPS)
            self.context_layer_norm = LayerNorm(d_model, eps=LAYER_NORM_EPS)

    def bind_seq_group(self, group):
        """Bind the attention that reads the sharded document to `group`."""
        self.attention.seq_group = None if self.sp_cross_only else group
        if self.use_cross_attention:
            self.cross_attention.seq_group = (group if self.sp_cross_only
                                              else None)

    def bind_model_group(self, group):
        """Bind the f/g collectives of the attention, the cross-attention
        and the FFN to the `model` group."""
        self.model_group = group
        self.attention.model_group = group
        if self.use_cross_attention:
            self.cross_attention.model_group = group
        if self.is_moe:
            self.moe.model_group = group

    def bind_expert_group(self, group):
        """Bind the MoE FFN's exchange to the `expert` group."""
        if self.is_moe:
            self.moe.expert_group = group

    def _ffn(self, x, deterministic: bool = True, generator=None,
             mask=None, moe_stats: Optional[list] = None):
        y = self.ffn_layer_norm(x)
        if self.is_moe:
            y, stats = self.moe(y, mask)
            if moe_stats is not None:
                moe_stats.append(stats)
        elif self.model_group is not None:
            from ..parallel.tp import reduce_activations, replicate_gradient
            y = replicate_gradient(y, self.model_group)  # column-parallel in
            y = self.ffn_out(F.gelu(self.ffn_in(y), approximate="tanh"))
            y = reduce_activations(y, self.model_group)  # row-parallel close
        else:
            y = self.ffn_out(F.gelu(self.ffn_in(y), approximate="tanh"))
        if not deterministic:
            y = dropout(y, self.dropout_rate, generator)
        return x + y

    def forward(self, x, mask=None, return_kv: bool = False, context=None,
                context_mask=None, deterministic: bool = True,
                generator=None, moe_stats: Optional[list] = None):
        """x: [B, L, D]; mask: [B, L] key-padding mask (True = valid);
        context: [B, Lc, D] for cross-attention, with context_mask
        [B, Lc]. With return_kv also returns the attention's head-major
        (k, v). deterministic False: the FFN output's dropout, its mask
        drawn from `generator`. moe_stats: a list the MoE FFN's
        statistics are appended to. With a `remat` policy and gradients
        on, the layer is rematerialised (models/remat.py)."""
        if self.remat is not None and torch.is_grad_enabled():
            return checkpoint_layer(
                self._forward, self.remat, x, mask, context, context_mask,
                generator=generator, moe_stats=moe_stats,
                return_kv=return_kv, deterministic=deterministic)
        return self._forward(x, mask, context, context_mask,
                             return_kv=return_kv,
                             deterministic=deterministic,
                             generator=generator, moe_stats=moe_stats)

    def _forward(self, x, mask, context, context_mask, *,
                 return_kv: bool, deterministic: bool, generator,
                 moe_stats: Optional[list]):
        y = self.attention(self.attn_layer_norm(x), kv_mask=mask,
                           return_kv=return_kv)
        if return_kv:
            y, kv = y
        x = y if self.learned_queries else x + y
        if self.use_cross_attention and context is not None:
            ctx = self.context_layer_norm(context)
            x = x + self.cross_attention(self.cross_attn_layer_norm(x),
                                         kv_mask=context_mask, x_kv=ctx)
        x = self._ffn(x, deterministic, generator, mask, moe_stats)
        return (x, kv) if return_kv else x

    def decode(self, x_t, cache: dict, index: int, mask=None):
        """One-token step, every row at position `index` (int). mask
        [B, 1]: the rows that feed a real token (a finished row feeds
        [PAD] and must not take a live row's expert slot)."""
        y, cache = self.attention.decode(self.attn_layer_norm(x_t), cache,
                                         index)
        return self._ffn(x_t + y, mask=mask), cache

    def decode_rowwise(self, x_t, cache: dict, index, mask=None):
        """One-token step at PER-ROW positions index [B]; mask as
        `decode`'s."""
        y, cache = self.attention.decode_rowwise(self.attn_layer_norm(x_t),
                                                 cache, index)
        return self._ffn(x_t + y, mask=mask), cache

    def init_cache(self, batch_size: int, max_length: int, device=None,
                   dtype=None) -> dict:
        return self.attention.init_cache(batch_size, max_length, device,
                                         dtype)

    def decode_chunk(self, x, cache: dict, index: int, mask=None):
        """C-token speculative-verification peek at positions index ..
        index + C - 1 (no cache write): equals C sequential `decode` steps
        of a dense FFN. mask [B, C]: the real tokens. Returns (out
        [B, C, D], this layer's chunk (k, v))."""
        y, kv = self.attention.decode_chunk(self.attn_layer_norm(x), cache,
                                            index)
        return self._ffn(x + y, mask=mask), kv

    def commit_chunk(self, cache: dict, kv, index: int, m: int) -> dict:
        return self.attention.commit_chunk(cache, kv, index, m)

    def window_decode(self, x, cache: dict, start: int, mask=None):
        """The active window's pass of frontier decoding: the layer at
        absolute positions start .. start + W - 1 over the frozen prefix's
        window cache. mask [B, W]: the window's real tokens ([PAD]
        guesses take no expert slot). Returns (out [B, W, D], the
        window's (k, v))."""
        y, kv = self.attention.window_attend(self.attn_layer_norm(x), cache,
                                             start)
        return self._ffn(x + y, mask=mask), kv

    def init_window_cache(self, batch_size: int, device=None,
                          dtype=None) -> dict:
        return self.attention.init_window_cache(batch_size, device, dtype)
