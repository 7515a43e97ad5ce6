"""Decoder-only causal transformer language model (port of
sparse_vae_tpu/models/transformer_lm.py): `embed` with the input dropout,
`pre_logits`, the tied `project`, `sequence_nll`, `sequence_ll_rows`,
`shifted_labels` / `labels_for`, `forward_hidden` (with the head-major
rotary K/V of every layer for a bulk prefill), the full forward
(`__call__`), `init_caches`, the decode steps `decode_step` (every
row at one position) and `decode_step_rowwise` (per-row positions, the
continuous-batching step), the lockstep sampling loops `sample` and
`sample_resumable` (models/generation.py), the speculative-verification
chunk `decode_chunk` / `commit_chunk`, the draft interface
`draft_propose` / `draft_init_state`, the frontier window
`init_window_caches` / `window_hidden`, and the parallel and speculative
generators `frontier_generate`, `speculative_generate`,
`spec_draft_generate` and `parallel_generate`
(models/parallel_decode.py, models/spec_decode.py). The Transformer-VAE
builds on it.

Configurations: the input embedding at d_embedding with its projection
to d_model where the two differ (`embedding_projection`); the output
tied to the input table (`tie_embedding_weights` and d_embedding ==
d_model, with `output_bias`) or an untied `output_embedding` (a Linear to
V with its bias), whose loss takes the chunked projection outside the
fused tied CE, as the JAX package's does; decoder cross-attention to a
context (`cross_attention`: `forward_hidden(..., context_ids=)`, the
context embedded by its own `context_embedding` table or, with
separate_context_embedding off, by `embed`), dense non-causal attention
(`dense_attention`) as JAX's XLA path; dense or mixture-of-experts FFNs
(num_experts > 1, models/moe.py), sparse (sliding-window)
or dense causal self-attention (ops/attention.py routes the dense one
through K1/K2 inside the JAX package's flash-attention gate), one device
or, with sparse attention, a length axis sharded over a `seq` group
(`bind_seq_group`, through parallel.sp.sp_localize). Tensor and
expert parallelism build a per-shard twin (parallel.tp.tp_localize,
parallel.ep.ep_localize: hparams with tp_size or ep_size > 1, then
`bind_model_group` / `bind_expert_group`); under tensor parallelism with
tied weights and the chunked loss (`shard_vocab`) the embedding and the
output bias hold V / tp_size rows, `embed` goes through
parallel.tp.vocab_parallel_embed and the loss through the vocab-parallel
cross-entropy (`_vocab_parallel_rows`); full logits (`project`) then
raise.
Every step, peek and window pass hands the MoE FFN the mask of real
tokens (token != 0), so finished rows and [PAD] guesses take no expert
slot; the training forwards append each layer's balance statistics to a
`moe_stats` list when given one (training/objectives.py).
The model computes in `compute_dtype` (default: its parameters' dtype);
models/base.py states the rule.

Under `grad_checkpointing` every decoder layer is rematerialised under
the named `remat_policy` (`checkpoint_policy`, models/remat.py): the
training forwards keep what the policy names and run the rest again in
the backward, with the same values. An unknown policy name raises even
with grad_checkpointing off, as in JAX.

Sampling takes an int seed: the decode noise comes from a generator on
the model's device seeded from (seed, DECODE_STREAM), and the
Transformer-VAE's prior z from a CPU generator seeded from (seed,
Z_STREAM) (`generation.decode_generator`, `generation.prior_z`), as the
JAX package splits its key into a z key and a decode key. The parallel
and speculative generators key their noise by block, chunk or pass
(`generation.KeyedNoise` under (seed, DECODE_STREAM)), or take a noise
source as `noise=`.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import ce_kernel
from ..ops.ce_kernel import FusedTiedCrossEntropy
from ..ops.cross_entropy import chunked_nll_rows
from .base import (LAYER_NORM_EPS, LanguageModelHparams, LayerNorm, Linear,
                   dropout)
from .remat import checkpoint_policy
from .generation import (DecodeState, KeyedNoise, SamplingParams,
                         decode_generator, decode_loop, final_output,
                         init_decode_state, prev_tokens)
from .parallel_decode import (frontier_jacobi_decode,
                              frontier_speculative_decode, jacobi_decode,
                              push_window_blocks)
from .spec_decode import chunk_speculative_decode
from .transformer_layer import TransformerLayer


@dataclass
class TransformerHparams(LanguageModelHparams):
    d_embedding: Optional[int] = None   # None => d_model
    d_model: int = 512
    num_heads: int = 8
    num_layers: int = 6
    # Read by the Transformer LM family; the VAE trains without dropout
    # in both packages.
    input_dropout: float = 0.0
    tie_embedding_weights: bool = True
    cross_attention: bool = False
    # Rematerialise every decoder layer under remat_policy
    # (`checkpoint_policy`): memory for time, the same values.
    grad_checkpointing: bool = False
    separate_context_embedding: bool = True
    attn_window_size: int = 2           # in attn_block_size blocks
    attn_block_size: int = 128
    sparse_self_attention: bool = True
    loss_chunk_size: int = 0            # > 0: chunked projection + CE
    use_pallas_kernel: bool = True      # here: the port's CUDA kernels
    precision: str = "fp32"
    remat_policy: str = "full"
    tp_size: int = 1
    sp_size: int = 1                    # set by parallel.sp.sp_localize
    num_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 1e-2
    moe_zloss_weight: float = 1e-3
    ep_size: int = 1


class DraftStack:
    """The draft's states after each step of `draft_propose`, without
    copies of the caches, which its steps wrote in place: `select(j)`
    rewinds them to the state after step j (index + j + 1 consumed
    positions). A dense cache rewinds by index alone: a later step at
    position p writes p and attends positions <= p, so the over-proposed
    entries are masked, then overwritten. A ring cache cannot: a step at p
    overwrote the slot of p - ring, which a later query may need, so the
    slots the steps write are saved before them and given back."""

    def __init__(self, caches: list, index: int, steps: int):
        self.caches, self.index = caches, index
        self.saved = []
        for cache in caches:
            if "k_ring" not in cache:
                self.saved.append(None)
                continue
            ring_len = cache["k_ring"].shape[2]
            if steps > ring_len:
                raise ValueError(f"{steps} draft steps exceed the ring of "
                                 f"{ring_len} positions")
            slots = torch.remainder(torch.arange(
                index, index + steps, device=cache["k_ring"].device),
                ring_len)
            n_cls = max(0, min(steps, cache["k_cls"].shape[2] - index))
            self.saved.append((slots, n_cls, {
                name: cache[name][:, :, slots].clone()
                for name in ("k_ring", "v_ring")}, {
                name: cache[name][:, :, index:index + n_cls].clone()
                for name in ("k_cls", "v_cls")}))

    def select(self, j: int):
        """(caches, index + j + 1): the steps after step j undone."""
        lo = j + 1
        for cache, saved in zip(self.caches, self.saved):
            if saved is None:
                continue
            slots, n_cls, ring, cls = saved
            for name, old in ring.items():
                cache[name][:, :, slots[lo:]] = old[:, :, lo:]
            for name, old in cls.items():
                cache[name][:, :, self.index + lo:self.index + n_cls] = \
                    old[:, :, lo:]
        return self.caches, self.index + lo


class TransformerLanguageModel(nn.Module):
    def __init__(self, hparams: TransformerHparams):
        super().__init__()
        remat = checkpoint_policy(hparams.remat_policy)
        if hparams.sp_size != 1:
            raise ValueError(
                "build the model with sp_size 1 and bind it to a seq group "
                "with parallel.sp.sp_localize, which sets sp_size")
        hp = self.hparams = hparams
        self.seq_group = None       # a parallel.group.SeqGroup when bound
        self.model_group = None     # the `model` AxisGroup under tp_size > 1
        # None: compute in the parameters' dtype. Training sets bf16 over
        # fp32 master parameters (checkpoint.load_run(train=True)).
        self.compute_dtype: Optional[torch.dtype] = None
        vocab_local = (hp.vocab_size // hp.tp_size if self.shard_vocab
                       else hp.vocab_size)
        d_embedding = hp.d_embedding or hp.d_model
        self.input_embedding = nn.Embedding(vocab_local, d_embedding)
        self.embedding_projection = (
            Linear(d_embedding, hp.d_model) if d_embedding != hp.d_model
            else None)
        self.decoder_layers = nn.ModuleList([
            TransformerLayer(hp.d_model, hp.num_heads, causal=True,
                             sparse_self_attention=hp.sparse_self_attention,
                             window_size=hp.attn_window_size,
                             block_size=hp.attn_block_size,
                             use_cross_attention=hp.cross_attention,
                             use_kernel=hp.use_pallas_kernel,
                             num_experts=hp.num_experts,
                             moe_top_k=hp.moe_top_k,
                             moe_capacity_factor=hp.moe_capacity_factor,
                             tp_size=hp.tp_size, ep_size=hp.ep_size)
            for _ in range(hp.num_layers)])
        if hp.grad_checkpointing:
            for layer in self.decoder_layers:
                layer.remat = remat
        self.context_embedding = (
            nn.Embedding(hp.vocab_size, hp.d_model)
            if hp.cross_attention and hp.separate_context_embedding
            else None)
        self.head_dense = Linear(hp.d_model, hp.d_model)
        self.head_norm = LayerNorm(hp.d_model, eps=LAYER_NORM_EPS)
        self.tie_output = (hp.tie_embedding_weights
                           and d_embedding == hp.d_model)
        if self.tie_output:
            self.output_bias = nn.Parameter(torch.zeros(vocab_local))
        else:
            self.output_embedding = Linear(hp.d_model, hp.vocab_size)

    @property
    def shard_vocab(self) -> bool:
        """The tied embedding and head sharded over the vocabulary (the
        tensor-parallel twin only; parallel.tp.shards_vocab)."""
        from ..parallel.tp import shards_vocab
        return shards_vocab(self.hparams, self.hparams.tp_size)

    def bind_model_group(self, group):
        """Bind the tensor-parallel collectives of every layer, the
        vocab-parallel embedding and the loss to the `model` group."""
        self.model_group = group
        for layer in self.decoder_layers:
            layer.bind_model_group(group)

    def bind_expert_group(self, group):
        """Bind every MoE layer's exchange to the `expert` group."""
        for layer in self.decoder_layers:
            layer.bind_expert_group(group)

    def bind_seq_group(self, group):
        """Shard the length axis over `group` (parallel/sp.py): the decoder
        attention takes the halo / [CLS] path and the labels shift across
        shards. The parameters do not change. Mixture-of-experts layers
        route and fill their capacity per length shard."""
        self.seq_group = group
        self.hparams = replace(self.hparams, sp_size=group.size)
        for layer in self.decoder_layers:
            layer.bind_seq_group(group)

    @property
    def dtype(self) -> torch.dtype:
        return self.compute_dtype or self.input_embedding.weight.dtype

    @property
    def device(self) -> torch.device:
        return self.input_embedding.weight.device

    def embed(self, token_ids, deterministic: bool = True,
              generator: Optional[torch.Generator] = None):
        """Token embeddings in the compute dtype; with deterministic False
        the input dropout (hparams.input_dropout, base.dropout) draws its
        mask from `generator`."""
        if self.shard_vocab:
            from ..parallel.tp import vocab_parallel_embed
            x = vocab_parallel_embed(self.input_embedding.weight, token_ids,
                                     self.model_group).to(self.dtype)
        else:
            x = self.input_embedding(token_ids).to(self.dtype)
        if self.embedding_projection is not None:
            x = self.embedding_projection(x)
        if deterministic:
            return x
        return dropout(x, self.hparams.input_dropout, generator)

    def embed_context(self, context_ids, deterministic: bool = True,
                      generator: Optional[torch.Generator] = None):
        """[B, Lc] context tokens -> [B, Lc, D] for the cross-attention:
        the context's own table or, without one, `embed` (its projection
        and input dropout included)."""
        if self.context_embedding is not None:
            return self.context_embedding(context_ids).to(self.dtype)
        return self.embed(context_ids, deterministic, generator)

    def table(self):
        """The output table [V, D] in the compute dtype: the input
        embedding when tied, else the untied head's weight."""
        if not self.tie_output:
            return self.output_embedding.weight.to(self.dtype)
        return self.input_embedding.weight.to(self.dtype)

    def pre_logits(self, h):
        """The head before the vocab projection: Dense -> GELU -> LN."""
        return self.head_norm(F.gelu(self.head_dense(h), approximate="tanh"))

    def project(self, h):
        """Head + output projection, [..., D] -> fp32 [..., V]. Tied, the
        product rounds to the compute dtype before the fp32 bias is added,
        as the reference's bf16 dot plus fp32 bias does; untied, the
        output Linear adds its bias in the compute dtype, as JAX's Dense."""
        if self.shard_vocab:
            raise NotImplementedError(
                "full [.., V] logits are never materialized under "
                "vocab-parallel TP; use sequence_nll / sequence_ll_rows "
                "(the chunked paths the objectives already select)")
        if not self.tie_output:
            return self.output_embedding(self.pre_logits(h)).float()
        logits = F.linear(self.pre_logits(h), self.table())
        return logits.float() + self.output_bias.float()

    def _nll_rows(self, hidden, labels):
        """(per-row NLL sums [B], token_count) over non-pad labels without
        [B, L, V] logits. hidden: [B, L', D]; labels: [B, L'] (0 = pad).

        Where `ce_kernel.route` gives "kernel" (use_pallas_kernel, the
        reference's gate V % 1024 == 0, and a kernel width, D in
        ce_kernel.D_MODELS): flatten,
        the head on [T, D], then the fused tied CE (K3/K3b on the card,
        their plain versions on the CPU). Otherwise the chunked projection
        + CE; inside the gate at another width that runs on the CPU only
        (`ce_kernel.take_plain_route`)."""
        hp = self.hparams
        if self.shard_vocab:
            return self._vocab_parallel_rows(hidden, labels)
        route = (ce_kernel.route(self.tie_output, hp.vocab_size,
                                 hp.d_model)
                 if hp.use_pallas_kernel else "outside")
        if route == "kernel":
            b, length, d = hidden.shape
            g = self.pre_logits(hidden.reshape(b * length, d))
            flat = labels.reshape(-1)
            nll = FusedTiedCrossEntropy.apply(
                g.contiguous(), self.table(), self.output_bias.float(),
                flat)
            mask = (flat != 0).float()
            return (nll * mask).reshape(b, length).sum(-1), mask.sum()
        if route == "plain":
            ce_kernel.take_plain_route(hidden.device, hp.d_model)
        return chunked_nll_rows(hidden, self.project, labels,
                                hp.loss_chunk_size or 2048)

    def _vocab_parallel_rows(self, hidden, labels):
        """`_nll_rows` under vocab-parallel TP: the length in chunks of
        loss_chunk_size (the last one short), each chunk's head on
        [B * chunk, D] and parallel.tp.tied_vocab_parallel_nll over this
        shard's V / tp_size rows of the table."""
        from ..parallel.tp import tied_vocab_parallel_nll
        b, length, d = hidden.shape
        cs = min(self.hparams.loss_chunk_size or 2048, length)
        table, bias = self.table(), self.output_bias.float()
        rows = hidden.new_zeros(b, dtype=torch.float32)
        count = hidden.new_zeros((), dtype=torch.float32)
        for lo in range(0, length, cs):
            h_c, lab = hidden[:, lo:lo + cs], labels[:, lo:lo + cs]
            n = h_c.shape[1]
            g = self.pre_logits(h_c.reshape(b * n, d))
            nll = tied_vocab_parallel_nll(g.contiguous(), table, bias,
                                          lab.reshape(-1), self.model_group)
            mask = (lab != 0).float()
            rows = rows + (nll.reshape(b, n) * mask).sum(-1)
            count = count + mask.sum()
        return rows, count

    def sequence_nll(self, hidden, labels):
        """(nll_sum, token_count) over non-pad labels without [B, L, V]
        logits (`_nll_rows` summed)."""
        rows, count = self._nll_rows(hidden, labels)
        return rows.sum(), count

    def sequence_ll_rows(self, hidden, labels):
        """Per-row summed log p(labels | hidden) over non-pad labels, [B]
        fp32 (the per-document statistic of the IWAE bound)."""
        return -self._nll_rows(hidden, labels)[0]

    @staticmethod
    def shifted_labels(token_ids):
        """Next-token labels aligned with the full-length hidden states:
        position t's label is token t+1, with [PAD] = 0 at the last
        position."""
        return F.pad(token_ids[:, 1:], (0, 1))

    def labels_for(self, token_ids):
        """Next-token labels for this module's layout: the end-padded
        shift on one device; under sequence parallelism each shard's last
        label is its right neighbour's first token."""
        if self.seq_group is not None:
            from ..parallel.sp import sp_shifted_labels
            return sp_shifted_labels(token_ids, self.seq_group)
        return self.shifted_labels(token_ids)

    def init_caches(self, batch_size: int, max_length: int) -> list:
        """Each layer's decode cache: the block ring when sparse, the
        dense [B, H, max_length, Dh] buffers otherwise."""
        return [layer.init_cache(batch_size, max_length, self.device,
                                 self.dtype)
                for layer in self.decoder_layers]

    # -- the Transformer LM's own forwards ---------------------------------
    def forward_hidden(self, token_ids, deterministic: bool = True,
                       generator: Optional[torch.Generator] = None,
                       return_kv: bool = False,
                       moe_stats: Optional[list] = None,
                       context_ids=None):
        """The decoder stack's output [B, L, D] before the head (the
        chunked-loss entry point). token_ids: [B, L] (0 = pad, the key
        mask); deterministic False applies the input dropout and each
        layer's FFN dropout, their masks drawn from `generator` in that
        order. With return_kv also each layer's head-major rotary (k, v),
        the bulk-prefill cache seed. moe_stats: a list each MoE layer's
        balance statistics are appended to, in layer order. context_ids:
        [B, Lc] context tokens every layer cross-attends to (0 = pad;
        cross_attention only)."""
        x = self.embed(token_ids, deterministic, generator)
        mask = token_ids != 0
        context = context_mask = None
        if context_ids is not None:
            if not self.hparams.cross_attention:
                raise ValueError("context requires cross_attention=True")
            context = self.embed_context(context_ids, deterministic,
                                         generator)
            context_mask = context_ids != 0
        kvs = []
        for layer in self.decoder_layers:
            out = layer(x, mask, return_kv=return_kv, context=context,
                        context_mask=context_mask,
                        deterministic=deterministic, generator=generator,
                        moe_stats=moe_stats)
            if return_kv:
                x, kv = out
                kvs.append(kv)
            else:
                x = out
        return (x, kvs) if return_kv else x

    def forward(self, token_ids, deterministic: bool = True,
                generator: Optional[torch.Generator] = None,
                moe_stats: Optional[list] = None, context_ids=None):
        """Logits [B, L, V] fp32 of the teacher-forced forward."""
        return self.project(self.forward_hidden(
            token_ids, deterministic, generator, moe_stats=moe_stats,
            context_ids=context_ids))

    def decode_step(self, token, caches: list, index: int):
        """One decode step, every row at position `index` (int): token
        [B] -> (fp32 logits [B, V], caches). Caches update in place."""
        x = self.embed(token[:, None])
        mask = (token != 0)[:, None]
        for layer, cache in zip(self.decoder_layers, caches):
            x, _ = layer.decode(x, cache, index, mask)
        return self.project(x[:, 0]), caches

    def decode_step_rowwise(self, token, caches: list, index):
        """One decode step at PER-ROW positions index [B] (the
        continuous-batching step, serving.py): token [B] -> (fp32 logits
        [B, V], caches). Caches update in place."""
        x = self.embed(token[:, None])
        mask = (token != 0)[:, None]
        for layer, cache in zip(self.decoder_layers, caches):
            x, _ = layer.decode_rowwise(x, cache, index, mask)
        return self.project(x[:, 0]), caches

    # -- sampling -----------------------------------------------------------
    def _lockstep_logits(self, state: DecodeState, caches: list):
        """decode_loop's logits_fn: the step at the state's last token."""
        return self.decode_step(prev_tokens(state), caches, state.index - 1)

    @torch.no_grad()
    def sample(self, seed: int, max_length: int, batch_size: int = 1,
               sampling: SamplingParams = SamplingParams(),
               start_token: int = 1, end_token: int = 2,
               fused_select: bool = True):
        """AR sampling from [CLS] through the lockstep loop: tokens
        [batch_size, max_length - 1] without the start token; finished
        rows are [PAD] after their end token. Nucleus-only params select
        through K4 (one read of the [B, V] logits a step);
        fused_select=False takes the top_p_filter bisection instead, the
        JAX package's unfused path."""
        state, _ = self.sample_resumable(seed, max_length, batch_size,
                                         sampling, start_token, end_token,
                                         fused_select=fused_select)
        return final_output(state)

    @torch.no_grad()
    def sample_resumable(self, seed: int, max_length: int,
                         batch_size: int = 1,
                         sampling: SamplingParams = SamplingParams(),
                         start_token: int = 1, end_token: int = 2,
                         state: Optional[DecodeState] = None,
                         caches: Optional[list] = None,
                         max_steps: Optional[int] = None,
                         fused_select: bool = True):
        """Bounded-slice sampling: at most max_steps positions this call;
        pass the returned (state, caches) back in to go on (seed is read
        only when state is None). Slices give the one-shot result."""
        if state is None:
            state = init_decode_state(
                batch_size, max_length, start_token,
                decode_generator(seed, self.device))
        if caches is None:
            caches = self.init_caches(batch_size, max_length)
        return decode_loop(state, self._lockstep_logits, caches, sampling,
                           end_token, max_steps=max_steps,
                           fused_select=fused_select)


    # -- speculative verification and the draft interface ------------------
    def decode_chunk(self, tokens, caches: list, index: int):
        """C-token speculative-verification peek: tokens [B, C] at absolute
        positions index .. index + C - 1 (caches committed through
        index - 1). Returns (fp32 logits [B, C, V], kvs) without writing
        the caches; row i decides position index + i + 1, as C sequential
        decode steps would. kvs feed `commit_chunk`."""
        x = self.embed(tokens)
        kvs = []
        for layer, cache in zip(self.decoder_layers, caches):
            x, kv = layer.decode_chunk(x, cache, index, tokens != 0)
            kvs.append(kv)
        return self.project(x), kvs

    def commit_chunk(self, caches: list, kvs, index: int, m: int) -> list:
        """Commit the first m positions of a `decode_chunk` peek, in place
        (rejected drafts are never written)."""
        return [layer.commit_chunk(cache, kv, index, m)
                for layer, cache, kv in zip(self.decoder_layers, caches,
                                            kvs)]

    def draft_init_state(self, batch_size: int, max_length: int):
        """The draft's (caches, index) before its first proposal."""
        return self.init_caches(batch_size, max_length), 0

    @torch.no_grad()
    def draft_propose(self, state, last_token, noise, k: int,
                      temperature: float = 1.0):
        """Draft k tokens as the cheap model of speculative decoding:
        k + 1 decode steps from state = (caches, index) (consumed through
        index - 1), the first on last_token [B]. Step i samples
        argmax(log_softmax(logits / temperature) + noise.gumbel(i, ...)),
        the draft's raw distribution q. The caches are written in place.
        Returns (drafts [B, k], q_logp [B, k, V] fp32, a `DraftStack` for
        `spec_decode.draft_select`)."""
        caches, index = state
        stack = DraftStack(caches, index, k + 1)
        tok, toks, logps = last_token, [], []
        for i in range(k + 1):
            logits, caches = self.decode_step(tok, caches, index + i)
            logp = torch.log_softmax(logits.float() / temperature, dim=-1)
            tok = torch.argmax(logp + noise.gumbel(i, logp.shape).to(
                logp.device), dim=-1)
            toks.append(tok)
            logps.append(logp)
        return (torch.stack(toks[:k], dim=1), torch.stack(logps[:k], dim=1),
                stack)

    # -- frontier-windowed and full-document parallel decoding -------------
    def init_window_caches(self, batch_size: int) -> list:
        return [layer.init_window_cache(batch_size, self.device, self.dtype)
                for layer in self.decoder_layers]

    def window_hidden(self, win_tokens, caches: list, start: int):
        """The active window's decoder pass: tokens [B, W] at absolute
        positions start .. -> (hidden [B, W, D], each layer's window
        (k, v))."""
        return self._window_pass(win_tokens, caches, start, None)

    def _window_pass(self, win_tokens, caches: list, start: int, z_inputs):
        """The window's decoder stack; z_inputs (the VAE's) gives each
        layer's z projection for absolute position 0."""
        x = self.embed(win_tokens)
        kvs = []
        for i, (layer, cache) in enumerate(zip(self.decoder_layers, caches)):
            if z_inputs is not None and start == 0:
                x = torch.cat([z_inputs(i, x), x[:, 1:]], dim=1)
            x, kv = layer.window_decode(x, cache, start, win_tokens != 0)
            kvs.append(kv)
        return x, kvs

    def _noise(self, seed: int, noise):
        return KeyedNoise(seed, self.device) if noise is None else noise

    def _push(self):
        bs = self.hparams.attn_block_size
        return lambda caches, kvs, f: push_window_blocks(caches, kvs, f, bs)

    def _require_sparse(self, name: str):
        if not self.hparams.sparse_self_attention:
            raise ValueError(f"{name} requires the sparse sliding-window "
                             "attention configuration")

    def _frontier(self, hidden_fn, seed, length, batch_size, sampling,
                  start_token, end_token, window_tokens, max_iters,
                  fused_select, draft_ngram, noise):
        self._require_sparse("frontier_generate")
        tokens, iters = frontier_jacobi_decode(
            hidden_fn, self.project, self._push(),
            self.init_window_caches(batch_size), batch_size, length,
            self._noise(seed, noise), sampling, start_token, end_token,
            window_tokens, self.hparams.attn_block_size, max_iters,
            fused_select, draft_ngram, self.device)
        return tokens[:, 1:], iters

    def _speculative(self, hidden_fn, seed, length, batch_size, sampling,
                     start_token, end_token, window_tokens, max_iters,
                     draft_ngram, noise):
        self._require_sparse("speculative_generate")
        tokens, iters = frontier_speculative_decode(
            hidden_fn, self.project, self._push(),
            self.init_window_caches(batch_size), batch_size, length,
            self._noise(seed, noise), sampling, start_token, end_token,
            window_tokens, self.hparams.attn_block_size, max_iters,
            draft_ngram, self.device)
        return tokens[:, 1:], iters

    def _spec_draft(self, chunk_fn, seed, length, draft_propose, draft_state,
                    sampling, start_token, end_token, draft_k, max_iters,
                    noise):
        tokens, iters, accepted = chunk_speculative_decode(
            chunk_fn, self.commit_chunk,
            self.init_caches(1, length + draft_k + 2), draft_propose,
            draft_state, length, self._noise(seed, noise), sampling,
            start_token, end_token, draft_k, max_iters, self.device)
        return tokens[:, 1:], iters, accepted

    def _jacobi(self, hidden_fn, seed, length, batch_size, sampling,
                start_token, end_token, max_iters, chunk_size, init_tokens,
                fused_select, noise):
        tokens, iters = jacobi_decode(
            hidden_fn, self.project, batch_size, length,
            self._noise(seed, noise), sampling, start_token, end_token,
            max_iters, chunk_size, init_tokens, fused_select, self.device)
        return tokens[:, 1:], iters

    @torch.no_grad()
    def frontier_generate(self, seed: int, length: int, batch_size: int = 1,
                          sampling: SamplingParams = SamplingParams(),
                          start_token: int = 1, end_token: int = 2,
                          window_tokens: int = 512,
                          max_iters: Optional[int] = None,
                          fused_select: bool = False, draft_ngram: int = 0,
                          noise=None):
        """Frontier-windowed Jacobi decoding
        (parallel_decode.frontier_jacobi_decode): a pass costs one window
        whatever the document's length; draft_ngram > 0 drafts the
        window's tail by suffix matching; fused_select selects sampled
        nucleus tokens through K4. Sparse models only. Returns (tokens
        [B, length - 1] without the start token, passes)."""
        return self._frontier(self.window_hidden, seed, length, batch_size,
                              sampling, start_token, end_token,
                              window_tokens, max_iters, fused_select,
                              draft_ngram, noise)

    @torch.no_grad()
    def speculative_generate(self, seed: int, length: int,
                             batch_size: int = 1,
                             sampling: SamplingParams = SamplingParams(),
                             start_token: int = 1, end_token: int = 2,
                             window_tokens: int = 512,
                             max_iters: Optional[int] = None,
                             draft_ngram: int = 3, noise=None):
        """Frontier speculative sampling
        (parallel_decode.frontier_speculative_decode): an exact sample of
        the AR sampling distribution, the greedy trajectory at temperature
        0. Sparse models only. Returns (tokens [B, length - 1], passes)."""
        return self._speculative(self.window_hidden, seed, length,
                                 batch_size, sampling, start_token,
                                 end_token, window_tokens, max_iters,
                                 draft_ngram, noise)

    @torch.no_grad()
    def spec_draft_generate(self, seed: int, length: int, draft_propose,
                            draft_state,
                            sampling: SamplingParams = SamplingParams(),
                            start_token: int = 1, end_token: int = 2,
                            draft_k: int = 8,
                            max_iters: Optional[int] = None, noise=None):
        """Draft-model speculative sampling (spec_decode.py): another model
        proposes draft_k tokens a pass through draft_propose(state, last,
        noise) from draft_state (written in place: give each call a fresh
        one), and this model verifies them in one chunk against its decode
        cache. Batch 1. Returns (tokens [1, length - 1], passes, accepted
        draft tokens)."""
        return self._spec_draft(self.decode_chunk, seed, length,
                                draft_propose, draft_state, sampling,
                                start_token, end_token, draft_k, max_iters,
                                noise)

    @torch.no_grad()
    def parallel_generate(self, seed: int, length: int, batch_size: int = 1,
                          sampling: SamplingParams = SamplingParams(),
                          start_token: int = 1, end_token: int = 2,
                          max_iters: Optional[int] = None,
                          chunk_size: int = 2048, init_tokens=None,
                          fused_select: bool = False, noise=None):
        """Full-document Jacobi decoding (parallel_decode.jacobi_decode):
        every iteration one teacher-forcing forward. init_tokens
        ([B, length] with the start token) resumes an earlier iterate.
        Returns (tokens [B, length - 1], iterations)."""
        return self._jacobi(self.forward_hidden, seed, length, batch_size,
                            sampling, start_token, end_token, max_iters,
                            chunk_size, init_tokens, fused_select, noise)
