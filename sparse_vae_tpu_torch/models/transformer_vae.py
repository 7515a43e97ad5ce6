"""The flagship Transformer-VAE (port of
sparse_vae_tpu/models/transformer_vae.py): the Perceiver encoder over the
shared input embedding, the ConditionalGaussian posterior, the per-layer z
projections, `reconstruct_hidden`, `reconstruct_ll`, the training
forwards (`__call__`, `forward_chunked_nll`), the decode steps
`decode_step_z` (every row at one position) and `decode_step_z_rowwise`,
the lockstep sampling loops `sample` and `sample_resumable`, the
speculative-verification chunk `decode_chunk_z`, the frontier window
`window_hidden_z`, and the four parallel and speculative generators
from z (`frontier_generate`, `speculative_generate`,
`spec_draft_generate`, `parallel_generate`).

z replaces position 0 ([CLS]) of every decoder layer's input. The training
forwards take the posterior noise eps (z = loc + scale * eps) or a
torch.Generator to draw it from, and a `moe_stats` list for a decoder
with mixture-of-experts FFNs (the encoder's stay dense). The decode
steps, the chunk peek and the window pass mask [PAD] tokens out of the
experts' capacity as the Transformer LM's do; the row-wise step counts a
row at position 0 as real (it feeds its z projection).

Under tensor parallelism (`bind_model_group`, parallel/tp.py) the encoder
and the decoder hold their shards of the heads and FFNs; the z
projections and the posterior stay replicated.

Under sequence parallelism (`bind_seq_group`) absolute position 0 lives
on shard 0 only: z replaces it there, and the other shards see z through
the [CLS] block broadcast of the decoder attention, which also carries its
gradient back. eps must be the same on every rank.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn as nn

from .base import Linear
from .conditional_gaussian import ConditionalGaussian
from .generation import (DecodeState, SamplingParams, decode_generator,
                         decode_loop, final_output, init_decode_state,
                         prev_tokens, prior_z)
from .perceiver import Perceiver
from .transformer_lm import TransformerHparams, TransformerLanguageModel


@dataclass
class TransformerVAEHparams(TransformerHparams):
    latent_depth: int = 64
    num_encoder_latents: int = 64
    kl_annealing_steps: int = 0
    kl_weight_start: float = 1.0
    kl_weight_end: float = 1.0
    train_mc_samples: int = 1
    free_bits: float = 0.0


def z_projection_module(hp: TransformerVAEHparams) -> nn.Linear:
    """One per-layer z-injection projection."""
    return Linear(hp.latent_depth, hp.d_model)


class TransformerVAE(TransformerLanguageModel):
    def __init__(self, hparams: TransformerVAEHparams):
        super().__init__(hparams)
        self.z_projections = nn.ModuleList([
            z_projection_module(hparams) for _ in range(hparams.num_layers)])
        self.encoder = Perceiver(
            num_layers=max(2, hparams.num_layers // 2),
            num_latents=hparams.num_encoder_latents,
            d_model=hparams.d_model, bottleneck_width=1,
            tp_size=hparams.tp_size)
        self.q_of_z_given_x = ConditionalGaussian(hparams.latent_depth,
                                                  hparams.d_model)

    def bind_seq_group(self, group):
        super().bind_seq_group(group)
        self.encoder.bind_seq_group(group)

    def bind_model_group(self, group):
        super().bind_model_group(group)
        self.encoder.bind_model_group(group)

    # -- encoder ------------------------------------------------------------
    def encode(self, token_ids):
        """token_ids [B, L] -> the encoder bottleneck [B, 1, d_model]."""
        return self.encoder(self.embed(token_ids), mask=token_ids != 0)

    def posterior(self, token_ids, get_kl: bool = False):
        return self.q_of_z_given_x(self.encode(token_ids), get_kl=get_kl)

    # -- decoder ------------------------------------------------------------
    def reconstruct_hidden(self, token_ids, z, return_kv: bool = False,
                           moe_stats: Optional[list] = None):
        """Decoder stack with z injected at position 0 of every layer.
        token_ids: [B, L] (0 = pad); z: [B, 1, latent_depth]. Returns the
        pre-head hidden [B, L, D]; with return_kv also each layer's
        head-major rotary (k, v), the bulk-prefill cache seed. moe_stats:
        as `forward_hidden`'s."""
        x = self.embed(token_ids)
        mask = token_ids != 0
        # On a shard past the first, z does not enter here; selecting with
        # a tensor keeps z in every rank's graph, so the encoder's backward
        # collectives run on every rank.
        first = (None if self.seq_group is None else
                 torch.tensor(self.seq_group.rank == 0, device=x.device))
        kvs = []
        for proj, layer in zip(self.z_projections, self.decoder_layers):
            z_hidden = proj(z.to(x.dtype)).expand(x.shape[0], 1, x.shape[-1])
            injected = torch.cat([z_hidden, x[:, 1:]], dim=1)
            x = injected if first is None else torch.where(first, injected,
                                                           x)
            if return_kv:
                x, kv = layer(x, mask, return_kv=True, moe_stats=moe_stats)
                kvs.append(kv)
            else:
                x = layer(x, mask, moe_stats=moe_stats)
        return (x, kvs) if return_kv else x

    def reconstruct(self, token_ids, z):
        return self.project(self.reconstruct_hidden(token_ids, z))

    def reconstruct_ll(self, token_ids, z):
        """Per-document log p(x | z) [B] with the next-token shift, logits
        never fully materialised. Under sequence parallelism each shard's
        row sums cover its slice, and one sum over the shards makes the
        global per-document value on every rank."""
        h = self.reconstruct_hidden(token_ids, z)
        ll = self.sequence_ll_rows(h, self.labels_for(token_ids))
        if self.seq_group is not None:
            from ..parallel.sp import sum_over_shards
            ll = sum_over_shards(ll, self.seq_group)
        return ll

    # -- training forwards --------------------------------------------------
    def _posterior_and_z(self, token_ids, eps, generator):
        q, kl = self.posterior(token_ids, get_kl=True)
        return q, kl, q.sample(eps, generator)

    def forward(self, token_ids, eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                moe_stats: Optional[list] = None):
        """(logits [B, L, V] fp32, per-dim KL [B, 1, latent], posterior,
        z) with z = loc + scale * eps, eps given or drawn from
        `generator`."""
        q, kl, z = self._posterior_and_z(token_ids, eps, generator)
        return self.project(self.reconstruct_hidden(
            token_ids, z, moe_stats=moe_stats)), kl, q, z

    def forward_chunked_nll(self, token_ids,
                            eps: Optional[torch.Tensor] = None,
                            generator: Optional[torch.Generator] = None,
                            moe_stats: Optional[list] = None):
        """Training forward without [B, L, V] logits: (nll_sum,
        token_count, per-dim KL, posterior, z)."""
        q, kl, z = self._posterior_and_z(token_ids, eps, generator)
        h = self.reconstruct_hidden(token_ids, z, moe_stats=moe_stats)
        nll_sum, count = self.sequence_nll(h, self.labels_for(token_ids))
        return nll_sum, count, kl, q, z

    # -- sampling and serving ----------------------------------------------
    def decode_step_z(self, token, caches: list, index: int, z):
        """One decode step, every row at position `index` (int), z's
        projection replacing each layer's input at index 0. token: [B];
        z: [B, 1, latent_depth]. Returns (fp32 logits [B, V], caches);
        the caches update in place."""
        x = self.embed(token[:, None])
        mask = (token != 0)[:, None]
        for proj, layer, cache in zip(self.z_projections,
                                      self.decoder_layers, caches):
            if index == 0:
                x = proj(z.to(x.dtype)).expand(x.shape[0], 1, x.shape[-1])
            x, _ = layer.decode(x, cache, index, mask)
        return self.project(x[:, 0]), caches

    @torch.no_grad()
    def sample(self, seed: int, max_length: int, batch_size: int = 1,
               z: Optional[torch.Tensor] = None,
               sampling: SamplingParams = SamplingParams(),
               start_token: int = 1, end_token: int = 2,
               fused_select: bool = True):
        """Unconditional (z ~ N(0, I) from `seed`, `generation.prior_z`)
        or conditional (z given) generation through the lockstep loop:
        tokens [batch_size, max_length - 1] without the start token. The
        refusal to sample while kl_weight < 1 lives in the trainer's
        callback (cli.make_sample_fns). fused_select: see
        TransformerLanguageModel.sample."""
        state, _, _ = self.sample_resumable(
            seed, max_length, batch_size, z, sampling, start_token,
            end_token, fused_select=fused_select)
        return final_output(state)

    @torch.no_grad()
    def sample_resumable(self, seed: int, max_length: int,
                         batch_size: int = 1,
                         z: Optional[torch.Tensor] = None,
                         sampling: SamplingParams = SamplingParams(),
                         start_token: int = 1, end_token: int = 2,
                         state: Optional[DecodeState] = None,
                         caches: Optional[list] = None,
                         max_steps: Optional[int] = None,
                         fused_select: bool = True):
        """Bounded-slice sampling for long documents (pg19's 102,400
        tokens): at most max_steps positions this call; returns (state,
        caches, z) to pass back in. A resumed call needs the first call's
        z. Slices give the one-shot result; the sparse cache stays
        O(window) whatever max_length is."""
        if z is None:
            if state is not None:
                raise ValueError("a resumed sample_resumable call needs "
                                 "the first call's z")
            z = prior_z(seed, batch_size, self.hparams.latent_depth,
                        self.device)
        if state is None:
            state = init_decode_state(
                batch_size, max_length, start_token,
                decode_generator(seed, self.device))
        if caches is None:
            caches = self.init_caches(batch_size, max_length)

        def logits_fn(st: DecodeState, caches):
            return self.decode_step_z(prev_tokens(st), caches,
                                      st.index - 1, z)

        state, caches = decode_loop(state, logits_fn, caches, sampling,
                                    end_token, max_steps=max_steps,
                                    fused_select=fused_select)
        return state, caches, z

    def decode_step_z_rowwise(self, token, caches: list, index, z):
        """One decode step at PER-ROW positions index [B]: rows at position
        0 take their z projection as the layer input. token: [B];
        z: [B, 1, latent_depth]. Returns (fp32 logits [B, V], caches)."""
        x = self.embed(token[:, None])
        first = (index == 0)[:, None, None]
        mask = ((token != 0) | (index == 0))[:, None]
        new_caches = []
        for proj, layer, cache in zip(self.z_projections,
                                      self.decoder_layers, caches):
            zh = proj(z.to(x.dtype)).expand(x.shape[0], 1, x.shape[-1])
            x = torch.where(first, zh, x)
            x, cache = layer.decode_rowwise(x, cache, index, mask)
            new_caches.append(cache)
        return self.project(x[:, 0]), new_caches

    # -- speculative verification and parallel decoding from z -------------
    def _z_inputs(self, z):
        """Each layer's input at absolute position 0: (layer i, x) -> its
        z projection [B, 1, D]."""
        return lambda i, x: self.z_projections[i](z.to(x.dtype)).expand(
            x.shape[0], 1, x.shape[-1])

    def _prior(self, seed: int, batch_size: int, z):
        return prior_z(seed, batch_size, self.hparams.latent_depth,
                       self.device) if z is None else z

    def decode_chunk_z(self, tokens, caches: list, index: int, z):
        """`decode_chunk` with z's projection as each layer's input at
        absolute position 0 (the chunk's first position when index is 0),
        as `decode_step_z` injects it. Returns (fp32 logits [B, C, V],
        kvs) without writing the caches."""
        x = self.embed(tokens)
        z_inputs = self._z_inputs(z)
        kvs = []
        for i, (layer, cache) in enumerate(zip(self.decoder_layers, caches)):
            if index == 0:
                x = torch.cat([z_inputs(i, x), x[:, 1:]], dim=1)
            x, kv = layer.decode_chunk(x, cache, index, tokens != 0)
            kvs.append(kv)
        return self.project(x), kvs

    def window_hidden_z(self, win_tokens, caches: list, start: int, z):
        """`window_hidden` with z's projection as each layer's input at
        absolute position 0 while the window holds it."""
        return self._window_pass(win_tokens, caches, start, self._z_inputs(z))

    @torch.no_grad()
    def frontier_generate(self, seed: int, length: int, batch_size: int = 1,
                          z: Optional[torch.Tensor] = None,
                          sampling: SamplingParams = SamplingParams(),
                          start_token: int = 1, end_token: int = 2,
                          window_tokens: int = 512,
                          max_iters: Optional[int] = None,
                          fused_select: bool = False, draft_ngram: int = 0,
                          noise=None):
        """Frontier-windowed Jacobi decoding from z (z ~ N(0, I) from
        `seed` unless given; see TransformerLanguageModel's)."""
        z = self._prior(seed, batch_size, z)
        return self._frontier(
            lambda w, c, f: self.window_hidden_z(w, c, f, z), seed, length,
            batch_size, sampling, start_token, end_token, window_tokens,
            max_iters, fused_select, draft_ngram, noise)

    @torch.no_grad()
    def speculative_generate(self, seed: int, length: int,
                             batch_size: int = 1,
                             z: Optional[torch.Tensor] = None,
                             sampling: SamplingParams = SamplingParams(),
                             start_token: int = 1, end_token: int = 2,
                             window_tokens: int = 512,
                             max_iters: Optional[int] = None,
                             draft_ngram: int = 3, noise=None):
        """Frontier speculative sampling from z (see
        TransformerLanguageModel's)."""
        z = self._prior(seed, batch_size, z)
        return self._speculative(
            lambda w, c, f: self.window_hidden_z(w, c, f, z), seed, length,
            batch_size, sampling, start_token, end_token, window_tokens,
            max_iters, draft_ngram, noise)

    @torch.no_grad()
    def spec_draft_generate(self, seed: int, length: int, draft_propose,
                            draft_state, z: Optional[torch.Tensor] = None,
                            sampling: SamplingParams = SamplingParams(),
                            start_token: int = 1, end_token: int = 2,
                            draft_k: int = 8,
                            max_iters: Optional[int] = None, noise=None):
        """Draft-model speculative sampling from z, batch 1 (see
        TransformerLanguageModel's)."""
        z = self._prior(seed, 1, z)
        return self._spec_draft(
            lambda t, c, i: self.decode_chunk_z(t, c, i, z), seed, length,
            draft_propose, draft_state, sampling, start_token, end_token,
            draft_k, max_iters, noise)

    @torch.no_grad()
    def parallel_generate(self, seed: int, length: int, batch_size: int = 1,
                          z: Optional[torch.Tensor] = None,
                          sampling: SamplingParams = SamplingParams(),
                          start_token: int = 1, end_token: int = 2,
                          max_iters: Optional[int] = None,
                          chunk_size: int = 2048, init_tokens=None,
                          fused_select: bool = False, noise=None):
        """Full-document Jacobi decoding from z: every iteration one
        teacher-forcing forward of the z-injected decoder (see
        TransformerLanguageModel's)."""
        z = self._prior(seed, batch_size, z)
        return self._jacobi(
            lambda t: self.reconstruct_hidden(t, z), seed, length,
            batch_size, sampling, start_token, end_token, max_iters,
            chunk_size, init_tokens, fused_select, noise)
