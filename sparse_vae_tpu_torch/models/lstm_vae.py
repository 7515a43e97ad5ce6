"""The LSTM variational autoencoder (port of
sparse_vae_tpu/models/lstm_vae.py): a (bi)LSTM encoder (ops/rnn.py
`BiLSTMEncoder`, with learned initial states `encoder_c0`) or, with
`transformer_encoder`, a Perceiver over the embeddings, compressed to a
Gaussian posterior over z [B, latent]; a unidirectional LSTM decoder that
reads z concatenated to every token embedding and starts from
c0 = z_to_hidden(z), h0 = tanh(c0) in every layer; logits through a Dense
output layer or, tied, a bottleneck to d_embedding and the embedding
table transposed. `encode`, `posterior`, `reconstruct_hidden`,
`reconstruct`, `reconstruct_ll` (logits never fully materialised), the
training forward of models/vae.py's VAEObjective, `decode_step` and the
lockstep `sample`.

It computes in fp32, as the JAX package's does. Dropout (hparams.dropout,
on the decoder's embeddings and on its outputs) applies whenever its
rate is above 0, in training and in evaluation alike, as the JAX
module's, whose `deterministic` is fixed by the rate: the masks are
handed in (`dropout_masks`) or drawn from a generator. No preset or run
sets it. Sampling selects with the JAX package's unfused path (no K4) and
takes an int seed: z ~ N(0, I) from (seed, Z_STREAM) on the CPU, the
decode noise from `generation.decode_generator(seed)`.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.cross_entropy import chunked_sequence_log_likelihood
from ..ops.rnn import BiLSTMEncoder, StackedRNN
from .base import Linear, dropout
from .conditional_gaussian import ConditionalGaussian
from .generation import (DecodeState, SamplingParams, decode_generator,
                         decode_loop, final_output, init_decode_state,
                         prev_tokens, prior_z)
from .perceiver import Perceiver
from .vae import ContinuousVAEHparams


@dataclass
class LSTMVAEHparams(ContinuousVAEHparams):
    latent_depth: int = 32
    num_latent_vectors: int = 1
    bidirectional_encoder: bool = False
    transformer_encoder: bool = False
    tie_embedding_weights: bool = True
    d_embedding: int = 512
    d_model: int = 1024
    num_layers: int = 1
    tie_logit_weights: bool = False
    dropout: float = 0.0
    init_scale: Optional[float] = None


class LSTMVAE(nn.Module):
    def __init__(self, hparams: LSTMVAEHparams):
        super().__init__()
        hp = self.hparams = hparams
        self.compute_dtype: Optional[torch.dtype] = None
        self.decoder_embedding = nn.Embedding(hp.vocab_size, hp.d_embedding)
        if not hp.tie_embedding_weights:
            self.encoder_embedding = nn.Embedding(hp.vocab_size,
                                                  hp.d_embedding)
        if hp.transformer_encoder:
            self.encoder = Perceiver(
                num_layers=3, num_latents=32, d_model=hp.d_embedding,
                bottleneck_width=hp.num_latent_vectors)
            enc_width = hp.d_embedding * hp.num_latent_vectors
        else:
            directions = 2 if hp.bidirectional_encoder else 1
            self.encoder = BiLSTMEncoder(
                hp.d_embedding, hp.d_model // 4, hp.num_layers,
                bidirectional=hp.bidirectional_encoder)
            enc_width = hp.d_model // 4 * directions
            self.encoder_c0 = nn.Parameter(
                torch.empty(directions, hp.d_model // 4))
        self.q_of_z_given_x = ConditionalGaussian(
            hp.latent_depth, enc_width, init_scale=hp.init_scale or 0.02)
        self.z_to_hidden = Linear(hp.latent_depth, hp.d_model)
        self.decoder = StackedRNN(hp.d_embedding + hp.latent_depth,
                                  hp.d_model, hp.num_layers)
        if hp.tie_logit_weights:
            self.logit_bottleneck = Linear(hp.d_model, hp.d_embedding)
            self.logit_bias = nn.Parameter(torch.zeros(hp.vocab_size))
        else:
            self.output_layer = Linear(hp.d_model, hp.vocab_size)

    @property
    def device(self) -> torch.device:
        return self.decoder_embedding.weight.device

    # -- pieces -------------------------------------------------------------
    def _embed_enc(self, token_ids):
        if self.hparams.tie_embedding_weights:
            return self.decoder_embedding(token_ids)
        return self.encoder_embedding(token_ids)

    def _logits(self, h):
        """[..., d_model] -> fp32 logits [..., V]."""
        if self.hparams.tie_logit_weights:
            return (self.logit_bottleneck(h) @ self.decoder_embedding.weight.T
                    + self.logit_bias).float()
        return self.output_layer(h).float()

    def _drop(self, x, mask, generator):
        """Dropout at hparams.dropout: `mask` (True = kept) given, or
        drawn from `generator`."""
        p = self.hparams.dropout
        if p <= 0.0:
            return x
        if mask is None:
            return dropout(x, p, generator)
        return torch.where(mask, x / (1.0 - p), 0.0)

    def encode(self, token_ids):
        """token_ids [B, L] (0 = pad) -> the encoder's summary [B,
        enc_width]."""
        x = self._embed_enc(token_ids)
        mask = token_ids != 0
        if self.hparams.transformer_encoder:
            z = self.encoder(x, mask=mask)
            return z.reshape(z.shape[0], -1)
        return self.encoder(x, mask=mask, c0=self.encoder_c0)

    def posterior(self, token_ids, get_kl: bool = False):
        return self.q_of_z_given_x(self.encode(token_ids), get_kl=get_kl)

    def _decoder_init(self, z) -> list:
        c0 = self.z_to_hidden(z)
        return [(torch.tanh(c0), c0)] * self.hparams.num_layers

    def reconstruct_hidden(self, token_ids, z, dropout_masks=None,
                           generator: Optional[torch.Generator] = None):
        """The teacher-forced decoder outputs [B, L, d_model] given z
        [B, latent], concatenated to every embedding and giving the
        initial state. dropout_masks: (embeddings' [B, L, d_embedding],
        outputs' [B, L, d_model]) bool, used where hparams.dropout > 0."""
        masks = dropout_masks or (None, None)
        x = self._drop(self.decoder_embedding(token_ids), masks[0],
                       generator)
        zb = z[:, None, :].expand(*x.shape[:-1], z.shape[-1])
        hs, _ = self.decoder(torch.cat([x, zb], dim=-1),
                             self._decoder_init(z))
        return self._drop(hs, masks[1], generator)

    def reconstruct(self, token_ids, z, dropout_masks=None,
                    generator: Optional[torch.Generator] = None):
        """Teacher-forced logits [B, L, V] fp32 given z."""
        return self._logits(self.reconstruct_hidden(token_ids, z,
                                                    dropout_masks,
                                                    generator))

    def reconstruct_ll(self, token_ids, z, chunk_size: int = 512):
        """Per-document log p(x | z) [B] with the next-token shift,
        through the chunked projection: [B, L, V] logits never exist."""
        hs = self.reconstruct_hidden(token_ids, z)
        labels = F.pad(token_ids[:, 1:], (0, 1))
        return chunked_sequence_log_likelihood(hs, self._logits, labels,
                                               chunk_size)

    # -- training forward ---------------------------------------------------
    def forward(self, token_ids, eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                dropout_masks=None):
        """(logits [B, L, V] fp32, per-dim KL [B, latent], posterior, z)
        with z = loc + scale * eps, eps [B, latent] given or drawn from
        `generator` (as are dropout masks not given)."""
        q, kl = self.posterior(token_ids, get_kl=True)
        z = q.sample(eps, generator)
        return (self.reconstruct(token_ids, z, dropout_masks, generator),
                kl, q, z)

    # -- sampling -----------------------------------------------------------
    def decode_step(self, token, states: list, z):
        """One sampling step: token [B] -> (fp32 logits [B, V], states)."""
        x = torch.cat([self.decoder_embedding(token), z], dim=-1)
        h, states = self.decoder.step(x, states)
        return self._logits(h), states

    @torch.no_grad()
    def sample(self, seed: int, max_length: int, batch_size: int = 1,
               z: Optional[torch.Tensor] = None,
               sampling: SamplingParams = SamplingParams(),
               start_token: int = 1, end_token: int = 2):
        """Unconditional (z ~ N(0, I) from `seed`) or conditional (z
        [B, latent] given) generation through the lockstep loop with the
        unfused selection: tokens [batch_size, max_length - 1] without the
        start token. The refusal to sample while kl_weight < 1 lives in
        the trainer's callback (cli.make_sample_fns)."""
        if z is None:
            z = prior_z(seed, batch_size, self.hparams.latent_depth,
                        self.device)
        z = z.reshape(z.shape[0], -1).to(self.device)
        state = init_decode_state(batch_size, max_length, start_token,
                                  decode_generator(seed, self.device))

        def logits_fn(st: DecodeState, rnn_states):
            return self.decode_step(prev_tokens(st), rnn_states, z)

        state, _ = decode_loop(state, logits_fn, self._decoder_init(z),
                               sampling, end_token, fused_select=False)
        return final_output(state)
