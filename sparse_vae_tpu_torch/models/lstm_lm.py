"""The LSTM/GRU language model (port of sparse_vae_tpu/models/lstm_lm.py):
a learned initial state c0 per layer with h0 = tanh(c0), the RNN stack of
ops/rnn.py over the token embeddings, and logits through a Dense output
layer or, tied, through a bottleneck to d_embedding, the embedding table
transposed and a bias; `initial_rnn_state`, the teacher-forced forward
(with an optional per-document context concatenated to every
embedding), `decode_step`, the lockstep `sample` and the draft interface
`draft_propose` of draft-model speculative decoding.

It computes in fp32, as the JAX package's does (no compute dtype). Its
sampling selects with the JAX package's unfused path (the bisection and a
Gumbel-max draw): the JAX LSTM `sample` takes no fused selection, so K4
never runs here. Sampling takes an int seed: the decode noise comes from
`generation.decode_generator(seed)` on the model's device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn as nn

from ..ops.rnn import StackedRNN
from .base import LanguageModelHparams, Linear
from .generation import (DecodeState, SamplingParams, decode_generator,
                         decode_loop, final_output, init_decode_state,
                         prev_tokens)


@dataclass
class LSTMLanguageModelHparams(LanguageModelHparams):
    d_embedding: int = 512
    d_model: int = 1024
    num_layers: int = 1
    rnn_type: str = "LSTM"
    tie_logit_weights: bool = False
    init_scale: Optional[float] = None   # every LSTM preset's


class RNNStates:
    """The draft's states after each step of `draft_propose`:
    `select(j)` is the state after step j (spec_decode.draft_select)."""

    def __init__(self, states: list):
        self.states = states

    def select(self, j: int):
        return self.states[j]


class LSTMLanguageModel(nn.Module):
    def __init__(self, hparams: LSTMLanguageModelHparams):
        super().__init__()
        hp = self.hparams = hparams
        # Read by checkpoint.py's training form; the LSTM computes in its
        # parameters' dtype.
        self.compute_dtype: Optional[torch.dtype] = None
        self.decoder_embedding = nn.Embedding(hp.vocab_size, hp.d_embedding)
        self.decoder = StackedRNN(hp.d_embedding, hp.d_model, hp.num_layers,
                                  hp.rnn_type)
        self.c0 = nn.Parameter(torch.empty(hp.num_layers, hp.d_model))
        if hp.tie_logit_weights:
            self.logit_bottleneck = Linear(hp.d_model, hp.d_embedding)
            self.logit_bias = nn.Parameter(torch.zeros(hp.vocab_size))
        else:
            self.output_layer = Linear(hp.d_model, hp.vocab_size)

    @property
    def device(self) -> torch.device:
        return self.c0.device

    def logits_from_hidden(self, h):
        """[..., d_model] -> fp32 logits [..., V]."""
        if self.hparams.tie_logit_weights:
            return (self.logit_bottleneck(h) @ self.decoder_embedding.weight.T
                    + self.logit_bias).float()
        return self.output_layer(h).float()

    def initial_rnn_state(self, batch_size: int) -> list:
        """Every layer's (tanh(c0), c0) for the LSTM, tanh(c0) for the
        GRU, at batch_size rows."""
        states = []
        for c in self.c0.unbind(0):
            c = c.expand(batch_size, -1)
            states.append((torch.tanh(c), c)
                          if self.hparams.rnn_type == "LSTM"
                          else torch.tanh(c))
        return states

    def _inputs(self, token_ids, context):
        x = self.decoder_embedding(token_ids)
        if context is None:
            return x
        if x.ndim == 3:
            context = context[:, None, :].expand(*x.shape[:-1], -1)
        return torch.cat([x, context], dim=-1)

    def forward(self, token_ids, context=None):
        """Teacher-forced logits [B, L, V] fp32; context [B, D_ctx], if
        given, is concatenated to every embedding."""
        hs, _ = self.decoder(self._inputs(token_ids, context),
                             self.initial_rnn_state(token_ids.shape[0]))
        return self.logits_from_hidden(hs)

    def decode_step(self, token, states: list, context=None):
        """One sampling step: token [B] -> (fp32 logits [B, V], states)."""
        h, states = self.decoder.step(self._inputs(token, context), states)
        return self.logits_from_hidden(h), states

    @torch.no_grad()
    def draft_propose(self, state: list, last_token, noise, k: int,
                      temperature: float = 1.0, context=None):
        """Draft k tokens as the cheap model of speculative decoding:
        k + 1 decode steps from `state` (everything before last_token
        consumed), the first on last_token [B], step i sampling
        argmax(log_softmax(logits / temperature) + noise.gumbel(i, ...)).
        Returns (drafts [B, k], q_logp [B, k, V] fp32, an `RNNStates`
        whose entry j is the state after consuming last_token and
        drafts[:j])."""
        tok, toks, logps, stack = last_token, [], [], []
        for i in range(k + 1):
            logits, state = self.decode_step(tok, state, context)
            logp = torch.log_softmax(logits / temperature, dim=-1)
            tok = torch.argmax(logp + noise.gumbel(i, logp.shape).to(
                logp.device), dim=-1)
            toks.append(tok)
            logps.append(logp)
            stack.append(state)
        return (torch.stack(toks[:k], dim=1), torch.stack(logps[:k], dim=1),
                RNNStates(stack))

    @torch.no_grad()
    def sample(self, seed: int, max_length: int, batch_size: int = 1,
               sampling: SamplingParams = SamplingParams(),
               start_token: int = 1, end_token: int = 2,
               initial_state: Optional[list] = None, context=None):
        """AR sampling from [CLS] through the lockstep loop with the
        unfused selection: tokens [batch_size, max_length - 1] without
        the start token; finished rows are [PAD] after their end token."""
        state = init_decode_state(batch_size, max_length, start_token,
                                  decode_generator(seed, self.device))
        carry = (initial_state if initial_state is not None
                 else self.initial_rnn_state(batch_size))

        def logits_fn(st: DecodeState, rnn_states):
            return self.decode_step(prev_tokens(st), rnn_states, context)

        state, _ = decode_loop(state, logits_fn, carry, sampling, end_token,
                               fused_select=False)
        return final_output(state)
