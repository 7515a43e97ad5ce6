"""Draft-model speculative decoding with chunked verification (port of
sparse_vae_tpu/models/spec_decode.py).

A cheaper trained model proposes k tokens a pass; the target verifies
them in one (k + 1)-token chunk peek against its own KV caches. A
drafted token d ~ q is accepted with probability min(1, p(d) / q(d)), the
first rejection resamples from the residual max(p - q, 0) / Z, and a fully
accepted chunk takes a bonus token from the target's last row. The output
is an exact sample of the target's sampling distribution (the lockstep
sampler's penalty, temperature, top-k and top-p); greedy decoding gives
the AR trajectory. The draft samples its own raw distribution q
(`TransformerLanguageModel.draft_propose`: its own temperature, no
filter).

Every pass draws afresh: pass `it` reads noise.fold(it), whose sub-stream
DRAFT_KEY feeds the draft's k + 1 steps, whose COIN_KEY uniforms are the
accept coins and whose SELECT_KEY Gumbel noise picks the resampled or
bonus token. The target's caches commit only the accepted prefix
(`commit_chunk`); the draft rewinds through the stack its `draft_propose`
returns (`draft_select`). The loop runs on the host: a pass's accepted
count, token and end are read once.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from .generation import SamplingParams, _is_greedy
from .parallel_decode import (_chunk_repetition_penalty, _filter_logits,
                              _finish, _new_buffer)

# Sub-streams of a pass's noise.
DRAFT_KEY, COIN_KEY, SELECT_KEY = 0, 1, 2


def draft_select(stack, j: int):
    """The draft's state after step j of its proposal (j + 1 consumed
    tokens): `stack.select(j)`, a rewind of the caches the steps wrote."""
    return stack.select(j)


def chunk_speculative_decode(chunk_logits_fn: Callable, commit_fn: Callable,
                             caches, draft_propose: Callable, draft_state,
                             length: int, noise,
                             sampling: SamplingParams = SamplingParams(),
                             start_token: int = 1, end_token: int = 2,
                             draft_k: int = 8,
                             max_iters: Optional[int] = None, device=None):
    """Decode `length` tokens (with the start token) speculatively, batch 1.

    chunk_logits_fn(tokens [1, C], caches, index) -> (logits [1, C, V],
    kvs) peeks without writing; commit_fn(caches, kvs, index, m) commits
    the first m; draft_propose(state, last [1], noise) -> (drafts [1, k],
    q_logp [1, k, V], stack). The caches are sized for length + k + 2
    positions (the bonus pass peeks past `length`); they and the draft's
    state are written in place.

    At the top of a pass buffer[0, :n] is final, the target's caches hold
    positions 0 .. n - 2, the draft has consumed 0 .. n - 2, and the chunk
    [buffer[n - 1], d_1 .. d_k] feeds both the newest final token and the
    drafts. Returns (tokens [1, length], passes, accepted drafts)."""
    k = draft_k
    greedy = _is_greedy(sampling)
    max_iters = max_iters or (length + 2)
    buffer = _new_buffer(1, length + k + 2, start_token, device)
    n, it, accepted, ended = 1, 0, 0, False
    while not ended and n < length and it < max_iters:
        draws = noise.fold(it)
        drafts, q_logp, stack = draft_propose(
            draft_state, buffer[:, n - 1], draws.fold(DRAFT_KEY))
        # Drafts enter the buffer before verification, so the penalty sees
        # each position's history.
        buffer[:, n:n + k] = drafts
        logits, kvs = chunk_logits_fn(buffer[:, n - 1:n + k], caches, n - 1)
        logits = logits.float()                                 # [1, k+1, V]
        v = logits.shape[-1]
        if sampling.repetition_penalty > 1.0:
            logits = _chunk_repetition_penalty(
                logits, buffer, n - 1, sampling.repetition_penalty,
                sampling.repetition_window)
        lf = _filter_logits(logits, sampling)
        # Row i decides position n + i; rows 0 .. k - 1 verify drafts.
        if greedy:
            accept = drafts == torch.argmax(lf[:, :k], dim=-1)
        else:
            logp = lf - torch.logsumexp(lf, dim=-1, keepdim=True)
            p_d = logp[:, :k].gather(-1, drafts[..., None])[..., 0]
            q_d = q_logp.gather(-1, drafts[..., None])[..., 0]
            coins = draws.uniform(COIN_KEY, (1, k)).to(lf.device)
            accept = torch.log(coins) < torch.clamp(p_d - q_d, max=0.0)
        rejected = ~accept[0]
        rejected_any = rejected.any()
        j = torch.where(rejected_any,
                        torch.argmax(rejected.to(torch.int64)), k)
        # The token at row j: a residual resample after a rejection, the
        # target's (bonus) sample when every draft was accepted.
        lf_j = lf[0].index_select(0, j.view(1))                 # [1, V]
        if greedy:
            t_star = torch.argmax(lf_j, dim=-1)
        else:
            gum = draws.gumbel(SELECT_KEY, (1, v)).to(lf.device)
            target_pick = torch.argmax(
                torch.where(torch.isfinite(lf_j), lf_j + gum, lf_j), dim=-1)
            q_j = torch.exp(q_logp[0].index_select(
                0, j.clamp(max=k - 1).view(1)))
            resid = torch.clamp(torch.softmax(lf_j, dim=-1) - q_j, min=0.0)
            r_log = torch.where(resid > 0, torch.log(resid), float("-inf"))
            # An all-zero residual comes only from rounding: take the
            # target's sample.
            resid_pick = torch.argmax(r_log + gum, dim=-1)
            t_star = torch.where(rejected_any & (resid > 0).any(),
                                 resid_pick, target_pick)
        read = torch.cat([j.view(1), t_star.view(1), drafts[0]]).tolist()
        j, token, proposed = read[0], read[1], read[2:]
        buffer[0, n + j] = token
        caches = commit_fn(caches, kvs, n - 1, j + 1)
        draft_state = draft_select(stack, j)
        ended = end_token in proposed[:j] or token == end_token
        n += j + 1
        it += 1
        accepted += j
    return _finish(buffer, length, end_token, start_token), it, accepted
