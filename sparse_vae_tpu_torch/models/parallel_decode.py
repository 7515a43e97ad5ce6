"""Non-autoregressive generation by Jacobi fixed-point decoding (port of
sparse_vae_tpu/models/parallel_decode.py).

The document is generated by iterating a parallel map to its fixed point,

    t^0     = [CLS], PAD, PAD, ...
    t^{k+1} = select(f(t^k), noise), shifted right by one,

where f is the teacher-forcing forward. The decoder is causal, so once a
prefix of t^k matches the AR trajectory it never changes, and the fixed
point is exactly what AR decoding gives under the same selection rule:
greedy decoding's tokens, or, with Gumbel noise that is a function of the
position only, an ancestral sample.

- `jacobi_decode`: the whole document every iteration, its selection
  chunk by chunk (a chunk whose inputs did not change is skipped);
- `frontier_jacobi_decode`: for sliding-window models, only an active
  window at the convergence frontier, over the frozen prefix's window
  cache; leading blocks that are a fixed point freeze;
- `frontier_speculative_decode`: the window as a draft, verified by the
  speculative accept / residual-resample rule: an exact sample of the AR
  sampling distribution (greedy: the AR trajectory).

A position's noise is keyed by its block (or chunk) through a noise
source (`generation.KeyedNoise`, or any object with its `gumbel`,
`uniform` and `fold`), so a block evaluated again sees the same noise.
The loops run on the host: the frontier, the freeze count, each row's
final count, and Jacobi's convergence and dirty chunks are read once a
pass. Sampled nucleus-only selection may go through K4
(`_fused_select`). Token buffers are int64.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F

from ..ops.attention import Attention
from ..ops.select_kernel import nucleus_gumbel_argmax
from .generation import SamplingParams, _is_greedy, top_p_filter


def _filter_logits(logits, sampling: SamplingParams):
    """Temperature, top-k and top-p filtering over [..., V] logits (the
    lockstep sampler's pipeline, vectorised over positions)."""
    if sampling.temperature > 0.0:
        logits = logits / sampling.temperature
    if sampling.top_k > 0:
        kth = torch.topk(logits, sampling.top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if 0.0 < sampling.top_p < 1.0:
        logits = top_p_filter(logits, sampling.top_p)
    return logits


def _use_fused_select(sampling: SamplingParams, fused: bool) -> bool:
    """K4 covers the sampled nucleus path; greedy is one argmax and top-k
    needs an order statistic the kernel does not compute."""
    return fused and not _is_greedy(sampling) and sampling.top_k == 0


def _fused_select(logits, tokens, chunk_start: int, noise,
                  sampling: SamplingParams):
    """[B, C, V] logits -> [B, C] choices through K4
    (`select_kernel.nucleus_gumbel_argmax`) on the penalised logits; noise:
    [B, C, V] Gumbel noise of the caller's block or chunk grid."""
    b, c, v = logits.shape
    if sampling.repetition_penalty > 1.0:
        logits = _chunk_repetition_penalty(
            logits, tokens, chunk_start, sampling.repetition_penalty,
            sampling.repetition_window)
    chosen = nucleus_gumbel_argmax(
        logits.reshape(b * c, v).float().contiguous(),
        noise.reshape(b * c, v).contiguous(), top_p=sampling.top_p,
        temperature=sampling.temperature)
    return chosen.reshape(b, c)


def _select(logits, tokens, start: int, sampling: SamplingParams, noise_fn,
            fused: bool):
    """[B, C, V] logits at positions start.. -> [B, C] next tokens: the
    penalty, the filters and Gumbel-max (noise_fn() gives the [B, C, V]
    noise), or K4 when `_use_fused_select`."""
    if _use_fused_select(sampling, fused):
        return _fused_select(logits, tokens, start,
                             noise_fn().to(logits.device), sampling)
    if sampling.repetition_penalty > 1.0:
        logits = _chunk_repetition_penalty(
            logits, tokens, start, sampling.repetition_penalty,
            sampling.repetition_window)
    logits = _filter_logits(logits, sampling)
    if not _is_greedy(sampling):
        g = noise_fn().to(logits.device)
        logits = torch.where(torch.isfinite(logits), logits + g, logits)
    return torch.argmax(logits, dim=-1)


def _select_chunked(hidden, tokens, project_fn, sampling: SamplingParams,
                    noise, chunk_size: int, prev_chosen=None, dirty=None,
                    fused: bool = False):
    """hidden [B, L, D] -> chosen next tokens [B, L] (position i's choice
    decides token i + 1), the head applied chunk by chunk so that [B, L, V]
    logits never exist. Chunk ci's noise is noise.gumbel(ci, ...). dirty
    (host bools a chunk): a clean chunk's inputs did not change since the
    last iteration, so its choices are prev_chosen's."""
    b, length, _ = hidden.shape
    chunk_size = min(chunk_size, length)
    num_chunks = -(-length // chunk_size)
    pad = num_chunks * chunk_size - length
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
    chosen = torch.zeros((b, num_chunks * chunk_size), dtype=torch.int64,
                         device=hidden.device)
    for ci in range(num_chunks):
        cols = slice(ci * chunk_size, (ci + 1) * chunk_size)
        if dirty is not None and not dirty[ci]:
            chosen[:, cols] = F.pad(prev_chosen, (0, pad))[:, cols]
            continue
        logits = project_fn(hidden[:, cols]).float()
        chosen[:, cols] = _select(
            logits, tokens, ci * chunk_size, sampling,
            lambda: noise.gumbel(ci, logits.shape), fused)
    return chosen[:, :length]


def _chunk_membership(tokens, chunk_start: int, c: int, window: int,
                      vocab: int):
    """[B, C, V] bool: is token v inside position (chunk_start + i)'s
    `window`-token lookback in the [B, L] buffer? Positions before the
    buffer read [PAD] (0), as the reference's clamped indices do.

    The reference builds this from cumulative one-hot counts, because a
    scatter of W updates into [..., V] serialises on a TPU; here one
    scatter of each position's W lookback tokens into the [B, C, V]
    result does it, and no [B, W + C - 1, V] tensor exists."""
    length = tokens.shape[1]
    w = min(window, length)
    padded = F.pad(tokens, (w - 1, c))
    span = w + c - 1
    # A dynamic slice clamps its start into the buffer.
    start = min(max(chunk_start, 0), padded.shape[1] - span)
    windows = padded[:, start:start + span].unfold(1, w, 1)     # [B, C, W]
    member = torch.zeros((tokens.shape[0], c, vocab), dtype=torch.bool,
                         device=tokens.device)
    return member.scatter_(2, windows, True)


def _chunk_repetition_penalty(logits, tokens, chunk_start: int,
                              penalty: float, window: int):
    """The repetition penalty on [B, C, V] logits at positions
    chunk_start .. chunk_start + C - 1 (x < 0 -> x * p, else x / p)."""
    _, c, vocab = logits.shape
    member = _chunk_membership(tokens, chunk_start, c, window, vocab)
    return torch.where(member,
                       torch.where(logits < 0.0, logits * penalty,
                                   logits / penalty),
                       logits)


def _mask_after_end(tokens, end_token: int, start_token: int):
    """Positions strictly after a row's first end_token become [PAD];
    position 0 stays start_token (the AR loop's live mask, in parallel)."""
    is_end = tokens[:, 1:] == end_token
    seen = torch.cumsum(is_end.to(torch.int64), dim=-1)
    after = F.pad(seen[:, :-1], (1, 0)) > 0
    body = torch.where(after, 0, tokens[:, 1:])
    return F.pad(body, (1, 0), value=start_token)


def push_window_blocks(caches, kvs, start: int, block_size: int):
    """Freeze the leading window block into every layer's cache."""
    return [Attention.push_window_block(c, kv, start, block_size)
            for c, kv in zip(caches, kvs)]


def _freeze_leading_blocks(caches, kvs, f: int, s: int, block_size: int,
                           push_fn):
    """Push the first s of the window's K/V blocks into the caches."""
    for j in range(s):
        cols = slice(j * block_size, (j + 1) * block_size)
        caches = push_fn(caches, [(k[:, :, cols], v[:, :, cols])
                                  for k, v in kvs], f + j * block_size)
    return caches


def _suffix_match_draft(buffer, win_old, frontier: int, ngram: int):
    """Prompt-lookup drafting of the window's tail: the `ngram` tokens
    ending at each row's first changed window position (the cascade point)
    are matched against the text to their left, and the latest match's
    continuation, copied cyclically with the match distance as period,
    rewrites the window past the cascade point. An initialisation only:
    the fixed point is unchanged. buffer [B, buf_len] after the pass;
    win_old [B, W] the window before it."""
    b, buf_len = buffer.shape
    w = win_old.shape[1]
    pos = torch.arange(buf_len, device=buffer.device)
    change = buffer[:, frontier:frontier + w] != win_old
    any_change = change.any(dim=1)
    ci = torch.argmax(change.to(torch.int64), dim=1)          # first change
    pc = frontier + ci
    q_idx = pc[:, None] - (ngram - 1) + torch.arange(
        ngram, device=buffer.device)[None, :]
    q = buffer.gather(1, q_idx.clamp(0, buf_len - 1))
    # match[p]: the n-gram ending at p equals q, p strictly left of pc.
    match = torch.ones((b, buf_len), dtype=torch.bool, device=buffer.device)
    for j in range(ngram):
        shifted = F.pad(buffer, (j, 0))[:, :buf_len]
        match &= shifted == q[:, ngram - 1 - j][:, None]
    match &= (pos[None, :] < pc[:, None]) & (pos[None, :] >= ngram - 1)
    found = match.any(dim=1) & any_change & (q_idx[:, 0] >= 0)
    # The latest match: argmax over the reversed row.
    p_star = buf_len - 1 - torch.argmax(
        match.flip(1).to(torch.int64), dim=1)
    d = torch.where(found, pc - p_star, 1)[:, None]            # period >= 1
    wi = torch.arange(w + 1, device=buffer.device)
    src = p_star[:, None] + 1 + torch.remainder(
        wi[None, :] - ci[:, None] - 1, d)
    draft = buffer.gather(1, src.clamp(0, buf_len - 1))
    cur = buffer[:, frontier:frontier + w + 1]
    upd = torch.where(found[:, None] & (wi[None, :] > ci[:, None]), draft,
                      cur)
    out = buffer.clone()
    out[:, frontier:frontier + w + 1] = upd
    return out


def _window_noise(noise, start: int, b: int, w: int, v: int,
                  block_size: int):
    """[B, W, V] Gumbel noise keyed by the absolute block index, so a
    position's noise is the same whichever window (or full-document
    Jacobi chunk of the same size) evaluates it."""
    first = start // block_size
    return torch.cat([noise.gumbel(first + a, (b, block_size, v))
                      for a in range(w // block_size)], dim=1)


def _window_coins(noise, start: int, b: int, w: int, block_size: int):
    """[B, W] uniforms keyed like `_window_noise`: a position's accept coin
    is the same in every pass. Reuse is unbiased: a coin is consumed only
    when its decision becomes final."""
    first = start // block_size
    return torch.cat([noise.uniform(first + a, (b, block_size))
                      for a in range(w // block_size)], dim=1)


def _select_window(hidden, buffer, start: int, project_fn,
                   sampling: SamplingParams, noise, block_size: int,
                   fused: bool = False):
    """The active window's selection: hidden [B, W, D] at positions
    start.. -> [B, W] next tokens (noise: `_window_noise`)."""
    logits = project_fn(hidden).float()
    b, w, v = logits.shape
    return _select(logits, buffer, start, sampling,
                   lambda: _window_noise(noise, start, b, w, v, block_size),
                   fused)


def _speculative_verify(lf, draft, coins, noise):
    """The speculative accept / resample operator, per position. lf:
    [..., V] filtered logits; draft: [...] proposed tokens (a point-mass
    draft, so min(1, p/q) is p(draft)); coins: [...] uniforms; noise:
    [..., V] Gumbel. Returns (accept, resample): accept with probability
    p(draft); resample a Gumbel-max sample of p without the draft token."""
    logp_d = lf.gather(-1, draft[..., None])[..., 0] - torch.logsumexp(
        lf, dim=-1)
    accept = torch.log(coins) < logp_d
    noisy = torch.where(torch.isfinite(lf), lf + noise, lf)
    res_src = noisy.scatter(-1, draft[..., None], float("-inf"))
    return accept, torch.argmax(res_src, dim=-1)


def _first_end(buffer, end_token: int):
    """[B] each row's first end_token position (buffer width if none)."""
    hit = buffer == end_token
    first = torch.argmax(hit.to(torch.int64), dim=1)
    return torch.where(hit.any(dim=1), first, buffer.shape[1])


def _new_buffer(batch_size: int, length: int, start_token: int, device):
    buffer = torch.zeros((batch_size, length), dtype=torch.int64,
                         device=device)
    buffer[:, 0] = start_token
    return buffer


def _finish(buffer, length: int, end_token: int, start_token: int):
    """The first `length` tokens, [PAD] after the end, the last slot [PAD]
    (the AR loop never writes it)."""
    out = _mask_after_end(buffer[:, :length], end_token, start_token)
    out[:, -1] = 0
    return out


def _check_window(length: int, window_tokens: int, block_size: int):
    if length % block_size or window_tokens % block_size \
            or window_tokens < block_size:
        raise ValueError(f"length {length} and window {window_tokens} must "
                         f"be multiples of the block {block_size}, the "
                         "window at least one block")


def frontier_jacobi_decode(window_hidden_fn: Callable, project_fn: Callable,
                           push_fn: Callable, caches, batch_size: int,
                           length: int, noise,
                           sampling: SamplingParams = SamplingParams(),
                           start_token: int = 1, end_token: int = 2,
                           window_tokens: int = 512, block_size: int = 128,
                           max_iters: Optional[int] = None,
                           fused_select: bool = False, draft_ngram: int = 0,
                           device=None):
    """Frontier-windowed Jacobi decoding for sliding-window models: each
    pass evaluates the `window_tokens` positions at the frontier over the
    frozen prefix's window cache, then freezes every leading block that did
    not change (its inputs were final, so it is the AR trajectory) and
    advances the frontier past them. draft_ngram > 0 re-initialises the
    window's tail by suffix matching (`_suffix_match_draft`), a lever for
    greedy decoding.

    window_hidden_fn(win [B, W], caches, start) -> (hidden [B, W, D],
    per-layer window (k, v)); push_fn(caches, kvs, start) freezes kvs'
    leading block. The caches are written in place. Returns (tokens
    [B, length] with the start token, passes)."""
    w = window_tokens
    _check_window(length, w, block_size)
    max_iters = max_iters or 4 * length
    nblk = w // block_size
    buffer = _new_buffer(batch_size, length + w, start_token, device)
    f, it, done = 0, 0, False
    while not done and it < max_iters:
        win = buffer[:, f:f + w].clone()
        hidden, kvs = window_hidden_fn(win, caches, f)
        chosen = _select_window(hidden, buffer, f, project_fn, sampling,
                                noise, block_size, fused_select)
        # W + 1 tokens: the choice at the window's last position decides
        # token f + W.
        buffer[:, f + 1:f + w + 1] = chosen
        buffer = _mask_after_end(buffer, end_token, start_token)
        changed = (buffer[:, f:f + w] != win).view(
            batch_size, nblk, block_size).any(dim=2).any(dim=0)
        stats = torch.cat([changed.to(torch.int64),
                           _first_end(buffer, end_token)]).tolist()
        s = next((i for i, c in enumerate(stats[:nblk]) if c), nblk)
        s = min(s, (length - f) // block_size)
        caches = _freeze_leading_blocks(caches, kvs, f, s, block_size,
                                        push_fn)
        if draft_ngram > 0:
            buffer = _suffix_match_draft(buffer, win, f, draft_ngram)
        f += s * block_size
        it += 1
        # Done once every row has a frozen end token, or all is frozen.
        done = f >= length or all(e < f for e in stats[nblk:])
    return _finish(buffer, length, end_token, start_token), it


def frontier_speculative_decode(window_hidden_fn: Callable,
                                project_fn: Callable, push_fn: Callable,
                                caches, batch_size: int, length: int, noise,
                                sampling: SamplingParams = SamplingParams(),
                                start_token: int = 1, end_token: int = 2,
                                window_tokens: int = 512,
                                block_size: int = 128,
                                max_iters: Optional[int] = None,
                                draft_ngram: int = 3, device=None):
    """Frontier speculative sampling: the window past each row's final
    prefix is a draft (the last pass's iterate, re-initialised by suffix
    matching); one window pass gives every position's filtered target
    distribution; left to right a drafted token is accepted with
    probability p(draft) and the first rejection resamples from the
    residual. A row's accepted prefix and its resampled token are final
    (the count is per row: a coin is consumed once, when its decision
    becomes final). Blocks final for every row freeze. The output is an
    exact sample of the AR sampling distribution; greedy gives the AR
    trajectory. Coins come from noise.fold(1), Gumbel noise from
    noise.fold(2), both keyed by block. Same plumbing as
    `frontier_jacobi_decode`. Returns (tokens [B, length], passes)."""
    w = window_tokens
    _check_window(length, w, block_size)
    nblk = w // block_size
    max_iters = max_iters or (length + length // nblk + 2)
    coin_noise, gumbel_noise = noise.fold(1), noise.fold(2)
    buf_len = length + w
    buffer = _new_buffer(batch_size, buf_len, start_token, device)
    pos = torch.arange(buf_len, device=buffer.device)
    rows = torch.arange(batch_size, device=buffer.device)
    wi = torch.arange(w, device=buffer.device)
    greedy = _is_greedy(sampling)
    n = torch.ones(batch_size, dtype=torch.int64, device=buffer.device)
    f, it = 0, 0

    def row_ended(buffer, n):
        """Rows with a final end_token (inside their first n[r])."""
        return ((buffer == end_token) & (pos[None, :] < n[:, None])).any(1)

    while it < max_iters:
        ended = row_ended(buffer, n)
        done, n_min = torch.stack([
            (ended | (n >= length)).all().to(torch.int64),
            torch.where(ended, buf_len, n).min()]).tolist()
        if done:
            break
        win = buffer[:, f:f + w].clone()
        hidden, kvs = window_hidden_fn(win, caches, f)
        # Freeze the blocks inside every row's final prefix (keeping one
        # final token in the window); ended rows never hold it back.
        s = min(max((n_min - f - 1) // block_size, 0), nblk,
                (length - f) // block_size)
        caches = _freeze_leading_blocks(caches, kvs, f, s, block_size,
                                        push_fn)
        logits = project_fn(hidden).float()
        v = logits.shape[-1]
        if sampling.repetition_penalty > 1.0:
            logits = _chunk_repetition_penalty(
                logits, buffer, f, sampling.repetition_penalty,
                sampling.repetition_window)
        lf = _filter_logits(logits, sampling)
        draft = buffer[:, f + 1:f + 1 + w]
        if greedy:
            res_choice = torch.argmax(lf, dim=-1)
            accept = draft == res_choice
        else:
            coins = _window_coins(coin_noise, f, batch_size, w, block_size)
            gum = _window_noise(gumbel_noise, f, batch_size, w, v,
                                block_size)
            accept, res_choice = _speculative_verify(
                lf, draft, coins.to(lf.device), gum.to(lf.device))
        # Decisions before each row's first live one (index n[r] - f - 1)
        # are final: force-accept them; ended rows accept everything.
        accept = accept | (wi[None, :] < (n[:, None] - f - 1)) \
            | ended[:, None]
        rejected = ~accept
        rejected_any = rejected.any(dim=1)
        j = torch.where(rejected_any,
                        torch.argmax(rejected.to(torch.int64), dim=1), w)
        jc = j.clamp(max=w - 1)
        tok_idx = f + jc + 1
        upd = torch.where(rejected_any,
                          res_choice.gather(1, jc[:, None])[:, 0],
                          buffer.gather(1, tok_idx[:, None])[:, 0])
        buffer[rows, tok_idx] = upd
        buffer = _mask_after_end(buffer, end_token, start_token)
        # Each row's final count: the accepted prefix and the resampled
        # token; a row accepted through the window's edge waits there.
        n_row = torch.where(rejected_any, f + jc + 2, f + w + 1)
        n = torch.maximum(n_row.clamp(max=length), n)
        if draft_ngram > 0:
            buffer = _suffix_match_draft(buffer, win, f, draft_ngram)
        f += s * block_size
        it += 1
    return _finish(buffer, length, end_token, start_token), it


def jacobi_decode(hidden_fn: Callable, project_fn: Callable,
                  batch_size: int, length: int, noise,
                  sampling: SamplingParams = SamplingParams(),
                  start_token: int = 1, end_token: int = 2,
                  max_iters: Optional[int] = None, chunk_size: int = 2048,
                  init_tokens=None, fused_select: bool = False,
                  device=None):
    """Iterate tokens -> select(project(hidden_fn(tokens))) to the fixed
    point over the whole document. hidden_fn: [B, L] -> [B, L, D] causal
    hidden states; project_fn: [B, C, D] -> [B, C, V]. Chunk ci's noise is
    noise.gumbel(ci, ...). init_tokens ([B, L] with the start token)
    resumes an earlier iterate. Returns (tokens [B, L], iterations)."""
    max_iters = max_iters or length
    if init_tokens is None:
        tokens = _new_buffer(batch_size, length, start_token, device)
    else:
        tokens = init_tokens.to(torch.int64).clone()
        tokens[:, 0] = start_token
    eff_chunk = min(chunk_size, length)
    num_chunks = -(-length // eff_chunk)
    pad = num_chunks * eff_chunk - length
    chosen = torch.zeros_like(tokens)
    dirty = [True] * num_chunks         # nothing selected yet
    it, converged = 0, False
    while not converged and it < max_iters:
        chosen = _select_chunked(hidden_fn(tokens), tokens, project_fn,
                                 sampling, noise, chunk_size,
                                 prev_chosen=chosen, dirty=dirty,
                                 fused=fused_select)
        # Position i + 1 takes the choice made at position i; the AR loop
        # never writes the last slot.
        new = _mask_after_end(torch.cat([tokens[:, :1], chosen[:, :-1]],
                                        dim=-1), end_token, start_token)
        new[:, -1] = 0
        diff = F.pad((new != tokens).any(dim=0), (0, pad))
        changed = diff.view(num_chunks, eff_chunk).any(dim=1).tolist()
        converged = not any(changed)
        # A chunk's selection reads tokens[0:(c + 1) * C]: dirty once any
        # chunk up to its own changed.
        dirty = [any(changed[:c + 1]) for c in range(num_chunks)]
        tokens = new
        it += 1
    return tokens, it
