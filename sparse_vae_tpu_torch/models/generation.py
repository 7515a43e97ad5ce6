"""Batched decoding state machines (port of
sparse_vae_tpu/models/generation.py).

The lockstep loop (`DecodeState`, `decode_loop`) moves every row of the
batch one position a step from [CLS]: `sample` of all four families,
`sample_resumable` of the transformer families and the mass-sampling
path run on it. Finished rows keep flowing through the step and write
[PAD]. The position is a host int, the same for every row.

The row-wise loop (`RowDecodeState`, `decode_loop_rowwise`) gives every
row its own position, so a serving loop can harvest finished rows and
refill them between bounded decode slices (serving.py, server.py).

Random draws come from an explicit torch.Generator held in the state: the
Gumbel noise for a sampled step is drawn as uniforms and transformed, so a
test can hand the same noise to the JAX reference and to this port
(`noise=` of process_logits and process_logits_rowwise).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import torch

from ..ops.select_kernel import nucleus_gumbel_argmax
from ..utils.seeds import derived_seed


# The streams of a sampling seed (utils.seeds.derived_seed keys).
Z_STREAM, DECODE_STREAM = 0, 1


def decode_generator(seed: int, device) -> torch.Generator:
    """The decode noise's generator of sampling seed `seed`, on `device`."""
    return torch.Generator(device=device).manual_seed(
        derived_seed(seed, DECODE_STREAM))


def prior_z(seed: int, batch_size: int, latent_depth: int, device,
            *keys: int):
    """z ~ N(0, I) [batch_size, 1, latent_depth] fp32 on `device`, drawn on
    the CPU from sampling seed `seed` (and `keys`, e.g. a document
    number), so that every device gets the same z."""
    gen = torch.Generator().manual_seed(derived_seed(seed, Z_STREAM, *keys))
    return torch.randn((batch_size, 1, latent_depth),
                       generator=gen).to(device)


class KeyedNoise:
    """Noise that is a pure function of an integer key, for the parallel
    and speculative decoders (models/parallel_decode.py,
    models/spec_decode.py): `gumbel(key, shape)` and `uniform(key, shape)`
    draw from a torch.Generator on `device` seeded with
    derived_seed(seed, *path, key), so drawing one key twice gives the
    same tensor, and `fold(key)` names a sub-stream (the role of JAX's
    fold_in). The decoders key a position's noise by its block or chunk
    and a pass's draws by the pass; a test hands them any object with
    these three methods, such as one built on JAX's keys."""

    def __init__(self, seed: int, device, path: tuple = (DECODE_STREAM,)):
        self.seed, self.device, self.path = seed, device, path

    def fold(self, key: int) -> "KeyedNoise":
        return KeyedNoise(self.seed, self.device, (*self.path, key))

    def uniform(self, key: int, shape):
        """Uniforms in [tiny, 1), as jax.random.uniform(minval=tiny)."""
        gen = torch.Generator(device=self.device).manual_seed(
            derived_seed(self.seed, *self.path, key))
        u = torch.rand(shape, generator=gen, device=self.device,
                       dtype=torch.float32)
        return u.clamp_(min=torch.finfo(torch.float32).tiny)

    def gumbel(self, key: int, shape):
        return gumbel_from_uniform(self.uniform(key, shape))


@dataclass(frozen=True)
class SamplingParams:
    """Decode hyperparameters (the reference's defaults)."""
    top_k: int = 0
    top_p: float = 0.9
    temperature: float = 1.0
    repetition_penalty: float = 1.2
    repetition_window: int = 512


@dataclass
class DecodeState:
    tokens: torch.Tensor   # [B, max_len] int64 output buffer; [CLS] at 0
    index: int             # next position to write, the same for every row
    live: torch.Tensor     # [B] bool: still-generating rows
    rng: torch.Generator   # on the state's device


def init_decode_state(batch_size: int, max_length: int, start_token: int,
                      rng: torch.Generator) -> DecodeState:
    tokens = torch.zeros((batch_size, max_length), dtype=torch.int64,
                         device=rng.device)
    tokens[:, 0] = start_token
    return DecodeState(tokens=tokens, index=1,
                       live=torch.ones(batch_size, dtype=torch.bool,
                                       device=rng.device), rng=rng)


def prev_tokens(state: DecodeState):
    """[B] most recently generated token."""
    return state.tokens[:, state.index - 1]


def apply_repetition_penalty(logits, tokens, index: int, penalty: float,
                             window: int):
    """apply_repetition_penalty_rowwise with every row at `index`: the
    slice starts at max(index - window, 0), clamped to max_len - window as
    JAX's dynamic slice clamps it."""
    rows = torch.full((tokens.shape[0],), index, dtype=torch.int64,
                      device=tokens.device)
    return apply_repetition_penalty_rowwise(logits, tokens, rows, penalty,
                                            window)


@dataclass
class RowDecodeState:
    tokens: torch.Tensor   # [B, max_len] int64 per-row output buffer
    index: torch.Tensor    # [B] int64: each row's next position to write
    live: torch.Tensor     # [B] bool: frozen rows await harvest/refill
    rng: torch.Generator   # on the state's device
    # Optional [B] per-row position cap: a row freezes once index reaches it.
    row_max: Optional[torch.Tensor] = None
    # Optional [B] per-row prompt length in index space: positions below it
    # are forced from the pre-written token buffer instead of sampled.
    prompt_len: Optional[torch.Tensor] = None


def init_row_decode_state(batch_size: int, max_length: int, start_token: int,
                          rng: torch.Generator) -> RowDecodeState:
    device = rng.device
    tokens = torch.zeros((batch_size, max_length), dtype=torch.int64,
                         device=device)
    tokens[:, 0] = start_token
    return RowDecodeState(
        tokens=tokens,
        index=torch.ones(batch_size, dtype=torch.int64, device=device),
        live=torch.ones(batch_size, dtype=torch.bool, device=device),
        rng=rng)


def gumbel_from_uniform(u):
    """Gumbel(0, 1) noise from uniforms in [tiny, 1), as jax.random.gumbel
    transforms its uniforms."""
    return -torch.log(-torch.log(u))


def gumbel_noise(shape, rng: torch.Generator):
    u = torch.rand(shape, generator=rng, device=rng.device,
                   dtype=torch.float32)
    return gumbel_from_uniform(u.clamp_(min=torch.finfo(torch.float32).tiny))


def _row_gather(buf, idx):
    return buf.gather(1, idx[:, None])[:, 0]


def prev_tokens_rowwise(state: RowDecodeState):
    """[B] token each row generated last (at its own index - 1)."""
    return _row_gather(state.tokens, state.index - 1)


def apply_repetition_penalty_rowwise(logits, tokens, index, penalty,
                                     window: int):
    """Divide (or, for negative logits, multiply) by `penalty` the logits
    of the tokens in each row's lookback window ending at ITS index.
    penalty is a float or a [B, 1] tensor. Slots past the index hold
    [PAD] = 0, whose penalisation is harmless."""
    max_len = tokens.shape[-1]
    window = min(window, max_len)
    starts = (index - window).clamp(0, max_len - window)           # [B]
    cols = starts[:, None] + torch.arange(window, device=tokens.device)
    prev = tokens.gather(1, cols)
    prev_logits = logits.gather(1, prev)
    penalized = torch.where(prev_logits < 0.0, prev_logits * penalty,
                            prev_logits / penalty)
    return logits.scatter(1, prev, penalized)


def top_p_filter(logits, top_p, num_iters: int = 24):
    """Nucleus filtering by threshold bisection (no vocab sort): mask the
    logits whose probability is below the largest threshold t that keeps
    mass >= top_p; the most probable token always survives. top_p is a
    float or a [B, 1] tensor."""
    probs = torch.softmax(logits, dim=-1)
    pmax = probs.amax(dim=-1, keepdim=True)
    lo, hi = torch.zeros_like(pmax), pmax
    for _ in range(num_iters):
        mid = (lo + hi) * 0.5
        mass = torch.where(probs >= mid, probs, 0.0).sum(dim=-1,
                                                         keepdim=True)
        raise_ = mass >= top_p
        lo = torch.where(raise_, mid, lo)
        hi = torch.where(raise_, hi, mid)
    keep = (probs >= lo) | (probs == pmax)
    return logits.masked_fill(~keep, float("-inf"))


def _select_token_rows(logits, noise, params: SamplingParams,
                       overrides: dict):
    """Token selection with PER-ROW temperature / top_p ([B] tensors in
    `overrides`; params fill whatever is absent). Per-row temperature
    <= 0 means greedy for that row; top_p >= 1 disables the nucleus for
    that row. noise: [B, V] Gumbel noise (categorical = Gumbel-max)."""
    b = logits.shape[0]
    temp = overrides.get("temperature")
    if temp is None:
        temp = torch.full((b,), params.temperature, device=logits.device)
    top_p = overrides.get("top_p")
    if top_p is None:
        top_p = torch.full((b,), params.top_p, device=logits.device)
    scaled = logits / temp.clamp(min=1e-6)[:, None]
    if params.top_k > 1:
        kth = torch.topk(scaled, params.top_k, dim=-1).values[..., -1:]
        scaled = scaled.masked_fill(scaled < kth, float("-inf"))
    filtered = top_p_filter(scaled, top_p[:, None])
    scaled = torch.where((top_p >= 1.0)[:, None], scaled, filtered)
    sampled = torch.argmax(scaled + noise, dim=-1)
    greedy = (temp <= 0.0) | (params.top_k == 1)
    return torch.where(greedy, torch.argmax(logits, dim=-1), sampled)


def _is_greedy(params: SamplingParams) -> bool:
    return params.temperature <= 0.0 or params.top_k == 1


def _select_token(logits, noise, params: SamplingParams, fused: bool):
    """Shared token selection: temperature, top-k, nucleus (bisection or
    the fused K4 kernel), greedy. logits: [B, V] -> [B] int64; noise:
    [B, V] Gumbel noise, unused (and may be None) when greedy."""
    if _is_greedy(params):
        return torch.argmax(logits, dim=-1)
    if fused and params.top_k == 0 and 0.0 < params.top_p < 1.0:
        return nucleus_gumbel_argmax(
            logits.float().contiguous(), noise, top_p=params.top_p,
            temperature=params.temperature)
    logits = logits / params.temperature
    if params.top_k > 0:
        kth = torch.topk(logits, params.top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if params.top_p < 1.0:
        logits = top_p_filter(logits, params.top_p)
    return torch.argmax(logits + noise, dim=-1)


def process_logits(logits, state: DecodeState, params: SamplingParams,
                   end_token: int, fused: bool = True,
                   noise=None) -> DecodeState:
    """One lockstep decode step on the logits [B, V] for position
    state.index: penalise, select (through K4 where the params are
    nucleus-only, as the JAX package's fused path; fused=False takes the
    bisection of its unfused path), write the token
    (finished rows write [PAD]) and advance. noise: optional [B, V]
    Gumbel noise; by default it is drawn from state.rng when the step
    samples. The token buffer is written in place."""
    if noise is None and not _is_greedy(params):
        noise = gumbel_noise(logits.shape, state.rng)
    if params.repetition_penalty > 1.0:
        logits = apply_repetition_penalty(
            logits, state.tokens, state.index, params.repetition_penalty,
            params.repetition_window)
    token = torch.where(state.live, _select_token(logits, noise, params,
                                                  fused), 0)
    state.tokens[:, state.index] = token
    max_len = state.tokens.shape[-1]
    live = state.live & (token != end_token) & (state.index + 1 < max_len)
    return replace(state, index=state.index + 1, live=live)


def should_continue(state: DecodeState) -> bool:
    """Whether another lockstep step runs: a free position before the
    buffer's last and a live row (one host synchronisation)."""
    return (state.index < state.tokens.shape[-1] - 1
            and bool(state.live.any()))


def final_output(state: DecodeState):
    """The token buffer without the start token: [B, max_len - 1]."""
    return state.tokens[:, 1:]


def process_logits_rowwise(logits, state: RowDecodeState,
                           params: SamplingParams, end_token: int,
                           fused: bool = True,
                           overrides: Optional[dict] = None,
                           noise=None) -> RowDecodeState:
    """One decode step: penalise, select, write each row's token at its
    own index, and advance only live rows. noise: optional [B, V] Gumbel
    noise; by default it is drawn from state.rng when the step samples.
    overrides: optional per-row [B] sampling parameters."""
    sampled = overrides is not None or not _is_greedy(params)
    if noise is None and sampled:
        noise = gumbel_noise(logits.shape, state.rng)
    if overrides is not None:
        pen = overrides.get("repetition_penalty")
        if pen is None:
            pen = torch.full((logits.shape[0],), params.repetition_penalty,
                             device=logits.device)
        # A penalty of 1.0 is an exact no-op, so it always applies here.
        logits = apply_repetition_penalty_rowwise(
            logits, state.tokens, state.index, pen[:, None],
            params.repetition_window)
        token = _select_token_rows(logits, noise, params, overrides)
    else:
        if params.repetition_penalty > 1.0:
            logits = apply_repetition_penalty_rowwise(
                logits, state.tokens, state.index,
                params.repetition_penalty, params.repetition_window)
        token = _select_token(logits, noise, params, fused)
    token = torch.where(state.live, token, 0)

    max_len = state.tokens.shape[-1]
    forced = None
    if state.prompt_len is not None:
        # Inside its prompt a row's token comes from the pre-written
        # buffer, and a forced token never ends the row.
        forced = state.live & (state.index < state.prompt_len)
        token = torch.where(forced, _row_gather(state.tokens, state.index),
                            token)
    tokens = state.tokens.scatter(1, state.index[:, None], token[:, None])
    index = state.index + state.live.to(torch.int64)
    ended = token == end_token
    if forced is not None:
        ended = ended & ~forced
    live = state.live & ~ended & (index < max_len - 1)
    if state.row_max is not None:
        live = live & (index < state.row_max)
    return replace(state, tokens=tokens, index=index, live=live)


def decode_loop_rowwise(state: RowDecodeState, logits_fn, carry,
                        params: SamplingParams, end_token: int,
                        max_steps: int, fused_select: bool = True,
                        overrides: Optional[dict] = None):
    """Bounded per-row decode slice: at most `max_steps` steps, stopping
    early once no row is live. logits_fn(state, carry) -> (logits,
    carry). Returns the resumable (state, carry)."""
    for _ in range(max_steps):
        if not bool(state.live.any()):
            break
        logits, carry = logits_fn(state, carry)
        state = process_logits_rowwise(logits, state, params, end_token,
                                       fused=fused_select,
                                       overrides=overrides)
    return state, carry


def decode_loop(state: DecodeState, logits_fn, carry,
                params: SamplingParams, end_token: int,
                max_steps: Optional[int] = None,
                fused_select: bool = True):
    """Lockstep AR decode: logits_fn(state, carry) -> (logits [B, V] fp32,
    carry) and a step, until every row has emitted `end_token` or the
    buffer is full. max_steps bounds this call to that many positions and
    leaves the returned (state, carry) resumable by calling again: a run
    in slices gives the one-shot result (long documents decode as a host
    loop of bounded calls)."""
    stop = None if max_steps is None else state.index + max_steps
    while should_continue(state) and (stop is None or state.index < stop):
        logits, carry = logits_fn(state, carry)
        state = process_logits(logits, state, params, end_token,
                               fused=fused_select)
    return state, carry
