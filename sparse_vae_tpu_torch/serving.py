"""Continuous-batching sampling (port of sparse_vae_tpu/serving.py).

The lockstep loop (models/generation.py `decode_loop`) moves a batch
until its slowest row ends, so at the mass-sampling scale (700,000
documents of <= 512 tokens at batch 1000) the rows that ended write
[PAD] while the stragglers finish. Here every row sits at its own position
(`RowDecodeState`): a bounded decode slice (`make_slice_fn`) runs at most
`slice_steps` steps, then the host harvests the rows that finished and
refills each with a fresh document (its own z, position 1). The caches
need no reset: their validity follows each row's index, and the new
document overwrites positions from 0 on. server.py drives the same slice
for online requests.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from .models.generation import (RowDecodeState, SamplingParams,
                                decode_generator, decode_loop_rowwise,
                                init_row_decode_state, prev_tokens_rowwise,
                                prior_z)


def rowwise_family(module) -> bool:
    """Whether `module` supports per-row decode (continuous batching, the
    serving engine); returns is_vae: True for the Transformer-VAE
    (`decode_step_z_rowwise`), False for the Transformer LM
    (`decode_step_rowwise`). Any other model raises, the LSTM families
    among them, as in the JAX package."""
    is_vae = hasattr(type(module), "decode_step_z_rowwise")
    if not is_vae and not hasattr(type(module), "decode_step_rowwise"):
        raise ValueError(
            f"{type(module).__name__} has no row-wise decode step — "
            "continuous batching supports the transformer families; LSTM "
            "models use the lockstep sample loop")
    return is_vae


def make_slice_fn(module, sampling: SamplingParams, end_token: int,
                  slice_steps: int, fused_select: bool):
    """The bounded decode slice of a Transformer-VAE or a Transformer LM:
    slice_fn(state, caches, z, overrides) -> (state, caches), with z
    [B, 1, latent_depth] per row for the VAE and None for the LM. Caches
    are updated in place."""
    is_vae = rowwise_family(module)

    @torch.inference_mode()
    def slice_fn(state: RowDecodeState, caches, z,
                 overrides: Optional[dict] = None):
        def logits_fn(st: RowDecodeState, caches):
            prev, pos = prev_tokens_rowwise(st), st.index - 1
            if is_vae:
                logits, caches = module.decode_step_z_rowwise(
                    prev, caches, pos, z)
            else:
                logits, caches = module.decode_step_rowwise(prev, caches,
                                                            pos)
            return logits.float(), caches

        return decode_loop_rowwise(state, logits_fn, caches, sampling,
                                   end_token, slice_steps,
                                   fused_select=fused_select,
                                   overrides=overrides)

    return slice_fn


def continuous_batch_sample(model, seed: int, num_samples: int,
                            max_length: int, batch_size: int,
                            sampling: SamplingParams = SamplingParams(),
                            start_token: int = 1, end_token: int = 2,
                            slice_steps: int = 256, z_pool=None,
                            fused_select: bool = True,
                            progress: bool = False) -> List[np.ndarray]:
    """Generate `num_samples` documents through `batch_size` continuously
    refilled rows of a Transformer-VAE or a Transformer LM.

    The decode noise comes from `generation.decode_generator(seed)`, the
    generator `sample(seed, ...)` uses, so with num_samples == batch_size
    and z_pool = that call's z the documents are `sample`'s. Document d's
    z is z_pool[d] ([num_samples, 1, latent_depth]) or, without a pool,
    `generation.prior_z(seed, 1, latent_depth, ..., d)`; an LM has none.
    Returns np.int32 token arrays in document order, each without the
    start token and with its end token when one was emitted."""
    is_vae = rowwise_family(model)
    latent = getattr(model.hparams, "latent_depth", 0)
    device = model.device

    def draw_z(doc: int):
        if z_pool is not None:
            return torch.as_tensor(z_pool[doc], dtype=torch.float32
                                   ).reshape(1, latent)
        return prior_z(seed, 1, latent, "cpu", doc)[0]

    caches = model.init_caches(batch_size, max_length)
    slice_fn = make_slice_fn(model, sampling, end_token, slice_steps,
                             fused_select)
    state = init_row_decode_state(batch_size, max_length, start_token,
                                  decode_generator(seed, device))
    z_host = torch.zeros((batch_size, 1, max(latent, 1)))
    assigned: List[Optional[int]] = [None] * batch_size
    live = torch.zeros(batch_size, dtype=torch.bool)
    next_doc = 0
    for b in range(min(batch_size, num_samples)):
        assigned[b] = next_doc
        if is_vae:
            z_host[b] = draw_z(next_doc)
        live[b] = True
        next_doc += 1
    state.live = live.to(device)
    z = z_host.to(device) if is_vae else None

    outputs: List[Optional[np.ndarray]] = [None] * num_samples
    pbar = None
    if progress:
        try:
            from tqdm import tqdm
            pbar = tqdm(desc="Generating samples", total=num_samples,
                        unit="samples", smoothing=0.1)
        except ImportError:
            pass

    while any(a is not None for a in assigned):
        state, caches = slice_fn(state, caches, z)
        tokens = state.tokens.cpu().numpy()
        index = state.index.cpu().numpy()
        live = state.live.cpu().numpy()
        refills = []
        for b in range(batch_size):
            if assigned[b] is None or live[b]:
                continue
            outputs[assigned[b]] = tokens[b, 1:index[b]].astype(np.int32)
            if pbar is not None:
                pbar.update(1)
            if next_doc < num_samples:
                assigned[b] = next_doc
                if is_vae:
                    z_host[b] = draw_z(next_doc)
                next_doc += 1
                refills.append(b)
            else:
                assigned[b] = None
        if refills:
            rows = torch.tensor(refills, device=device)
            with torch.inference_mode():
                state.tokens[rows] = 0
                state.tokens[rows, 0] = start_token
                state.index[rows] = 1
                state.live[rows] = True
                if is_vae:
                    z[rows] = z_host[refills].to(device)

    if pbar is not None:
        pbar.close()
    return outputs  # type: ignore[return-value]
