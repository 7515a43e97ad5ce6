"""Row-wise decode slices for continuous batching (port of the slice half
of sparse_vae_tpu/serving.py).

A slice runs at most `slice_steps` decode steps over a batch whose rows
each sit at their own position; the host harvests finished rows and
refills them between slices (server.py).
"""
from __future__ import annotations

from typing import Optional

import torch

from .models.generation import (RowDecodeState, SamplingParams,
                                decode_loop_rowwise, prev_tokens_rowwise)


def rowwise_family(module) -> bool:
    """Whether `module` supports per-row decode (continuous batching, the
    serving engine); returns is_vae: True for the Transformer-VAE
    (`decode_step_z_rowwise`), False for the Transformer LM
    (`decode_step_rowwise`). Any other model raises."""
    is_vae = hasattr(type(module), "decode_step_z_rowwise")
    if not is_vae and not hasattr(type(module), "decode_step_rowwise"):
        raise ValueError(
            f"{type(module).__name__} has no row-wise decode step — "
            "continuous batching serves the transformer families")
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
