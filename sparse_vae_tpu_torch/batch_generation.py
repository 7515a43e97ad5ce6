"""Mass sampling sink (port of sparse_vae_tpu/batch_generation.py): call
a batched sample function repeatedly, stream its rows into one
preallocated host buffer, then trim each row after its first end token.
"""
from __future__ import annotations

from typing import Callable, List, Optional

import numpy as np
import torch


def batch_generate_samples(sample_fn: Callable[[int], torch.Tensor],
                           num_samples: int, max_length: int,
                           end_token: Optional[int] = 2,
                           progress: bool = True) -> List[np.ndarray]:
    """sample_fn(batch_index) -> tokens [B, max_length - 1] (a tensor on
    any device, or an array). Returns num_samples np.int32 rows, each
    trimmed after its first end_token (kept); end_token None keeps whole
    rows."""
    buffer = np.zeros((num_samples, max_length - 1), dtype=np.int32)
    pbar = None
    if progress:
        try:
            from tqdm import tqdm
            pbar = tqdm(desc="Generating samples", total=num_samples,
                        unit="samples", smoothing=0.1)
        except ImportError:
            pass

    cur, call = 0, 0
    while cur < num_samples:
        ready = torch.as_tensor(sample_fn(call)).cpu().numpy()
        call += 1
        n = min(len(ready), num_samples - cur)
        buffer[cur:cur + n] = ready[:n]
        cur += n
        if pbar is not None:
            pbar.update(n)
    if pbar is not None:
        pbar.close()

    outputs: List[np.ndarray] = []
    for row in buffer:
        if end_token is not None:
            ends = np.flatnonzero(row == end_token)
            if len(ends):
                row = row[:ends[0] + 1]
        outputs.append(row)
    return outputs
