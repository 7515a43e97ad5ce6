"""Seeded random training batches: the stand-in for the corpus pipeline
until the tokenizer and the corpus pipeline of sparse_vae_tpu/data/ are
ported, as the JAX package's bench.py trains on random ids.

Each row is one document: [CLS], random ids in [3, V), [SEP], then [PAD]
(0). Lengths are ragged: row 0 fills the row, the others are drawn
uniformly from [min_tokens, seq]. The row length is the longest document
rounded up to `pad_to_multiple_of` (the run's data hparam), so
`num_tokens` (the real token count, [CLS] and [SEP] included) drives the
per-document KL normalisation as on real data.

The ragged distribution has no source in real traffic: it is there so
that padding, masking and the per-document normalisation run. With
`min_tokens=seq` every row is full, which is the JAX train bench's
traffic (bench.py: `num_tokens = L` for every row); that is what
profile_train measures.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models.base import CLS_ID, SEP_ID


def synthetic_batch(rng: np.random.Generator, batch: int, seq: int,
                    vocab: int, pad_to_multiple_of: int = 512,
                    min_tokens: int = 512, device="cpu") -> dict:
    """{"token_ids": [batch, L] int64, "num_tokens": [batch] int64} with
    L = seq rounded up to pad_to_multiple_of."""
    length = -(-seq // pad_to_multiple_of) * pad_to_multiple_of
    lengths = rng.integers(min(min_tokens, seq), seq + 1, size=batch)
    lengths[0] = seq
    ids = np.zeros((batch, length), np.int64)
    for row, n in enumerate(lengths):
        ids[row, 0] = CLS_ID
        ids[row, 1:n - 1] = rng.integers(3, vocab, size=n - 2)
        ids[row, n - 1] = SEP_ID
    return {"token_ids": torch.from_numpy(ids).to(device),
            "num_tokens": torch.from_numpy(lengths.astype(np.int64)).to(
                device)}
