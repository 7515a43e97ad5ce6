"""The token arena and the batch packer of the host data path (port of
sparse_vae_tpu/data/native.py, its numpy path).

`TokenArena` holds a corpus as one contiguous uint16 token array with
[n_docs + 1] uint64 offsets, built from ragged documents. `pack_batch` widens and pads a batch's
documents into the [rows, L] int32 batch, and `bucket_lengths` rounds
lengths up to a multiple. Both are the numpy versions of the JAX
package's C++ packer (native/packer.cc) and give the same bytes; this
package does not bind that library yet.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np


class TokenArena:
    """Contiguous uint16 token storage with [n_docs + 1] offsets."""

    def __init__(self, tokens: np.ndarray, offsets: np.ndarray):
        if tokens.dtype != np.uint16 or offsets.dtype != np.uint64:
            raise TypeError(f"tokens must be uint16 and offsets uint64, "
                            f"not {tokens.dtype} and {offsets.dtype}")
        self.tokens = tokens
        self.offsets = offsets

    @classmethod
    def from_docs(cls, docs: Sequence[np.ndarray]) -> "TokenArena":
        lengths = np.array([len(d) for d in docs], dtype=np.uint64)
        offsets = np.zeros(len(docs) + 1, dtype=np.uint64)
        np.cumsum(lengths, out=offsets[1:])
        tokens = np.empty(int(offsets[-1]), dtype=np.uint16)
        for i, d in enumerate(docs):
            tokens[int(offsets[i]):int(offsets[i + 1])] = d
        return cls(tokens, offsets)

    @property
    def lengths(self) -> np.ndarray:
        return (self.offsets[1:] - self.offsets[:-1]).astype(np.int64)

    def doc(self, i: int) -> np.ndarray:
        return self.tokens[int(self.offsets[i]):int(self.offsets[i + 1])]


def pack_batch(arena: TokenArena, doc_indices: Sequence[int], rows: int,
               bucket_len: int):
    """([rows, bucket_len] int32 batch, [rows] int32 num_tokens): document
    r of `doc_indices` in row r, cut at bucket_len; the other rows and
    positions [PAD] (0)."""
    out = np.zeros((rows, bucket_len), dtype=np.int32)
    num_tokens = np.zeros((rows,), dtype=np.int32)
    for r, i in enumerate(np.asarray(doc_indices, dtype=np.int64)):
        doc = arena.doc(int(i))
        n = min(len(doc), bucket_len)
        out[r, :n] = doc[:n].astype(np.int32)
        num_tokens[r] = n
    return out, num_tokens


def bucket_lengths(lengths: np.ndarray, multiple: int) -> np.ndarray:
    """Each length rounded up to a multiple of `multiple`."""
    lengths = np.ascontiguousarray(lengths, dtype=np.int64)
    return ((lengths + multiple - 1) // multiple) * multiple
