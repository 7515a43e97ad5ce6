"""Token-budget batching by length bucket (port of
sparse_vae_tpu/data/batching.py).

Documents are rounded up to length buckets (multiples of
``pad_to_multiple_of``, coarser past ``coarsen_after`` multiples), and
every bucket has one batch shape, ``(tokens_per_batch // L, L)``, so
rows * L <= tokens_per_batch. Documents are shuffled within buckets and
the batches are shuffled, from one numpy Generator, so an epoch's batches
are a function of its seed; short final batches are padded with all-[PAD]
rows, which the loss masks out. Batches are numpy arrays on the host; the
trainer moves them to the device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, NamedTuple, Optional, Sequence

import numpy as np

from .native import pack_batch


class TextBatch(NamedTuple):
    """[B, L] int32 token ids (0 = [PAD]) and per-row token and byte
    counts; a row of padding has num_tokens == 0."""
    token_ids: np.ndarray   # [B, L] int32
    num_tokens: np.ndarray  # [B] int32, [CLS] and [SEP] included
    num_bytes: np.ndarray   # [B] int32, 0 for padding rows


def length_bucket(n_tokens: int, multiple: int = 512,
                  coarsen_after: int = 8) -> int:
    """A document length rounded up to its bucket: multiples of
    `multiple` up to coarsen_after * multiple tokens, then the
    granularity doubles each octave (multiples of 1024 up to 8192, and so
    on), which bounds the number of distinct batch shapes while padding
    stays under ~1/coarsen_after of a long document."""
    g = multiple
    while coarsen_after > 0 and n_tokens > coarsen_after * g:
        g *= 2
    return ((n_tokens + g - 1) // g) * g


@dataclass
class BatchPlan:
    """One batch to assemble: its bucket length, its row count and the
    documents in it (possibly fewer than rows; the rest are [PAD] rows)."""
    bucket_len: int
    rows: int
    doc_indices: List[int]


def plan_batches(lengths: Sequence[int], tokens_per_batch: int,
                 pad_to_multiple_of: int = 512,
                 rng: Optional[np.random.Generator] = None,
                 drop_remainder: bool = False,
                 rows_multiple_of: int = 1) -> List[BatchPlan]:
    """An epoch's batch plan. Each bucket yields batches of
    max(1, tokens_per_batch // bucket_len) rows (a multiple of
    rows_multiple_of when that is > 1); documents are shuffled within
    buckets and the batch list is shuffled. A corpus of at most four
    distinct lengths (such as concatenated streams, all of one length)
    gets exact `pad_to_multiple_of` buckets instead of the coarsened ones:
    102,400-token streams stay [1, 102400] rather than padding to
    114,688."""
    rng = rng or np.random.default_rng()
    lengths = np.asarray(lengths)
    if len(np.unique(lengths)) <= 4:
        m = pad_to_multiple_of
        buckets = ((lengths + m - 1) // m) * m
    else:
        buckets = np.array([length_bucket(int(n), pad_to_multiple_of)
                            for n in lengths])

    plans: List[BatchPlan] = []
    for bucket_len in np.unique(buckets):
        bucket_len = int(bucket_len)
        rows = max(1, tokens_per_batch // bucket_len)
        m = rows_multiple_of
        if m > 1:
            rows = max(m, (rows // m) * m)
        idx = np.flatnonzero(buckets == bucket_len)
        rng.shuffle(idx)
        for start in range(0, len(idx), rows):
            chunk = idx[start:start + rows]
            if drop_remainder and len(chunk) < rows:
                continue
            plans.append(BatchPlan(bucket_len=bucket_len, rows=rows,
                                   doc_indices=[int(i) for i in chunk]))
    order = rng.permutation(len(plans))
    return [plans[i] for i in order]


def collate(plan: BatchPlan, docs: Sequence[np.ndarray],
            num_bytes: Sequence[int]) -> TextBatch:
    """A TextBatch of the plan's shape from its documents (in plan order)
    and their byte counts, widened to int32 on the host."""
    out = np.zeros((plan.rows, plan.bucket_len), dtype=np.int32)
    n_tok = np.zeros(plan.rows, dtype=np.int32)
    n_byte = np.zeros(plan.rows, dtype=np.int32)
    for row, (doc, nb) in enumerate(zip(docs, num_bytes)):
        n = min(len(doc), plan.bucket_len)
        out[row, :n] = doc[:n].astype(np.int32)
        n_tok[row] = n
        n_byte[row] = nb
    return TextBatch(token_ids=out, num_tokens=n_tok, num_bytes=n_byte)


def iterate_epoch(corpus, tokens_per_batch: int,
                  pad_to_multiple_of: int = 512,
                  rng: Optional[np.random.Generator] = None,
                  drop_remainder: bool = False,
                  rows_multiple_of: int = 1) -> Iterator[TextBatch]:
    """The collated batches of one epoch over `corpus`, which exposes
    .lengths, .num_bytes and .get_docs(indices), and optionally
    .ensure_arena() (datasets.TokenizedCorpus), whose arena the batches
    are packed from."""
    plans = plan_batches(corpus.lengths, tokens_per_batch,
                         pad_to_multiple_of, rng, drop_remainder,
                         rows_multiple_of)
    arena = corpus.ensure_arena() if hasattr(corpus, "ensure_arena") \
        else None
    if arena is not None:
        for plan in plans:
            tokens, num_tokens = pack_batch(arena, plan.doc_indices,
                                            plan.rows, plan.bucket_len)
            nbytes = np.zeros(plan.rows, dtype=np.int32)
            nbytes[:len(plan.doc_indices)] = corpus.num_bytes[
                plan.doc_indices]
            yield TextBatch(tokens, num_tokens, nbytes)
        return
    for plan in plans:
        docs = corpus.get_docs(plan.doc_indices)
        nbytes = [int(corpus.num_bytes[i]) for i in plan.doc_indices]
        yield collate(plan, docs, nbytes)
