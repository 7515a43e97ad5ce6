"""Token-level cross-entropy losses (port of
sparse_vae_tpu/ops/cross_entropy.py): `token_nll` and
`chunked_cross_entropy`, the projection + CE over sequence chunks that
never holds more than one chunk's logits, and `chunked_nll_rows`, its
per-row sums. They are the plain yardstick of
the fused K3/K3b path (ops/ce_kernel.py), which the model takes when the
kernels are on.
"""
from __future__ import annotations

from typing import Callable, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


def token_nll(logits, labels, reduce: bool = True):
    """Mean NLL over non-pad labels (label 0 is padding), or with
    reduce=False the masked per-token NLL and the mask."""
    log_probs = torch.log_softmax(logits.float(), dim=-1)
    nll = -log_probs.gather(-1, labels[..., None])[..., 0]
    mask = (labels != 0).float()
    if not reduce:
        return nll * mask, mask
    return (nll * mask).sum() / mask.sum().clamp_min(1.0)


def _chunk_loss(project_fn, h, y):
    logits = project_fn(h).float()
    lse = torch.logsumexp(logits, dim=-1)
    label_logit = logits.gather(-1, y[..., None])[..., 0]
    mask = (y != 0).float()
    return ((lse - label_logit) * mask).sum(-1), mask.sum()


def chunked_nll_rows(hidden, project_fn: Callable, labels,
                     chunk_size: int = 2048
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Output projection + CE over sequence chunks. hidden: [B, L, D];
    project_fn maps [B, C, D] to [B, C, V] logits; labels: [B, L].
    Returns (per-row NLL sums [B], token_count) over non-pad labels. Each
    chunk's logits are recomputed in the backward pass (the reference's
    remat of the chunk body), so only one chunk's logits ever exist."""
    b, length, _ = hidden.shape
    pad = (-length) % chunk_size
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
    rows = hidden.new_zeros((b,), dtype=torch.float32)
    count = hidden.new_zeros((), dtype=torch.float32)
    for i in range(0, hidden.shape[1], chunk_size):
        h, y = hidden[:, i:i + chunk_size], labels[:, i:i + chunk_size]
        if torch.is_grad_enabled() and h.requires_grad:
            r, c = checkpoint(_chunk_loss, project_fn, h, y,
                              use_reentrant=False)
        else:
            r, c = _chunk_loss(project_fn, h, y)
        rows = rows + r
        count = count + c
    return rows, count


def chunked_cross_entropy(hidden, project_fn: Callable, labels,
                          chunk_size: int = 2048
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(nll_sum, token_count) over non-pad labels: `chunked_nll_rows`
    summed over the rows."""
    rows, count = chunked_nll_rows(hidden, project_fn, labels, chunk_size)
    return rows.sum(), count
