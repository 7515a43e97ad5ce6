"""Shared model hparams and device/dtype helpers.

Counterpart of sparse_vae_tpu/models/base.py: the LanguageModelHparams
fields the serving slice reads, and `compute_dtype`.
"""
from __future__ import annotations

from dataclasses import dataclass
import torch

VOCAB_SIZE = 2 ** 15

# Special token ids of the project's tokenizer
# (sparse_vae_tpu/data/tokenizer.py).
PAD_ID = 0
CLS_ID = 1
SEP_ID = 2

# flax.linen.LayerNorm's epsilon (torch's default is 1e-5).
LAYER_NORM_EPS = 1e-6


@dataclass
class LanguageModelHparams:
    vocab_size: int = VOCAB_SIZE


def compute_dtype(precision: str) -> torch.dtype:
    return torch.bfloat16 if precision == "bf16" else torch.float32


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on. CUDA is the default; asking for
    it without a card raises instead of quietly running on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return device
