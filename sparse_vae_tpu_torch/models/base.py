"""Shared model hparams, device/dtype helpers and the compute-dtype rule.

Counterpart of sparse_vae_tpu/models/base.py: LanguageModelHparams, field
for field (so a run's meta.json and a preset read the same in both
packages), and `compute_dtype` (its initialisers are in models/init.py).

The compute-dtype rule is flax's `dtype=` semantics: a module computes in
the dtype of the activations it is given, whatever its parameters are
stored in. For training the parameters (and the optimizer state) are fp32
masters and the activations bf16, so `Linear` casts its weight and bias to
bf16 at use, and `LayerNorm` normalises in fp32 and rounds its output to
the activations' dtype. A model whose parameters are already in the
activations' dtype (serving in bf16, or an fp32 reference) computes
exactly as plain nn.Linear / nn.LayerNorm do.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

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
    grad_clip_threshold: float = 5.0
    init_scale: Optional[float] = 0.02   # models/init.py
    base_batch_size: int = 100_000       # sqrt-lr-scaling base
    lr: float = 2e-4
    lr_decay_steps: Optional[int] = 250_000
    start_token: Optional[int] = None    # None: the data's [CLS]
    end_token: Optional[int] = None
    early_stopping_metric: str = "val_nll"
    log_samples: bool = True
    weight_decay: float = 0.01
    lamb: bool = False
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


class Linear(nn.Linear):
    """nn.Linear in the dtype of its input: the weight and bias are cast
    at use (flax Dense with `dtype=`)."""

    def forward(self, x):
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class LayerNorm(nn.LayerNorm):
    """nn.LayerNorm whose statistics and affine run in the wider of the
    input's and the parameters' dtypes, with the output in the input's
    dtype (flax LayerNorm with `dtype=`: fp32 statistics, bf16 out)."""

    def forward(self, x):
        dt = torch.promote_types(x.dtype, self.weight.dtype)
        return F.layer_norm(x.to(dt), self.normalized_shape,
                            self.weight.to(dt), self.bias.to(dt),
                            self.eps).to(x.dtype)
