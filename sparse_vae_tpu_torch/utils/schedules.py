"""Step-indexed schedules as pure functions of the step counter (port of
sparse_vae_tpu/utils/schedules.py): the cosine learning-rate decay, with
and without linear warmup, the linear KL-weight annealing, and the
square-root learning-rate scaling by tokens per step. Steps and results
are Python floats; the optimizer evaluates them on the host once a step.
"""
from __future__ import annotations

import math


def cosine_decay_factor(step, decay_steps: int) -> float:
    """Cosine decay from 1 to 0 over `decay_steps`; 0 afterwards."""
    progress = min(step / max(1, decay_steps), 1.0)
    return max(0.0, 0.5 * (1.0 + math.cos(math.pi * progress)))


def cosine_decay_with_warmup_factor(step, decay_steps: int,
                                    warmup_steps: int) -> float:
    """Linear warmup, then cosine decay."""
    if step < warmup_steps:
        return step / max(1, warmup_steps)
    progress = (step - warmup_steps) / max(1, decay_steps - warmup_steps)
    progress = min(progress, 1.0)
    return max(0.0, 0.5 * (1.0 + math.cos(math.pi * progress)))


def kl_weight_schedule(step, start: float, end: float,
                       annealing_steps: int) -> float:
    """Linear KL annealing from `start` to `end` over `annealing_steps`;
    constant `end` when annealing_steps <= 0."""
    if annealing_steps <= 0:
        return float(end)
    progress = min(step / annealing_steps, 1.0)
    return start + (end - start) * progress


def scaled_lr(base_lr: float, tokens_per_step: int,
              base_batch_size: int) -> float:
    """Square-root learning-rate scaling against a base token batch:
    lr * (tokens / base) ** 0.5."""
    return base_lr * (tokens_per_step / base_batch_size) ** 0.5
