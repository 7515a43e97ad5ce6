"""Rectified Adam with an optional LAMB trust ratio, behind a global-norm
clip (port of sparse_vae_tpu/training/optimizer.py: `radam`,
`optax.clip_by_global_norm` and `make_optimizer`'s chain with the cosine
schedule).

- The variance-rectification term rho_t with an SGD-momentum fallback
  while rho_t <= 4: steps 1-4 take the fallback (rho_1 = 1.0,
  rho_4 = 3.997, rho_5 = 4.996), so a comparison of fewer than six steps
  never tests the rectified branch.
- The rectified lr multiplier r_t * sqrt(1 - b2^t) scales both the Adam
  direction and the decoupled weight decay, which applies to every
  parameter, biases and LayerNorms included.
- LAMB clamps each parameter's norm into [0.01, 10] for its trust ratio.
- On a mesh whose parameters are sharded (parallel/tp.py, ep.py) the
  clip's norm comes from `norm_fn`, which sums the shards' squares over
  their group (`clip_by_tp_global_norm` / the EP twin in the JAX
  package), so every rank clips by the same, exact norm; LAMB's
  per-parameter trust ratios are refused there, as in the JAX package.
- One global step counter; the schedule is evaluated at the 1-indexed
  step. The step's scalars are computed in fp32 and the update is
  rounded where the reference rounds it (update = -lr_eff * (wd * p + d),
  then p + update), so the port follows its arithmetic step for step.
"""
from __future__ import annotations

from typing import Callable, Optional, Union

import numpy as np
import torch

from ..utils.schedules import (cosine_decay_factor,
                               cosine_decay_with_warmup_factor)


def global_norm(tensors) -> torch.Tensor:
    """The l2 norm of all tensors together, in fp32."""
    return torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(t.float()) for t in tensors]))


class RAdam(torch.optim.Optimizer):
    """RAdam/LAMB over fp32 parameters, with the global-norm clip of
    `clip_threshold` applied to the gradients first (optax semantics: the
    gradients are scaled by threshold / norm unless norm < threshold).
    `step()` returns the unclipped global gradient norm, `norm_fn(grads)`
    (default `global_norm`) of the gradients in parameter order."""

    def __init__(self, params, lr: Union[float, Callable[[int], float]],
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-6,
                 weight_decay: float = 0.01, lamb: bool = False,
                 clip_threshold: Optional[float] = None,
                 norm_fn: Optional[Callable] = None):
        super().__init__(params, dict(lr=lr))
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay, self.lamb = weight_decay, lamb
        self.clip_threshold = clip_threshold
        self.norm_fn = norm_fn or global_norm
        self.count = 0

    def _params(self):
        return [p for group in self.param_groups for p in group["params"]]

    def state_tensors(self) -> dict:
        """{"count": steps taken, "exp_avg": [...], "exp_avg_sq": [...]},
        the moments in parameter order (empty before the first step): the
        whole state of the optimizer, the lr being a function of count."""
        params = [p for p in self._params() if self.state[p]]
        return {"count": self.count,
                "exp_avg": [self.state[p]["exp_avg"] for p in params],
                "exp_avg_sq": [self.state[p]["exp_avg_sq"] for p in params]}

    def load_state_tensors(self, state: dict):
        """Restore what `state_tensors` gave, copied into new tensors on
        each parameter's device."""
        params = self._params()
        if state["exp_avg"] and len(state["exp_avg"]) != len(params):
            raise ValueError(f"{len(state['exp_avg'])} moments for "
                             f"{len(params)} parameters")
        self.state.clear()
        for p, m, v in zip(params, state["exp_avg"], state["exp_avg_sq"]):
            self.state[p]["exp_avg"] = m.to(p.device, copy=True)
            self.state[p]["exp_avg_sq"] = v.to(p.device, copy=True)
        self.count = int(state["count"])

    @torch.no_grad()
    def step(self, closure=None):
        params = self._params()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in params]
        norm = self.norm_fn(grads)
        if self.clip_threshold is not None and not bool(
                norm < self.clip_threshold):
            grads = [g / norm * self.clip_threshold for g in grads]

        self.count += 1
        f32 = np.float32
        step = f32(self.count)
        lr = self.param_groups[0]["lr"]
        lr = f32(lr(self.count) if callable(lr) else lr)
        b1, b2 = self.b1, self.b2
        b2_t, b1_t = f32(b2) ** step, f32(b1) ** step
        bc_v, bc_m = np.sqrt(f32(1.0) - b2_t), f32(1.0) - b1_t
        rho_inf = f32(2.0 / (1.0 - b2) - 1.0)
        rho_t = rho_inf - f32(2.0) * step * b2_t / (f32(1.0) - b2_t)
        rectified = bool(rho_t > 4.0)
        if rectified:
            r_t_sq = ((rho_t - f32(4.0)) * (rho_t - f32(2.0)) * rho_inf) / (
                (rho_inf - f32(4.0)) * (rho_inf - f32(2.0))
                * max(rho_t, f32(1e-6)))
            lr_eff = lr * np.sqrt(abs(r_t_sq)) * bc_v
        else:
            lr_eff = lr
        lr_eff, bc_v, bc_m = float(lr_eff), float(bc_v), float(bc_m)

        for p in params:
            if not self.state[p]:
                self.state[p]["exp_avg"] = torch.zeros_like(p)
                self.state[p]["exp_avg_sq"] = torch.zeros_like(p)
        ms = [self.state[p]["exp_avg"] for p in params]
        vs = [self.state[p]["exp_avg_sq"] for p in params]
        torch._foreach_mul_(ms, b1)
        torch._foreach_add_(ms, grads, alpha=1.0 - b1)
        torch._foreach_mul_(vs, b2)
        torch._foreach_addcmul_(vs, grads, grads, value=1.0 - b2)
        if rectified:
            denom = torch._foreach_sqrt(vs)
            torch._foreach_div_(denom, bc_v)
            torch._foreach_add_(denom, self.eps)
            dirs = torch._foreach_div(ms, denom)
        else:
            dirs = [m.clone() for m in ms]
        torch._foreach_div_(dirs, bc_m)

        if self.lamb:
            for p, d in zip(params, dirs):
                u = -self.weight_decay * p - d
                p_norm = torch.linalg.vector_norm(p).clamp(0.01, 10.0)
                trust = p_norm / torch.linalg.vector_norm(u).clamp_min(1e-12)
                p.add_(lr_eff * trust * u)
        else:
            # p <- p + (-lr_eff * (weight_decay * p + direction))
            torch._foreach_add_(dirs, torch._foreach_mul(
                params, self.weight_decay))
            torch._foreach_mul_(dirs, -lr_eff)
            torch._foreach_add_(params, dirs)
        return norm


def make_optimizer(params, lr: float, lr_decay_steps: Optional[int],
                   grad_clip_threshold: float, weight_decay: float = 0.01,
                   lamb: bool = False, warmup_steps: int = 0,
                   tp_size: int = 1, ep_size: int = 1,
                   norm_fn: Optional[Callable] = None) -> RAdam:
    """The training chain: global-norm clip at grad_clip_threshold, then
    RAdam stepping a cosine-decayed lr (with linear warmup when
    warmup_steps > 0). With tp_size or ep_size > 1 the parameters are a
    rank's shards: `norm_fn` gives the exact global norm
    (parallel.spmd.mesh_norm_fn), and LAMB raises."""
    if (tp_size > 1 or ep_size > 1) and lamb:
        raise NotImplementedError(
            "LAMB trust ratios are per-param norms and would be wrong on "
            "model- or expert-sharded params (each shard would compute a "
            "different ratio from its local slice); use lamb=False with "
            "tensor/expert parallelism")
    if lr_decay_steps:
        if warmup_steps:
            def schedule(step):
                return lr * cosine_decay_with_warmup_factor(
                    step, lr_decay_steps, warmup_steps)
        else:
            def schedule(step):
                return lr * cosine_decay_factor(step, lr_decay_steps)
    else:
        schedule = lr
    return RAdam(params, schedule, weight_decay=weight_decay, lamb=lamb,
                 clip_threshold=grad_clip_threshold, norm_fn=norm_fn)
