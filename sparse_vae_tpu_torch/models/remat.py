"""Rematerialisation of the decoder layers under `grad_checkpointing` (the
JAX package's `nn.remat` / `jax.checkpoint` with a named policy,
sparse_vae_tpu/models/transformer_lm.py `checkpoint_policy`).

A rematerialised layer keeps its inputs and what its policy names, and
runs its forward again in the backward for everything else:

- `full`: the inputs only;
- `dots`: also the outputs of the matrix products (every `Linear` of the
  layer and the MoE experts' two batched products: JAX's
  `dots_saveable`);
- `dots_attn`: also the attention kernel's (out, lse), so the backward
  does not launch the forward kernel again;
- `dots_attn_qkv`: also the head-major q/k/v the kernel reads (after the
  halo and [CLS] exchange under sequence parallelism, as in JAX);
- `offload`: the outputs of the products without batch dimensions (the
  `Linear`s: JAX's `offload_dot_with_no_batch_dims`), kept in pinned host
  memory instead of on the device and copied back in the recompute.

`checkpoint_layer` runs one layer under `torch.utils.checkpoint` (no
re-entrance), which drops what autograd saved in the forward and runs the
forward again in the backward to make it anew. The policies keep tensors
at the layer's own save points, not per operator: a `Linear` (`linear`),
the experts' products (`bmm`), the attention Functions' kernel forwards
(`kernel_forward`, ops/sliding_window_attention.py and ops/sp_kernel.py)
and the q/k/v copies (`keep_qkv`, ops/attention.py). The checkpoint's
context_fn hands the forward and the recompute one `_Pass` each over a
shared store. Inside the forward a save point of a kept kind stores its
output; inside the recompute it gives that output back, in the same
order, instead of computing it, and still saves for the backward what its
node needs, so the checkpoint sees the same saved tensors in both runs.
The products are autograd Functions whose backward is the one autograd
gives `F.linear` and `torch.bmm` (the same products in the same layouts),
so a kept product's gradients equal the recomputed one's bit for bit.
Outside a rematerialised layer, or under `full`, a save point is one
global read beside its computation.

The layer's dropout draws from an explicit generator, which the
checkpoint does not restore: the recompute sets the generator to its
state at the layer's start and gives it back its state afterwards, so the
masks are the forward's and the next step's do not move. The MoE balance
statistics are appended in the forward only. Under the `model` or `seq`
groups the recompute issues the layer's collectives again in the
backward, on every rank in the same order.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint, noop_context_fn

LINEAR, BMM, ATTN_OUT, ATTN_QKV = "linear", "bmm", "attn_out", "attn_qkv"

# The save point of the layer being run under a policy that keeps
# something: its forward or its recompute (checkpoint_layer); None
# elsewhere. The recompute runs on the autograd engine's thread while the
# caller waits, so one layer is active at a time.
_ACTIVE: Optional["_Pass"] = None


@dataclass(frozen=True)
class RematPolicy:
    """What a rematerialised layer keeps: `saved`, the kinds of save
    point whose outputs stay on the device; `offloaded`, those whose
    outputs go to pinned host memory. Neither: the inputs alone
    (`full`)."""
    name: str
    saved: frozenset = frozenset()
    offloaded: frozenset = frozenset()

    def context_fn(self):
        """The (forward, recompute) contexts of `torch.utils.checkpoint`."""
        if not (self.saved or self.offloaded):
            return noop_context_fn()
        store: list = []
        return _Pass(self, store, False), _Pass(self, store, True)


POLICIES = {
    "full": RematPolicy("full"),
    "dots": RematPolicy("dots", saved=frozenset({LINEAR, BMM})),
    "dots_attn": RematPolicy("dots_attn",
                             saved=frozenset({LINEAR, BMM, ATTN_OUT})),
    "dots_attn_qkv": RematPolicy(
        "dots_attn_qkv", saved=frozenset({LINEAR, BMM, ATTN_OUT, ATTN_QKV})),
    "offload": RematPolicy("offload", offloaded=frozenset({LINEAR})),
}


def checkpoint_policy(name: str) -> RematPolicy:
    """The named rematerialisation policy of grad_checkpointing: 'full',
    'dots', 'dots_attn', 'dots_attn_qkv' or 'offload' (above: what each
    keeps); any other name raises ValueError, as in JAX. The decoder
    layers of both transformer families and the pipeline stages
    (parallel/pp.py) share it."""
    if name not in POLICIES:
        raise ValueError(f"remat_policy {name!r} not in {sorted(POLICIES)}")
    return POLICIES[name]


class _Pass:
    """One run of a rematerialised layer, the forward or the recompute,
    over the store the two share: the forward appends each kept output
    (a pinned host copy for an offloaded kind), the recompute takes them
    back in order."""

    def __init__(self, policy: RematPolicy, store: list, recompute: bool):
        self.policy, self.store, self.recompute = policy, store, recompute
        self.index = 0

    def __enter__(self):
        global _ACTIVE
        self.outer, _ACTIVE, self.index = _ACTIVE, self, 0
        return self

    def __exit__(self, *exc):
        global _ACTIVE
        _ACTIVE = self.outer
        return False

    def keeps(self, kind: str) -> bool:
        return kind in self.policy.saved or kind in self.policy.offloaded

    def put(self, kind: str, tensors: tuple) -> None:
        if kind in self.policy.offloaded:
            self.store.append(tuple(_to_host(t) for t in tensors))
        else:
            self.store.append(tuple((t.detach(), None) for t in tensors))

    def take(self) -> tuple:
        if self.index >= len(self.store):
            raise RuntimeError("the recompute of a rematerialised layer "
                               "reached a save point its forward did not")
        kept = self.store[self.index]
        self.index += 1
        return tuple(t.detach() if device is None
                     else t.to(device, non_blocking=True)
                     for t, device in kept)


def _to_host(t: torch.Tensor) -> tuple:
    if t.device.type != "cuda":
        return t.detach().clone(), t.device
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host, t.device


def _point(kind: str) -> Optional[_Pass]:
    active = _ACTIVE
    return active if active is not None and active.keeps(kind) else None


def kernel_forward(compute) -> tuple:
    """compute() -> (out, lse) of an attention kernel's forward, called by
    its autograd Function: kept under dots_attn and dots_attn_qkv, so the
    recompute does not launch the kernel again."""
    point = _point(ATTN_OUT)
    if point is None:
        return compute()
    if point.recompute:
        return point.take()
    out = compute()
    point.put(ATTN_OUT, out)
    return out


class _KeptLinear(torch.autograd.Function):
    """F.linear(x, weight, bias) whose output a policy keeps. The
    backward is autograd's for F.linear: addmm on x flattened to rows
    (mm without a bias), the weight's gradient as gᵀx, the bias's the
    rows' sum."""

    @staticmethod
    def forward(ctx, point, x, weight, bias):
        if point.recompute:
            (y,) = point.take()
        else:
            y = F.linear(x, weight, bias)
            point.put(LINEAR, (y,))
        ctx.save_for_backward(x, weight)
        ctx.has_bias = bias is not None
        return y

    @staticmethod
    def backward(ctx, grad):
        x, weight = ctx.saved_tensors
        g = grad.reshape(-1, grad.shape[-1])
        dx = dw = db = None
        if ctx.needs_input_grad[1]:
            dx = g.mm(weight).reshape(x.shape)
        if ctx.needs_input_grad[2]:
            dw = g.t().mm(x.reshape(-1, x.shape[-1]))
        if ctx.has_bias and ctx.needs_input_grad[3]:
            # The rows' sum; a strided x of three or more dimensions took
            # matmul and add_ in F.linear, whose bias sums every leading
            # dimension of the gradient.
            db = (grad.sum(tuple(range(grad.dim() - 1)))
                  if x.dim() > 2 and not x.is_contiguous() else g.sum(0))
        return None, dx, dw, db


def linear(x, weight, bias=None):
    """F.linear, kept by the products' policies inside a rematerialised
    layer (models/base.py `Linear` calls it)."""
    point = _point(LINEAR)
    if point is None:
        return F.linear(x, weight, bias)
    return _KeptLinear.apply(point, x, weight, bias)


class _KeptBmm(torch.autograd.Function):
    """torch.bmm(a, b) whose output a policy keeps; the backward is
    autograd's for bmm."""

    @staticmethod
    def forward(ctx, point, a, b):
        if point.recompute:
            (y,) = point.take()
        else:
            y = torch.bmm(a, b)
            point.put(BMM, (y,))
        ctx.save_for_backward(a, b)
        return y

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        da = grad.bmm(b.transpose(1, 2)) if ctx.needs_input_grad[1] else None
        db = a.transpose(1, 2).bmm(grad) if ctx.needs_input_grad[2] else None
        return None, da, db


def bmm(a, b):
    """torch.bmm, kept by the products' policies inside a rematerialised
    layer (the MoE experts' products, models/moe.py)."""
    point = _point(BMM)
    if point is None:
        return torch.bmm(a, b)
    return _KeptBmm.apply(point, a, b)


def _copy(x):
    return x.clone(memory_format=torch.contiguous_format)


class _KeptCopies(torch.autograd.Function):
    """Contiguous copies of the q/k/v an attention reads, kept by
    dots_attn_qkv (JAX's `attn_qkv` names); the backward passes the
    gradients through, as a copy's does."""

    @staticmethod
    def forward(ctx, point, *xs):
        if point.recompute:
            return point.take()
        out = tuple(_copy(x) for x in xs)
        point.put(ATTN_QKV, out)
        return out

    @staticmethod
    def backward(ctx, *grads):
        return (None,) + grads


def keep_qkv(*tensors) -> tuple:
    """The head-major (or packed) q/k/v an attention kernel reads: under
    dots_attn_qkv, contiguous copies the recompute takes back instead of
    making them again; elsewhere the tensors as they are."""
    point = _point(ATTN_QKV)
    if point is None:
        return tensors
    return _KeptCopies.apply(point, *tensors)


def checkpoint_layer(fn, remat: RematPolicy, *args,
                     generator: Optional[torch.Generator] = None,
                     moe_stats: Optional[list] = None, **kwargs):
    """fn(*args, generator=, moe_stats=, **kwargs) rematerialised under
    `remat`: args are the tensors (or None) the checkpoint keeps, kwargs
    the rest. The recompute draws the forward's dropout masks from
    `generator` and leaves it where it found it; moe_stats is appended to
    by the forward only."""
    start = None if generator is None else generator.get_state()
    runs = 0

    def run(*inputs):
        nonlocal runs
        recompute, runs = runs > 0, runs + 1
        saved = None
        if recompute and generator is not None:
            saved = generator.get_state()
            generator.set_state(start)
        try:
            return fn(*inputs, generator=generator,
                      moe_stats=None if recompute else moe_stats, **kwargs)
        finally:
            if saved is not None:
                generator.set_state(saved)

    return checkpoint(run, *args, use_reentrant=False,
                      context_fn=remat.context_fn)
