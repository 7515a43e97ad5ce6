#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (sparse_vae_tpu_torch) on one NVIDIA
GPU:

    python3 chip_smoke.py [--k4-parent DIR]

Phases, each timed:
  1. device  — the card's name and power limit (nvidia-smi); exits non-zero
               without CUDA;
  2. build   — the CUDA kernels from csrc/, one nvcc process per source,
               all started together, then one link; the `ptxas info`
               lines (nvcc -Xptxas -v) give registers, spills and static
               shared memory of every kernel;
  3. kernels — each kernel against its plain PyTorch version on the card,
               at the shapes the serving path gives it, timed with CUDA
               events beside its bound and, for K1, beside PyTorch's
               scaled_dot_product_attention (a yardstick the port never
               calls); K1's rows also give its device time from
               torch.profiler, without the wrapper's host cost;
               The training kernels likewise: K2 (the attention backward)
               and K3/K3b (the fused tied projection + CE, forward and
               backward) against their plain versions at the token counts
               of the train, sp-train and [8, 12800] steps, timed at the
               last beside a PyTorch yardstick; K2, K3 and K3b must give
               bit-identical results in two calls, and the K2 and K3b
               rows give their device time by part (K2: dq, dk/dv with the
               [CLS] partials, reduce, PyTorch; K3b: dl, dg, dE, dbias,
               PyTorch's copies); K4 (the selection) at the serving batch
               [64, 32768] (T 1.0 and 0.7) and at a 512-token Jacobi
               window's [512, 32768], by events and torch.profiler beside
               its bound, and for correctness alone at [1, 512],
               [133, 32768] and [3, 50000], without noise and at top_p
               1e-3 too, every row bit-identical across two calls; its
               two instantiations (a cluster of two CTAs a row, one CTA a
               row) timed against each other at 16 to 2,048 rows;
               with --k4-parent DIR, DIR's K4 (another checkout's
               csrc/nucleus_select.cu) is built alone into this
               checkout's _build/ and timed beside this one at the timed
               shapes, in the order parent, this, this, parent;
  4. model   — the flagship real-prose-vae-r5 weights on the card in bf16:
               prefill logits against the fp32 CPU model on a fixed input;
  5. serve   — ServeEngine (batch 64, max_length 512, fused selection)
               answers requests, some with >= 128-token prompts so bulk
               prefill runs K1; every request must complete and both
               kernels' launch counts, zeroed just before, must rise;
  6. train   — r5 in its training form (fp32 master weights, bf16
               compute) at full width and depth takes optimizer steps on
               [4, 4096] ragged random documents through K1, K2, K3 and
               K3b (their counts, zeroed just before, must rise); step 1's
               loss and all 165 gradients are held against the same step
               in fp32 through the plain versions on the card.
The Dh = 128 geometry (bench.py --heads 4, built from the JAX
initialisation with no archive; its decoder attention takes the packed
layout):
  7. kernels — K5 and K5b (the packed attention forward and backward:
               K1's kernel and K2's kernels at Dh = 128 on the packed
               layout) against their fp32 plain versions at three shapes
               up to [8, 12800, 4 * 128] on full rows, each timed by CUDA
               events and by torch.profiler's device time beside its bound
               and SDPA (forward and backward) under the band mask; K5b
               bit-identical across two calls, its device time by part as
               K2's;
  8. serve   — ServeEngine answers the same requests through bulk prefill
               (K5) and fused selection (K4); the bf16 prefill logits are
               held against the fp32 plain model on the card;
  9. train   — 3 optimizer steps at [4, 4096] through K5, K5b, K3 and K3b
               (K5 and K5b 6 launches a step), step 1 held against the fp32
               plain step as in phase 6.
Sequence parallelism, r5 at the pg19 preset's document shape (one
102,400-token document per micro-batch, 4 length shards of 25,600):
 10. kernels — K6 (the shard attention: one K1 launch with q_off and the
               broadcast [CLS] block as a slot of its own; its backward
               one K2 launch set with the same slot) forward and backward
               against its plain version on the banded branch at the shard
               shape q [1, 8, 25600, 64] over k_ext [1, 8, 25728, 64], on
               the square branch (shard 0), on ragged rows with a partial
               [CLS] (77 keys) and a filler row, and at windows 1 and 3;
               the backward bit-identical across two calls, and on a
               banded shard the profiled forward K1's kernel alone and the
               backward K2's kernels alone (no cuBLAS, no aten
               elementwise); timed beside its bound and SDPA over
               [CLS | k_ext] under the boolean band mask (a yardstick the
               port never calls);
 11. sp-train — one unsharded kernel step of r5 on a seeded document
               [1, 102400] (K1/K2 at [1, 8, 102400, 64]), then 4 ranks
               spawned on this card (gloo: they share it) take the same
               step with the same weights, document and eps, and 2 more;
               the same pair again in fp32 through the plain versions.
               fp32: all 165 summed gradients at cosine >= 0.99, loss to
               1e-5; kernels: loss within 1e-3 relative, gradients at
               cosine >= 0.99 wherever the unsharded kernel step is itself
               that close to fp32 (see sp_train_phase); parameters bitwise
               equal across ranks, K6 launched on ranks 1-3, K1/K2 on rank
               0, K3/K3b on every rank.
No path may route a call to a plain version: on the card such a route
raises, and every path's `plain_routes` counters must stay 0.
Then one {"kernels": [...]} JSON line, the nvidia-smi line, and last
{"ok": true, "device": {...}}. Any failed check raises: no result line.
"""
from __future__ import annotations

import ctypes
import functools
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

# The run writes nothing into the checkout but the kernel library
# (sparse_vae_tpu_torch/_build/): no bytecode caches either.
sys.dont_write_bytecode = True

import numpy as np
import torch
import torch.nn.functional as F

from sparse_vae_tpu_torch import profile_train
from sparse_vae_tpu_torch.checkpoint import load_run, model_from_hparams
from sparse_vae_tpu_torch.models.base import SEP_ID
from sparse_vae_tpu_torch.models.generation import (SamplingParams,
                                                    gumbel_noise)
from sparse_vae_tpu_torch.ops import (ce_kernel, cuda_lib, launches,
                                      select_kernel, sp_kernel, swa_kernel)
from sparse_vae_tpu_torch.ops.sliding_window_attention import (
    sliding_window_attention_bwd_plain,
    sliding_window_attention_packed_bwd_plain,
    sliding_window_attention_packed_plain, sliding_window_attention_plain)
from sparse_vae_tpu_torch.server import ServeEngine
from sparse_vae_tpu_torch.parallel.group import choose_backend, spawn
from sparse_vae_tpu_torch.train import bench_hparams, build_from_hparams
from sparse_vae_tpu_torch.train import build as build_training
from sparse_vae_tpu_torch.train import sp_pad_multiple, train_rank
from sparse_vae_tpu_torch.training.data import synthetic_batch
from sparse_vae_tpu_torch.training.train_step import train_step

RUN = "real-prose-vae-r5"
# H100 SXM published peaks (NVIDIA data sheet, dense, at 700 W).
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
FP32_FLOPS = 67e12

# K1: out is compared in bf16: both sides round the softmax weights to bf16
# before the value product and the output to bf16 after it, in other
# summation orders (bf16 roundings of values of order 1); lse is fp32 on
# both sides and differs only by summation order.
K1_OUT_ATOL, K1_OUT_RTOL = 2e-2, 2e-2
K1_LSE_ATOL = 1e-3
# K4: a row may choose differently only when its bisection mass sat within
# fp32 summation rounding of the target at some step (relative margin
# below this) or its chosen token's p sits on the threshold.
K4_FLIP_MARGIN = 1e-4
# Model: the bf16 card path against the fp32 CPU path after 6 layers.
MODEL_MEAN_ABS_TOL = 0.25
MODEL_ARGMAX_AGREE = 0.9
# K2 and K3b: bf16 gradients against the fp32 plain versions, the largest
# error relative to the largest entry: one bf16 rounding of each output
# (2^-9) plus, in K3b, the rounding of the logit gradients to bf16 before
# the products, as the JAX kernel rounds them.
GRAD_REL_TOL = 1e-2
# K3: fp32 lse and nll, summation order over 32,768 logits.
K3_ATOL = 1e-4
# Train: the bf16 kernel step against the fp32 plain step: the loss within
# 0.1% relative (bf16 rounding of the activations; a fault in a share of
# the tokens, such as mis-masked padding, moves it by more), and every one
# of the 165 gradients at cosine >= 0.99.
TRAIN_LOSS_RTOL = 1e-3
TRAIN_GRAD_COS = 0.99
# Document lengths of the [8, 12800] training-shape kernel timings: full
# rows, the JAX train bench's traffic (bench.py: num_tokens = L).
TRAIN_LENGTHS = [12800] * 8
# The Dh = 128 model (bench.py --heads 4): its bf16 prefill logits against
# the fp32 plain model on the card, the largest |difference| relative to
# the largest |logit|: bf16 rounding of the activations through 6 layers
# and the head, about 1e-2 on an H100 (0.0243 of a largest |logit| of
# 2.37); the bound is three times that reading. Argmax agreement is not
# held here: the logits of a freshly initialised model are nearly flat,
# so which token is largest says little. K5/K5b's own checks carry the
# weight for the kernels.
MODEL_H4_REL_TOL = 3e-2
H4_SEED = 0          # the torch.Generator of the Dh = 128 initialisation
# Sequence parallelism: the pg19 preset's document (102,400 tokens, batch
# 1) over 4 length shards. K6's tolerances are K1's (out, lse) and K2's
# (gradients); the sharded step against the unsharded kernel step as the
# train phases hold the kernel step against the plain one.
SP = 4
SP_SEQ = 102400
SP_SEED = 21
# The fp32 plain sharded step against the fp32 plain unsharded one:
# summation order only (both 13.867570877 on an H100).
SP_FP32_LOSS_RTOL = 1e-5
# Where the unsharded bf16 kernel step is itself below TRAIN_GRAD_COS
# against the fp32 step (the encoder bottleneck's near-zero gradients at
# 102,400 tokens: 0.699 on an H100), the sharded kernel step may be no
# farther from fp32 than it, less this margin (bf16 noise of two
# different summation orders: 0.696 was measured beside that 0.699).
SP_NOISY_MARGIN = 0.05


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        print(f"[{self.name}] start", flush=True)
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        status = "failed" if exc[0] else "done"
        print(f"[{self.name}] {status} in {dt:.2f} s", flush=True)
        return False


def check(ok: bool, what: str):
    if not ok:
        raise AssertionError(what)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds of fn() over `iters` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 10) -> dict:
    """Device milliseconds per call of fn() by kernel name, from
    torch.profiler over `iters` calls after one warm-up call: what the card
    spent, without the host's share of the call's time
    (profile_train.per_call_device_ms, which tolerates a dropped kernel
    record; a trace that lost more is taken again)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(profile_train.TRACE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        averages = prof.key_averages()
        times = profile_train.per_call_device_ms(averages, iters)
        if times is not None:
            return times
        launched, recorded = profile_train.kernel_records(averages)
        print(f"profiler trace incomplete: {recorded} kernel records for "
              f"{launched} launches; taken again", flush=True)
    raise AssertionError(f"the profiler dropped kernel records in "
                         f"{profile_train.TRACE_ATTEMPTS} traces running")


def kernel_ms(times: dict, name: str) -> float:
    """The device ms of the kernels whose name contains `name`."""
    return sum(ms for key, ms in times.items() if name in key)


def bound(nbytes: float, ops: float, op_rate: float):
    byte_ms = nbytes / HBM_BYTES_PER_S * 1e3
    op_ms = ops / op_rate * 1e3
    return (byte_ms, "bytes") if byte_ms >= op_ms else (op_ms, "operations")


def device_phase() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}",
          flush=True)
    # Full fp32 for the plain versions' fp32 products.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return smi


def build_phase():
    cuda_lib.library()
    info = cuda_lib.build_info
    print(f"library {info.path.name}: nvcc {info.seconds:.1f} s", flush=True)
    for line in info.ptxas_log.splitlines():
        if "ptxas" in line:
            print(f"  {line.strip()}")


def band_mask(L: int, lengths, window: int, block: int, device):
    """[B, 1, L, L] bool: causal band of `window` blocks + [CLS] block +
    key prefix, the token mask the K1 kernel applies."""
    pos = torch.arange(L, device=device)
    qb, kb = pos[:, None] // block, pos[None, :] // block
    mask = ((qb - kb < window) | (kb == 0)) & (pos[None, :] <= pos[:, None])
    keys = pos[None, :] < lengths[:, None]
    return (mask[None] & keys[:, None, :])[:, None]


def k1_phase(b: int, L: int, lengths, seed: int, iters: int):
    h, d, window, block = 8, 64, 2, 128
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn((b, h, L, d), generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    key_mask = torch.arange(L, device="cuda")[None, :] < lens[:, None]
    out, lse = swa_kernel.swa_fwd(q, k, v, lens, window_size=window,
                                  block_size=block, causal=True)
    torch.cuda.synchronize()
    ref, ref_lse = sliding_window_attention_plain(
        q, k, v, key_mask, window_size=window, block_size=block,
        causal=True, return_lse=True)
    err = (out.float() - ref.float()).abs()
    lse_err = (lse - ref_lse).abs().max().item()
    check(bool(torch.isfinite(out.float()).all()), "K1 out is not finite")
    check(bool((err <= K1_OUT_ATOL + K1_OUT_RTOL * ref.float().abs()).all()),
          f"K1 out disagrees with its plain version: max {err.max():.3g}")
    check(lse_err <= K1_LSE_ATOL, f"K1 lse disagrees: {lse_err:.3g}")

    mask = band_mask(L, lens, window, block, "cuda")
    ms = cuda_ms(lambda: swa_kernel.swa_fwd(q, k, v, lens,
                                            window_size=window,
                                            block_size=block), iters)
    plain_ms = cuda_ms(lambda: sliding_window_attention_plain(
        q, k, v, key_mask, window_size=window, block_size=block),
        max(3, iters // 10))
    library_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=mask), max(3, iters // 10))
    device = kernel_ms(device_ms(lambda: swa_kernel.swa_fwd(
        q, k, v, lens, window_size=window, block_size=block)),
        "swa_fwd_kernel")
    pairs = int(mask.sum().item()) * h      # attended (query, key) pairs
    nbytes = 4 * q.numel() * 2 + lse.numel() * 4 + lens.numel() * 4
    bound_ms, bound_by = bound(nbytes, 4 * d * pairs, BF16_TENSOR_FLOPS)
    row = {"shape": [b, h, L, d], "lengths": list(lengths),
           "max_abs_err": err.max().item(), "lse_max_abs_err": lse_err,
           "ms": ms, "device_ms": device, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": bound_ms,
           "bound_by": bound_by}
    print("K1 " + json.dumps(row), flush=True)
    return row


class ParentK4:
    """Another tree's K4 (`--k4-parent DIR`): DIR's csrc/nucleus_select.cu
    built alone into this checkout's _build/k4_parent/ (DIR is only read)
    and called through the same C entry, so that a run can time it beside
    this tree's kernel on the same card."""

    def __init__(self, root: str):
        src = (Path(root).resolve() / "sparse_vae_tpu_torch" / "csrc"
               / "nucleus_select.cu")
        out = cuda_lib.BUILD_DIR / "k4_parent" / "libk4_parent.so"
        out.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run([cuda_lib._nvcc(), "-gencode",
                        "arch=compute_90a,code=sm_90a", "-std=c++17",
                        "-O3", "-Xcompiler", "-fPIC", "-shared", "-I",
                        str(src.parent), "-o", str(out), str(src)],
                       check=True, timeout=cuda_lib.NVCC_TIMEOUT_S)
        self.fn = ctypes.CDLL(str(out)).svt_nucleus_select
        self.fn.argtypes = cuda_lib._SIGNATURES["svt_nucleus_select"]
        self.fn.restype = ctypes.c_int

    def __call__(self, s, noise, top_p: float, temperature: float):
        out = torch.empty(s.shape[0], dtype=torch.int64, device=s.device)
        code = self.fn(s.data_ptr(),
                       None if noise is None else noise.data_ptr(),
                       out.data_ptr(), s.shape[0], s.shape[1], top_p,
                       temperature, select_kernel.NUM_ITERS,
                       torch.cuda.current_stream().cuda_stream)
        check(code == 0, f"the parent's K4 failed: CUDA error {code}")
        return out


def k4_on(cluster: int):
    """This tree's K4 on one instantiation (`svt_nucleus_select_on`: 2 a
    cluster of two CTAs a row, 1 one CTA a row), outside the wrapper and
    its launch count."""
    fn = cuda_lib.library().svt_nucleus_select_on

    def call(s, noise, top_p: float, temperature: float):
        out = torch.empty(s.shape[0], dtype=torch.int64, device=s.device)
        code = fn(s.data_ptr(), None if noise is None else noise.data_ptr(),
                  out.data_ptr(), s.shape[0], s.shape[1], top_p,
                  temperature, select_kernel.NUM_ITERS, cluster,
                  torch.cuda.current_stream().cuda_stream)
        check(code == 0, f"K4 on instantiation {cluster} failed: CUDA "
              f"error {code}")
        return out
    return call


def k4_agrees(got, s, noise, kw: dict):
    """K4's choices against the plain version's: a row may differ only
    where its bisection margin is below K4_FLIP_MARGIN or its chosen
    token's p sits on the threshold. Returns (the rows excused, the largest
    index difference on the others, the tokens the plain version keeps)."""
    n = s.shape[0]
    ref, thresh, margin = select_kernel.select_rows_plain(s, noise, **kw)
    differ = (got != ref).nonzero().flatten().tolist()
    t = kw["temperature"]
    scaled = s / t if t != 1.0 and t > 0.0 else s
    p_un = torch.exp(scaled - scaled.amax(dim=-1, keepdim=True))
    flips = []
    for r in differ:
        on_edge = any(abs(p_un[r, i].item() - thresh[r].item())
                      <= 1e-5 * thresh[r].item()
                      for i in (int(got[r]), int(ref[r])))
        if margin[r].item() < K4_FLIP_MARGIN or on_edge:
            flips.append(r)
    check(len(flips) == len(differ),
          f"K4 at {list(s.shape)} disagrees with its plain version on rows "
          f"{sorted(set(differ) - set(flips))}")
    held = torch.ones(n, dtype=torch.bool, device=s.device)
    held[flips] = False
    max_err = (got[held] - ref[held]).abs().max().item() if held.any() \
        else 0.0
    kept = int(((p_un >= thresh[:, None]) | (p_un == 1.0)).sum().item())
    return flips, max_err, kept


def k4_bound(s, noise, top_p: float, temperature: float, kept: int):
    """K4's least time on these inputs. Bytes: every logit once, the noise
    of the kept tokens only (all of it without a nucleus), one int64 a
    row. Operations as the function computes them: a divide an element
    when T != 1; with a nucleus max, subtract, exp and sum, a compare and
    a bin add an element at each histogram level, two compares to keep,
    then a noise add and a compare a kept token; without one, a noise add
    and a compare an element."""
    n, v = s.shape
    nucleus = 0.0 < top_p < 1.0
    noise_bytes = 0 if noise is None else 4 * (kept if nucleus else n * v)
    nbytes = 4 * n * v + noise_bytes + 8 * n
    per_element = int(temperature != 1.0 and temperature > 0.0)
    if nucleus:
        levels = min(3, -(-select_kernel.NUM_ITERS // 8))
        ops = n * v * (per_element + 6 + 2 * levels) + 2 * kept
    else:
        ops = n * v * (per_element + 1 + (noise is not None))
    return bound(nbytes, ops, FP32_FLOPS)


def k4_phase(temperature: float, seed: int, iters: int, n: int = 64,
             vocab: int = 32768, top_p: float = 0.9,
             with_noise: bool = True, parent: ParentK4 | None = None):
    """K4 against its plain version, and bit for bit across two calls;
    with iters > 0 also timed by events and torch.profiler beside its
    bound, and beside `parent` in the order parent, this, this, parent."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    # Peaked like a language model's logits, so the nucleus is a small set.
    s = 4.0 * torch.randn((n, vocab), generator=gen, device="cuda")
    noise = gumbel_noise((n, vocab), gen) if with_noise else None
    kw = {"top_p": top_p, "temperature": temperature}
    got = select_kernel.nucleus_gumbel_argmax(s, noise, **kw)
    again = select_kernel.nucleus_gumbel_argmax(s, noise, **kw)
    torch.cuda.synchronize()
    check(torch.equal(got, again), f"K4 at {[n, vocab]} gave other choices "
          f"in a second call on the same inputs")
    flips, max_err, kept = k4_agrees(got, s, noise, kw)
    row = {"shape": [n, vocab], "temperature": temperature, "top_p": top_p,
           "noise": with_noise, "max_abs_err": max_err,
           "ulp_flip_rows": len(flips), "bit_identical": True,
           "kept_tokens": kept}
    if iters:
        def kernel():
            return select_kernel.nucleus_gumbel_argmax(s, noise, **kw)

        ms = cuda_ms(kernel, iters)
        device = kernel_ms(device_ms(kernel), "nucleus_select")
        plain_ms = cuda_ms(lambda: select_kernel.nucleus_gumbel_argmax_plain(
            s, noise, **kw), max(3, iters // 10))
        bound_ms, bound_by = k4_bound(s, noise, top_p, temperature, kept)
        row.update({"ms": ms, "device_ms": device, "plain_ms": plain_ms,
                    "library_ms": None, "bound_ms": bound_ms,
                    "bound_by": bound_by})
        if parent is not None:
            def old():
                return parent(s, noise, top_p, temperature)

            turns = (("parent", old), ("this", kernel), ("this", kernel),
                     ("parent", old))
            timed = [(name, cuda_ms(fn, iters),
                      kernel_ms(device_ms(fn), "nucleus_select"))
                     for name, fn in turns]
            row["pccp"] = {
                "order": [name for name, _, _ in timed],
                "ms": [ms for _, ms, _ in timed],
                "device_ms": [dev for _, _, dev in timed]}
            for key, at in (("ms", 1), ("device_ms", 2)):
                row[f"parent_{key}"] = (timed[0][at] + timed[3][at]) / 2
    print("K4 " + json.dumps(row), flush=True)
    return row


def k4_instantiations(seed: int, iters: int,
                      rows=(16, 64, 100, 512, 2048)):
    """K4's two instantiations timed against each other on the same inputs
    ([rows, 32768], T 1.0, noise, top_p 0.9; turns cluster, one CTA, one
    CTA, cluster), each held against the plain version: the measurement
    behind svt_nucleus_select's rule (a cluster while 2 rows <= SMs)."""
    kw = {"top_p": 0.9, "temperature": 1.0}
    table = {}
    for i, n in enumerate(rows):
        gen = torch.Generator(device="cuda").manual_seed(seed + i)
        s = 4.0 * torch.randn((n, 32768), generator=gen, device="cuda")
        noise = gumbel_noise(s.shape, gen)
        entry = {}
        calls = {name: functools.partial(k4_on(cluster), s, noise, **kw)
                 for name, cluster in (("cluster", 2), ("one_cta", 1))}
        for name, call in calls.items():
            flips, _, _ = k4_agrees(call(), s, noise, kw)
            entry[name] = {"ulp_flip_rows": len(flips), "ms": [],
                           "device_ms": []}
        for name in ("cluster", "one_cta", "one_cta", "cluster"):
            call = calls[name]
            entry[name]["ms"].append(cuda_ms(call, iters))
            entry[name]["device_ms"].append(
                kernel_ms(device_ms(call), "nucleus_select"))
        for name in ("cluster", "one_cta"):
            for key in ("ms", "device_ms"):
                entry[name][key] = sum(entry[name][key]) / 2
        table[str(n)] = entry
    print("K4 instantiations " + json.dumps(table), flush=True)
    return table


def model_phase(model, seed: int = 0, length: int = 256):
    """Prefill logits of the card model (bf16, K1) against the fp32 CPU
    model (plain attention) on one fixed input."""
    cpu_model, _, _ = load_run(RUN, device="cpu", dtype=torch.float32)
    rng = np.random.default_rng(seed)
    vocab = model.hparams.vocab_size
    ids = rng.integers(3, vocab, size=(1, length))
    ids[0, 0] = 1
    ids[0, 200:] = 0                                   # right padding
    z = rng.standard_normal((1, 1, model.hparams.latent_depth))
    ids_t = torch.tensor(ids)
    z_t = torch.tensor(z, dtype=torch.float32)
    with torch.inference_mode():
        got = model.reconstruct(ids_t.cuda(), z_t.cuda()).float().cpu()
        ref = cpu_model.reconstruct(ids_t, z_t)
    real = ids_t[0] != 0
    diff = (got - ref).abs()[0, real]
    agree = (got.argmax(-1) == ref.argmax(-1))[0, real].float().mean().item()
    check(got.shape == ref.shape and bool(torch.isfinite(got).all()),
          "model logits are not finite or have the wrong shape")
    check(diff.mean().item() <= MODEL_MEAN_ABS_TOL,
          f"model logits mean abs err {diff.mean():.3g}")
    check(agree >= MODEL_ARGMAX_AGREE, f"model argmax agreement {agree:.3f}")
    print(f"model: logits max abs err {diff.max():.4g}, mean abs err "
          f"{diff.mean():.4g}, argmax agreement {agree:.4f} "
          f"(bf16 card vs fp32 CPU, {int(real.sum())} tokens)", flush=True)


def make_requests(vocab: int, prompt_lengths, max_tokens, seed: int):
    rng = np.random.default_rng(seed)
    return [([int(t) for t in rng.integers(3, vocab, size=p)], m)
            for p, m in zip(prompt_lengths, max_tokens)]


def serve_phase(model, requests, *, batch_size: int = 64,
                max_length: int = 512, slice_steps: int = 64,
                fused_select: bool = True, timeout: float = 300.0,
                before_traffic=None) -> dict:
    """Drive ServeEngine with `requests` [(prompt_tokens, max_tokens)] and
    check every answer. before_traffic() runs once the engine is ready,
    just before the first submit. Returns the run's statistics."""
    sampling = SamplingParams(temperature=1.0, top_p=0.9,
                              repetition_penalty=1.2)
    engine = ServeEngine(model, batch_size=batch_size, max_length=max_length,
                         sampling=sampling, end_token=SEP_ID,
                         slice_steps=slice_steps, fused_select=fused_select,
                         rng_seed=0)
    try:
        deadline = time.monotonic() + timeout
        while not engine.snapshot()["ready"]:
            check("fatal" not in engine.snapshot(), "engine failed to start")
            check(time.monotonic() < deadline, "engine never became ready")
            time.sleep(0.05)
        if before_traffic is not None:
            before_traffic()
        if model.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t0 = time.monotonic()
        done_at = {}
        futures = []
        for i, (prompt, max_tokens) in enumerate(requests):
            fut = engine.submit(max_tokens, seed=1000 + i,
                                prompt_tokens=prompt or None)
            fut.add_done_callback(
                lambda f, i=i: done_at.setdefault(i, time.monotonic()))
            futures.append(fut)
        outs = [f.result(max(1.0, deadline - time.monotonic()))
                for f in futures]
        wall = time.monotonic() - t0
        vocab = model.hparams.vocab_size
        new_tokens = 0
        for (prompt, max_tokens), out in zip(requests, outs):
            p = len(prompt)
            check(np.array_equal(out[:p], prompt), "prompt not echoed")
            new = out[p:]
            check(1 <= len(new) <= max_tokens,
                  f"{len(new)} new tokens for max_tokens={max_tokens}")
            check(bool(((new >= 0) & (new < vocab)).all()),
                  "token id out of range")
            new_tokens += len(new)
        snap = engine.snapshot()
    finally:
        engine.shutdown(timeout=30.0)
    check(not engine._thread.is_alive(), "engine worker did not stop")
    check(snap["served"] == len(requests), "not every request was served")
    latency = np.array([done_at[i] - t0 for i in range(len(requests))])
    stats = {"requests": len(requests), "new_tokens": new_tokens,
             "wall_s": wall, "tokens_per_s": new_tokens / wall,
             "latency_p50_s": float(np.median(latency)),
             "latency_max_s": float(latency.max()),
             "prefills": snap["prefills"], "slices": snap["slices"]}
    if model.device.type == "cuda":
        stats["max_memory_allocated_bytes"] = \
            torch.cuda.max_memory_allocated()
    return stats


def rel_err(got, want) -> float:
    """Largest |got - want| relative to the largest |want|."""
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-30)).item()


def band_pairs(L: int, lengths, window: int, block: int) -> int:
    """Attended (query, key) pairs of the causal band + [CLS] pattern over
    all rows, per head: what K1/K2 compute for this run's lengths."""
    pos = torch.arange(L, device="cuda", dtype=torch.int64)
    qb = pos // block
    band_lo = (qb - window + 1).clamp_min(0) * block
    total = 0
    for n in lengths:
        keys = (torch.minimum(pos, torch.tensor(n - 1, device="cuda"))
                - band_lo + 1).clamp_min(0)
        cls = torch.where(qb - window + 1 > 0, min(block, n), 0)
        total += int((keys + cls).sum())
    return total


def k2_phase(b: int, L: int, lengths, seed: int, iters: int,
             time_it: bool = False):
    """K2 against its plain version; timed beside the plain version and
    the backward of scaled_dot_product_attention under the band mask."""
    h, d, window, block = 8, 64, 2, 128
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn((b, h, L, d), generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    out, lse = swa_kernel.swa_fwd(q, k, v, lens)
    got = swa_kernel.swa_bwd(q, k, v, lens, lse, out, do)
    again = swa_kernel.swa_bwd(q, k, v, lens, lse, out, do)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"K2 gives different gradients in two calls on the same inputs "
          f"at {[b, h, L, d]}")
    del again
    want = sliding_window_attention_bwd_plain(q, k, v, lens, lse, out, do)
    errs = [rel_err(g, w) for g, w in zip(got, want)]
    abs_err = max((g.float() - w.float()).abs().max().item()
                  for g, w in zip(got, want))
    del want
    check(all(bool(torch.isfinite(g.float()).all()) for g in got),
          "K2 gradients are not finite")
    check(max(errs) <= GRAD_REL_TOL,
          f"K2 disagrees with its plain version: rel errors {errs}")
    row = {"shape": [b, h, L, d], "lengths": list(lengths),
           "max_abs_err": abs_err, "rel_errs_dq_dk_dv": errs,
           "bit_identical": True}
    if time_it:
        row["ms"] = cuda_ms(lambda: swa_kernel.swa_bwd(
            q, k, v, lens, lse, out, do), iters)
        # On the device, by part: dq (with delta), dk/dv (the band and the
        # [CLS] partials, one launch), the [CLS] reduce, and PyTorch's
        # allocations.
        times = device_ms(lambda: swa_kernel.swa_bwd(
            q, k, v, lens, lse, out, do), 5)
        row["device_ms"] = sum(times.values())
        row["parts_device_ms"] = k2_parts(times)
        row["plain_ms"] = cuda_ms(lambda: sliding_window_attention_bwd_plain(
            q, k, v, lens, lse, out, do), 2, warmup=1)
        row["library_ms"] = sdpa_backward_ms(q, k, v, do, lens, window,
                                             block)
        pairs = band_pairs(L, lengths, window, block) * h
        # 5 tensors read (q, k, v, out, do), lse and lengths, 3 written.
        nbytes = 8 * q.numel() * 2 + lse.numel() * 4 + lens.numel() * 4
        # Per attended pair: s and dp recomputed, dq, dk, dv: 5 products
        # of 64 multiply-adds.
        row["bound_ms"], row["bound_by"] = bound(nbytes, 10 * d * pairs,
                                                 BF16_TENSOR_FLOPS)
        row["pairs"] = pairs
    print("K2 " + json.dumps(row), flush=True)
    return row


# The kernels of csrc/swa_bwd.cu (K2, K5b and K6's backward).
K2_KERNELS = {"dq": "swa_dq_kernel", "dkv": "swa_dkv_kernel",
              "reduce": "swa_cls_reduce_kernel"}


def k2_parts(times: dict) -> dict:
    """The device ms of csrc/swa_bwd.cu's kernels (K2, K5b) by part from
    `device_ms`, and the rest (PyTorch's) beside them."""
    parts = {part: kernel_ms(times, name)
             for part, name in K2_KERNELS.items()}
    parts["pytorch"] = sum(times.values()) - sum(parts.values())
    return parts


def sdpa_backward_ms(q, k, v, do, lens, window, block, mask=None):
    """Backward of F.scaled_dot_product_attention under the band mask, or
    under `mask` when given (a dense O(L^2) yardstick the port never
    calls): forward + backward minus forward."""
    L = q.shape[2]
    if mask is None:
        mask = band_mask(L, lens, window, block, "cuda")
    qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))

    def fwd():
        return F.scaled_dot_product_attention(qq, kk, vv, attn_mask=mask)

    def fwd_bwd():
        torch.autograd.grad(fwd(), (qq, kk, vv), do)

    try:
        total = cuda_ms(fwd_bwd, 2, warmup=1)
        fwd_only = cuda_ms(fwd, 2, warmup=1)
    except torch.OutOfMemoryError:
        print("K2 library yardstick: out of memory at this shape",
              flush=True)
        return None
    finally:
        del mask
    return total - fwd_only


def k5_phase(b: int, L: int, lengths, seed: int, iters: int,
             heads: int = 4):
    """K5 and K5b on packed [b, L, heads * 128] operands against their fp32
    plain versions; timed beside the plain versions and SDPA forward and
    backward under the band mask on the head-major transposes."""
    d, window, block = 128, 2, 128
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (torch.randn((b, L, heads * d), generator=gen,
                               device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    out, lse = swa_kernel.swa_fwd_packed(q, k, v, lens, heads)
    got = swa_kernel.swa_bwd_packed(q, k, v, lens, lse, out, do, heads)
    again = swa_kernel.swa_bwd_packed(q, k, v, lens, lse, out, do, heads)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          f"K5b gives different gradients in two calls on the same inputs "
          f"at {[b, L, heads * d]}")
    del again
    q32, k32, v32 = q.float(), k.float(), v.float()
    ref, ref_lse = sliding_window_attention_packed_plain(q32, k32, v32, lens,
                                                         heads)
    err = (out.float() - ref).abs()
    lse_err = (lse - ref_lse).abs().max().item()
    agree = bool((err <= K1_OUT_ATOL + K1_OUT_RTOL * ref.abs()).all())
    del ref, ref_lse
    check(bool(torch.isfinite(out.float()).all()), "K5 out is not finite")
    check(agree, f"K5 out disagrees with its plain version: max "
          f"{err.max():.3g}")
    check(lse_err <= K1_LSE_ATOL, f"K5 lse disagrees: {lse_err:.3g}")
    want = sliding_window_attention_packed_bwd_plain(
        q32, k32, v32, lens, lse, out.float(), do.float(), heads)
    errs = [rel_err(g, w) for g, w in zip(got, want)]
    bwd_abs = max((g.float() - w).abs().max().item()
                  for g, w in zip(got, want))
    del want, q32, k32, v32
    check(all(bool(torch.isfinite(g.float()).all()) for g in got),
          "K5b gradients are not finite")
    check(max(errs) <= GRAD_REL_TOL,
          f"K5b disagrees with its plain version: rel errors {errs}")
    fwd = {"shape": [b, L, heads * d], "lengths": list(lengths),
           "max_abs_err": err.max().item(), "lse_max_abs_err": lse_err}
    bwd = {"shape": [b, L, heads * d], "lengths": list(lengths),
           "max_abs_err": bwd_abs, "rel_errs_dq_dk_dv": errs,
           "bit_identical": True}
    pairs = band_pairs(L, lengths, window, block) * heads
    fwd["ms"] = cuda_ms(lambda: swa_kernel.swa_fwd_packed(
        q, k, v, lens, heads), iters)
    fwd["device_ms"] = kernel_ms(device_ms(lambda: swa_kernel.swa_fwd_packed(
        q, k, v, lens, heads)), "swa_fwd")
    few = max(2, iters // 10)
    fwd["plain_ms"] = cuda_ms(lambda: sliding_window_attention_packed_plain(
        q, k, v, lens, heads), few, warmup=1)
    heads_major = [t.view(b, L, heads, d).transpose(1, 2)
                   for t in (q, k, v, do)]
    mask = band_mask(L, lens, window, block, "cuda")
    try:
        fwd["library_ms"] = cuda_ms(lambda: F.scaled_dot_product_attention(
            *heads_major[:3], attn_mask=mask), few, warmup=1)
    except torch.OutOfMemoryError:
        print("K5 library yardstick: out of memory at this shape",
              flush=True)
        fwd["library_ms"] = None
    del mask
    # q, k, v read and out written once (bf16), lse written, lengths
    # read; per attended pair 2 products of d multiply-adds.
    nbytes = 4 * q.numel() * 2 + lse.numel() * 4 + lens.numel() * 4
    fwd["bound_ms"], fwd["bound_by"] = bound(nbytes, 4 * d * pairs,
                                             BF16_TENSOR_FLOPS)
    bwd["ms"] = cuda_ms(lambda: swa_kernel.swa_bwd_packed(
        q, k, v, lens, lse, out, do, heads), iters)
    # On the device, by part, as K2's (the same kernels at Dh = 128).
    times = device_ms(lambda: swa_kernel.swa_bwd_packed(
        q, k, v, lens, lse, out, do, heads), 5)
    bwd["device_ms"] = sum(times.values())
    bwd["parts_device_ms"] = k2_parts(times)
    bwd["plain_ms"] = cuda_ms(
        lambda: sliding_window_attention_packed_bwd_plain(
            q, k, v, lens, lse, out, do, heads), few, warmup=1)
    bwd["library_ms"] = sdpa_backward_ms(*heads_major, lens, window,
                                         block)
    # 5 tensors read (q, k, v, out, do), lse and lengths, 3 written;
    # per pair s and dp recomputed, dq, dk, dv: 5 products.
    nbytes = 8 * q.numel() * 2 + lse.numel() * 4 + lens.numel() * 4
    bwd["bound_ms"], bwd["bound_by"] = bound(nbytes, 10 * d * pairs,
                                             BF16_TENSOR_FLOPS)
    fwd["pairs"] = bwd["pairs"] = pairs
    print("K5 " + json.dumps(fwd), flush=True)
    print("K5b " + json.dumps(bwd), flush=True)
    return fwd, bwd


def ce_inputs(t: int, seed: int, vocab: int = 32768, d: int = 512,
              padded: int = 0):
    """Tied-CE inputs; the last `padded` tokens are padding (label 0,
    dnll 0), as the tail of a short document gives them."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    g = torch.randn((t, d), generator=gen, device="cuda").to(torch.bfloat16)
    table = (0.05 * torch.randn((vocab, d), generator=gen, device="cuda")
             ).to(torch.bfloat16)
    bias = 0.1 * torch.randn(vocab, generator=gen, device="cuda")
    labels = torch.randint(1, vocab, (t,), generator=gen, device="cuda")
    dnll = torch.full((t,), 1.0 / (t - padded), device="cuda")
    labels[t - padded:] = 0
    dnll[t - padded:] = 0.0
    return g, table, bias, labels, dnll


# K3 and K3b are held against their plain versions at the token counts
# of the main paths, as (tokens, padding tokens at the tail): a train step
# at [4, 4096] (one chunk of K3b), an sp-train rank's 25,600 (two chunks
# of 12,800) and the [8, 12800] step's 102,400 (seven chunks of 14,720,
# the last 14,080), where both are also timed. The last two tails end
# inside a 128-token tile.
CE_CHECKS = ((16384, 2048), (25600, 3261), (102400, 12861))


def ce_check(g, table, bias, labels, dnll) -> dict:
    """K3 and K3b against their plain versions on the same inputs (the
    plain backward in fp32), and K3b's second call bit-identical to its
    first; fails on a disagreement."""
    t = g.shape[0]
    nll, lse = ce_kernel.tied_ce_fwd(g, table, bias, labels)
    nll2, lse2 = ce_kernel.tied_ce_fwd(g, table, bias, labels)
    grads = ce_kernel.tied_ce_bwd(g, table, bias, labels, lse, dnll)
    again = ce_kernel.tied_ce_bwd(g, table, bias, labels, lse, dnll)
    torch.cuda.synchronize()
    check(torch.equal(nll, nll2) and torch.equal(lse, lse2),
          f"K3 gives a different lse in two calls on the same inputs at "
          f"T = {t}")
    del nll2, lse2
    check(all(torch.equal(a, b) for a, b in zip(grads, again)),
          f"K3b gives different gradients in two calls on the same inputs "
          f"at T = {t}")
    del again
    want_nll, want_lse = ce_kernel.tied_ce_fwd_plain(g, table, bias, labels)
    want = ce_kernel.tied_ce_bwd_plain(g.float(), table.float(), bias,
                                       labels, want_lse, dnll)
    fwd_err = max((lse - want_lse).abs().max().item(),
                  (nll - want_nll).abs().max().item())
    bwd_errs = [rel_err(a, w) for a, w in zip(grads, want)]
    bwd_abs = max((a.float() - w.float()).abs().max().item()
                  for a, w in zip(grads, want))
    check(bool(torch.isfinite(nll).all()),
          f"K3 nll is not finite at T = {t}")
    check(fwd_err <= K3_ATOL, f"K3 disagrees with its plain version at "
          f"T = {t}: {fwd_err:.3g}")
    check(all(bool(torch.isfinite(a.float()).all()) for a in grads),
          f"K3b gradients are not finite at T = {t}")
    check(max(bwd_errs) <= GRAD_REL_TOL,
          f"K3b disagrees with its plain version at T = {t}: rel errors "
          f"{bwd_errs}")
    return {"tokens": t, "chunk_tokens": ce_kernel.bwd_chunk(
        t, table.shape[0]), "fwd_vocab_splits": ce_kernel.fwd_splits(
        t, table.shape[0], torch.cuda.get_device_properties(
            0).multi_processor_count),
        "padding": int((dnll == 0).sum().item()),
        "fwd_err": fwd_err, "bwd_abs_err": bwd_abs,
        "rel_errs_dg_dE_dbias": bwd_errs}


def k3_phase(seed: int):
    """K3 and K3b against their plain versions at each of CE_CHECKS; timed
    at the last of them beside the plain versions and F.linear +
    F.cross_entropy forward and backward."""
    checks = []
    for i, (t, padded) in enumerate(CE_CHECKS):
        g, table, bias, labels, dnll = ce_inputs(t, seed + i, padded=padded)
        checks.append(ce_check(g, table, bias, labels, dnll))
    fwd_err = max(c["fwd_err"] for c in checks)
    bwd_abs = max(c["bwd_abs_err"] for c in checks)

    t, vocab, d = g.shape[0], table.shape[0], g.shape[1]
    _, lse = ce_kernel.tied_ce_fwd(g, table, bias, labels)
    fwd_ms = cuda_ms(lambda: ce_kernel.tied_ce_fwd(g, table, bias, labels),
                     5)
    bwd_ms = cuda_ms(lambda: ce_kernel.tied_ce_bwd(g, table, bias, labels,
                                                   lse, dnll), 3)
    plain_fwd_ms = cuda_ms(lambda: ce_kernel.tied_ce_fwd_plain(
        g, table, bias, labels), 1, warmup=1)
    plain_bwd_ms = cuda_ms(lambda: ce_kernel.tied_ce_bwd_plain(
        g, table, bias, labels, lse, dnll), 1, warmup=1)
    lib_fwd_ms, lib_bwd_ms = ce_library_ms(g, table, bias, labels)
    fwd_device = kernel_ms(device_ms(lambda: ce_kernel.tied_ce_fwd(
        g, table, bias, labels), 3), "tied_ce_kernel")
    # K3b's parts on the device: the logit gradients (dl), the two
    # gradient products, the dbias sum, and PyTorch's share (the E^T and
    # g^T copies, the fp32 label-row term, the dtype casts).
    bwd_times = device_ms(lambda: ce_kernel.tied_ce_bwd(
        g, table, bias, labels, lse, dnll), 3)
    parts = {"dl": kernel_ms(bwd_times, "ce_dl_kernel"),
             "dg": kernel_ms(bwd_times, "ce_gemm_kernel<0>"),
             "dE": kernel_ms(bwd_times, "ce_gemm_kernel<1>"),
             "dbias": kernel_ms(bwd_times, "ce_dbias_kernel")}
    parts["pytorch"] = sum(bwd_times.values()) - sum(parts.values())
    flops = 2 * t * vocab * d
    in_bytes = g.numel() * 2 + table.numel() * 2 + vocab * 4 + t * 8
    # K3: reads once, writes lse and nll; one product of 2 T V D.
    fwd_bound = bound(in_bytes + 2 * t * 4, flops, BF16_TENSOR_FLOPS)
    # K3b: reads the inputs, lse and dnll, writes dg, dE and dbias; the
    # least work is the logits once and the two gradient products
    # (3 x 2 T V D, what the kernels do).
    bwd_bound = bound(in_bytes + 2 * t * 4 + g.numel() * 2
                      + table.numel() * 2 + vocab * 4, 3 * flops,
                      BF16_TENSOR_FLOPS)
    shape = [t, vocab, d]
    check_tokens = [c["tokens"] for c in checks]
    k3 = {"shape": shape, "check_tokens": check_tokens,
          "max_abs_err": fwd_err, "bit_identical": True,
          "vocab_splits": [c["fwd_vocab_splits"] for c in checks],
          "ms": fwd_ms, "device_ms": fwd_device, "plain_ms": plain_fwd_ms,
          "library_ms": lib_fwd_ms, "bound_ms": fwd_bound[0],
          "bound_by": fwd_bound[1]}
    k3b = {"shape": shape, "check_tokens": check_tokens,
           "max_abs_err": bwd_abs, "checks": checks, "bit_identical": True,
           "ms": bwd_ms, "device_ms": sum(bwd_times.values()),
           "parts_device_ms": parts, "chunk_tokens": ce_kernel.bwd_chunk(
               t, vocab), "plain_ms": plain_bwd_ms,
           "library_ms": lib_bwd_ms, "bound_ms": bwd_bound[0],
           "bound_by": bwd_bound[1]}
    print("K3 " + json.dumps(k3), flush=True)
    print("K3b " + json.dumps(k3b), flush=True)
    return k3, k3b


def ce_library_ms(g, table, bias, labels):
    """(forward ms, backward ms) of F.linear + F.cross_entropy on the same
    inputs (bf16 logits, as autocast would give), a yardstick the port
    never calls."""
    gg, tt, bb = (x.detach().requires_grad_() for x in (g, table, bias))

    def fwd():
        logits = F.linear(gg, tt, bb.to(gg.dtype))
        return F.cross_entropy(logits.float(), labels, reduction="sum")

    def fwd_bwd():
        torch.autograd.grad(fwd(), (gg, tt, bb))

    try:
        fwd_ms = cuda_ms(fwd, 2, warmup=1)
        total = cuda_ms(fwd_bwd, 2, warmup=1)
    except torch.OutOfMemoryError:
        print("K3 library yardstick: out of memory at this shape",
              flush=True)
        return None, None
    return fwd_ms, total - fwd_ms


def train_phase(make, expect: dict, steps: int = 3, batch: int = 4,
                seq: int = 4096, seed: int = 11, name: str = "train") -> dict:
    """The model of `make(use_kernels, dtype)` -> (model, objective,
    optimizer) trains for `steps` optimizer steps on the card through the
    kernels; step 1 is held against the fp32 plain step on the card.
    expect: {counter: launches per step, or None for at least one}; every
    other kernel counter and both plain_routes counters must stay 0."""
    device = "cuda"
    model, objective, optimizer = make(True, None)
    rng = np.random.default_rng(seed)
    vocab = model.hparams.vocab_size
    batches = [synthetic_batch(rng, batch, seq, vocab, device=device)
               for _ in range(steps)]
    gen = torch.Generator(device=device).manual_seed(seed)
    noise = {"eps": torch.randn((batch, 1, model.hparams.latent_depth),
                                generator=gen, device=device),
             "mi": torch.randn((objective.mi_samples, batch,
                                model.hparams.latent_depth),
                               generator=gen, device=device)}
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    losses, step_s, first_grads = [], [], None
    for step in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = train_step(model, objective, optimizer, [batches[step]],
                             step, [noise] if step == 0 else None, gen)
        losses.append(float(metrics["loss"]))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
        if step == 0:
            first_grads = {n: p.grad.detach().clone()
                           for n, p in model.named_parameters()}
            first_metrics = {k: float(v) for k, v in metrics.items()}
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    check(all(np.isfinite(losses)), f"{name} losses not finite: {losses}")
    check_counts(name, counts, {k: None if n is None else n * steps
                                for k, n in expect.items()})
    del model, optimizer

    ref, ref_objective, _ = make(False, torch.float32)
    ref_loss, _ = ref_objective.loss(ref, batches[0], 0, noise)
    ref_loss.backward()
    ref_loss = ref_loss.detach().item()
    cos = {}
    for pname, p in ref.named_parameters():
        a, w = first_grads[pname].double(), p.grad.double()
        cos[pname] = float((a * w).sum() / (a.norm() * w.norm()).clamp_min(
            1e-300))
    del ref
    worst = sorted(cos.items(), key=lambda kv: kv[1])[:3]
    loss_rel = abs(losses[0] - ref_loss) / abs(ref_loss)
    check(len(cos) == 165, f"{len(cos)} gradients compared, not 165")
    check(loss_rel <= TRAIN_LOSS_RTOL,
          f"{name} step 1 loss {losses[0]} vs fp32 plain {ref_loss}")
    check(worst[0][1] >= TRAIN_GRAD_COS,
          f"{name} step 1 gradients disagree with fp32 plain: {worst}")
    stats = {"steps": steps, "batch": [batch, seq],
             "real_tokens": [int(b["num_tokens"].sum()) for b in batches],
             "losses": losses, "step_s": step_s, "step1": first_metrics,
             "fp32_plain_loss": ref_loss, "loss_rel_err": loss_rel,
             "min_grad_cosine": worst, "launches": counts,
             "max_memory_allocated_bytes": peak}
    print(f"{name} " + json.dumps(stats), flush=True)
    return stats


def h4_model(use_kernels: bool = True, dtype=None, train: bool = False):
    """The Dh = 128 model (bench.py --heads 4) from the JAX
    initialisation drawn from a torch.Generator seeded H4_SEED."""
    gen = torch.Generator().manual_seed(H4_SEED)
    if train:
        return build_from_hparams(bench_hparams(4), gen, "cuda", use_kernels,
                                  dtype)[:3]
    model, _ = model_from_hparams(bench_hparams(4), gen, device="cuda",
                                  dtype=dtype, use_kernels=use_kernels)
    return model


def model_h4_phase(model, seed: int = 0, length: int = 256) -> dict:
    """Prefill logits of the bf16 Dh = 128 model (K5) against the fp32
    plain model on the card, on one fixed input."""
    ref_model = h4_model(use_kernels=False, dtype=torch.float32)
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, model.hparams.vocab_size, size=(1, length))
    ids[0, 0] = 1
    ids[0, 200:] = 0                                   # right padding
    z = rng.standard_normal((1, 1, model.hparams.latent_depth))
    ids_t = torch.tensor(ids, device="cuda")
    z_t = torch.tensor(z, dtype=torch.float32, device="cuda")
    with torch.inference_mode():
        got = model.reconstruct(ids_t, z_t).float()
        ref = ref_model.reconstruct(ids_t, z_t)
    del ref_model
    real = ids_t[0] != 0
    diff = (got - ref).abs()[0, real]
    rel = (diff.max() / ref[0, real].abs().max()).item()
    check(got.shape == ref.shape and bool(torch.isfinite(got).all()),
          "h4 model logits are not finite or have the wrong shape")
    check(rel <= MODEL_H4_REL_TOL, f"h4 model logits rel err {rel:.3g}")
    row = {"max_abs_err": diff.max().item(), "mean_abs_err":
           diff.mean().item(), "max_abs_logit": ref[0, real].abs().max()
           .item(), "rel_err": rel, "tokens": int(real.sum())}
    print("model-h4 " + json.dumps(row), flush=True)
    return row


reset_counts = launches.reset
read_counts = launches.read


def sp_mask(S: int, start: int, ext_lens, cls_lens, window: int,
            block: int = 128):
    """[B, 1, S, block + ctx + S] bool: what one shard's queries attend
    in the key layout [CLS block | k_ext], the mask K6 applies (shard 0:
    K1's band + [CLS] slot over its local keys, the [CLS] columns unused)."""
    ctx = (window - 1) * block
    i = torch.arange(S, device="cuda")
    e = torch.arange(ctx + S, device="cuda")
    t = start + i                                    # query positions
    g = start - ctx + e                              # extended key positions
    ext = torch.tensor(ext_lens, device="cuda")
    if start == 0:
        local = e - ctx
        band = ((t[:, None] // block - local[None, :] // block < window)
                | (local[None, :] // block == 0)) & (local[None, :] >= 0) \
            & (local[None, :] <= t[:, None])
        keys = (local[None, :] >= 0) & (local[None, :] < ext[:, None])
        ext_mask = band[None] & keys[:, None, :]
        cls_mask = torch.zeros((len(ext_lens), S, block), dtype=torch.bool,
                               device="cuda")
    else:
        band = (g[None, :] // block > t[:, None] // block - window) \
            & (g[None, :] <= t[:, None])
        ext_mask = band[None] & (e[None, :] < ext[:, None])[:, None, :]
        cls = torch.arange(block, device="cuda")[None, :] < torch.tensor(
            cls_lens, device="cuda")[:, None]
        cls_mask = cls[:, None, :].expand(-1, S, -1)
    return torch.cat([cls_mask, ext_mask], dim=2)[:, None]


def k6_phase(b: int, S: int, start: int, ext_lens, cls_lens, window: int,
             seed: int, h: int = 8, time_it: bool = False):
    """K6 forward and backward (ops/sp_kernel.py: one K1 call with q_off,
    the backward one K2 call, the broadcast [CLS] block a slot of each)
    against its plain version on the same bf16 inputs, the backward
    bit-identical across two calls; filler rows (ext_len 0 and cls_len 0)
    must give out 0 and zero gradients with no NaN. Timed beside its plain
    version and SDPA over [CLS | k_ext] under the same mask when time_it;
    then a banded shard's profiled forward must launch K1's kernel only
    and its backward K2's kernels only."""
    d, block = 64, 128
    ctx = (window - 1) * block
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    q, do = randn(b, h, S, d), randn(b, h, S, d)
    k_ext, v_ext = randn(b, h, ctx + S, d), randn(b, h, ctx + S, d)
    cls_k, cls_v = randn(b, h, block, d), randn(b, h, block, d)
    if start == 0:       # shard 0 receives a zero halo
        k_ext[:, :, :ctx] = 0
        v_ext[:, :, :ctx] = 0
    ext_len = torch.tensor(ext_lens, dtype=torch.int32, device="cuda")
    cls_len = torch.tensor(cls_lens, dtype=torch.int32, device="cuda")
    args = (q, k_ext, v_ext, cls_k, cls_v, start, ext_len, cls_len)
    out, lse = sp_kernel.sp_fwd(*args, window, block)
    grads = sp_kernel.sp_bwd(*args, out, lse, do, window, block)
    again = sp_kernel.sp_bwd(*args, out, lse, do, window, block)
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(grads, again)),
          f"K6's backward gives different gradients in two calls at "
          f"start {start}, window {window}")
    del again
    # The plain forward rounds the band's output to bf16 before the
    # logaddexp merge with the [CLS] part, as JAX does; the kernel rounds
    # the joint output once: about one bf16 rounding apart, inside K1's
    # tolerance.
    ref, ref_lse = sp_kernel.sp_fwd_plain(*args, window, block)
    want = sp_kernel.sp_bwd_plain(*args, out, lse, do, window, block)
    check(all(bool(torch.isfinite(t.float()).all()) for t in (out, *grads)),
          "K6 out or gradients are not finite")
    err = (out.float() - ref.float()).abs()
    check(bool((err <= K1_OUT_ATOL + K1_OUT_RTOL * ref.float().abs()).all()),
          f"K6 out disagrees with its plain version: max {err.max():.3g}")
    check(torch.equal(torch.isinf(lse), torch.isinf(ref_lse)),
          "K6 lse is -inf on other rows than its plain version's")
    finite = torch.isfinite(ref_lse)
    lse_err = (lse[finite] - ref_lse[finite]).abs().max().item()
    check(lse_err <= K1_LSE_ATOL, f"K6 lse disagrees: {lse_err:.3g}")
    errs = [rel_err(g, w) for g, w in zip(grads, want)]
    abs_err = max((g.float() - w.float()).abs().max().item()
                  for g, w in zip(grads, want))
    check(max(errs) <= GRAD_REL_TOL,
          f"K6 gradients disagree with the plain version: {errs}")
    filler = [r for r in range(b) if ext_lens[r] == 0 and cls_lens[r] == 0]
    for r in filler:
        check(bool((out[r] == 0).all()) and all(
            bool((g[r] == 0).all()) for g in grads),
            f"K6 filler row {r} is not zero")
    row = {"shape": [b, h, S, d], "k_ext": list(k_ext.shape),
           "start": start, "window": window, "ext_len": list(ext_lens),
           "cls_len": list(cls_lens), "filler_rows": filler,
           "max_abs_err": err.max().item(), "lse_max_abs_err": lse_err,
           "bwd_max_abs_err": abs_err,
           "rel_errs_dq_dkext_dvext_dclsk_dclsv": errs,
           "bwd_bit_identical": True}
    if time_it:
        mask = sp_mask(S, start, ext_lens, cls_lens, window, block)
        pairs = int(mask.sum().item()) * h
        keys = torch.cat([cls_k, k_ext], dim=2)
        values = torch.cat([cls_v, v_ext], dim=2)
        row["ms"] = cuda_ms(lambda: sp_kernel.sp_fwd(*args, window, block),
                            10)
        # On the device: the whole call, and K1's kernel inside it (on a
        # banded shard all of it: the band and the broadcast [CLS] block
        # in one launch).
        times = device_ms(lambda: sp_kernel.sp_fwd(*args, window, block))
        row["device_ms"] = sum(times.values())
        row["k1_device_ms"] = kernel_ms(times, "swa_fwd_kernel")
        if start > 0:
            others = sorted(name for name in times
                            if "swa_fwd_kernel" not in name)
            check(not others, f"K6's forward on a banded shard launched "
                  f"other kernels than K1's: {others}")
            print(f"K6 forward on a banded shard: {len(times)} kernel, "
                  f"K1's (no cuBLAS, no aten elementwise)", flush=True)
        row["bwd_ms"] = cuda_ms(lambda: sp_kernel.sp_bwd(
            *args, out, lse, do, window, block), 10)
        # The backward on the device, and K2's kernels inside it (on a
        # banded shard all of it: the band and the broadcast [CLS] block
        # in one K2 call).
        times = device_ms(lambda: sp_kernel.sp_bwd(
            *args, out, lse, do, window, block))
        row["bwd_device_ms"] = sum(times.values())
        parts = k2_parts(times)
        row["bwd_k2_device_ms"] = sum(parts.values()) - parts["pytorch"]
        row["bwd_parts_device_ms"] = parts
        if start > 0:
            others = sorted(name for name in times if not any(
                kernel in name for kernel in K2_KERNELS.values()))
            check(not others, f"K6's backward on a banded shard launched "
                  f"other kernels than K2's: {others}")
            print(f"K6 backward on a banded shard: {len(times)} kernels, "
                  f"all K2's (no cuBLAS or aten matmul)", flush=True)
        row["plain_ms"] = cuda_ms(lambda: sp_kernel.sp_fwd_plain(
            *args, window, block), 2, warmup=1)
        row["bwd_plain_ms"] = cuda_ms(lambda: sp_kernel.sp_bwd_plain(
            *args, out, lse, do, window, block), 2, warmup=1)
        try:
            row["library_ms"] = cuda_ms(
                lambda: F.scaled_dot_product_attention(
                    q, keys, values, attn_mask=mask), 2, warmup=1)
        except torch.OutOfMemoryError:
            print("K6 library yardstick: out of memory", flush=True)
            row["library_ms"] = None
        row["bwd_library_ms"] = sdpa_backward_ms(q, keys, values, do, None,
                                                 window, block, mask)
        del mask, keys, values
        lens_bytes = 2 * b * 4
        # Forward: q, k_ext, v_ext, cls_k, cls_v read and out written
        # (bf16), lse written (fp32); per attended pair 2 products of Dh
        # multiply-adds.
        io = (2 * q.numel() + 2 * k_ext.numel() + 2 * cls_k.numel()) * 2
        row["bound_ms"], row["bound_by"] = bound(
            io + lse.numel() * 4 + lens_bytes, 4 * d * pairs,
            BF16_TENSOR_FLOPS)
        # Backward: those inputs, out and do read, lse read, the five
        # gradients written; per pair s and dp recomputed, dq, dk, dv.
        row["bwd_bound_ms"], row["bwd_bound_by"] = bound(
            2 * io + q.numel() * 2 + lse.numel() * 4 + lens_bytes,
            10 * d * pairs, BF16_TENSOR_FLOPS)
        row["pairs"] = pairs
    print("K6 " + json.dumps(row), flush=True)
    return row


def cosines(got: dict, want: dict) -> dict:
    out = {}
    for name, w in want.items():
        a, w = got[name].double(), w.double()
        out[name] = float((a * w).sum() / (a.norm() * w.norm()).clamp_min(
            1e-300))
    return out


def unsharded_sp_step(use_kernels: bool, dtype, noise=None):
    """One unsharded step of r5 on the sp-train document [1, SP_SEQ]:
    (loss, gradients on the CPU, launch counts, seconds, peak bytes,
    noise). noise: the posterior noise, drawn from SP_SEED when None."""
    model, objective, optimizer = build_training(
        RUN, "cuda", 1, use_kernels=use_kernels, dtype=dtype)[:3]
    hp = model.hparams
    rng = np.random.default_rng(SP_SEED)
    mb = synthetic_batch(rng, 1, SP_SEQ, hp.vocab_size,
                         pad_to_multiple_of=sp_pad_multiple(hp, SP),
                         device="cuda")
    check(mb["token_ids"].shape == (1, SP_SEQ), "the document is padded")
    if noise is None:
        gen = torch.Generator(device="cuda").manual_seed(SP_SEED)
        noise = {"eps": torch.randn((1, 1, hp.latent_depth), generator=gen,
                                    device="cuda"),
                 "mi": torch.randn((objective.mi_samples, 1,
                                    hp.latent_depth), generator=gen,
                                   device="cuda")}
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    metrics = train_step(model, objective, optimizer, [mb], 0, [noise])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = read_counts()
    grads = {n: p.grad.detach().float().cpu()
             for n, p in model.named_parameters()}
    out = (float(metrics["loss"]), grads, counts, seconds,
           torch.cuda.max_memory_allocated(), noise)
    del model, objective, optimizer, metrics, mb
    gc.collect()
    torch.cuda.empty_cache()
    return out


def sharded_sp_steps(steps: int, noise: dict, use_kernels: bool = True,
                     dtype=None) -> list:
    """SP ranks spawned on the card take `steps` steps of r5 on the same
    documents, the first with `noise`; their records, checked: every rank
    on the card, one backend, the same losses and bitwise equal
    parameters after every step."""
    records = spawn(train_rank, SP, "cuda",
                    (RUN, steps, 1, SP_SEQ, SP_SEED, 1,
                     [{k: v.cpu() for k, v in noise.items()}], True, False,
                     use_kernels, dtype), timeout=900)
    check([r["rank"] for r in records] == list(range(SP)),
          "a rank is missing")
    check(all(r["device"].startswith("cuda") for r in records),
          "a rank ran off the card")
    check(len({r["backend"] for r in records}) == 1,
          "the ranks disagree on the backend")
    losses = [[m["loss"] for m in r["metrics"]] for r in records]
    check(all(np.isfinite(x).all() and x == losses[0] for x in losses),
          f"the ranks' losses differ or are not finite: {losses}")
    for step in range(steps):
        check(len({r["param_digests"][step] for r in records}) == 1,
              f"parameters differ across ranks after step {step + 1}")
    return records


def sp_train_phase(steps: int = 3) -> dict:
    """r5's step on one [1, SP_SEQ] document, unsharded and over SP ranks
    spawned on the card with the same weights, document and eps, each in
    bf16 through the kernels and in fp32 through the plain versions; then
    2 more sharded kernel steps.

    The fp32 pair is held exactly (loss 1e-5 relative, all 165 gradients
    at cosine >= 0.99). The kernel pair: loss within 1e-3 relative; a
    gradient at cosine >= 0.99 with the unsharded kernel step wherever that
    step is itself at >= 0.99 with the fp32 one, and elsewhere no farther
    from the fp32 gradient than the unsharded kernel step less
    SP_NOISY_MARGIN: a few tensors whose gradients are near zero (the
    encoder bottleneck's, at this length) sit at bf16 noise in either
    bf16 step, so the unsharded kernel step is no reference for them."""
    a_loss, a_grads, a_counts, a_s, a_peak, noise = unsharded_sp_step(
        True, None)
    check_counts("sp-train unsharded", a_counts,
                 {"swa_fwd": 6, "swa_bwd": 6, "tied_ce_fwd": 1,
                  "tied_ce_bwd": 1})
    c_loss, c_grads, _, c_s, _, _ = unsharded_sp_step(False, torch.float32,
                                                      noise)
    records = sharded_sp_steps(steps, noise)
    plain = sharded_sp_steps(1, noise, False, torch.float32)

    d_cos = cosines(plain[0]["grads"], c_grads)
    d_loss = plain[0]["metrics"][0]["loss"]
    check(len(d_cos) == 165, f"{len(d_cos)} gradients compared, not 165")
    check(abs(d_loss - c_loss) <= SP_FP32_LOSS_RTOL * abs(c_loss),
          f"fp32 sp step 1 loss {d_loss} vs unsharded {c_loss}")
    check(min(d_cos.values()) >= TRAIN_GRAD_COS,
          f"fp32 sp gradients disagree with the unsharded fp32 step: "
          f"{sorted(d_cos.items(), key=lambda kv: kv[1])[:3]}")

    losses = [m["loss"] for m in records[0]["metrics"]]
    loss_rel = abs(losses[0] - a_loss) / abs(a_loss)
    check(loss_rel <= TRAIN_LOSS_RTOL,
          f"sp step 1 loss {losses[0]} vs unsharded {a_loss}")
    b_grads = records[0]["grads"]
    ba_cos = cosines(b_grads, a_grads)
    ac_cos = cosines(a_grads, c_grads)
    bc_cos = cosines(b_grads, c_grads)
    noisy = {n: {"unsharded_vs_fp32": ac_cos[n], "sp_vs_fp32": bc_cos[n],
                 "sp_vs_unsharded": ba_cos[n]}
             for n in ac_cos if ac_cos[n] < TRAIN_GRAD_COS}
    held = {n: c for n, c in ba_cos.items() if n not in noisy}
    check(len(ba_cos) == 165, f"{len(ba_cos)} gradients compared, not 165")
    check(min(held.values()) >= TRAIN_GRAD_COS,
          f"sp step 1 gradients disagree with the unsharded step: "
          f"{sorted(held.items(), key=lambda kv: kv[1])[:3]}")
    for n, c in noisy.items():
        check(c["sp_vs_fp32"] >= c["unsharded_vs_fp32"] - SP_NOISY_MARGIN,
              f"{n}: the sp step is farther from fp32 than the unsharded "
              f"step: {c}")
    for r in records:
        c = r["launches"]
        check(c["swa_plain_routes"] == 0 and c["ce_plain_routes"] == 0,
              f"rank {r['rank']} took a plain route: {c}")
        check(c["tied_ce_fwd"] > 0 and c["tied_ce_bwd"] > 0,
              f"rank {r['rank']} ran no K3/K3b: {c}")
        if r["rank"] == 0:
            check(c["swa_fwd"] > 0 and c["swa_bwd"] > 0
                  and c["sp_windowed_attention"] == 0,
                  f"rank 0 ran no K1/K2 or ran K6: {c}")
        else:
            check(c["sp_windowed_attention"] > 0
                  and c["sp_windowed_attention_bwd"] > 0
                  and c["swa_fwd"] == 0 and c["swa_bwd"] == 0,
                  f"rank {r['rank']} ran no K6 or ran K1/K2: {c}")
    stats = {"sp": SP, "backend": records[0]["backend"],
             "document": [1, SP_SEQ],
             "unsharded": {"loss": a_loss, "step_s": a_s, "launches":
                           a_counts, "max_memory_allocated_bytes": a_peak},
             "losses": losses, "loss_rel_err": loss_rel,
             "min_grad_cosine": sorted(held.items(),
                                       key=lambda kv: kv[1])[:3],
             "near_zero_gradients": noisy,
             "fp32": {"unsharded_loss": c_loss, "sp_loss": d_loss,
                      "unsharded_step_s": c_s,
                      "min_grad_cosine": sorted(
                          d_cos.items(), key=lambda kv: kv[1])[:3],
                      "step_s_by_rank": [r["step_s"] for r in plain]},
             "step_s_by_rank": [r["step_s"] for r in records],
             "max_memory_allocated_by_rank": [
                 r["max_memory_allocated"] for r in records],
             "launches_by_rank": [r["launches"] for r in records]}
    print("sp-train " + json.dumps(stats), flush=True)
    return stats


def check_counts(path: str, counts: dict, expect: dict):
    """expect: {counter: exact count, or None for at least one}; every
    other counter, the plain_routes ones included, must be 0."""
    for name, n in counts.items():
        want = expect.get(name, 0)
        ok = n > 0 if want is None else n == want
        check(ok, f"the {path} path gave {name} = {n}, expected "
              f"{'> 0' if want is None else want}")


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if argv and (len(argv) != 2 or argv[0] != "--k4-parent"):
        print("usage: chip_smoke.py [--k4-parent DIR]", file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    with Phase("device"):
        smi = device_phase()
    with Phase("build"):
        build_phase()
        parent = ParentK4(argv[1]) if argv else None
    with Phase("kernels"):
        k1_serve = k1_phase(1, 512, [417], seed=1, iters=200)
        k1_long = k1_phase(4, 4096, [4096, 3001, 1500, 129], seed=2,
                           iters=50)
        # K4 at the serving batch (a row over a cluster of two CTAs), at a
        # 512-token Jacobi window's rows (one CTA a row), its two
        # instantiations against each other, then correctness alone at one
        # row, past the SM count and at a V that is no power of two.
        k4_rows = [k4_phase(t, seed=3 + i, iters=200, parent=parent)
                   for i, t in enumerate((1.0, 0.7))]
        k4_wide = k4_phase(1.0, seed=9, iters=50, n=512, parent=parent)
        k4_split = k4_instantiations(seed=12, iters=50)
        k4_checks = [
            k4_phase(1.0, seed=30 + 3 * i + j, iters=0, n=n, vocab=v,
                     top_p=top_p, with_noise=with_noise)
            for i, (n, v) in enumerate(((1, 512), (133, 32768), (3, 50000)))
            for j, (with_noise, top_p) in enumerate(
                ((True, 0.9), (False, 0.9), (True, 1e-3)))]
        k1_train = k1_phase(8, 12800, TRAIN_LENGTHS, seed=8, iters=5)
        k2_phase(1, 512, [417], seed=4, iters=0)
        k2_phase(4, 4096, [4096, 3001, 1500, 129], seed=5, iters=0)
        k2_train = k2_phase(8, 12800, TRAIN_LENGTHS, seed=6, iters=5,
                            time_it=True)
        k3, k3b = k3_phase(seed=7)
    with Phase("model"):
        model, _, _ = load_run(RUN, device="cuda")
        model_phase(model)
    vocab = model.hparams.vocab_size
    requests = make_requests(
        vocab, prompt_lengths=[0, 127, 0, 200, 300, 0, 416, 150, 0, 255, 0,
                               180],
        max_tokens=[256, 128, 192, 160, 96, 64, 64, 256, 128, 200, 96, 160],
        seed=7)
    with Phase("serve"):
        stats = serve_phase(model, requests, before_traffic=reset_counts)
        counts = read_counts()
        check_counts("serve", counts, {"swa_fwd": None,
                                       "nucleus_select": None})
        print("serve " + json.dumps({**stats, "launches": counts,
                                     "card": smi}), flush=True)
        del model
    with Phase("train"):
        train_counts = train_phase(
            lambda kernels, dtype: build_training(
                RUN, "cuda", 1, use_kernels=kernels, dtype=dtype)[:3],
            {"swa_fwd": 6, "swa_bwd": 6, "tied_ce_fwd": 1,
             "tied_ce_bwd": 1})["launches"]
    with Phase("kernels-h4"):
        k5_serve, k5b_serve = k5_phase(1, 512, [417], seed=12, iters=200)
        k5_long, k5b_long = k5_phase(4, 4096, [4096, 3001, 1500, 129],
                                     seed=13, iters=50)
        k5_train, k5b_train = k5_phase(8, 12800, TRAIN_LENGTHS, seed=14,
                                       iters=5)
    with Phase("model-h4"):
        model = h4_model()
        model_h4_phase(model)
    with Phase("serve-h4"):
        stats = serve_phase(model, requests, before_traffic=reset_counts)
        h4_counts = read_counts()
        check_counts("serve-h4", h4_counts, {"swa_fwd_packed": None,
                                             "nucleus_select": None})
        print("serve-h4 " + json.dumps({**stats, "launches": h4_counts,
                                        "card": smi}), flush=True)
        del model
    with Phase("train-h4"):
        h4_train_counts = train_phase(
            lambda kernels, dtype: h4_model(kernels, dtype, train=True),
            {"swa_fwd_packed": 6, "swa_bwd_packed": 6, "tied_ce_fwd": 1,
             "tied_ce_bwd": 1}, name="train-h4")["launches"]
    shard = SP_SEQ // SP
    with Phase("kernels-sp"):
        k6 = k6_phase(1, shard, shard, [shard + 128], [128], 2, seed=15,
                      time_it=True)
        k6_square = k6_phase(1, shard, 0, [shard], [128], 2, seed=16,
                             time_it=True)
        k6_phase(4, 4096, 8192, [4224, 3000, 129, 0], [128, 77, 128, 0], 2,
                 seed=17)
        k6_phase(4, 4096, 0, [4096, 2000, 1, 0], [128, 128, 128, 0], 2,
                 seed=18)
        for window, seed in ((1, 19), (3, 20)):
            k6_phase(1, 1024, 1024, [(window - 1) * 128 + 1024], [128],
                     window, seed=seed, h=2)
    with Phase("sp-train"):
        sp_stats = sp_train_phase()
    sp_counts = sp_stats["launches_by_rank"]
    sp_single = sp_stats["unsharded"]["launches"]

    def sp_sum(name):
        return sp_single[name] + sum(c[name] for c in sp_counts)

    def timed(row):
        return {k: row[k] for k in ("max_abs_err", "ms", "plain_ms",
                                    "bound_ms", "bound_by", "library_ms",
                                    "shape")}

    def smaller(*rows):
        return [{k: r[k] for k in ("shape", "lengths", "max_abs_err", "ms",
                                   "device_ms", "plain_ms", "bound_ms",
                                   "library_ms")}
                for r in rows]

    kernels = [
        {"name": "swa_fwd", "route": "cuda",
         "source": "sparse_vae_tpu_torch/csrc/swa_fwd.cu",
         "replaces": "sparse_vae_tpu/ops/pallas_kernels.py:152",
         "launches": counts["swa_fwd"] + train_counts["swa_fwd"]
         + sp_sum("swa_fwd"),
         "launches_by_path": {"serve": counts["swa_fwd"],
                              "train": train_counts["swa_fwd"],
                              "sp-train": sp_sum("swa_fwd")},
         **{k: k1_serve[k] for k in ("max_abs_err", "ms", "device_ms",
                                     "plain_ms", "bound_ms", "bound_by",
                                     "library_ms")},
         "shape": k1_serve["shape"],
         "long": {k: k1_long[k] for k in ("shape", "max_abs_err", "ms",
                                          "device_ms", "plain_ms",
                                          "bound_ms", "library_ms")},
         "train": {k: k1_train[k] for k in ("shape", "max_abs_err", "ms",
                                            "device_ms", "plain_ms",
                                            "bound_ms", "bound_by",
                                            "library_ms")}},
        {"name": "nucleus_select", "route": "cuda",
         "source": "sparse_vae_tpu_torch/csrc/nucleus_select.cu",
         "replaces": "sparse_vae_tpu/ops/pallas_select.py:128",
         "launches": counts["nucleus_select"] + h4_counts["nucleus_select"],
         "launches_by_path": {"serve": counts["nucleus_select"],
                              "serve-h4": h4_counts["nucleus_select"]},
         **{k: k4_rows[0][k] for k in ("max_abs_err", "ms", "device_ms",
                                       "plain_ms", "bound_ms", "bound_by",
                                       "library_ms")},
         "shape": k4_rows[0]["shape"],
         "ulp_flip_rows": sum(r["ulp_flip_rows"]
                              for r in (*k4_rows, k4_wide, *k4_checks)),
         "bit_identical": all(r["bit_identical"]
                              for r in (*k4_rows, k4_wide, *k4_checks)),
         "temperature_0.7": {k: k4_rows[1][k] for k in (
             "max_abs_err", "ms", "device_ms", "plain_ms")},
         "rows_512": {k: k4_wide[k] for k in (
             "shape", "max_abs_err", "ms", "device_ms", "plain_ms",
             "bound_ms", "bound_by", "library_ms")},
         "parent": None if parent is None else {
             name: {k: r[k] for k in ("parent_ms", "parent_device_ms",
                                      "pccp")}
             for name, r in (("t1.0", k4_rows[0]), ("t0.7", k4_rows[1]),
                             ("rows_512", k4_wide))},
         "checks": [{k: r[k] for k in ("shape", "noise", "top_p",
                                       "ulp_flip_rows")}
                    for r in k4_checks],
         "instantiations": k4_split},
        {"name": "swa_bwd", "route": "cuda",
         "source": "sparse_vae_tpu_torch/csrc/swa_bwd.cu",
         "replaces": "sparse_vae_tpu/ops/pallas_kernels.py:337",
         "launches": train_counts["swa_bwd"] + sp_sum("swa_bwd"),
         "launches_by_path": {"train": train_counts["swa_bwd"],
                              "sp-train": sp_sum("swa_bwd")},
         **timed(k2_train), **{k: k2_train[k] for k in (
             "device_ms", "parts_device_ms", "bit_identical")}},
        {"name": "tied_ce_fwd", "route": "cuda",
         "source": "sparse_vae_tpu_torch/csrc/tied_ce.cu",
         "replaces": "sparse_vae_tpu/ops/pallas_ce.py:143",
         "launches": train_counts["tied_ce_fwd"]
         + h4_train_counts["tied_ce_fwd"] + sp_sum("tied_ce_fwd"),
         "launches_by_path": {"train": train_counts["tied_ce_fwd"],
                              "train-h4": h4_train_counts["tied_ce_fwd"],
                              "sp-train": sp_sum("tied_ce_fwd")},
         **timed(k3), **{k: k3[k] for k in (
             "device_ms", "bit_identical", "vocab_splits")}},
        {"name": "tied_ce_bwd", "route": "cuda",
         "source": "sparse_vae_tpu_torch/csrc/tied_ce_bwd.cu",
         "replaces": "sparse_vae_tpu/ops/pallas_ce.py:177",
         "launches": train_counts["tied_ce_bwd"]
         + h4_train_counts["tied_ce_bwd"] + sp_sum("tied_ce_bwd"),
         "launches_by_path": {"train": train_counts["tied_ce_bwd"],
                              "train-h4": h4_train_counts["tied_ce_bwd"],
                              "sp-train": sp_sum("tied_ce_bwd")},
         **timed(k3b), **{k: k3b[k] for k in (
             "device_ms", "parts_device_ms", "chunk_tokens",
             "bit_identical", "checks")}},
        {"name": "swa_fwd_packed", "route": "cuda",
         "source": "sparse_vae_tpu_torch/csrc/swa_fwd.cu",
         "replaces": "sparse_vae_tpu/ops/pallas_kernels.py:590",
         "launches": h4_counts["swa_fwd_packed"]
         + h4_train_counts["swa_fwd_packed"],
         "launches_by_path": {
             "serve-h4": h4_counts["swa_fwd_packed"],
             "train-h4": h4_train_counts["swa_fwd_packed"]},
         **timed(k5_train), "device_ms": k5_train["device_ms"],
         "smaller": smaller(k5_serve, k5_long)},
        {"name": "swa_bwd_packed", "route": "cuda",
         "source": "sparse_vae_tpu_torch/csrc/swa_bwd.cu",
         "replaces": "sparse_vae_tpu/ops/pallas_kernels.py:788",
         "launches": h4_train_counts["swa_bwd_packed"],
         "launches_by_path": {
             "train-h4": h4_train_counts["swa_bwd_packed"]},
         **timed(k5b_train), **{k: k5b_train[k] for k in (
             "device_ms", "parts_device_ms", "bit_identical")},
         "smaller": smaller(k5b_serve, k5b_long)},
        {"name": "sp_windowed_attention", "route": "cuda",
         "source": "sparse_vae_tpu_torch/csrc/swa_fwd.cu",
         "wrapper": "sparse_vae_tpu_torch/ops/sp_kernel.py",
         "replaces": "sparse_vae_tpu/ops/pallas_kernels.py:1031",
         "launches": sp_sum("sp_windowed_attention"),
         "launches_by_rank": {"sp-train": [
             c["sp_windowed_attention"] for c in sp_counts]},
         **timed(k6), "device_ms": k6["device_ms"],
         "k1_device_ms": k6["k1_device_ms"],
         "square": {k: k6_square[k] for k in (
             "shape", "max_abs_err", "ms", "device_ms", "k1_device_ms",
             "plain_ms", "bound_ms", "bound_by", "library_ms")}},
        {"name": "sp_windowed_attention_bwd", "route": "cuda",
         "source": "sparse_vae_tpu_torch/csrc/swa_bwd.cu",
         "wrapper": "sparse_vae_tpu_torch/ops/sp_kernel.py",
         "replaces": "sparse_vae_tpu/ops/pallas_kernels.py:1057",
         "launches": sp_sum("sp_windowed_attention_bwd"),
         "launches_by_rank": {"sp-train": [
             c["sp_windowed_attention_bwd"] for c in sp_counts]},
         "shape": k6["shape"], "max_abs_err": k6["bwd_max_abs_err"],
         "ms": k6["bwd_ms"], "device_ms": k6["bwd_device_ms"],
         "k2_device_ms": k6["bwd_k2_device_ms"],
         "parts_device_ms": k6["bwd_parts_device_ms"],
         "bit_identical": k6["bwd_bit_identical"],
         "plain_ms": k6["bwd_plain_ms"],
         "bound_ms": k6["bwd_bound_ms"], "bound_by": k6["bwd_bound_by"],
         "library_ms": k6["bwd_library_ms"],
         "square": {"shape": k6_square["shape"],
                    "max_abs_err": k6_square["bwd_max_abs_err"],
                    "ms": k6_square["bwd_ms"],
                    "device_ms": k6_square["bwd_device_ms"],
                    "k2_device_ms": k6_square["bwd_k2_device_ms"],
                    "plain_ms": k6_square["bwd_plain_ms"],
                    "bound_ms": k6_square["bwd_bound_ms"],
                    "bound_by": k6_square["bwd_bound_by"],
                    "library_ms": k6_square["bwd_library_ms"]}},
    ]
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
