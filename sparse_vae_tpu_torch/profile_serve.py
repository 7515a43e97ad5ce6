"""Where the serving path's time goes on the card:

    python -m sparse_vae_tpu_torch.profile_serve [run=real-prose-vae-r5 |
        heads=N] [batch_size=64] [max_length=512] [prompt=256] [steps=64]

Loads the run in its compute dtype on CUDA, or with `heads=N` builds the
JAX train bench's model at N heads in bf16 from the JAX initialisation
(train.bench_hparams, seed 0, as profile_train does: heads=2 is packed
Dh 256, whose prefill runs the generic forward of csrc/swa_generic.cu;
heads=4 is Dh 128, K5), bulk-prefills every row of a batch_size-row batch
with a `prompt`-token random prompt (K1 for r5), then times
decode slices of `steps` steps with every row live (nucleus sampling at
temperature 1.0, top_p 0.9, repetition penalty 1.2, fused K4 selection):
host-clock step time and tokens/s, and a torch.profiler window of 16 steps
that starts and ends in a synchronize: the device time by kernel, and the
device's idle share of that window, 1 - (union of the device's busy
intervals) / (the window's wall time), read as profile_train reads it
(`busy_share`). Prints one JSON line last. Needs a card; there is no CPU
mode.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

WINDOW = "profile_serve.window"


def _args(argv):
    extra = dict(kv.split("=", 1) for kv in argv[1:])
    if "heads" in extra and "run" in extra:
        raise SystemExit("give run= or heads=, not both")
    return (extra.get("run", "real-prose-vae-r5"),
            int(extra["heads"]) if "heads" in extra else None,
            int(extra.get("batch_size", 64)),
            int(extra.get("max_length", 512)),
            int(extra.get("prompt", 256)), int(extra.get("steps", 64)))


def main(argv) -> int:
    from .checkpoint import load_run, model_from_hparams
    from .models.generation import SamplingParams, init_row_decode_state
    from .ops.attention import fill_cache_row
    from .profile_train import busy_share
    from .serving import make_slice_fn

    if not torch.cuda.is_available():
        print("profile_serve needs a CUDA card", file=sys.stderr)
        return 1
    run, heads, b, ml, prompt, steps = _args(argv)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    if heads is None:
        model, hp, _ = load_run(run, device="cuda")
    else:
        from .train import bench_hparams
        run = f"bench.py --heads {heads} (JAX initialisation, seed 0)"
        hp = bench_hparams(heads)
        model, _ = model_from_hparams(hp, torch.Generator().manual_seed(0),
                                      device="cuda")
    sampling = SamplingParams(temperature=1.0, top_p=0.9,
                              repetition_penalty=1.2)
    # end_token=-1: no row ends early, so every step runs all b rows.
    slice_fn = make_slice_fn(model, sampling, -1, steps, True)
    rng = np.random.default_rng(0)
    dev = torch.device("cuda")

    with torch.inference_mode():
        caches = model.init_caches(b, ml)
        state = init_row_decode_state(
            b, ml, 1, torch.Generator(device=dev).manual_seed(0))
        z = torch.randn((b, 1, hp.latent_depth), device=dev)
        lp = -(-(prompt + 1) // hp.attn_block_size) * hp.attn_block_size
        prefill_s = []
        for row in range(b):
            ids = np.zeros((1, lp), np.int64)
            ids[0, 0] = 1
            ids[0, 1:1 + prompt] = rng.integers(3, hp.vocab_size, prompt)
            ids_t = torch.tensor(ids, device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, kvs = model.reconstruct_hidden(ids_t, z[row:row + 1],
                                              return_kv=True)
            for cache, (k, v) in zip(caches, kvs):
                fill_cache_row(cache, row, k[0], v[0], prompt + 1)
            torch.cuda.synchronize()
            prefill_s.append(time.perf_counter() - t0)
            state.tokens[row, :1 + prompt] = torch.tensor(ids[0, :1 + prompt])
        state.index[:] = prompt + 1

        def decode():
            """One slice from the post-prefill state; its wall seconds."""
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            slice_fn(state, caches, z)
            torch.cuda.synchronize()
            return time.perf_counter() - t0

        decode()                                        # warm-up
        wall = decode()
        step_ms = 1e3 * wall / steps

        from torch.profiler import ProfilerActivity, profile, record_function
        window = 16
        window_fn = make_slice_fn(model, sampling, -1, window, True)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function(WINDOW):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                window_fn(state, caches, z)
                torch.cuda.synchronize()
                prof_wall = time.perf_counter() - t0
        window_us, busy_us = busy_share(prof.events(), WINDOW)
        # Device work only: kernels and copies, not annotation ranges.
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.is_user_annotation]
        device_us = sum(e.self_device_time_total for e in events)
        top = sorted(events, key=lambda e: -e.self_device_time_total)[:12]

    print(f"card: {card}")
    print(f"{'kernel':70s} {'calls':>6s} {'device ms/step':>14s}")
    for e in top:
        print(f"{e.key[:70]:70s} {e.count // window:6d} "
              f"{e.self_device_time_total / 1e3 / window:14.4f}")
    result = {
        "card": card, "run": run, "batch_size": b, "max_length": ml,
        "prompt": prompt, "steps": steps,
        "prefill_ms_median": 1e3 * float(np.median(prefill_s[1:])),
        "decode_step_ms": step_ms,
        "tokens_per_s": b * steps / wall,
        "profiled_step_ms": 1e3 * prof_wall / window,
        "device_ms_per_step": device_us / 1e3 / window,
        "device_busy_ms_per_step": busy_us / 1e3 / window,
        "device_idle_share": 1.0 - busy_us / window_us,
        "kernels_per_step": sum(e.count for e in events) / window,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
