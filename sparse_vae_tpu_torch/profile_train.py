"""Where the training step's time goes on the card:

    python -m sparse_vae_tpu_torch.profile_train [run=real-prose-vae-r5]
        [heads=N | geometry=<run>] [batch=8] [seq=12800] [accumulate=1]
        [steps=5] [profiled=3] [remat=<policy>[,<policy>...]]
        [layers=1] [trace=<path>]

Loads the run (a Transformer-VAE or a Transformer LM run with weights)
in its training form (fp32 master parameters, bf16 compute, kernels on)
on CUDA, or with `heads=N` builds the JAX train bench's model at N heads
from the JAX initialisation with no archive (train.py `bench_hparams`;
heads=4 is the Dh = 128 geometry, whose decoder attention runs the
packed kernels K5/K5b; heads=2 is packed Dh 256 and heads=16 head-major
Dh 32, both on the generic pair of csrc/swa_generic.cu), or with
`geometry=<run>` the model of that run's
meta.json hparams from the JAX initialisation (train.py `run_hparams`:
`geometry=real-prose-lm-r4 batch=14 seq=3584` is the dense Transformer
LM at the preset's 50,000-token batches on full rows, the dense causal
pair of csrc/causal_fwd.cu and causal_bwd.cu and K3/K3b at D = 512), and trains on the JAX train
bench's traffic
(bench.py): every row a full document of `seq` random ids, so every slot
is a real token. After two warm-up steps it times `steps` optimizer steps
of `accumulate` micro-batches of [batch, seq] on the host clock (each
step ends in a synchronize): step time and real tokens/s. Then
`profiled` more steps run under torch.profiler, as one window that
starts and ends in a synchronize: the device time by kernel per step,
and the device's idle share of that window, 1 - (union of the device's
busy intervals) / (the window's wall time). The profiler has been seen
to drop kernel records, so a window counts when it holds a record for
every kernel launch the runtime saw in it (`kernel_records`), and is
otherwise profiled again, up to TRACE_ATTEMPTS windows; the last one then
counts, with its missing records a step in the JSON line. The profiler slows the host,
so the window's step time is printed beside the unprofiled one. Also
reports max_memory_allocated over the run. Prints one JSON line last.
Needs a card; there is no CPU mode.

remat= switches the decoder layers' rematerialisation (models/remat.py)
to each named policy in turn ("none": off) and measures each on the same
model, state and batches, one JSON line a policy; without it the model
keeps its meta's policy. layers=1 adds each decoder layer's host
milliseconds, median over `steps` more steps: its forward call, and its
backward from the gradient reaching its output to the gradient leaving
its input (the recompute included), on the host clock without a
synchronize inside the step, so they are the host's dispatch time while
the card keeps up. trace=<path> writes a Chrome trace of one more step
(utils/profiling.py `start_trace`), a policy's name before the suffix.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

WINDOW = "profile_train.window"
TRACE_ATTEMPTS = 5
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel")


KEYS = {"run", "heads", "geometry", "batch", "seq", "accumulate", "steps",
        "profiled", "remat", "layers", "trace"}


def _args(argv):
    extra = dict(kv.split("=", 1) for kv in argv[1:])
    unknown = set(extra) - KEYS
    if unknown:
        raise SystemExit(f"unknown keys {sorted(unknown)}; known: "
                         f"{sorted(KEYS)}")
    heads = int(extra["heads"]) if "heads" in extra else None
    if heads is not None and "geometry" in extra:
        raise SystemExit("give heads= or geometry=, not both")
    return (extra.get("run", "real-prose-vae-r5"), heads,
            extra.get("geometry"),
            int(extra.get("batch", 8)), int(extra.get("seq", 12800)),
            int(extra.get("accumulate", 1)), int(extra.get("steps", 5)),
            int(extra.get("profiled", 3)),
            extra["remat"].split(",") if "remat" in extra else [None],
            extra.get("layers") == "1", extra.get("trace"))


def set_remat(model, name: str) -> None:
    """Every decoder layer rematerialised under policy `name` ("none":
    off)."""
    from .models.transformer_lm import checkpoint_policy
    remat = None if name == "none" else checkpoint_policy(name)
    for layer in model.decoder_layers:
        layer.remat = remat


def layer_host_ms(model, one_step, steps: int) -> dict:
    """Each decoder layer's host ms, median over `steps` steps: its
    forward call, and its backward from the gradient reaching its output
    to the gradient leaving its input (module hooks and tensor hooks; the
    backward's run on the autograd engine's thread)."""
    marks: dict = {}

    def stamp(key):
        def hook(*_):
            marks[key] = time.perf_counter()
        return hook

    def pre(i):
        def hook(module, args):
            marks["f0", i] = time.perf_counter()
            if args[0].requires_grad:
                args[0].register_hook(stamp(("b1", i)))
        return hook

    def post(i):
        def hook(module, args, out):
            marks["f1", i] = time.perf_counter()
            y = out[0] if isinstance(out, tuple) else out
            if y.requires_grad:
                y.register_hook(stamp(("b0", i)))
        return hook

    layers = list(model.decoder_layers)
    handles = [h for i, layer in enumerate(layers)
               for h in (layer.register_forward_pre_hook(pre(i)),
                         layer.register_forward_hook(post(i)))]
    fwd, bwd = [], []
    try:
        for i in range(steps):
            marks.clear()
            one_step(i)
            torch.cuda.synchronize()
            fwd.append([1e3 * (marks["f1", j] - marks["f0", j])
                        for j in range(len(layers))])
            bwd.append([1e3 * (marks["b1", j] - marks["b0", j])
                        for j in range(len(layers))])
    finally:
        for h in handles:
            h.remove()
    return {"layer_forward_host_ms": np.median(fwd, axis=0).tolist(),
            "layer_backward_host_ms": np.median(bwd, axis=0).tolist()}


def busy_share(events, window_name: str = WINDOW) -> tuple[float, float]:
    """(window wall us, union of device busy us inside it) from the
    profiler's events: the window is the one host range named
    `window_name`, and the device's busy time is the union of its kernel
    and copy intervals clipped to it (overlapping intervals count once).
    profile_serve reads its idle share the same way."""
    window = [e.time_range for e in events
              if e.name == window_name and e.device_type
              == torch.autograd.DeviceType.CPU]
    if len(window) != 1:
        raise RuntimeError(f"expected one {window_name} range, found "
                           f"{len(window)}")
    lo, hi = window[0].start, window[0].end
    spans = sorted((max(e.time_range.start, lo), min(e.time_range.end, hi))
                   for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.is_user_annotation)
    busy, end = 0.0, lo
    for start, stop in spans:
        start = max(start, end)
        if stop > start:
            busy += stop - start
            end = stop
    return hi - lo, busy


def kernel_records(averages) -> tuple[int, int]:
    """(kernel launches the runtime saw, kernel records on the device) in
    a trace's key_averages(). A trace that kept every kernel has at least
    as many records as counted launches (a launch through an API not in
    LAUNCH_CALLS adds a record and no count)."""
    launched = sum(e.count for e in averages
                   if e.key.startswith(LAUNCH_CALLS))
    recorded = sum(e.count for e in averages
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.is_user_annotation
                   and not e.key.startswith(("Memcpy", "Memset")))
    return launched, recorded


def per_call_device_ms(averages, iters: int):
    """Device ms per call by kernel name from the key_averages() of a trace
    of `iters` identical calls, or None if the trace has lost too much.
    The profiler drops a kernel record now and then (on an H100 with
    torch 2.11 and CUDA 12.8: one of 15 in every trace of some
    processes, a whole call's in others), so each name's time is its mean per record times its
    launches per call, its record count over `iters` rounded: a record or
    two missing leave that unchanged. None when those rounded counts fall
    short of the kernel launches the runtime saw (`kernel_records`)."""
    launched, _ = kernel_records(averages)
    on_device = [e for e in averages
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and not e.is_user_annotation and e.count > 0]
    per_call = {e.key: round(e.count / iters) for e in on_device}
    kernels = sum(per_call[e.key] for e in on_device
                  if not e.key.startswith(("Memcpy", "Memset")))
    if kernels * iters < launched:
        return None
    return {e.key: e.self_device_time_total / 1e3 / e.count
            * per_call[e.key] for e in on_device if per_call[e.key]}


def main(argv) -> int:
    from .train import bench_hparams, build, build_from_hparams, run_hparams
    from .training.data import synthetic_batch

    if not torch.cuda.is_available():
        print("profile_train needs a CUDA card", file=sys.stderr)
        return 1
    (run, heads, geometry, b, seq, accumulate, steps, profiled, policies,
     layers, trace) = _args(argv)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    if geometry is not None:
        run = f"{geometry}'s hparams (JAX initialisation, seed 0)"
        model, objective, optimizer, _ = build_from_hparams(
            run_hparams(geometry), torch.Generator().manual_seed(0), dev)
    elif heads is None:
        model, objective, optimizer, accumulate = build(run, dev, accumulate)
    else:
        run = f"bench.py --heads {heads} (JAX initialisation, seed 0)"
        model, objective, optimizer, _ = build_from_hparams(
            bench_hparams(heads), torch.Generator().manual_seed(0), dev)
    rng = np.random.default_rng(0)
    generator = torch.Generator(device=dev).manual_seed(0)
    vocab = model.hparams.vocab_size
    batches = [[synthetic_batch(rng, b, seq, vocab, min_tokens=seq,
                                device=dev)
                for _ in range(accumulate)] for _ in range(2)]
    slots = sum(int(mb["token_ids"].numel()) for mb in batches[0])
    real = sum(int(mb["num_tokens"].sum()) for mb in batches[0])
    for policy in policies:
        if policy is not None:
            set_remat(model, policy)
        _measure(model, objective, optimizer, batches, generator, card,
                 dict(run=run, batch=b, seq=seq, accumulate=accumulate,
                      steps=steps, profiled=profiled, slots=slots,
                      real=real, policy=policy, layers=layers,
                      trace=trace))
    return 0


def _measure(model, objective, optimizer, batches, generator, card,
             opts) -> None:
    """One policy's timed steps, profiled window, layer times and trace;
    prints its table and JSON line."""
    from .training.train_step import train_step
    steps, profiled = opts["steps"], opts["profiled"]
    real = opts["real"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    def one_step(i):
        metrics = train_step(model, objective, optimizer, batches[i % 2], i,
                             generator=generator)
        return float(metrics["loss"])

    def timed_step(i):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = one_step(i)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, loss

    for i in range(2):                                   # warm-up
        timed_step(i)
    walls, losses = zip(*(timed_step(i) for i in range(2, 2 + steps)))
    step_s = float(np.median(walls))

    from torch.profiler import ProfilerActivity, profile, record_function
    first = 2 + steps
    for attempt in range(TRACE_ATTEMPTS):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with record_function(WINDOW):
                torch.cuda.synchronize()
                for i in range(first, first + profiled):
                    one_step(i)
                torch.cuda.synchronize()
        first += profiled
        averages = prof.key_averages()
        launched, recorded = kernel_records(averages)
        if recorded >= launched:
            break
        print(f"profiler trace incomplete: {recorded} kernel records for "
              f"{launched} launches; profiled again", flush=True)
    # After TRACE_ATTEMPTS short windows the last one counts, its missing
    # records reported (a record or two of thousands moves the idle share
    # by less than its spread between windows).
    window_us, busy_us = busy_share(prof.events())
    # Device work only: kernels and copies, not the annotation ranges,
    # which span kernels already counted.
    kernels = [e for e in averages
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.is_user_annotation]
    device_us = sum(e.self_device_time_total for e in kernels) / profiled
    top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]

    print(f"card: {card}")
    print(f"{'kernel':70s} {'calls/step':>10s} {'device ms/step':>14s}")
    for e in top:
        print(f"{e.key[:70]:70s} {e.count / profiled:10.1f} "
              f"{e.self_device_time_total / 1e3 / profiled:14.3f}")
    extra = {}
    if opts["layers"]:
        extra = layer_host_ms(model, one_step, steps)
    if opts["trace"]:
        from .utils.profiling import start_trace, stop_trace
        stem, dot, suffix = opts["trace"].rpartition(".")
        path = (f"{stem}-{opts['policy'] or 'meta'}.{suffix}" if dot
                else f"{opts['trace']}-{opts['policy'] or 'meta'}")
        profiler = start_trace(torch.device("cuda"))
        one_step(0)
        extra["trace"] = str(stop_trace(profiler, torch.device("cuda"),
                                        path))
    remat = getattr(model.decoder_layers[0], "remat", None)
    result = {
        "card": card, "run": opts["run"], "batch": opts["batch"],
        "seq": opts["seq"], "accumulate": opts["accumulate"],
        "steps": steps,
        "remat": None if remat is None else remat.name,
        "slots_per_step": opts["slots"], "real_tokens_per_step": real,
        "step_ms_median": 1e3 * step_s,
        "step_ms_all": [1e3 * w for w in walls],
        "real_tokens_per_s": real / step_s,
        "losses": list(losses),
        "profiled_steps": profiled,
        "profiled_step_ms": window_us / 1e3 / profiled,
        "device_ms_per_step": device_us / 1e3,
        "device_busy_ms_per_step": busy_us / 1e3 / profiled,
        "device_idle_share": 1.0 - busy_us / window_us,
        "kernels_per_step": sum(e.count for e in kernels) / profiled,
        "kernel_launches_per_step": launched / profiled,
        "profiled_windows": attempt + 1,
        "kernel_records_missing": max(0, launched - recorded) / profiled,
        # [name, launches per step, device ms per step]; a list, since
        # kernel names can share a long prefix.
        "top_kernels": [[e.key[:120], e.count / profiled,
                         e.self_device_time_total / 1e3 / profiled]
                        for e in top],
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        **extra,
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
