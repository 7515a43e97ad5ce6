"""Tracing hooks (port of sparse_vae_tpu/utils/profiling.py): a
torch.profiler trace of a few steps written as a Chrome trace, and named
spans (`record_function`) around the phases of a step, so the encoder,
the decoder and the loss show up as labelled ranges in the trace.
"""
from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Iterator, Optional

import torch


def start_trace(device: torch.device):
    """A running torch.profiler session: the host's activity, and the
    card's where `device` is CUDA. Stop it with `stop_trace`."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    profiler = profile(activities=activities)
    profiler.__enter__()
    return profiler


def stop_trace(profiler, device: torch.device, path: Path) -> Path:
    """End `profiler` (after the card's queued work) and write its Chrome
    trace to `path`."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    profiler.__exit__(None, None, None)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    profiler.export_chrome_trace(str(path))
    return path


@contextlib.contextmanager
def trace(log_dir: Optional[Path], enabled: bool = True,
          device: Optional[torch.device] = None) -> Iterator[None]:
    """Trace the enclosed work into <log_dir>/trace_<time>.json (a Chrome
    trace: chrome://tracing or Perfetto). Wrap a few steady steps, not the
    first ones, whose kernel builds and allocations dominate. device: the
    CUDA device to trace as well (default: the current one, if any)."""
    if not enabled or log_dir is None:
        yield
        return
    if device is None:
        device = torch.device("cuda" if torch.cuda.is_available()
                              else "cpu")
    profiler = start_trace(device)
    try:
        yield
    finally:
        stop_trace(profiler, device, Path(log_dir)
                   / f"trace_{time.strftime('%Y%m%d-%H%M%S')}.json")


def annotate(name: str):
    """A named span of the trace around the enclosed work."""
    return torch.profiler.record_function(name)


def annotate_fn(name: str):
    """Decorator form of `annotate`: the function's body is the span."""
    def wrap(fn):
        def inner(*args, **kwargs):
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return inner
    return wrap
