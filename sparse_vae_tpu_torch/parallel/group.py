"""The `seq` process group of sequence parallelism (port of the `seq` axis
of sparse_vae_tpu/parallel/mesh.py) and the launcher of its ranks.

The JAX package maps the length axis onto a `seq` axis of a device mesh
inside one program; here every shard is a process, rank r of a
torch.distributed group of `size` ranks holding positions r*S..r*S+S-1.
`SeqGroup` holds what the parallel code needs: the rank, the size, the
device and the backend.

The backend follows from the layout, never from an error caught:
- NCCL when every rank has a card of its own;
- gloo when ranks share one card (NCCL refuses two ranks on one device)
  or run on the CPU. gloo's point-to-point send and receive take CPU
  tensors only, so with CUDA tensors every collective of this package is
  staged through the host (`SeqGroup.host_staged`).

Ranks come from torchrun (RANK, WORLD_SIZE and LOCAL_RANK in the
environment, `from_environment`) or from `spawn`, which starts them itself
and meets them through a `file://` rendezvous in a fresh temporary
directory, so that parallel test workers never race for a TCP port.
The data, model, pipe and expert axes are not ported.
"""
from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass
from datetime import timedelta
from pathlib import Path
from typing import Callable, Optional

import torch
import torch.distributed as dist

# A collective that waits longer than this raises instead of hanging.
COLLECTIVE_TIMEOUT = timedelta(minutes=10)


@dataclass(frozen=True)
class SeqGroup:
    rank: int
    size: int
    device: torch.device
    backend: str            # "nccl" or "gloo"

    @property
    def host_staged(self) -> bool:
        """True where tensors cross ranks through the host: gloo with CUDA
        tensors."""
        return self.backend == "gloo" and self.device.type == "cuda"


def rank_device(device, local_rank: int) -> torch.device:
    """The device of a rank: cuda:{local_rank % device_count} for "cuda",
    the CPU for "cpu"."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the ranks on the CPU")
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def choose_backend(size: int, device) -> str:
    """NCCL when each of `size` ranks has its own card, else gloo."""
    device = torch.device(device)
    if device.type == "cuda" and torch.cuda.device_count() >= size:
        return "nccl"
    return "gloo"


def init_seq_group(rank: int, size: int, device, init_method: str,
                   local_rank: Optional[int] = None) -> SeqGroup:
    """Join the default process group as `rank` of `size` and return its
    SeqGroup. device: "cuda" or "cpu"."""
    dev = rank_device(device, rank if local_rank is None else local_rank)
    backend = choose_backend(size, dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kwargs = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=size, timeout=COLLECTIVE_TIMEOUT,
                            **kwargs)
    return SeqGroup(rank, size, dev, backend)


def from_environment(device="cuda") -> SeqGroup:
    """The SeqGroup of a rank started by torchrun (RANK, WORLD_SIZE,
    LOCAL_RANK and its rendezvous variables in the environment)."""
    return init_seq_group(int(os.environ["RANK"]),
                          int(os.environ["WORLD_SIZE"]), device, "env://",
                          int(os.environ.get("LOCAL_RANK", 0)))


def _rank_main(rank: int, fn: Callable, size: int, device, workdir: str,
               args: tuple):
    group = init_seq_group(rank, size, device,
                           f"file://{workdir}/rendezvous")
    try:
        result = fn(group, *args)
        torch.save(result, Path(workdir) / f"result-{rank}.pt")
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, size: int, device, args: tuple = (),
          timeout: float = 900.0) -> list:
    """Run fn(group, *args) on `size` new ranks and return their results
    in rank order. `fn` must live in a module that imports neither jax nor
    the JAX package, since every rank imports it; it returns something
    torch.save takes. Raises if any rank fails or the ranks are not done
    within `timeout` seconds, after stopping every rank."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="svt-sp-") as workdir:
        ctx = mp.start_processes(_rank_main,
                                 args=(fn, size, str(device), workdir, args),
                                 nprocs=size, join=False,
                                 start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{size} ranks not done within "
                                       f"{timeout:.0f} s")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.kill()
                proc.join()
        return [torch.load(Path(workdir) / f"result-{rank}.pt",
                           weights_only=False) for rank in range(size)]
