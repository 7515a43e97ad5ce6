"""Process groups of the parallel axes, their transfers, and the launcher
of their ranks.

The JAX package maps its axes (`data`, `seq`, `model`, `expert`) onto a
device mesh inside one program; here every shard is a process. An
`AxisGroup` is one axis as this rank sees it: its coordinate `rank` and
`size` along the axis, the device, the backend, and the torch.distributed
process group `pg` that holds the axis's members (None: the default
group, which is the whole world) with their world ranks `ranks` (None:
0 .. size - 1). parallel/mesh.py builds one per axis; the `seq` axis of
sequence parallelism alone is the world group (`SeqGroup`, the name it
had before the other axes came).

The backend follows from the layout, never from an error caught:
- NCCL when every rank has a card of its own;
- gloo when ranks share one card (NCCL refuses two ranks on one device)
  or run on the CPU. gloo's point-to-point transfers and all-to-all take
  CPU tensors only, so with CUDA tensors every transfer below is staged
  through the host (`AxisGroup.host_staged`), in this module only. The
  seconds those staged transfers take are summed in `staged_seconds`.

Every transfer of the parallel code goes through the functions below:
`all_reduce` (floating point summed in fp32), `broadcast_from_first`,
`shift` (point to point along the axis), `all_to_all` and `all_gather`.
A group of one rank returns its input.

Ranks come from torchrun (RANK, WORLD_SIZE and LOCAL_RANK in the
environment, `from_environment`) or from `spawn`, which starts them itself
and meets them through a `file://` rendezvous in a fresh temporary
directory, so that parallel test workers never race for a TCP port.
"""
from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass
from datetime import timedelta
from pathlib import Path
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

# A collective that waits longer than this raises instead of hanging.
COLLECTIVE_TIMEOUT = timedelta(minutes=10)

# Seconds spent in host-staged transfers by this process (the device
# synchronised first, so the time is the copies and gloo's alone).
staged_seconds = 0.0


@dataclass(frozen=True)
class AxisGroup:
    rank: int
    size: int
    device: torch.device
    backend: str            # "nccl" or "gloo"
    pg: Optional[Any] = None          # None: the default (world) group
    ranks: Optional[tuple] = None     # world ranks; None: 0 .. size - 1

    @property
    def host_staged(self) -> bool:
        """True where tensors cross ranks through the host: gloo with CUDA
        tensors."""
        return self.backend == "gloo" and self.device.type == "cuda"

    def world_rank(self, rank: int) -> int:
        """The world rank of this axis's member `rank`."""
        return rank if self.ranks is None else self.ranks[rank]


# The sequence-parallel group: the world, one length shard a rank.
SeqGroup = AxisGroup


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
                   local_rank: Optional[int] = None) -> AxisGroup:
    """Join the default process group as `rank` of `size` and return the
    world's AxisGroup. device: "cuda" or "cpu"."""
    dev = rank_device(device, rank if local_rank is None else local_rank)
    backend = choose_backend(size, dev)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kwargs = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=size, timeout=COLLECTIVE_TIMEOUT,
                            **kwargs)
    return AxisGroup(rank, size, dev, backend)


def from_environment(device="cuda") -> AxisGroup:
    """The world AxisGroup of a rank started by torchrun (RANK, WORLD_SIZE,
    LOCAL_RANK and its rendezvous variables in the environment)."""
    return init_seq_group(int(os.environ["RANK"]),
                          int(os.environ["WORLD_SIZE"]), device, "env://",
                          int(os.environ.get("LOCAL_RANK", 0)))


def sub_group(world: AxisGroup, members, pg) -> AxisGroup:
    """This rank's AxisGroup among the world ranks `members` (which hold
    it), over the process group `pg` that `dist.new_group(members)` gave.
    Every rank must make every group, in the same order
    (parallel/mesh.py); members spanning the world give the world."""
    members = tuple(members)
    if len(members) == world.size:
        return world
    return AxisGroup(members.index(world.rank), len(members), world.device,
                     world.backend, pg, members)


# -- transfers --------------------------------------------------------------------
def _staged(fn):
    """Run fn() and add its seconds to `staged_seconds` when the group
    stages through the host."""
    def run(x, group, *args, **kwargs):
        if not group.host_staged:
            return fn(x, group, *args, **kwargs)
        global staged_seconds
        torch.cuda.synchronize(x.device)
        t0 = time.perf_counter()
        out = fn(x, group, *args, **kwargs)
        staged_seconds += time.perf_counter() - t0
        return out
    return run


def _send_buffer(x, group: AxisGroup, dtype=None):
    """A contiguous copy of x (in `dtype`) where gloo can read it."""
    buf = x.detach().to(dtype or x.dtype, copy=True).contiguous()
    return buf.cpu() if group.host_staged else buf


@_staged
def all_reduce(x, group: AxisGroup, op=dist.ReduceOp.SUM):
    """A new tensor: x reduced over the group, floating point in fp32,
    returned in x's dtype on x's device."""
    if group.size == 1:
        return x.detach().clone()
    buf = _send_buffer(x, group, torch.float32 if x.is_floating_point()
                       else x.dtype)
    dist.all_reduce(buf, op=op, group=group.pg)
    return buf.to(device=x.device, dtype=x.dtype)


def all_reduce_sum(x, group: AxisGroup):
    """x summed over the group, without a gradient (counts, statistics)."""
    return all_reduce(x, group)


@_staged
def broadcast_from_first(x, group: AxisGroup):
    """The group's first member's x on every rank, without a gradient."""
    if group.size == 1:
        return x.detach().clone()
    buf = _send_buffer(x, group)
    dist.broadcast(buf, src=group.world_rank(0), group=group.pg)
    return buf.to(x.device)


@_staged
def shift(x, group: AxisGroup, step: int):
    """Member r receives member r - step's x (zeros where there is none):
    step 1 moves data to the right, -1 to the left."""
    send = _send_buffer(x, group)
    recv = torch.zeros_like(send)
    ops = []
    if 0 <= group.rank + step < group.size:
        ops.append(dist.P2POp(dist.isend, send,
                              group.world_rank(group.rank + step),
                              group=group.pg))
    if 0 <= group.rank - step < group.size:
        ops.append(dist.P2POp(dist.irecv, recv,
                              group.world_rank(group.rank - step),
                              group=group.pg))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return recv.to(x.device)


@_staged
def all_to_all(x, group: AxisGroup):
    """x [size, ...]: slice j goes to member j, and slice j of the result
    came from member j."""
    if group.size == 1:
        return x.detach().clone()
    send = _send_buffer(x, group)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group.pg)
    return recv.to(x.device)


@_staged
def all_gather(x, group: AxisGroup, dim: int = 0):
    """Every member's x concatenated along `dim` in member order."""
    if group.size == 1:
        return x.detach().clone()
    send = _send_buffer(x, group)
    parts = [torch.empty_like(send) for _ in range(group.size)]
    dist.all_gather(parts, send, group=group.pg)
    return torch.cat(parts, dim=dim).to(x.device)


def barrier(group: AxisGroup):
    """Wait for every member of the group."""
    if group.size > 1:
        dist.barrier(group=group.pg)


# -- ranks ----------------------------------------------------------------------
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
    """Run fn(world_group, *args) on `size` new ranks and return their
    results in rank order. `fn` must live in a module that imports neither
    jax nor the JAX package, since every rank imports it; it returns
    something torch.save takes. Raises if any rank fails or the ranks are
    not done within `timeout` seconds, after stopping every rank."""
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
