"""Train a model of any of the four families on the port, in one of two
forms.

The training run, the JAX package's `train.py` CLI:

    python -m sparse_vae_tpu_torch.train
        {transformer-vae|transformer-lm|lstm-vae|lstm-lm}
        [model.k=v ...] [data.k=v ...] [trainer.k=v ...] [preset=<name>]
        [name=<run>] [from_checkpoint=<run>] [no_log=true]
        [anomaly_detection=true] [device=cuda]

(e.g. `train lstm-vae preset=lstm-benchmark`: the LSTM-VAE at the
lstm-benchmark preset from the JAX package's default initialisers)

assembles the configuration (cli.py: defaults, the dotlist, a preset),
prepares the corpus (data/: tokenizer, token cache, length buckets) and
runs `Trainer.fit` (training/trainer.py) from the JAX initialisation:
validation, early stopping, checkpoints under
sparse-vae-logs/<experiment>/<name>/, and every
trainer.sample_every_n_steps a sample and, for a VAE, a reconstruction
with its BLEU (cli.make_sample_fns). from_checkpoint=<run> resumes
that run with its saved hparams as the base. It is selected when the
argument after the experiment is absent or holds a `=`. With
trainer.num_devices=N > 1 (and trainer.model_parallel,
trainer.seq_parallel or trainer.expert_parallel) it trains on a mesh of
N ranks (parallel/mesh.py: data x seq x model or data x expert):
spawned here, rank r on cuda:{r %
device_count} (all on the CPU with device=cpu), or, under torchrun (RANK
and WORLD_SIZE set), this process as one rank. Rank 0 prepares the corpus
before the others read it, and rank 0 logs and writes the checkpoints,
gathered to the single-device format.

The step run on an archived model's weights:

    python -m sparse_vae_tpu_torch.train <experiment>
        <run-name> [steps=10] [batch=8] [seq=12800] [accumulate=<run's>]
        [seed=0] [device=cuda] [sp=1] [dp=1] [tp=1] [ep=1]

loads runs/<run-name>/ (a run of that experiment, such as
real-prose-vae-r5 or draft-tlm-r5) in its training form (fp32 master
parameters, the run's compute dtype) with its objective (the ELBO or the
next-token NLL) and takes `steps` optimizer steps of `accumulate`
micro-batches of [batch, seq] seeded random token ids with ragged
document lengths (training/data.py, the train bench's stand-in for a
corpus). The optimizer is the run's: RAdam (or LAMB) behind the
global-norm clip on the cosine schedule, at the JAX trainer's lr
(`run_lr`). Prints one JSON line of metrics per step.

sp=N > 1 shards the length axis over N ranks (sequence parallelism,
parallel/; a run with sparse attention): lengths are padded to a
multiple of N * window * block, the kernels are built once here, and N
ranks are spawned, rank r on cuda:{r % device_count} (or all on the CPU
with device=cpu). Under torchrun (RANK and WORLD_SIZE set) this process
is one rank of that group instead, on cuda:{LOCAL_RANK % device_count}.
The Transformer-VAE alone runs its own loop (`train_rank`); the
Transformer LM (`sp=N` on a run with sparse attention) runs the mesh's
(`mesh_rank`, data 1 x seq N).
Every rank runs with the same weights and the same global batches,
holding positions r * L / N .. (r + 1) * L / N - 1. The process group is NCCL when every
rank has a card of its own and gloo otherwise (parallel/group.py); the
chosen backend is printed. Every rank prints its own line per step
({"rank", "step", "seconds", ...}); rank 0 also prints the step's
metrics, the same on every rank.

dp=, tp= and ep= train on a mesh of dp x sp x tp x ep ranks
(parallel/mesh.py; ep beside neither tp nor sp, as in the JAX package):
tensor parallelism over tp (heads, FFNs, the tied vocabulary), sequence
parallelism over sp (each row's length), expert parallelism over ep (an
MoE run's experts), the rows of each global batch over dp (x ep). The
ranks are spawned as for sp=N, or come from torchrun, whose WORLD_SIZE
gives dp. Each rank prints its line per step, rank 0 also the step's
metrics (`mesh_rank`).

`build_from_hparams` builds a model with no archive instead: hparams plus
the JAX package's initialisation, at `bench_hparams`, the JAX train
bench's geometry, or at a run's meta.json hparams (`run_hparams`: such
as real-prose-lm-r4, which has no weights).
"""
from __future__ import annotations

import json
import os
import sys
import time

KEYS = {"steps", "batch", "seq", "accumulate", "seed", "device", "sp",
        "dp", "tp", "ep"}


def run_lr(hp, meta: dict, accumulate: int) -> float:
    """The JAX trainer's lr (training/trainer.py): the run's lr scaled by
    the data's token budget per optimizer step, tokens_per_batch *
    accumulate, against base_batch_size."""
    from .utils.schedules import scaled_lr

    tokens = meta["data_hparams"]["tokens_per_batch"] * accumulate
    return scaled_lr(hp.lr, tokens, hp.base_batch_size)


def _optimizer(model, hp, lr: float):
    from .training.optimizer import make_optimizer

    return make_optimizer(model.parameters(), lr=lr,
                          lr_decay_steps=hp.lr_decay_steps,
                          grad_clip_threshold=hp.grad_clip_threshold,
                          weight_decay=hp.weight_decay, lamb=hp.lamb)


def build(name: str, device="cuda", accumulate=None,
          use_kernels: bool = True, dtype=None):
    """(model, objective, optimizer, accumulate) for runs/<name> (a
    Transformer-VAE with VAEObjective or a Transformer LM with
    ARObjective) on `device`, the optimizer at `run_lr`; accumulate
    defaults to the run's accumulate_grad_batches."""
    from .checkpoint import load_run
    from .cli import objective_for

    model, hp, meta = load_run(name, device=device, dtype=dtype, train=True,
                               use_kernels=use_kernels)
    if accumulate is None:
        accumulate = meta.get("trainer_hparams", {}).get(
            "accumulate_grad_batches", 1)
    optimizer = _optimizer(model, hp, run_lr(hp, meta, accumulate))
    return model, objective_for(hp), optimizer, accumulate


def bench_hparams(num_heads: int = 4):
    """The JAX train bench's Transformer-VAE (bench.py, `--heads`; 4 heads
    give Dh = 128, the packed-attention geometry): d_model 512, 6 decoder
    layers, a 3-layer Perceiver with 64 latents, latent 64, vocab 32,768,
    window 2 x block 128, bf16, with the bench optimizer's lr 3e-4 (not
    scaled), 250,000 decay steps and clip 150."""
    from .models.transformer_vae import TransformerVAEHparams

    return TransformerVAEHparams(
        d_model=512, num_heads=num_heads, num_layers=6, latent_depth=64,
        vocab_size=2 ** 15, num_encoder_latents=64,
        sparse_self_attention=True, attn_window_size=2, attn_block_size=128,
        loss_chunk_size=2048, use_pallas_kernel=True, precision="bf16",
        lr=3e-4, lr_decay_steps=250_000, grad_clip_threshold=150.0)


def run_hparams(name: str):
    """The model hparams of runs/<name>/meta.json (a run with or without
    weights)."""
    from .checkpoint import hparams_from_meta, run_directory

    meta = json.loads((run_directory(name) / "meta.json").read_text())
    return hparams_from_meta(meta)


def build_from_hparams(hparams, generator, device="cuda",
                       use_kernels: bool = True, dtype=None):
    """(model, objective, optimizer, 1) for a model with no archive:
    `hparams` plus the JAX initialisation drawn from `generator` (a CPU
    torch.Generator), in the training form of `build`, the optimizer at
    hparams.lr as bench.py gives it."""
    from .checkpoint import model_from_hparams
    from .cli import objective_for

    model, hp = model_from_hparams(hparams, generator, device=device,
                                   dtype=dtype, train=True,
                                   use_kernels=use_kernels)
    return model, objective_for(hp), _optimizer(model, hp, hp.lr), 1


def param_digest(model) -> str:
    """sha256 of every parameter's bytes, in order: equal digests are
    bitwise equal parameters."""
    return param_digest_of(model.parameters())


def param_digest_of(tensors) -> str:
    """sha256 of the tensors' bytes, in order."""
    import hashlib

    import torch

    digest = hashlib.sha256()
    with torch.no_grad():
        for t in tensors:
            digest.update(t.detach().float().cpu().numpy().tobytes())
    return digest.hexdigest()


def train_rank(group, name: str, steps: int, batch: int, seq: int,
               seed: int = 0, accumulate=None, noise=None,
               keep_grads: bool = False, report: bool = True,
               use_kernels: bool = True, dtype=None) -> dict:
    """One rank of a sequence-parallel run of runs/<name>: `steps` optimizer
    steps on this rank's slice of seeded global batches (the same batches
    on every rank, and the same as an unsharded run with this seed gives
    at the padded length). noise: the first step's per-micro-batch
    {"eps", "mi"}, or None to draw all noise from the seeded generator
    (broadcast from rank 0). Returns the rank's record: metrics, step
    seconds, launch counts, peak memory, a digest of the parameters after
    each step and, with keep_grads on rank 0, the first step's summed
    gradients on the CPU. use_kernels and dtype as for `build` (False and
    fp32: the plain reference path)."""
    import numpy as np
    import torch

    from .ops import launches
    from .parallel.sp import shard_length, sp_localize, sp_pad_multiple
    from .training.data import synthetic_batch
    from .training.train_step import train_step

    device = group.device
    if device.type == "cpu":    # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // group.size))
    if noise is not None:
        noise = [{k: v.to(device) for k, v in n.items()} for n in noise]
    model, objective, optimizer, accumulate = build(
        name, device, accumulate, use_kernels=use_kernels, dtype=dtype)
    sp_localize(model, group)
    pad = sp_pad_multiple(model.hparams, group.size)
    rng = np.random.default_rng(seed)
    generator = torch.Generator(device=device).manual_seed(seed)
    vocab = model.hparams.vocab_size
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    launches.reset()
    record = {"rank": group.rank, "size": group.size,
              "backend": group.backend, "device": str(device),
              "metrics": [], "step_s": [], "param_digests": []}
    for step in range(steps):
        mbs = []
        for _ in range(accumulate):
            mb = synthetic_batch(rng, batch, seq, vocab,
                                 pad_to_multiple_of=pad)
            mbs.append({"token_ids": shard_length(mb["token_ids"], group)
                        .contiguous().to(device),
                        "num_tokens": mb["num_tokens"].to(device)})
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        metrics = train_step(model, objective, optimizer, mbs, step,
                             noise if step == 0 else None, generator)
        out = {k: float(v) for k, v in metrics.items()}
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds = time.perf_counter() - t0
        if keep_grads and step == 0 and group.rank == 0:
            record["grads"] = {n: p.grad.detach().float().cpu()
                               for n, p in model.named_parameters()}
        record["metrics"].append(out)
        record["step_s"].append(seconds)
        record["param_digests"].append(param_digest(model))
        if report:
            line = {"rank": group.rank, "step": step, "seconds": seconds,
                    "local_tokens": int(sum((m["token_ids"] != 0).sum()
                                            for m in mbs))}
            if device.type == "cuda":
                line["max_memory_allocated"] = \
                    torch.cuda.max_memory_allocated(device)
            print(json.dumps(line), flush=True)
            if group.rank == 0:
                print(json.dumps({**out, "step": step, "seconds": seconds,
                                  "tokens": batch * seq * accumulate,
                                  "sp": group.size}), flush=True)
    record["launches"] = launches.read()
    if device.type == "cuda":
        record["max_memory_allocated"] = torch.cuda.max_memory_allocated(
            device)
    return record


def mesh_rank(world, source, steps: int, batch: int, seq: int,
              seed: int = 0, accumulate=None, tp: int = 1, ep: int = 1,
              noise=None, keep_grads: bool = False, report: bool = True,
              use_kernels: bool = True, dtype=None, first_step=None,
              drops: bool = False, sp: int = 1) -> dict:
    """One rank of a mesh run (tp, sp and ep as `create_mesh`'s
    model_axis, seq_axis and expert_axis; data = the world / (tp * sp *
    ep)): `steps` optimizer steps on this rank's part of seeded global
    batches [batch, seq] (its rows; with sp > 1 its slice of their length,
    padded to a multiple of `sp_pad_multiple`: the same batches on every
    rank, and the same as an unsharded run with this seed gives at that
    length). source: a run name (`build`) or hparams (`build_from_hparams`
    with the JAX initialisation drawn from `seed`). noise: the first
    step's per-micro-batch global {"eps", "mi"}, or None to draw it from
    the seeded generator. first_step: settings of the first step alone,
    {"capacity_factor": an MoE model's, "dropout": False for the
    layers' FFN dropout at rate 0} (its masks are per row shard, so a
    step with them is not the unsharded step's): a step to hold against
    the unsharded one, then the run's own settings. Returns the rank's
    record: its mesh coordinates, metrics, step seconds, seconds in
    host-staged transfers, launch counts, peak memory, a digest of its
    parameters after each step and of each parameter at the end, with
    keep_grads the first step's full gathered gradients on the CPU (rank
    0), and with drops (an MoE model) the share of each layer's
    dispatches that capacity dropped on this rank's part of the last
    micro-batch, and each layer's routes (assign, keep) of its part of
    the first micro-batch before the first step."""
    import numpy as np
    import torch

    from .ops import launches
    from .parallel import group as pgroup
    from .parallel.mesh import create_mesh, shard_batch
    from .parallel.sp import sp_pad_multiple
    from .parallel.spmd import localize, mesh_norm_fn, shard_layout
    from .parallel.tp import gather_state
    from .training.data import synthetic_batch
    from .training.optimizer import make_optimizer
    from .training.train_step import train_step

    device = world.device
    if device.type == "cpu":    # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world.size))
    mesh = create_mesh(world, model_axis=tp, seq_axis=sp, expert_axis=ep)
    if isinstance(source, str):
        model, objective, _, accumulate = build(
            source, device, accumulate, use_kernels=use_kernels,
            dtype=dtype)
        from .checkpoint import run_directory
        meta = json.loads((run_directory(source) / "meta.json").read_text())
        lr = run_lr(model.hparams, meta, accumulate)
    else:
        model, objective, _, _ = build_from_hparams(
            source, torch.Generator().manual_seed(seed), device,
            use_kernels=use_kernels, dtype=dtype)
        accumulate, lr = accumulate or 1, model.hparams.lr
    hp = model.hparams
    pad = sp_pad_multiple(hp, sp) if sp > 1 else 512
    model = localize(model, mesh)
    layers = getattr(model, "decoder_layers", [])
    run_settings = [(layer.dropout_rate, layer.moe.capacity_factor
                     if layer.is_moe else None) for layer in layers]
    first_step = first_step or {}
    optimizer = make_optimizer(
        model.parameters(), lr=lr, lr_decay_steps=hp.lr_decay_steps,
        grad_clip_threshold=hp.grad_clip_threshold,
        weight_decay=hp.weight_decay, lamb=hp.lamb, tp_size=tp,
        ep_size=ep, norm_fn=mesh_norm_fn(model, mesh))
    rng = np.random.default_rng(seed)
    generator = torch.Generator(device=device).manual_seed(seed)
    if noise is not None:
        noise = [{k: v.to(device) for k, v in n.items()} for n in noise]
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    launches.reset()
    pgroup.staged_seconds = 0.0
    record = {"rank": world.rank, "size": world.size,
              "backend": world.backend, "device": str(device),
              "mesh": dict(mesh.shape),
              "coords": {a: mesh.coord(a) for a in mesh.shape},
              "metrics": [], "step_s": [], "staged_s": [],
              "param_digests": []}
    for step in range(steps):
        mbs = []
        for _ in range(accumulate):
            mb = synthetic_batch(rng, batch, seq, hp.vocab_size,
                                 pad_to_multiple_of=pad)
            mbs.append({k: v.to(device)
                        for k, v in shard_batch(mb, mesh).items()})
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        for layer, (rate, capacity) in zip(layers, run_settings):
            first = step == 0
            layer.dropout_rate = (0.0 if first and first_step.get(
                "dropout") is False else rate)
            if capacity is not None:
                layer.moe.capacity_factor = (first_step.get(
                    "capacity_factor", capacity) if first else capacity)
        if drops and step == 0:
            stats = []
            with torch.no_grad():
                model.forward_hidden(mbs[0]["token_ids"], moe_stats=stats)
            record["routes"] = [(s["assign"].cpu(), s["keep"].cpu())
                                for s in stats]
            launches.reset()    # the steps' launches alone
        staged0 = pgroup.staged_seconds
        t0 = time.perf_counter()
        metrics = train_step(model, objective, optimizer, mbs, step,
                             noise if step == 0 else None, generator)
        out = {k: float(v) for k, v in metrics.items()}
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        seconds = time.perf_counter() - t0
        if keep_grads and step == 0:
            grads = {n: p.grad.detach() for n, p in model.named_parameters()}
            specs, group = shard_layout(model, mesh)
            full = gather_state(grads, specs, group)
            if world.rank == 0:
                record["grads"] = {n: g.float().cpu()
                                   for n, g in full.items()}
        record["metrics"].append(out)
        record["step_s"].append(seconds)
        record["staged_s"].append(pgroup.staged_seconds - staged0)
        record["param_digests"].append(param_digest(model))
        if report:
            line = {"rank": world.rank, "step": step, "seconds": seconds,
                    "staged_seconds": record["staged_s"][-1],
                    "local_tokens": int(sum((m["token_ids"] != 0).sum()
                                            for m in mbs))}
            if device.type == "cuda":
                line["max_memory_allocated"] = \
                    torch.cuda.max_memory_allocated(device)
            print(json.dumps(line), flush=True)
            if world.rank == 0:
                print(json.dumps({**out, "step": step, "seconds": seconds,
                                  "tokens": batch * seq * accumulate,
                                  "mesh": dict(mesh.shape)}), flush=True)
    record["launches"] = launches.read()
    if drops:
        stats = []
        with torch.no_grad():
            model.forward_hidden(mbs[-1]["token_ids"], moe_stats=stats)
        dispatches = int((mbs[-1]["token_ids"] != 0).sum()) * hp.moe_top_k
        record["dropped_share_by_layer"] = [
            1.0 - int(s["keep"].sum()) / dispatches for s in stats]
    record["local_digests"] = {
        n: param_digest_of([p]) for n, p in model.named_parameters()}
    if device.type == "cuda":
        record["max_memory_allocated"] = torch.cuda.max_memory_allocated(
            device)
    return record


def _fit_config(experiment: str, dotlist: list):
    from .cli import assemble_config
    from .training.checkpointing import load_run_meta

    cfg = assemble_config(experiment, dotlist)
    if cfg.from_checkpoint:
        meta = load_run_meta(experiment, cfg.name)
        if meta:
            cfg = assemble_config(experiment, dotlist, base_meta=meta)
    return cfg


def fit_rank(world, experiment: str, dotlist: list) -> dict:
    """One rank of the training run on a mesh (trainer.num_devices ranks:
    trainer.model_parallel or trainer.expert_parallel innermost). Rank 0
    prepares the corpus while the others wait, then reads it with them.
    Returns {"step", "stopped_reason", "best_metric"}."""
    import torch

    from .cli import (build_data, build_hparams, make_sample_fns,
                      seed_everything)
    from .parallel.group import barrier
    from .parallel.mesh import create_mesh
    from .training.trainer import Trainer

    if world.device.type == "cpu":    # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world.size))
    cfg = _fit_config(experiment, dotlist)
    thp = cfg.trainer
    mesh = create_mesh(world, model_axis=thp.model_parallel,
                       seq_axis=thp.seq_parallel,
                       expert_axis=thp.expert_parallel)
    seed_everything(thp.seed)
    if cfg.anomaly_detection:
        torch.autograd.set_detect_anomaly(True)
    if world.rank == 0:
        print(f"Training {experiment} on mesh {dict(mesh.shape)} "
              f"({world.backend})...", flush=True)
        data = build_data(cfg)
    barrier(world)
    if world.rank != 0:
        data = build_data(cfg)
    overrides = dict(cfg.model_overrides)
    overrides.setdefault("vocab_size", cfg.data.vocab_size)
    hparams, objective = build_hparams(experiment, overrides)
    sample_fn, reconstruct_fn = make_sample_fns(experiment, objective)
    trainer = Trainer(hparams, objective, data, thp, experiment=experiment,
                      name=cfg.name, enable_logging=not cfg.no_log,
                      sample_fn=sample_fn, reconstruct_fn=reconstruct_fn,
                      mesh=mesh)
    outcome = trainer.fit(resume=cfg.from_checkpoint is not None)
    if world.rank == 0:
        print(f"Done: step={outcome.step} stopped={outcome.stopped_reason} "
              f"best {hparams.early_stopping_metric}={outcome.best_metric}",
              flush=True)
    return {"step": outcome.step, "stopped_reason": outcome.stopped_reason,
            "best_metric": outcome.best_metric}


def _start_ranks(device: str, size: int):
    """The device of spawned ranks, with the kernels built once here
    first."""
    from .parallel.group import rank_device

    dev = rank_device(device, 0)
    if dev.type == "cuda":
        from .ops import cuda_lib
        cuda_lib.library()      # built once, before the ranks start
    return dev


def fit_main(experiment: str, args) -> int:
    """The training run: `args` is the dotlist after the experiment, with
    device=<device> (default cuda) among it."""
    import torch

    from .cli import (build_data, build_hparams, make_sample_fns,
                      seed_everything)
    from .training.trainer import Trainer

    device = "cuda"
    dotlist = []
    for item in args:
        if item.startswith("device="):
            device = item.split("=", 1)[1]
        else:
            dotlist.append(item)
    cfg = _fit_config(experiment, dotlist)
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        import torch.distributed as dist

        from .parallel.group import from_environment
        world = from_environment(device)
        try:
            fit_rank(world, experiment, dotlist)
        finally:
            dist.destroy_process_group()
        return 0
    if (cfg.trainer.num_devices or 1) > 1:
        from .parallel.group import spawn
        from .parallel.mesh import mesh_axes
        n = cfg.trainer.num_devices
        mesh_axes(n, cfg.trainer.model_parallel, cfg.trainer.seq_parallel,
                  1, cfg.trainer.expert_parallel)   # JAX's refusals
        spawn(fit_rank, n, _start_ranks(device, n).type,
              (experiment, dotlist), timeout=float("inf"))
        return 0
    seed_everything(cfg.trainer.seed)
    if cfg.anomaly_detection:
        torch.autograd.set_detect_anomaly(True)

    print(f"Training {experiment}...", flush=True)
    data = build_data(cfg)
    overrides = dict(cfg.model_overrides)
    overrides.setdefault("vocab_size", cfg.data.vocab_size)
    hparams, objective = build_hparams(experiment, overrides)
    sample_fn, reconstruct_fn = make_sample_fns(experiment, objective)
    trainer = Trainer(hparams, objective, data, cfg.trainer,
                      experiment=experiment, name=cfg.name,
                      enable_logging=not cfg.no_log, device=device,
                      sample_fn=sample_fn, reconstruct_fn=reconstruct_fn)
    outcome = trainer.fit(resume=cfg.from_checkpoint is not None)
    print(f"Done: step={outcome.step} stopped={outcome.stopped_reason} "
          f"best {hparams.early_stopping_metric}={outcome.best_metric}",
          flush=True)
    return 0


def main(args) -> int:
    import numpy as np
    import torch

    from .training.data import synthetic_batch
    from .training.train_step import train_step

    if len(args) < 2:
        print(__doc__)
        return 1
    if len(args) == 2 or "=" in args[2]:
        return fit_main(args[1], args[2:])
    experiment, name = args[1], args[2]
    from .checkpoint import run_directory
    run_experiment = json.loads((run_directory(name) / "meta.json")
                                .read_text()).get("experiment")
    if run_experiment != experiment:
        raise SystemExit(f"run {name!r} is a {run_experiment!r} run, not "
                         f"{experiment!r}")
    extra = dict(kv.split("=", 1) for kv in args[3:])
    unknown = set(extra) - KEYS
    if unknown:
        raise SystemExit(f"unknown keys {sorted(unknown)}; known: "
                         f"{sorted(KEYS)}")
    steps = int(extra.get("steps", 10))
    batch, seq = int(extra.get("batch", 8)), int(extra.get("seq", 12800))
    seed = int(extra.get("seed", 0))
    accumulate = int(extra["accumulate"]) if "accumulate" in extra else None
    sp = int(extra.get("sp", 1))
    dp, tp, ep = (int(extra.get(k, 1)) for k in ("dp", "tp", "ep"))
    torchrun = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    meshed = dp * tp * ep > 1 or (torchrun and any(
        k in extra for k in ("dp", "tp", "ep")))
    # The length axis alone: the world is the seq group (train_rank) for
    # the Transformer-VAE; the Transformer LM, or seq beside the other
    # axes, takes the mesh (mesh_rank with sp).
    seq_alone = not meshed and (sp > 1 or torchrun)
    seq_run = seq_alone and experiment == "transformer-vae"
    mesh_run = meshed or (seq_alone and not seq_run)
    if mesh_run and not torchrun:
        from .parallel.mesh import mesh_axes
        mesh_axes(dp * tp * sp * ep, tp, sp, 1, ep)   # JAX's refusals
    if sp > 1 or (seq_alone and torchrun):
        from .parallel.sp import check_seq_parallel
        check_seq_parallel(run_hparams(name), experiment)
    device_arg = extra.get("device", "cuda")
    if torchrun:
        import torch.distributed as dist

        from .parallel.group import from_environment
        group = from_environment(device_arg)
        if mesh_run and not meshed and "sp" not in extra:
            sp = group.size
        if group.rank == 0:
            print(json.dumps({"sp": group.size, "backend": group.backend}
                             if seq_run else
                             {"world": group.size, "tp": tp, "sp": sp,
                              "ep": ep, "backend": group.backend}),
                  flush=True)
        try:
            if seq_run:
                train_rank(group, name, steps, batch, seq, seed, accumulate)
            else:
                mesh_rank(group, name, steps, batch, seq, seed, accumulate,
                          tp, ep, sp=sp)
        finally:
            dist.destroy_process_group()
        return 0
    if seq_run or mesh_run:
        from .parallel.group import choose_backend, spawn

        size = sp if seq_run else dp * tp * sp * ep
        device = _start_ranks(device_arg, size)
        backend = choose_backend(size, device)
        if seq_run:
            print(json.dumps({"sp": sp, "backend": backend}), flush=True)
            spawn(train_rank, sp, device.type,
                  (name, steps, batch, seq, seed, accumulate))
        else:
            print(json.dumps({"world": size, "tp": tp, "sp": sp, "ep": ep,
                              "backend": backend}), flush=True)
            spawn(mesh_rank, size, device.type,
                  (name, steps, batch, seq, seed, accumulate, tp, ep, None,
                   False, True, True, None, None, False, sp))
        return 0
    model, objective, optimizer, accumulate = build(
        name, extra.get("device", "cuda"), accumulate)
    device = model.device
    rng = np.random.default_rng(seed)
    generator = torch.Generator(device=device).manual_seed(seed)
    vocab = model.hparams.vocab_size
    for step in range(steps):
        t0 = time.perf_counter()
        mbs = [synthetic_batch(rng, batch, seq, vocab, device=device)
               for _ in range(accumulate)]
        metrics = train_step(model, objective, optimizer, mbs, step,
                             generator=generator)
        out = {k: float(v) for k, v in metrics.items()}
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        out.update(step=step, seconds=time.perf_counter() - t0,
                   tokens=batch * seq * accumulate)
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
