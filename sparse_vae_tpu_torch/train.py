"""Train the flagship Transformer-VAE on the port, in one of two forms.

The training run, the JAX package's `train.py` CLI:

    python -m sparse_vae_tpu_torch.train transformer-vae
        [model.k=v ...] [data.k=v ...] [trainer.k=v ...] [preset=<name>]
        [name=<run>] [from_checkpoint=<run>] [no_log=true]
        [anomaly_detection=true] [device=cuda]

assembles the configuration (cli.py: defaults, the dotlist, a preset),
prepares the corpus (data/: tokenizer, token cache, length buckets) and
runs `Trainer.fit` (training/trainer.py) from the JAX initialisation:
validation, early stopping and checkpoints under
sparse-vae-logs/transformer-vae/<name>/. from_checkpoint=<run> resumes
that run with its saved hparams as the base. It is selected when the
argument after the experiment is absent or holds a `=`.

The step run on an archived model's weights:

    python -m sparse_vae_tpu_torch.train transformer-vae <run-name>
        [steps=10] [batch=8] [seq=12800] [accumulate=<run's>] [seed=0]
        [device=cuda] [sp=1]

loads runs/<run-name>/ in its training form (fp32 master parameters, the
run's compute dtype) and takes `steps` optimizer steps of `accumulate`
micro-batches of [batch, seq] seeded random token ids with ragged
document lengths (training/data.py, the train bench's stand-in for a
corpus). The optimizer is the run's: RAdam (or LAMB) behind the
global-norm clip on the cosine schedule, at the JAX trainer's lr
(`run_lr`). Prints one JSON line of metrics per step.

sp=N > 1 shards the length axis over N ranks (sequence parallelism,
parallel/): lengths are padded to a multiple of N * window * block, the
kernels are built once here, and N ranks are spawned, rank r on
cuda:{r % device_count} (or all on the CPU with device=cpu). Under
torchrun (RANK and WORLD_SIZE set) this process is one rank of that
group instead, on cuda:{LOCAL_RANK % device_count}. Every rank runs with
the same weights and the same global batches, holding positions
r * L / N .. (r + 1) * L / N - 1. The process group is NCCL when every
rank has a card of its own and gloo otherwise (parallel/group.py); the
chosen backend is printed. Every rank prints its own line per step
({"rank", "step", "seconds", ...}); rank 0 also prints the step's
metrics, the same on every rank.

`build_from_hparams` builds a model with no archive instead: hparams plus
the JAX package's initialisation, at `bench_hparams`, the JAX train
bench's geometry.
"""
from __future__ import annotations

import json
import math
import os
import sys
import time

KEYS = {"steps", "batch", "seq", "accumulate", "seed", "device", "sp"}


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
    """(model, objective, optimizer, accumulate) for runs/<name> on
    `device`, the optimizer at `run_lr`; accumulate defaults to the run's
    accumulate_grad_batches."""
    from .checkpoint import load_run
    from .models.vae import VAEObjective

    model, hp, meta = load_run(name, device=device, dtype=dtype, train=True,
                               use_kernels=use_kernels)
    if accumulate is None:
        accumulate = meta.get("trainer_hparams", {}).get(
            "accumulate_grad_batches", 1)
    optimizer = _optimizer(model, hp, run_lr(hp, meta, accumulate))
    return model, VAEObjective(hp), optimizer, accumulate


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


def build_from_hparams(hparams, generator, device="cuda",
                       use_kernels: bool = True, dtype=None):
    """(model, objective, optimizer, 1) for a model with no archive:
    `hparams` plus the JAX initialisation drawn from `generator` (a CPU
    torch.Generator), in the training form of `build`, the optimizer at
    hparams.lr as bench.py gives it."""
    from .checkpoint import model_from_hparams
    from .models.vae import VAEObjective

    model, hp = model_from_hparams(hparams, generator, device=device,
                                   dtype=dtype, train=True,
                                   use_kernels=use_kernels)
    return model, VAEObjective(hp), _optimizer(model, hp, hp.lr), 1


def sp_pad_multiple(hp, sp: int, pad_to_multiple_of: int = 512) -> int:
    """The row-length multiple of a batch sharded over `sp` ranks: every
    shard a whole number of window bands (training/trainer.py of the JAX
    package)."""
    need = sp * hp.attn_window_size * hp.attn_block_size
    return math.lcm(pad_to_multiple_of, need)


def param_digest(model) -> str:
    """sha256 of every parameter's bytes, in order: equal digests are
    bitwise equal parameters."""
    import hashlib

    import torch

    digest = hashlib.sha256()
    with torch.no_grad():
        for p in model.parameters():
            digest.update(p.detach().float().cpu().numpy().tobytes())
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
    from .parallel.sp import shard_length, sp_localize
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


def fit_main(experiment: str, args) -> int:
    """The training run: `args` is the dotlist after the experiment, with
    device=<device> (default cuda) among it."""
    import torch

    from .cli import (assemble_config, build_data, build_hparams,
                      seed_everything)
    from .training.checkpointing import load_run_meta
    from .training.trainer import Trainer

    device = "cuda"
    dotlist = []
    for item in args:
        if item.startswith("device="):
            device = item.split("=", 1)[1]
        else:
            dotlist.append(item)
    cfg = assemble_config(experiment, dotlist)
    if cfg.from_checkpoint:
        meta = load_run_meta(experiment, cfg.name)
        if meta:
            cfg = assemble_config(experiment, dotlist, base_meta=meta)
    seed_everything(cfg.trainer.seed)
    if cfg.anomaly_detection:
        torch.autograd.set_detect_anomaly(True)

    print(f"Training {experiment}...", flush=True)
    data = build_data(cfg)
    overrides = dict(cfg.model_overrides)
    overrides.setdefault("vocab_size", cfg.data.vocab_size)
    hparams, objective = build_hparams(experiment, overrides)
    trainer = Trainer(hparams, objective, data, cfg.trainer,
                      experiment=experiment, name=cfg.name,
                      enable_logging=not cfg.no_log, device=device)
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
    if experiment != "transformer-vae":
        raise SystemExit(f"model {experiment!r} is not ported; "
                         "transformer-vae is")
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
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        import torch.distributed as dist

        from .parallel.group import from_environment
        group = from_environment(extra.get("device", "cuda"))
        if group.rank == 0:
            print(json.dumps({"sp": group.size, "backend": group.backend}),
                  flush=True)
        try:
            train_rank(group, name, steps, batch, seq, seed, accumulate)
        finally:
            dist.destroy_process_group()
        return 0
    if sp > 1:
        from .parallel.group import choose_backend, rank_device, spawn

        device = rank_device(extra.get("device", "cuda"), 0)
        if device.type == "cuda":
            from .ops import cuda_lib
            cuda_lib.library()      # built once, before the ranks start
        print(json.dumps({"sp": sp, "backend": choose_backend(sp, device)}),
              flush=True)
        spawn(train_rank, sp, device.type,
              (name, steps, batch, seq, seed, accumulate))
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
