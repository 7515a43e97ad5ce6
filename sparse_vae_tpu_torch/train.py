"""Train the flagship Transformer-VAE on the port:

    python -m sparse_vae_tpu_torch.train transformer-vae <run-name>
        [steps=10] [batch=8] [seq=12800] [accumulate=<run's>] [seed=0]
        [device=cuda]

Loads runs/<run-name>/ in its training form (fp32 master parameters, the
run's compute dtype) and takes `steps` optimizer steps of `accumulate`
micro-batches of [batch, seq] seeded random token ids with ragged
document lengths (training/data.py; the corpus pipeline is not ported
yet). The optimizer is the run's: RAdam (or LAMB) behind the global-norm
clip on the cosine schedule, at the JAX trainer's lr (`run_lr`). Prints
one JSON line of metrics per step. Validation, checkpoint saving and
early stopping are not ported yet.

`build_from_hparams` builds a model with no archive instead: hparams plus
the JAX package's initialisation, at `bench_hparams`, the JAX train
bench's geometry.
"""
from __future__ import annotations

import json
import sys
import time

KEYS = {"steps", "batch", "seq", "accumulate", "seed", "device"}


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


def main(args) -> int:
    import numpy as np
    import torch

    from .training.data import synthetic_batch
    from .training.train_step import train_step

    if len(args) < 3:
        print(__doc__)
        return 1
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
