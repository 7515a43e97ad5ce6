"""Train the flagship Transformer-VAE on the port:

    python -m sparse_vae_tpu_torch.train transformer-vae <run-name>
        [steps=10] [batch=8] [seq=12800] [accumulate=<run's>] [seed=0]
        [device=cuda]

Loads runs/<run-name>/ in its training form (fp32 master parameters, the
run's compute dtype) and takes `steps` optimizer steps of `accumulate`
micro-batches of [batch, seq] seeded random token ids with ragged
document lengths (training/data.py; the corpus pipeline is not ported
yet). The optimizer is the run's: RAdam (or LAMB) behind the global-norm
clip, at lr = scaled_lr(lr, tokens per step, base_batch_size) on the
cosine schedule. Prints one JSON line of metrics per step. Validation,
checkpoint saving and early stopping are not ported yet.
"""
from __future__ import annotations

import json
import sys
import time

KEYS = {"steps", "batch", "seq", "accumulate", "seed", "device"}


def build(name: str, device="cuda", accumulate=None, batch: int = 8,
          seq: int = 12800, use_kernels: bool = True, dtype=None):
    """(model, objective, optimizer, accumulate) for runs/<name> on
    `device`, the optimizer at the run's lr scaled to batch * seq *
    accumulate tokens per step."""
    from .checkpoint import load_run
    from .models.vae import VAEObjective
    from .training.optimizer import make_optimizer
    from .utils.schedules import scaled_lr

    model, hp, meta = load_run(name, device=device, dtype=dtype, train=True,
                               use_kernels=use_kernels)
    if accumulate is None:
        accumulate = meta.get("trainer_hparams", {}).get(
            "accumulate_grad_batches", 1)
    lr = scaled_lr(hp.lr, batch * seq * accumulate, hp.base_batch_size)
    optimizer = make_optimizer(model.parameters(), lr=lr,
                               lr_decay_steps=hp.lr_decay_steps,
                               grad_clip_threshold=hp.grad_clip_threshold,
                               weight_decay=hp.weight_decay, lamb=hp.lamb)
    return model, VAEObjective(hp), optimizer, accumulate


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
        name, extra.get("device", "cuda"), accumulate, batch, seq)
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
