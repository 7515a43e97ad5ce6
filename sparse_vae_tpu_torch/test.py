"""The test split's NLL (the port of the JAX package's test.py):
importance-weighted for the VAEs, plain for the language models:

    python -m sparse_vae_tpu_torch.test <experiment> <run-name>
        [data.k=v ...] [num_samples=N] [num_iter=M] [step=<N>|best]
        [device=cuda]

loads a run that this package's trainer saved
(sparse-vae-logs/<experiment>/<run-name>/checkpoints/, the newest step
unless `step` says otherwise) and iterates the test split of its data
(the run's saved data hparams, or the defaults with the data.k=v given;
`epoch_batches("test", seed=0)`). For each batch with a real row it
prints the NLL per token, averaged over the batch's real documents, and
the running average; then the average over the batches. For a VAE (the
Transformer-VAE or the LSTM-VAE) each document's log p(x) is
`estimate_log_prob_iw` over num_samples posterior samples in num_iter
chunks, through `reconstruct_ll`: no [B, L, V] logits. num_iter defaults
to 100 for the Transformer-VAE (100 x 100, the reference's
transformer_vae.py:76) and to 20 otherwise (the LSTM-VAE's 100 x 20,
lstm_vae.py:137). Batch i's noise comes from a generator seeded with i.
For a language model (the Transformer LM or the LSTM LM) a batch's NLL
per token is its ARObjective.eval_stats, nll_sum over token_count
(num_samples and num_iter are read and unused, as in the JAX package).

It runs on the card unless device=cpu is given.
"""
from __future__ import annotations

import sys
from typing import Optional

import numpy as np
import torch

from .models.vae import estimate_log_prob_iw

def batch_nll(model, batch: dict, num_samples: int, num_iter: int,
              eps: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None) -> float:
    """The IWAE NLL per token of one batch {"token_ids": [B, L],
    "num_tokens": [B]}: -log p(x) / num_tokens averaged over the rows
    with num_tokens > 0. eps [num_samples, *posterior shape] ([K, B, 1,
    latent] for the Transformer-VAE, [K, B, latent] for the LSTM-VAE) or
    `generator` as for `estimate_log_prob_iw`. Call under torch.no_grad()."""
    ids, num_tokens = batch["token_ids"], batch["num_tokens"]
    posterior = model.posterior(ids)
    lp = estimate_log_prob_iw(model.reconstruct_ll, posterior, ids,
                              num_samples, num_iter, eps, generator)
    real = num_tokens > 0
    per_tok = -lp[real].double().cpu() / num_tokens[real].cpu()
    return float(per_tok.mean())


def lm_batch_nll(model, objective, batch: dict) -> float:
    """The NLL per real token of one batch through a language model's
    objective: eval_stats' nll_sum over its token_count. Call under
    torch.no_grad()."""
    stats = objective.eval_stats(model, batch)
    return float(stats["nll_sum"]) / max(float(stats["token_count"]), 1.0)


def main(args) -> float:
    """args: sys.argv. Returns the average."""
    from . import load_checkpoint_for_name
    from .cli import assemble_config, build_data
    from .data.text_data_module import TextDataModuleHparams

    experiment, name = args[1], args[2]
    extra = dict(kv.split("=", 1) for kv in args[3:])
    device = extra.pop("device", "cuda")
    num_samples = int(extra.pop("num_samples", 100))
    num_iter = int(extra.pop("num_iter",
                             100 if experiment == "transformer-vae" else 20))
    step = extra.pop("step", None)  # None: the newest; "best"; or a step

    model, _, objective, _, meta = load_checkpoint_for_name(
        experiment, name, step=step, device=device)
    is_vae = experiment.endswith("vae")
    data_dot = [f"data.{k.removeprefix('data.')}={v}"
                for k, v in extra.items()]
    cfg = assemble_config(experiment, data_dot)
    if not data_dot:
        cfg.data = TextDataModuleHparams(**meta.get("data_hparams", {}))
    data = build_data(cfg)

    losses = []
    with torch.no_grad():
        for i, batch in enumerate(data.epoch_batches("test", seed=0)):
            if not (np.asarray(batch.num_tokens) > 0).any():
                continue
            arrays = {k: torch.from_numpy(np.asarray(v)).to(model.device,
                                                            torch.int64)
                      for k, v in batch._asdict().items()}
            if is_vae:
                generator = torch.Generator(
                    device=model.device).manual_seed(i)
                nll = batch_nll(model, arrays, num_samples, num_iter,
                                generator=generator)
            else:
                nll = lm_batch_nll(model, objective, arrays)
            losses.append(nll)
            print(f"batch {i}: last={nll:.4f} "
                  f"avg={sum(losses) / len(losses):.4f}", flush=True)
    average = sum(losses) / max(len(losses), 1)
    print("Average test loss:", average, flush=True)
    return average


if __name__ == "__main__":
    main(sys.argv)
