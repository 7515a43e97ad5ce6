"""Posterior latents of every document (the port of the JAX package's
gather_latents.py):

    python -m sparse_vae_tpu_torch.gather_latents <experiment> <run-name>
        [device=cuda]

loads a run that this package's trainer saved
(sparse-vae-logs/<experiment>/<run-name>/, `load_checkpoint_for_name`),
rebuilds its corpus from the run's data hparams in the working directory
(`cli.assemble_config` / `build_data`), and runs the encoder's posterior
over every train, then test, document in document order: batches of 32
rows, each padded to `length_bucket(its longest document,
pad_to_multiple_of)`, the filler rows past a split's end dropped. The
result is saved as a `datasets.Dataset` with the columns title, latent
(the posterior mean), scale and doc_index (the position in the
train-then-test order: the join key of `tsne`) under
sparse-vae-datasets/latents/<experiment>/<run-name> in the working
directory, the layout the JAX package's knn.py and tsne.py read.

`gather` computes; `write_latents` writes, and only it imports
`datasets`. It runs on the card unless device=cpu is given.
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import torch

BATCH_ROWS = 32     # the JAX script's batch


def latents_path(experiment: str, name: str) -> Path:
    """Where the latents of a run live, in the working directory."""
    return (Path.cwd() / "sparse-vae-datasets" / "latents" / experiment
            / name)


def gather(model, data, device=None):
    """The posterior of every document of `data` (a prepared
    TextDataModule), train then test: (loc [N, latent] fp32, scale
    [N, latent] fp32, titles [N] ("" where the corpus has none),
    doc_index [N] int64) as numpy arrays and a list. `device` defaults
    to the model's."""
    from .data.batching import BatchPlan, collate, length_bucket

    device = model.device if device is None else torch.device(device)
    pad_mult = data.hparams.pad_to_multiple_of
    locs, scales, titles, doc_index = [], [], [], []
    next_index = 0
    for split in ("train", "test"):
        corpus = data.splits[split]
        for start in range(0, len(corpus), BATCH_ROWS):
            idx = list(range(start, min(start + BATCH_ROWS, len(corpus))))
            docs = corpus.get_docs(idx)
            plan = BatchPlan(bucket_len=length_bucket(
                max(len(d) for d in docs), pad_mult), rows=BATCH_ROWS,
                doc_indices=idx)
            batch = collate(plan, docs,
                            [int(corpus.num_bytes[i]) for i in idx])
            tokens = torch.as_tensor(batch.token_ids, dtype=torch.int64,
                                     device=device)
            with torch.no_grad():
                q = model.posterior(tokens)
            n = len(idx)
            locs.append(q.loc.float().reshape(BATCH_ROWS, -1)[:n].cpu())
            scales.append(q.scale.float().reshape(BATCH_ROWS, -1)[:n].cpu())
            titles.extend(corpus.titles[i] if corpus.titles else ""
                          for i in idx)
            doc_index.extend(next_index + i for i in idx)
        next_index += len(corpus)
    return (torch.cat(locs).numpy(), torch.cat(scales).numpy(), titles,
            np.asarray(doc_index, dtype=np.int64))


def write_latents(path: Path, loc, scale, titles, doc_index) -> Path:
    """Save the columns title, latent, scale and doc_index as a
    `datasets.Dataset` at `path`."""
    from datasets import Dataset
    Dataset.from_dict({"title": list(titles), "latent": loc.tolist(),
                       "scale": scale.tolist(),
                       "doc_index": [int(i) for i in doc_index]}
                      ).save_to_disk(str(path))
    return path


def main(args) -> Path:
    """args: sys.argv. Returns the dataset's directory."""
    from . import load_checkpoint_for_name
    from .cli import assemble_config, build_data
    from .data.text_data_module import TextDataModuleHparams

    if len(args) < 3:
        raise SystemExit(__doc__)
    experiment, name = args[1], args[2]
    extra = dict(kv.split("=", 1) for kv in args[3:])
    device = extra.pop("device", "cuda")
    if extra:
        raise SystemExit(f"unknown keys {sorted(extra)}; known: ['device']")
    model, _, _, _, meta = load_checkpoint_for_name(experiment, name,
                                                    device=device)
    cfg = assemble_config(experiment, [])
    cfg.data = TextDataModuleHparams(**meta.get("data_hparams", {}))
    data = build_data(cfg)
    loc, scale, titles, doc_index = gather(model, data)
    print("Saving to disk...")
    path = write_latents(latents_path(experiment, name), loc, scale, titles,
                         doc_index)
    print(f"Done: {len(titles)} latents -> {path}")
    return path


if __name__ == "__main__":
    main(sys.argv)
