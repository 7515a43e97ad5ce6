"""Nearest neighbours over gathered latents (the port of the JAX package's
knn.py):

    python -m sparse_vae_tpu_torch.knn <experiment> <run-name> [device=cuda]

reads the latents `gather_latents` (either package's) saved under
sparse-vae-datasets/latents/<experiment>/<run-name> in the working
directory, asks for an article's title and prints its 10 nearest
neighbours three ways: by the L2 distance of the posterior means, by
their cosine similarity, and by the summed KL(q_i || q_j) of the
diagonal posteriors; q quits. `knn_scores` computes the three lists'
scores on the device the latents are on (the card unless device=cpu is
given); the loop and its printing are the JAX script's.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

from .gather_latents import latents_path


def knn_scores(loc, scale, i: int):
    """(squared L2 distance [N], cosine similarity [N], KL(q_i || q_j)
    [N]) of document i against every document j, loc and scale [N,
    latent] on any device, in their dtype."""
    d2 = ((loc[i] - loc) ** 2).sum(-1)
    norms = torch.linalg.vector_norm(loc, dim=-1) * torch.linalg.vector_norm(
        loc[i])
    cos = loc @ loc[i] / norms.clamp_min(1e-12)
    var_p, var_q = scale[i] ** 2, scale ** 2
    kl = 0.5 * (var_p / var_q + (loc[i] - loc) ** 2 / var_q - 1.0
                + torch.log(var_q / var_p)).sum(-1)
    return d2, cos, kl


def topk_print(scores, titles, k: int = 10, largest: bool = False):
    order = np.argsort(scores)
    if largest:
        order = order[::-1]
    hits = order[:k]
    width = max(len(titles[i]) for i in hits)
    for i in hits:
        print(f"{titles[i]:<{width}} - {scores[i]}")


def main(args):
    """args: sys.argv."""
    from datasets import Dataset

    if len(args) < 3:
        raise SystemExit(__doc__)
    experiment, name = args[1], args[2]
    extra = dict(kv.split("=", 1) for kv in args[3:])
    device = extra.pop("device", "cuda")
    if extra:
        raise SystemExit(f"unknown keys {sorted(extra)}; known: ['device']")
    from .models.base import resolve_device
    device = resolve_device(device)
    dataset = Dataset.load_from_disk(str(latents_path(experiment, name)))
    titles = dataset["title"]
    loc = torch.tensor(np.asarray(dataset["latent"], dtype=np.float32),
                       device=device)
    scale = torch.tensor(np.asarray(dataset["scale"], dtype=np.float32),
                         device=device)
    index = {t: i for i, t in enumerate(titles)}

    print("Type the title of an article to get the nearest neighbors. "
          "Type q to quit.")
    while (query := input("Article: ")) != "q":
        i = index.get(query)
        if i is None:
            print("No article found with that title. Try again.")
            continue
        d2, cos, kl = (s.cpu().numpy() for s in knn_scores(loc, scale, i))
        print("\nL2 distance of means:")
        topk_print(d2, titles)
        print("\nCosine similarity:")
        topk_print(cos, titles, largest=True)
        print("\nKL divergence:")
        topk_print(kl, titles)
        print()


if __name__ == "__main__":
    main(sys.argv)
