"""Interactive reconstruction (the port of the JAX package's
reconstruct.py):

    python -m sparse_vae_tpu_torch.reconstruct <experiment> <run-name>
        [device=cuda]

loads a run that this package's trainer saved (`load_checkpoint_for_name`)
and its corpus (the run's data hparams, `cli.assemble_config` /
`build_data`, in the working directory), asks for an article's title
(a document's position in the train-then-test order where the corpus has
no titles), encodes that document, and decodes a reconstruction from
the posterior mean: `reconstruct`, the transformer families' `sample`
from seed 0 at batch 1, max_length 1024, temperature 0.7 (top_p 0.9,
repetition penalty 1.2), its nucleus selections through K4 on the card;
the text drops [PAD]. q quits. The trainer's sampling callback
(`cli.make_sample_fns`) reconstructs through the same function.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

MAX_LENGTH = 1024
TEMPERATURE = 0.7


def reconstruct(model, token_ids, seed: int = 0,
                max_length: int = MAX_LENGTH, **sample_kw):
    """Tokens [1, max_length - 1] decoded from the posterior mean of the
    document token_ids [1, L] (on the model's device) at temperature
    TEMPERATURE by the model's `sample` (either VAE family's), the noise
    from `seed` (models/generation.py); `sample_kw` goes to `sample`
    (fused_select=False: the JAX package's unfused selection)."""
    from .models.generation import SamplingParams
    with torch.no_grad():
        loc = model.posterior(token_ids).loc[:1]
    return model.sample(seed, max_length, 1, loc,
                        SamplingParams(temperature=TEMPERATURE), **sample_kw)


def main(args):
    """args: sys.argv."""
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
    tokenizer = data.tokenizer

    docs, titles = [], {}
    for split in ("train", "test"):
        corpus = data.splits[split]
        for i in range(len(corpus)):
            title = corpus.titles[i] if corpus.titles else str(len(docs))
            titles[title] = len(docs)
            docs.append(corpus.docs[i])

    print("Type the title of an article to get a reconstruction. "
          "Type q to quit.")
    while (query := input("Article: ")) != "q":
        idx = titles.get(query)
        if idx is None:
            print("No article found with that title. Try again.")
            continue
        tokens = torch.as_tensor(np.asarray(docs[idx], np.int64),
                                 device=model.device)[None, :]
        recon = reconstruct(model, tokens)
        text = tokenizer.decode([int(t) for t in recon[0].tolist()
                                 if t != 0])
        print("Reconstruction:\n\n" + text)


if __name__ == "__main__":
    main(sys.argv)
