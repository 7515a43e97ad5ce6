"""Mass sampling on the port (the JAX package's sample.py):

    python -m sparse_vae_tpu_torch.sample
        {transformer-vae|transformer-lm|lstm-vae|lstm-lm}
        <run-name> [num_samples=700000] [batch_size=1000] [max_length=512]
        [ignore_end=0] [fused_select=1] [continuous=0] [slice_steps=256]
        [spec_draft=<experiment>:<run>] [spec_k=8] [device=cuda]

loads runs/<run-name>/ (or an archive directory given as a path:
checkpoint.load_run) in its serving form and generates num_samples
documents from [CLS] at temperature 1, top_p 0.9, repetition penalty 1.2,
the defaults being the reference's workload (700,000 documents of <= 512
tokens at batch 1000). Batch i of the lockstep loop (`sample`, through
batch_generation.batch_generate_samples) samples with seed i;
continuous=1 decodes every document in its own row of a continuously
refilled batch (serving.continuous_batch_sample, seed 0, bounded slices
of slice_steps). ignore_end=1 never stops at [SEP], so every document
runs to max_length. fused_select=1 selects each sampled token with the
K4 kernel on the card. spec_draft=<experiment>:<run> decodes each
document at batch 1 by draft-model speculative sampling
(`spec_draft_generate`, document i from seed i): that run (a
transformer-lm or an lstm-lm run) proposes spec_k tokens a pass and the
target verifies them in one chunk; a transformer draft starts every
document from a fresh `draft_init_state(1, max_length + spec_k + 2)`, an
LSTM draft from its `initial_rnn_state(1)` (checkpoint.load_draft).

The LSTM families sample through the lockstep loop with the JAX
package's unfused selection (their `sample` takes no fused selection, as
the JAX package's does): for them fused_select defaults to 0 and
fused_select=1 raises, and so does continuous=1 (they have no row-wise
decode step: continuous batching serves the transformer families).

The documents are decoded with the run's tokenizer (cli.tokenizer_for_run:
the one cached under sparse-vae-pretrained/tokenizers/ in the working
directory for the run's dataset, else one trained there) and saved under
sparse-vae-datasets/samples/<run-name>/ in the working directory as JSON
lines {"text": ..., "token_ids": [...]}: train.jsonl and, where
min(50,000, n // 10) >= 1 (the JAX package's split rule), a test.jsonl
of that many documents from a seeded shuffle.

The keys are the JAX package's sample.py keys, except `step` and
`params_dtype`: the archive holds one set of params, cast to the run's
compute dtype. It runs on the card unless device=cpu is given.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path
from typing import List

import numpy as np

KEYS = {"num_samples", "batch_size", "max_length", "ignore_end",
        "fused_select", "continuous", "slice_steps", "device", "spec_draft",
        "spec_k"}
# The families whose `sample` selects with the unfused path only.
UNFUSED = ("lstm-lm", "lstm-vae")


def save_samples(outputs: List[np.ndarray], texts: List[str],
                 path: Path, seed: int = 0) -> dict:
    """Write the documents as train.jsonl and, where min(50,000, n // 10)
    >= 1, test.jsonl (that many documents from a shuffle seeded with
    `seed`). Returns {split: document count}."""
    n = len(outputs)
    test_size = min(50_000, n // 10)
    order = np.random.default_rng(seed).permutation(n)
    splits = ({"train": np.sort(order[test_size:]),
               "test": np.sort(order[:test_size])} if test_size >= 1
              else {"train": np.arange(n)})
    path.mkdir(parents=True, exist_ok=True)
    for stale in ("train.jsonl", "test.jsonl"):
        (path / stale).unlink(missing_ok=True)
    for split, rows in splits.items():
        with open(path / f"{split}.jsonl", "w") as fh:
            for i in rows:
                fh.write(json.dumps({"text": texts[i], "token_ids":
                                     [int(t) for t in outputs[i]]}) + "\n")
    return {split: len(rows) for split, rows in splits.items()}


def main(args) -> dict:
    """args: sys.argv. Returns {"documents": the token arrays, "new_tokens":
    their non-[PAD] tokens, "seconds": the generation's wall time,
    "splits": save_samples' counts, "path": the dataset directory}."""
    from .batch_generation import batch_generate_samples
    from .checkpoint import load_draft, load_run
    from .cli import tokenizer_for_run
    from .models.base import SEP_ID
    from .serving import continuous_batch_sample

    if len(args) < 3:
        raise SystemExit(__doc__)
    experiment, name = args[1], args[2]
    extra = dict(kv.split("=", 1) for kv in args[3:])
    unknown = set(extra) - KEYS
    if unknown:
        raise SystemExit(f"unknown keys {sorted(unknown)}; known: "
                         f"{sorted(KEYS)}")
    num_samples = int(extra.get("num_samples", 700_000))
    batch_size = int(extra.get("batch_size", 1000))
    max_length = int(extra.get("max_length", 512))
    ignore_end = extra.get("ignore_end", "0") == "1"
    unfused = experiment in UNFUSED
    fused_select = extra.get("fused_select", "0" if unfused else "1") == "1"
    if unfused and fused_select:
        raise SystemExit(f"fused_select=1: {experiment} samples with the "
                         "unfused selection only (its sample takes no fused "
                         "selection, as the JAX package's does)")
    continuous = extra.get("continuous", "0") == "1"
    slice_steps = int(extra.get("slice_steps", 256))
    spec_draft = extra.get("spec_draft")
    spec_k = int(extra.get("spec_k", 8))
    if spec_draft and batch_size != 1:
        raise SystemExit("spec_draft is the batch-1 latency path: give "
                         "batch_size=1")

    device = extra.get("device", "cuda")
    model, _, meta = load_run(name, device=device)
    if meta.get("experiment") != experiment:
        raise SystemExit(f"run {name!r} is a {meta.get('experiment')!r} "
                         f"run, not {experiment!r}")
    end = -1 if ignore_end else SEP_ID
    if spec_draft:
        propose, fresh_state = load_draft(spec_draft, spec_k, device)
    t0 = time.perf_counter()
    if spec_draft:
        def spec_batch(i):
            return model.spec_draft_generate(
                i, max_length, propose, fresh_state(max_length),
                end_token=end, draft_k=spec_k)[0]

        outputs = batch_generate_samples(
            spec_batch, num_samples, max_length,
            end_token=None if ignore_end else SEP_ID)
    elif continuous:
        outputs = continuous_batch_sample(
            model, 0, num_samples, max_length, batch_size, end_token=end,
            slice_steps=slice_steps, fused_select=fused_select,
            progress=True)
    else:
        fused = {} if unfused else {"fused_select": fused_select}
        outputs = batch_generate_samples(
            lambda i: model.sample(i, max_length, batch_size, end_token=end,
                                   **fused),
            num_samples, max_length,
            end_token=None if ignore_end else SEP_ID)
    seconds = time.perf_counter() - t0
    new_tokens = sum(int(np.count_nonzero(o)) for o in outputs)
    print(f"{len(outputs)} documents, {new_tokens} new tokens in "
          f"{seconds:.2f} s ({new_tokens / seconds:.1f} new tokens/s)",
          flush=True)

    print("Saving to disk...", flush=True)
    tokenizer = tokenizer_for_run(experiment, meta)
    texts = tokenizer.decode_batch(
        [[int(t) for t in o if t != 0] for o in outputs])
    path = Path.cwd() / "sparse-vae-datasets" / "samples" / Path(name).name
    splits = save_samples(outputs, texts, path)
    print("Done.", flush=True)
    return {"documents": outputs, "new_tokens": new_tokens,
            "seconds": seconds, "splits": splits, "path": path}


if __name__ == "__main__":
    main(sys.argv)
