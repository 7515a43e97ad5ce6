"""Generation benchmark of the port at equal generated lengths (the JAX
package's gen_bench.py):

    python -m sparse_vae_tpu_torch.gen_bench {transformer-vae|transformer-lm}
        <run-name> [seq=8192] [batch=1] [full=0] [window=512]
        [modes=greedy,sampled] [draft=3] [spec_draft=<experiment>:<run>]
        [spec_k=8] [check=0] [device=cuda]

Every decoder runs with end_token -1, so each generates exactly seq - 1
tokens and the seconds compare. A mode (greedy: temperature 0, no
penalty; sampled: the reference's temperature 1, top_p 0.9, penalty 1.2)
times its rows, each once from seed 2 after a short warm-up of the run
(the port compiles nothing per shape):
- `ar`, the lockstep loop (`sample`);
- sparse runs: `frontier` (frontier Jacobi); greedy with draft > 0 also
  `frontier_draftN` (suffix-match drafts of N-grams); sampled
  `frontier_fused` (selection through K4) and `speculative_draftN`
  (frontier speculative sampling);
- spec_draft with batch 1: `spec_model_kK`, draft-model speculative
  sampling, with `spec_model_accepted` and `spec_model_tokens_per_pass`;
  the draft is a transformer-lm or an lstm-lm run (checkpoint.load_draft);
- full=1: `jacobi_full`, full-document Jacobi at chunk 128.
check=1 counts each greedy row's tokens that differ from `ar`'s (and the
first such position of spec_model): exact in exact arithmetic, but two
bf16 paths can flip a near-tie argmax, and the trajectories then part.
A VAE decodes from z ~ N(0, I) of seed 7. The run prints each mode's
seconds and passes on stderr and one JSON line,
{"metric": "trained_generation_equal_length", "runs": [...]}.

The JAX script's TPU supervisor, `step` and `params_dtype` have no
counterpart (the archive holds one set of params, cast to the run's
compute dtype); `serve=` (lockstep against continuous batching) raises:
chip_smoke.py's sample phase makes that comparison. It runs on the card
unless device=cpu is given.
"""
from __future__ import annotations

import json
import sys
import time
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from .models.generation import SamplingParams, prior_z

KEYS = {"seq", "batch", "full", "window", "modes", "draft", "spec_draft",
        "spec_k", "check", "device", "serve"}
GREEDY = SamplingParams(temperature=0.0, top_p=1.0, repetition_penalty=1.0)
SAMPLED = SamplingParams()
SEED = 2          # the JAX script times its second key, PRNGKey(2)
Z_SEED = 7        # the JAX script's z key, PRNGKey(7)
JACOBI_CHUNK = 128
WARM_POSITIONS = 16


@dataclass
class Bench:
    """One run's settings: the model, its z (VAE) and the draft."""
    model: torch.nn.Module
    seq: int
    batch: int = 1
    window: int = 512
    draft: int = 3
    spec_k: int = 8
    spec: Optional[tuple] = None    # checkpoint.load_draft's pair
    z: Optional[torch.Tensor] = None

    def z_args(self) -> tuple:
        """The VAE's z (its first `batch` rows) as the positional argument
        after batch_size."""
        return () if self.z is None else (self.z[:self.batch],)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def rows(bench: Bench, sampling: SamplingParams) -> dict:
    """{row name: () -> (tokens [B, seq - 1], passes, accepted or None)}:
    the JAX script's rows of a mode, in its order."""
    m, seq, b = bench.model, bench.seq, bench.batch
    zs = bench.z_args()
    greedy = sampling.temperature <= 0.0 or sampling.top_k == 1
    kw = {"sampling": sampling, "end_token": -1}

    def ar():
        return m.sample(SEED, seq, b, *zs, **kw), seq - 1, None

    def frontier(fused: bool, ngram: int):
        return lambda: (*m.frontier_generate(
            SEED, seq, b, *zs, window_tokens=bench.window,
            fused_select=fused, draft_ngram=ngram, **kw), None)

    out: dict = {"ar": ar}
    if m.hparams.sparse_self_attention:
        out["frontier"] = frontier(False, 0)
        if greedy and bench.draft > 0:
            # Suffix-match drafts cannot anticipate the Gumbel-perturbed
            # fixed point: greedy only.
            out[f"frontier_draft{bench.draft}"] = frontier(False, bench.draft)
        if not greedy:
            out["frontier_fused"] = frontier(True, 0)
            out[f"speculative_draft{max(bench.draft, 0)}"] = lambda: (
                *m.speculative_generate(
                    SEED, seq, b, *zs, window_tokens=bench.window,
                    draft_ngram=max(bench.draft, 0), **kw), None)
    if bench.spec is not None and b == 1:
        propose, fresh_state = bench.spec
        out[f"spec_model_k{bench.spec_k}"] = lambda: m.spec_draft_generate(
            SEED, seq, propose, fresh_state(seq), *zs,
            draft_k=bench.spec_k, **kw)
    out["jacobi_full"] = lambda: (*m.parallel_generate(
        SEED, seq, b, *zs, chunk_size=JACOBI_CHUNK, **kw), None)
    return out


def run_mode(bench: Bench, sampling: SamplingParams, label: str,
             check: bool = False, full: bool = False,
             names: Optional[list] = None,
             timed: Optional[Callable] = None) -> tuple:
    """Time the mode's rows (`names`, default the JAX script's set; full
    adds jacobi_full). timed(name, fn) may wrap each call. Returns (the
    JSON row, {name: {"seconds", "passes", "accepted", "tokens"}})."""
    table = rows(bench, sampling)
    if names is None:
        names = [n for n in table if n != "jacobi_full" or full]
    device = bench.model.device
    runs = {}
    for name in names:
        fn = table[name] if timed is None else timed(name, table[name])
        _sync(device)
        t0 = time.perf_counter()
        tokens, passes, accepted = fn()
        _sync(device)
        runs[name] = {"seconds": time.perf_counter() - t0,
                      "passes": int(passes), "accepted": accepted,
                      "tokens": tokens.cpu()}
    greedy = sampling.temperature <= 0.0 or sampling.top_k == 1
    extras = {}
    spec = f"spec_model_k{bench.spec_k}"
    if spec in runs:
        extras["spec_model_accepted"] = runs[spec]["accepted"]
        extras["spec_model_tokens_per_pass"] = round(
            (bench.seq - 1) / max(runs[spec]["passes"], 1), 3)
    if check and greedy and "ar" in runs:
        ar = runs["ar"]["tokens"]
        for name, key in (("frontier", "frontier_mismatch_tokens"),
                          (f"frontier_draft{bench.draft}",
                           f"draft{bench.draft}_mismatch_tokens"),
                          (spec, "spec_model_mismatch_tokens")):
            if name in runs:
                extras[key] = int((runs[name]["tokens"] != ar).sum())
        if spec in runs:
            extras["spec_model_first_mismatch"] = first_mismatch(
                ar, runs[spec]["tokens"])
    detail = " ".join(f"{k}={r['seconds']:.2f}s({r['passes']} passes)"
                      for k, r in runs.items())
    print(f"# {label} batch=({bench.batch},{bench.seq}) {detail}",
          file=sys.stderr, flush=True)
    others = [r["seconds"] for k, r in runs.items() if k != "ar"]
    best = min(others) if others else None
    t_ar = runs["ar"]["seconds"] if "ar" in runs else None
    row = {"mode": label,
           **{k: round(r["seconds"], 3) for k, r in runs.items()},
           **extras,
           # null when no parallel decoder ran (a dense run with full=0)
           "parallel_speedup_vs_ar": (round(t_ar / best, 3)
                                      if best and t_ar else None)}
    return row, runs


def first_mismatch(a, b) -> Optional[int]:
    """The first position where any row of a and b differ, else None."""
    differ = (a != b).any(dim=0).nonzero()
    return int(differ[0]) if len(differ) else None


def main(args) -> dict:
    """args: sys.argv. Returns {"metric", "runs": the JSON rows, "detail":
    each mode's run_mode results}."""
    from .checkpoint import load_draft, load_run

    if len(args) < 3:
        raise SystemExit(__doc__)
    experiment, name = args[1], args[2]
    extra = dict(kv.split("=", 1) for kv in args[3:])
    unknown = set(extra) - KEYS
    if unknown:
        raise SystemExit(f"unknown keys {sorted(unknown)}; known: "
                         f"{sorted(KEYS)}")
    if int(extra.get("serve", 0)):
        raise NotImplementedError(
            "serve= (lockstep batches against continuous batching) is not "
            "ported to gen_bench: chip_smoke.py's sample phase runs that "
            "comparison (ROADMAP.md Queue 1 loose end 4)")
    device = extra.get("device", "cuda")
    model, hparams, meta = load_run(name, device=device)
    if meta.get("experiment") != experiment:
        raise SystemExit(f"run {name!r} is a {meta.get('experiment')!r} "
                         f"run, not {experiment!r}")
    bench = Bench(model, seq=int(extra.get("seq", 8192)),
                  batch=int(extra.get("batch", 1)),
                  window=int(extra.get("window", 512)),
                  draft=int(extra.get("draft", 3)),
                  spec_k=int(extra.get("spec_k", 8)))
    if extra.get("spec_draft"):
        bench.spec = load_draft(extra["spec_draft"], bench.spec_k, device)
    if experiment.endswith("vae"):
        bench.z = prior_z(Z_SEED, bench.batch, hparams.latent_depth, device)
    # Warm-up: the kernel library's first load and the allocator.
    model.sample(SEED, WARM_POSITIONS, bench.batch, *bench.z_args(),
                 end_token=-1)
    check = extra.get("check", "0") == "1"
    full = extra.get("full", "0") == "1"
    modes = extra.get("modes", "greedy,sampled").split(",")
    results, detail = [], {}
    for label, sampling in (("greedy", GREEDY), ("sampled", SAMPLED)):
        if label in modes:
            row, detail[label] = run_mode(bench, sampling, label, check,
                                          full)
            results.append(row)
    out = {"metric": "trained_generation_equal_length", "runs": results}
    print(json.dumps(out), flush=True)
    return {**out, "detail": detail}


if __name__ == "__main__":
    main(sys.argv)
