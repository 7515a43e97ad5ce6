"""Online generation server on the port:

    python -m sparse_vae_tpu_torch.serve {transformer-vae|transformer-lm}
        <run-name>
        [port=8600] [batch_size=64] [max_length=512] [slice_steps=64]
        [fused_select=1] [temperature=1.0] [top_p=0.9] [top_k=0]
        [repetition_penalty=1.2] [device=cuda]

Loads runs/<run-name>/ (a run of that experiment: real-prose-vae-r5,
draft-tlm-r5, ...) and serves it behind the continuous-batching HTTP API
(server.py). The keys are the JAX package's serve.py keys, except
`step` and `params_dtype`: the archive holds one set of params, cast to the
run's compute dtype. Requests carry "prompt_tokens" ids; text prompts wait
for the tokenizer.

  curl -s localhost:8600/v1/generate -d '{"max_tokens": 96, "n": 2}'
  curl -s localhost:8600/healthz
"""
from __future__ import annotations

import sys

KEYS = {"port", "batch_size", "max_length", "slice_steps", "fused_select",
        "temperature", "top_p", "top_k", "repetition_penalty", "device"}


def main(args) -> int:
    from .checkpoint import load_run
    from .models.base import SEP_ID
    from .models.generation import SamplingParams
    from .server import ServeEngine, run_server

    if len(args) < 3:
        print(__doc__)
        return 1
    experiment, name = args[1], args[2]
    extra = dict(kv.split("=", 1) for kv in args[3:])
    unknown = set(extra) - KEYS
    if unknown:
        raise SystemExit(f"unknown keys {sorted(unknown)}; known: "
                         f"{sorted(KEYS)}")
    port = int(extra.get("port", 8600))
    batch_size = int(extra.get("batch_size", 64))
    max_length = int(extra.get("max_length", 512))
    slice_steps = int(extra.get("slice_steps", 64))
    fused_select = extra.get("fused_select", "1") == "1"

    model, _, meta = load_run(name, device=extra.get("device", "cuda"))
    if meta.get("experiment") != experiment:
        raise SystemExit(f"run {name!r} is a {meta.get('experiment')!r} "
                         f"run, not {experiment!r}")
    sampling = SamplingParams(
        temperature=float(extra.get("temperature", 1.0)),
        top_p=float(extra.get("top_p", 0.9)),
        top_k=int(extra.get("top_k", 0)),
        repetition_penalty=float(extra.get("repetition_penalty", 1.2)))
    engine = ServeEngine(model, batch_size=batch_size,
                         max_length=max_length, sampling=sampling,
                         end_token=SEP_ID, slice_steps=slice_steps,
                         fused_select=fused_select)
    server = run_server(engine, port=port)
    print(f"Serving {experiment}/{name} on :{port} "
          f"(batch {batch_size} x {max_length}, slice {slice_steps}, "
          f"device {model.device})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.shutdown()
        server.server_close()
        engine.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
