"""Online generation server: continuous batching behind an HTTP API
(port of sparse_vae_tpu/server.py).

One worker thread owns the device state — a persistent [B, max_len]
RowDecodeState and the KV caches — and runs bounded decode slices; HTTP
handler threads only enqueue requests and wait on futures:

  client ->  POST /v1/generate {"max_tokens": .., "seed": ..}   (blocks)
  engine ->  admit queued requests into dead rows (fresh z for a VAE,
             per-row row_max), run one <= slice_steps slice, harvest
             finished rows, resolve their futures.

It serves the Transformer-VAE (each request draws its z) and the
Transformer LM (no z). Requests may carry a prompt as "prompt_tokens"
ids. A prompt of at least `bulk_prefill_min` positions fills its row's
caches with ONE teacher-forced forward (`fill_cache_row`), padded to
max(16, attn_block_size) positions as in the JAX package; on the card it
runs K1 where the attention's kernel gate admits the padded length (the
sliding-window path at a block multiple, the dense causal path at a
multiple of 512); a shorter prompt is forced token by token through the
decode path.
Text prompts ("prompt") need a tokenizer, which the port does not have yet.

Endpoints:
  POST /v1/generate  {"max_tokens": int=128, "seed": int?, "n": int=1,
                      "prompt_tokens": [int]?, "stream": bool=false,
                      "temperature": float?, "top_p": float?,
                      "repetition_penalty": float?}
                     -> {"samples": [{"tokens": [...]}, ..],
                         "latency_ms": float}
                     stream=true (n=1): chunked application/x-ndjson, one
                     {"tokens": [...]} line per slice, then {"done": true,
                     "tokens_total": ..}.
  GET  /healthz      -> engine statistics (also at /v1/stats)
"""
from __future__ import annotations

import json
import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, List, Optional

import numpy as np
import torch

from .models.generation import (RowDecodeState, SamplingParams,
                                init_row_decode_state)
from .ops.attention import fill_cache_row
from .serving import make_slice_fn, rowwise_family


@dataclass
class _Request:
    max_tokens: int
    seed: Optional[int]
    prompt_tokens: Optional[List[int]] = None
    # Per-request sampling overrides (None = the engine's SamplingParams).
    temperature: Optional[float] = None
    top_p: Optional[float] = None
    repetition_penalty: Optional[float] = None
    # Streaming: each slice's new tokens are put here, then None at the end.
    chunks: Optional["queue.Queue"] = None
    future: Future = field(default_factory=Future)
    submitted_at: float = field(default_factory=time.monotonic)


class ServeEngine:
    """Continuously batched generation engine. submit() is thread-safe;
    all device state lives on the single worker thread, on the model's
    device."""

    def __init__(self, module, batch_size: int, max_length: int,
                 sampling: SamplingParams = SamplingParams(),
                 start_token: int = 1, end_token: int = 2,
                 slice_steps: int = 64, fused_select: bool = False,
                 rng_seed: int = 0, bulk_prefill_min: int = 16):
        self.module = module
        self.device = module.device
        self.batch_size = batch_size
        self.max_length = max_length
        self.start_token = start_token
        self.sampling = sampling
        # Per-request overrides ride the slice as [B] tensors, except under
        # the fused selection kernel, which takes scalar parameters.
        self._use_overrides = not fused_select
        self.is_vae = rowwise_family(module)
        self._slice_fn = make_slice_fn(module, sampling, end_token,
                                       slice_steps, fused_select)
        self._latent = getattr(module.hparams, "latent_depth", 0)
        # Prompts of >= bulk_prefill_min positions are prefilled by one
        # forward, padded to a block multiple so the sparse forward takes
        # its blocked path.
        self.bulk_prefill_min = bulk_prefill_min
        self._prefill_align = max(16, module.hparams.attn_block_size)
        self._rng = torch.Generator().manual_seed(rng_seed)
        self._live_host = np.zeros(batch_size, bool)  # read by snapshot()
        self._assigned: List[Optional[_Request]] = [None] * batch_size
        self._queue: "queue.Queue[_Request]" = queue.Queue()
        self._shutdown = threading.Event()
        self._ready = threading.Event()
        self._fatal: Optional[BaseException] = None
        self._lock = threading.Lock()  # orders submit() vs shutdown/fail
        self.stats = {"served": 0, "tokens_generated": 0, "slices": 0,
                      "prefills": 0, "request_seconds": 0.0,
                      "started_at": time.time()}
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="serve-engine")
        self._thread.start()

    # -- client API ----------------------------------------------------------
    def submit(self, max_tokens: int, seed: Optional[int] = None,
               prompt_tokens: Optional[List[int]] = None,
               stream: bool = False, temperature: Optional[float] = None,
               top_p: Optional[float] = None,
               repetition_penalty: Optional[float] = None):
        """Enqueue one request; the Future resolves to the np.int32 token
        array (start token stripped, prompt included, end token kept).
        max_tokens counts NEW tokens after the prompt."""
        p = len(prompt_tokens or ())
        if p > self.max_length - 3:
            raise ValueError(
                f"prompt of {p} tokens exceeds the batch buffer "
                f"(max_length={self.max_length})")
        vocab = self.module.hparams.vocab_size
        if p and (min(prompt_tokens) <= 0 or max(prompt_tokens) >= vocab):
            raise ValueError(
                "prompt token ids must be in [1, vocab_size) — 0 is [PAD]")
        max_tokens = max(1, min(int(max_tokens), self.max_length - 2 - p))
        if not self._use_overrides and any(
                v is not None for v in (temperature, top_p,
                                        repetition_penalty)):
            raise ValueError(
                "per-request sampling overrides are unavailable with "
                "fused_select=True (the kernel takes scalar parameters)")
        req = _Request(max_tokens=max_tokens, seed=seed,
                       prompt_tokens=list(prompt_tokens or ()),
                       temperature=temperature, top_p=top_p,
                       repetition_penalty=repetition_penalty,
                       chunks=queue.Queue() if stream else None)
        with self._lock:
            if self._fatal is not None:
                raise RuntimeError(
                    f"engine failed: {self._fatal!r}") from self._fatal
            if self._shutdown.is_set():
                raise RuntimeError("engine is shut down")
            self._queue.put(req)
        return (req.future, req.chunks) if stream else req.future

    def generate(self, max_tokens: int, seed: Optional[int] = None,
                 prompt_tokens: Optional[List[int]] = None,
                 timeout: Optional[float] = 600.0, **sampling) -> np.ndarray:
        return self.submit(max_tokens, seed, prompt_tokens,
                           **sampling).result(timeout)

    def shutdown(self, timeout: float = 30.0):
        """Stop the worker (joined with `timeout`) and fail what is
        pending."""
        self._shutdown.set()
        self._thread.join(timeout)
        self._fail_pending(RuntimeError("engine shut down"))

    def _fail_pending(self, exc: BaseException):
        with self._lock:
            for row, req in enumerate(self._assigned):
                if req is not None:
                    self._assigned[row] = None
                    if req.chunks is not None:
                        req.chunks.put(None)
                    if not req.future.done():
                        req.future.set_exception(exc)
            while True:
                try:
                    req = self._queue.get_nowait()
                except queue.Empty:
                    break
                if req.chunks is not None:
                    req.chunks.put(None)
                if not req.future.done():
                    req.future.set_exception(exc)

    def snapshot(self) -> dict:
        s = dict(self.stats)
        served = max(s["served"], 1)
        s["avg_request_s"] = round(s.pop("request_seconds") / served, 3)
        s["queue_depth"] = self._queue.qsize()
        s["live_rows"] = int(np.sum(self._live_host))
        s["batch_size"] = self.batch_size
        s["ready"] = self._ready.is_set()
        s["uptime_s"] = round(time.time() - s.pop("started_at"), 1)
        if self._fatal is not None:
            s["fatal"] = repr(self._fatal)
        return s

    # -- worker thread ---------------------------------------------------
    def _prefill(self, caches, row: int, ids, length: int, z):
        """Bulk prefill: one teacher-forced forward (z injected for a VAE),
        then fill_cache_row writes the admitted row of every layer's
        cache."""
        if self.is_vae:
            _, kvs = self.module.reconstruct_hidden(ids, z, return_kv=True)
        else:
            _, kvs = self.module.forward_hidden(ids, return_kv=True)
        for cache, (k, v) in zip(caches, kvs):
            fill_cache_row(cache, row, k[0], v[0], length)

    def _draw_z(self, seed: Optional[int]) -> np.ndarray:
        gen = (self._rng if seed is None
               else torch.Generator().manual_seed(int(seed)))
        return torch.randn((1, self._latent), generator=gen).numpy()

    def _loop(self):
        try:
            with torch.inference_mode():
                self._run()
        except BaseException as e:  # noqa: BLE001 — a dead worker must not
            # leave clients hanging: record the failure and fail every
            # pending future.
            self._fatal = e
            self._fail_pending(RuntimeError(f"engine failed: {e!r}"))
        else:
            self._fail_pending(RuntimeError("engine shut down"))

    def _run(self):
        b, ml, dev = self.batch_size, self.max_length, self.device
        if dev.type == "cuda":
            # Build the kernels before accepting traffic, so the first
            # request does not wait for nvcc.
            from .ops import cuda_lib
            cuda_lib.library()
        caches = self.module.init_caches(b, ml)
        d_rng = torch.Generator(device=dev).manual_seed(
            int(torch.randint(2 ** 62, (1,), generator=self._rng)))
        state = init_row_decode_state(b, ml, self.start_token, d_rng)
        # All rows start DEAD: nothing decodes until a request is admitted.
        tokens_h = state.tokens.cpu().numpy().copy()
        index_h = np.ones(b, np.int64)
        self._live_host = np.zeros(b, bool)
        row_max_h = np.full(b, ml - 1, np.int64)
        prompt_len_h = np.zeros(b, np.int64)
        reported_h = np.zeros(b, np.int64)  # streaming: last pushed index
        temp_h = np.full(b, self.sampling.temperature, np.float32)
        topp_h = np.full(b, self.sampling.top_p, np.float32)
        rp_h = np.full(b, self.sampling.repetition_penalty, np.float32)
        z_h = np.zeros((b, 1, self._latent), np.float32)
        z = overrides = None

        def on_device(a):
            return torch.tensor(a, device=dev)  # a copy, never a view

        assigned = self._assigned
        dirty = True  # host mirrors differ from device state
        self._ready.set()

        while not self._shutdown.is_set():
            # Admit: fill every dead row from the queue; block briefly when
            # the whole batch is idle.
            admitted = False
            for row in range(b):
                if assigned[row] is not None:
                    continue
                try:
                    if not self._live_host.any() and not admitted:
                        req = self._queue.get(timeout=0.2)
                    else:
                        req = self._queue.get_nowait()
                except queue.Empty:
                    break
                assigned[row] = req
                tokens_h[row] = 0
                tokens_h[row, 0] = self.start_token
                p = len(req.prompt_tokens)
                if p:
                    tokens_h[row, 1:1 + p] = req.prompt_tokens
                index_h[row] = 1
                self._live_host[row] = True
                prompt_len_h[row] = 1 + p
                # index starts at 1 and counts written positions, so T new
                # tokens after a p-token prompt is row_max = p + T + 1.
                row_max_h[row] = p + req.max_tokens + 1
                reported_h[row] = 1 + p  # the prompt itself never streams
                s = self.sampling
                temp_h[row] = (s.temperature if req.temperature is None
                               else req.temperature)
                topp_h[row] = s.top_p if req.top_p is None else req.top_p
                rp_h[row] = (s.repetition_penalty
                             if req.repetition_penalty is None
                             else req.repetition_penalty)
                if self.is_vae:
                    z_h[row] = self._draw_z(req.seed)
                if 1 + p >= self.bulk_prefill_min:
                    # One forward fills positions 0..p; decoding resumes at
                    # p + 1.
                    align = self._prefill_align
                    lp = min(ml, -(-(1 + p) // align) * align)
                    ids = np.zeros((1, lp), np.int64)
                    ids[0, 0] = self.start_token
                    ids[0, 1:1 + p] = req.prompt_tokens
                    self._prefill(caches, row, on_device(ids), 1 + p,
                                  on_device(z_h[row][None]))
                    self.stats["prefills"] += 1
                    index_h[row] = 1 + p
                admitted = True
                dirty = True
            if not self._live_host.any():
                continue  # idle: retry the blocking get

            if dirty:
                state = RowDecodeState(
                    tokens=on_device(tokens_h), index=on_device(index_h),
                    live=on_device(self._live_host), rng=state.rng,
                    row_max=on_device(row_max_h),
                    prompt_len=on_device(prompt_len_h))
                z = on_device(z_h) if self.is_vae else None
                if self._use_overrides:
                    overrides = {"temperature": on_device(temp_h),
                                 "top_p": on_device(topp_h),
                                 "repetition_penalty": on_device(rp_h)}
                dirty = False

            state, caches = self._slice_fn(state, caches, z, overrides)
            self.stats["slices"] += 1
            tokens_h = state.tokens.cpu().numpy().copy()
            index_h = state.index.cpu().numpy().copy()
            self._live_host = state.live.cpu().numpy().copy()

            for row in range(b):
                req = assigned[row]
                if req is None or req.chunks is None:
                    continue
                new = tokens_h[row, reported_h[row]:index_h[row]]
                if new.size:
                    req.chunks.put([int(t) for t in new])
                reported_h[row] = index_h[row]

            for row in range(b):
                req = assigned[row]
                if req is None or self._live_host[row]:
                    continue
                if req.chunks is not None:
                    req.chunks.put(None)  # end-of-stream sentinel
                out = tokens_h[row, 1:index_h[row]].astype(np.int32)
                assigned[row] = None
                self.stats["served"] += 1
                self.stats["tokens_generated"] += int(out.size)
                self.stats["request_seconds"] += (time.monotonic()
                                                  - req.submitted_at)
                if not req.future.done():  # raced by a failing shutdown
                    req.future.set_result(out)


# -- HTTP layer --------------------------------------------------------------
def make_handler(engine: ServeEngine,
                 decode_fn: Optional[Callable[[List[int]], str]] = None,
                 request_timeout: float = 600.0,
                 encode_fn: Optional[Callable[[str], List[int]]] = None):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"  # keep-alive (Content-Length is set)

        def log_message(self, fmt, *args):  # quiet by default
            pass

        def _json(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path in ("/healthz", "/v1/stats"):
                snap = engine.snapshot()
                if "fatal" in snap:
                    self._json(503, {"status": "error", **snap})
                elif not snap.get("ready", True):
                    self._json(503, {"status": "warming", **snap})
                else:
                    self._json(200, {"status": "ok", **snap})
            else:
                self._json(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            # Read the body first on every path: under keep-alive an unread
            # body would be parsed as the next request line.
            length = int(self.headers.get("Content-Length", 0))
            body = self.rfile.read(length) if length else b"{}"
            if self.path != "/v1/generate":
                self._json(404, {"error": f"no route {self.path}"})
                return
            try:
                req = json.loads(body or b"{}")
                if not isinstance(req, dict):
                    raise ValueError("body must be a JSON object")
                n = max(1, min(int(req.get("n", 1)), engine.batch_size))
                max_tokens = int(req.get("max_tokens", 128))
                stream = bool(req.get("stream", False))
                if stream and int(req.get("n", 1)) != 1:
                    raise ValueError("stream=true requires n=1")
                seed = req.get("seed")
                seed = None if seed is None else int(seed)
                sp = {k: (None if req.get(k) is None else float(req[k]))
                      for k in ("temperature", "top_p",
                                "repetition_penalty")}
                prompt_tokens = req.get("prompt_tokens")
                if prompt_tokens is not None:
                    prompt_tokens = [int(t) for t in prompt_tokens]
                elif req.get("prompt"):
                    if encode_fn is None:
                        raise ValueError(
                            "text prompts need a tokenizer (encode_fn); "
                            "pass prompt_tokens instead")
                    prompt_tokens = list(encode_fn(str(req["prompt"])))
            except (ValueError, TypeError, AttributeError,
                    json.JSONDecodeError) as e:
                self._json(400, {"error": str(e)})
                return
            if stream:
                self._stream(max_tokens, seed, prompt_tokens, sp)
                return
            t0 = time.monotonic()
            try:
                futures = [
                    engine.submit(max_tokens,
                                  None if seed is None else seed + i,
                                  prompt_tokens, **sp)
                    for i in range(n)
                ]
                samples = []
                for f in futures:
                    toks = [int(t) for t in f.result(request_timeout)]
                    sample = {"tokens": toks}
                    if decode_fn is not None:
                        sample["text"] = decode_fn(
                            [t for t in toks if t != 0])
                    samples.append(sample)
            except Exception as e:  # noqa: BLE001 — surface to the client
                self._json(500, {"error": f"{type(e).__name__}: {e}"})
                return
            self._json(200, {
                "samples": samples,
                "latency_ms": round(1e3 * (time.monotonic() - t0), 1),
            })

        def _stream(self, max_tokens, seed, prompt_tokens, sp):
            """Chunked ndjson: one {"tokens": [...]} line per decode slice,
            then a {"done": true, ...} trailer."""
            try:
                fut, chunks = engine.submit(max_tokens, seed, prompt_tokens,
                                            stream=True, **sp)
            except (ValueError, RuntimeError) as e:
                self._json(400 if isinstance(e, ValueError) else 503,
                           {"error": str(e)})
                return
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def line(obj):
                payload = (json.dumps(obj) + "\n").encode()
                self.wfile.write(f"{len(payload):X}\r\n".encode()
                                 + payload + b"\r\n")

            deadline = time.monotonic() + request_timeout
            while True:
                try:
                    chunk = chunks.get(
                        timeout=max(0.1, deadline - time.monotonic()))
                except queue.Empty:
                    line({"done": True, "error": "timeout"})
                    break
                if chunk is None:
                    try:
                        toks = [int(t) for t in fut.result(1.0)]
                        trailer = {"done": True, "tokens_total": len(toks)}
                        if decode_fn is not None:
                            trailer["text"] = decode_fn(
                                [t for t in toks if t != 0])
                    except Exception as e:  # noqa: BLE001 — to the client
                        trailer = {"done": True,
                                   "error": f"{type(e).__name__}: {e}"}
                    line(trailer)
                    break
                line({"tokens": chunk})
            self.wfile.write(b"0\r\n\r\n")

    return Handler


class _Server(ThreadingHTTPServer):
    # The stdlib default listen backlog (5) resets connections under many
    # concurrent clients.
    request_queue_size = 128


def run_server(engine: ServeEngine, host: str = "127.0.0.1",
               port: int = 8600, decode_fn=None,
               request_timeout: float = 600.0,
               encode_fn=None) -> ThreadingHTTPServer:
    """Create (and return) the HTTP server; call .serve_forever() to block,
    or drive it from a thread."""
    handler = make_handler(engine, decode_fn, request_timeout, encode_fn)
    return _Server((host, port), handler)
