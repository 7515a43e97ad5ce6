"""The port's serving path: the row-wise decode slice against the JAX
package on the flagship weights, the continuous-batching engine, its HTTP
handler, and chip_smoke.py's serve phase, all on the CPU.
"""
import http.client
import json
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from sparse_vae_tpu.models.generation import (
    SamplingParams as JSamplingParams, init_row_decode_state as j_init_state)
from sparse_vae_tpu.serving import _get_slice_fn
from sparse_vae_tpu_torch.models.generation import (SamplingParams,
                                                    init_row_decode_state)
from sparse_vae_tpu_torch.models.transformer_vae import (
    TransformerVAE, TransformerVAEHparams)
from sparse_vae_tpu_torch.server import ServeEngine, run_server
from sparse_vae_tpu_torch.serving import make_slice_fn
from tests.test_torch_checkpoint import jax_r5, torch_r5

GREEDY = SamplingParams(top_k=1)


def test_greedy_rowwise_decode_matches_jax_on_r5():
    """Two rows, explicit z, 40 greedy steps (repetition penalty 1.2) of
    the flagship model in fp32: token for token the reference's."""
    import jax
    module, params = jax_r5()
    model = torch_r5()
    b, ml, steps = 2, 64, 40
    z = np.random.default_rng(0).standard_normal((b, 1, 64)).astype(
        np.float32)
    j_slice = _get_slice_fn(module, True, JSamplingParams(top_k=1), 2,
                            steps, False, False)
    j_state = j_init_state(b, ml, 1, jax.random.PRNGKey(0))
    j_state, _ = j_slice(params, j_state,
                         module.apply({"params": params}, b, ml,
                                      method=type(module).init_caches),
                         jnp.asarray(z))
    t_slice = make_slice_fn(model, GREEDY, 2, steps, False)
    t_state = init_row_decode_state(b, ml, 1, torch.Generator())
    t_state, _ = t_slice(t_state, model.init_caches(b, ml),
                         torch.from_numpy(z))
    np.testing.assert_array_equal(t_state.tokens.numpy(),
                                  np.asarray(j_state.tokens))
    np.testing.assert_array_equal(t_state.index.numpy(),
                                  np.asarray(j_state.index))
    assert int(t_state.index.max()) > 10  # not an immediate end token


def _tiny_vae(seed=0):
    torch.manual_seed(seed)
    hp = TransformerVAEHparams(d_model=32, num_heads=2, num_layers=2,
                               latent_depth=8, vocab_size=32,
                               attn_window_size=2, attn_block_size=8)
    return TransformerVAE(hp).eval().requires_grad_(False)


def _prompt(n, seed):
    return [int(t) for t in np.random.default_rng(seed).integers(3, 32, n)]


def test_engine_nine_requests_through_three_rows():
    """9 requests (with and without prompts, some bulk-prefilled) through
    a 3-row batch: all complete, refills happen, each seed's output is the
    same whichever row or slice served it, and shutdown stops the worker."""
    engine = ServeEngine(_tiny_vae(), batch_size=3, max_length=48,
                         sampling=GREEDY, slice_steps=4, end_token=-1)
    try:
        prompts = [None, _prompt(5, 1), _prompt(20, 2)]
        futures = [engine.submit(max_tokens=6 + (i % 3), seed=100 + (i % 3),
                                 prompt_tokens=prompts[i % 3])
                   for i in range(9)]
        outs = [f.result(120) for f in futures]
        for i in range(9):
            np.testing.assert_array_equal(outs[i], outs[i % 3])
            p = len(prompts[i % 3] or ())
            assert len(outs[i]) == p + 6 + (i % 3)
            np.testing.assert_array_equal(outs[i][:p], prompts[i % 3] or [])
        stats = engine.snapshot()
        assert stats["served"] == 9 and stats["prefills"] == 3
        assert stats["tokens_generated"] == sum(len(o) for o in outs)
    finally:
        engine.shutdown(timeout=30)
    assert not engine._thread.is_alive()
    with pytest.raises(RuntimeError):
        engine.submit(4)


@pytest.mark.parametrize("prompt_len", [20, 37])
def test_bulk_prefill_equals_forced_prefill(prompt_len):
    """One teacher-forced forward (fill_cache_row) gives the same greedy
    continuation as forcing the prompt token by token, including a prompt
    that wraps the 16-position ring."""
    prompt = _prompt(prompt_len, prompt_len)
    outs = []
    for bulk_min in (16, 10_000):
        engine = ServeEngine(_tiny_vae(), batch_size=2, max_length=64,
                             sampling=GREEDY, slice_steps=8, end_token=-1,
                             bulk_prefill_min=bulk_min)
        try:
            outs.append(engine.generate(12, seed=3, prompt_tokens=prompt,
                                        timeout=120))
            assert engine.snapshot()["prefills"] == (bulk_min == 16)
        finally:
            engine.shutdown()
    np.testing.assert_array_equal(outs[0], outs[1])


def test_per_request_overrides_without_fused_select():
    engine = ServeEngine(_tiny_vae(), batch_size=2, max_length=40,
                         sampling=SamplingParams(temperature=1.0, top_p=0.9),
                         slice_steps=8, end_token=-1)
    greedy = ServeEngine(_tiny_vae(), batch_size=2, max_length=40,
                         sampling=GREEDY, slice_steps=8, end_token=-1)
    try:
        got = engine.generate(10, seed=4, temperature=0.0,
                              repetition_penalty=1.2, timeout=120)
        want = greedy.generate(10, seed=4, timeout=120)
        np.testing.assert_array_equal(got, want)
    finally:
        engine.shutdown()
        greedy.shutdown()
    fused = ServeEngine(_tiny_vae(), batch_size=2, max_length=40,
                        fused_select=True)
    try:
        with pytest.raises(ValueError, match="fused_select"):
            fused.submit(4, temperature=0.5)
    finally:
        fused.shutdown()


def _post(port, body):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    try:
        conn.request("POST", "/v1/generate", json.dumps(body))
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def test_http_handler_answers_prompt_tokens():
    engine = ServeEngine(_tiny_vae(), batch_size=2, max_length=40,
                         sampling=GREEDY, slice_steps=8, end_token=-1,
                         fused_select=True)
    server = run_server(engine, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port = server.server_address[1]
    try:
        prompt = _prompt(6, 5)
        status, body = _post(port, {"prompt_tokens": prompt,
                                    "max_tokens": 7, "seed": 1, "n": 2})
        assert status == 200, body
        samples = json.loads(body)["samples"]
        assert len(samples) == 2
        for s in samples:
            assert s["tokens"][:6] == prompt and len(s["tokens"]) == 13
        status, body = _post(port, {"prompt": "text", "max_tokens": 3})
        assert status == 400 and b"tokenizer" in body
        status, body = _post(port, {"prompt_tokens": prompt,
                                    "max_tokens": 5, "stream": True})
        assert status == 200
        lines = [json.loads(x) for x in body.decode().splitlines()
                 if x.startswith("{")]
        assert lines[-1]["done"] and lines[-1]["tokens_total"] == 11
        assert sum(len(x.get("tokens", [])) for x in lines[:-1]) == 5
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
        conn.request("GET", "/healthz")
        health = conn.getresponse()
        assert health.status == 200
        assert json.loads(health.read())["served"] == 3
        conn.close()
    finally:
        server.shutdown()
        server.server_close()
        engine.shutdown()
        thread.join(10)
    assert not thread.is_alive()


def test_chip_smoke_serve_phase_on_cpu():
    """chip_smoke.py's serve phase with an explicit CPU model at tiny
    width: every request is answered and checked."""
    model = _tiny_vae()
    requests = chip_smoke.make_requests(32, [0, 20, 9, 0], [6, 8, 5, 7],
                                        seed=7)
    called = []
    stats = chip_smoke.serve_phase(model, requests, batch_size=3,
                                   max_length=48, slice_steps=4,
                                   before_traffic=lambda: called.append(1))
    assert called == [1]
    assert stats["requests"] == 4 and stats["prefills"] == 1
    assert 4 <= stats["new_tokens"] <= 26
    assert stats["latency_max_s"] >= stats["latency_p50_s"] > 0
