"""The port's recurrent layers (sparse_vae_tpu_torch/ops/rnn.py:
`lstm_scan`, `lstm_step`, `gru_scan`, `StackedRNN`, `BiLSTMEncoder`)
against the JAX package's (sparse_vae_tpu/ops/rnn.py) on the CPU, on
JAX-initialised parameters carried across as numpy arrays, with the same
numpy-seeded inputs.

Both routes of the port are held: the fused RNN (torch's `_VF.lstm` /
`_VF.gru`, cuDNN on the card, its CPU implementation here) and the step
loop (the plain version). Ragged rows end in PAD, and one row has no
token at all: its final state is the held initial state.

Tolerances: outputs and final states 2e-5 absolute (fp32, a few steps of
gates in other summation orders: measured at ~1e-7); input and parameter
gradients 2e-3 of each tensor's largest entry.

Worker time: about 60 s in one process (JAX's scans compile per shape).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from sparse_vae_tpu.ops import rnn as jrnn
from sparse_vae_tpu_torch.ops import rnn as trnn
from sparse_vae_tpu_torch.ops.rnn import use_step_loop

ATOL = 2e-5
GRAD_REL = 2e-3
B, L, E, H = 4, 9, 6, 8
LENGTHS = [9, 5, 1, 0]      # ragged rows and an empty one


def _inputs(seed: int, lengths=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, L, E)).astype(np.float32)
    mask = None
    if lengths is not None:
        mask = np.arange(L)[None, :] < np.array(lengths)[:, None]
    return x, mask


def _flat(params) -> dict:
    return {k: np.asarray(v) for k, v in flatten_dict(params,
                                                      sep="/").items()}


def _load(module, params):
    module.load_state_dict({k.replace("/", "."): torch.from_numpy(v.copy())
                            for k, v in _flat(params).items()}, strict=True)
    return module


def _close(got, want, atol=ATOL, what=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=atol, err_msg=what)


def _grad_close(got, want, what=""):
    want = np.asarray(want)
    bound = GRAD_REL * np.abs(want).max() + 1e-7
    err = np.abs(got.detach().numpy() - want).max()
    assert err <= bound, f"{what}: max err {err:.3g} > {bound:.3g}"


def _stacked_pair(rnn_type: str, layers: int, seed: int = 0):
    x, _ = _inputs(seed)
    jm = jrnn.StackedRNN(hidden_size=H, num_layers=layers, rnn_type=rnn_type)
    params = jm.init(jax.random.PRNGKey(seed), jnp.asarray(x))["params"]
    return jm, params, _load(trnn.StackedRNN(E, H, layers, rnn_type), params)


def _states(rng, rnn_type: str, layers: int):
    states = []
    for _ in range(layers):
        h = rng.standard_normal((B, H)).astype(np.float32)
        c = rng.standard_normal((B, H)).astype(np.float32)
        states.append((h, c) if rnn_type == "LSTM" else h)
    return states


def _to_torch(states):
    return [tuple(torch.from_numpy(a) for a in s) if isinstance(s, tuple)
            else torch.from_numpy(s) for s in states]


def _to_jax(states):
    return [tuple(jnp.asarray(a) for a in s) if isinstance(s, tuple)
            else jnp.asarray(s) for s in states]


def _final_h(states):
    return [s[0] if isinstance(s, tuple) else s for s in states]


@functools.lru_cache(maxsize=None)
def _stacked_case(rnn_type: str, layers: int):
    """The inputs of a stack case and JAX's outputs and gradients, shared
    by the fused route's case and the step loop's."""
    jm, params, _ = _stacked_pair(rnn_type, layers, seed=1)
    rng = np.random.default_rng(2)
    x, _ = _inputs(3)
    init = _states(rng, rnn_type, layers)
    w_out = rng.standard_normal((B, L, H)).astype(np.float32)
    w_fin = rng.standard_normal((layers, B, H)).astype(np.float32)

    def jax_f(p, xx, st):
        out, finals = jm.apply({"params": p}, xx, st)
        fin = jnp.stack(_final_h(finals))
        return jnp.sum(out * w_out) + jnp.sum(fin * w_fin), (out, finals)

    (_, want), grads = jax.jit(jax.value_and_grad(
        jax_f, argnums=(0, 1, 2), has_aux=True))(
        params, jnp.asarray(x), _to_jax(init))
    return params, x, init, w_out, w_fin, want, grads


@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("rnn_type", ["LSTM", "GRU"])
@pytest.mark.parametrize("step_loop", [False, True])
def test_stacked_rnn_and_its_gradients_match_jax(rnn_type, layers,
                                                  step_loop):
    """A full-sequence stack from given initial states: outputs and every
    layer's final state at 2e-5 of JAX's; the gradients of a seeded
    linear function of the outputs and the final states by the input, the
    initial states and every parameter at 2e-3 of the largest entry."""
    params, x, init, w_out, w_fin, (want_out, want_fin), (
        g_p, g_x, g_st) = _stacked_case(rnn_type, layers)
    model = _load(trnn.StackedRNN(E, H, layers, rnn_type), params)
    xt = torch.from_numpy(x).requires_grad_(True)
    st = _to_torch(init)
    leaves = [a for s in st for a in (s if isinstance(s, tuple) else (s,))]
    for a in leaves:
        a.requires_grad_(True)
    out, finals = use_step_loop(model, step_loop)(xt, st)
    fin = torch.stack(_final_h(finals))
    (out * torch.from_numpy(w_out)).sum().add(
        (fin * torch.from_numpy(w_fin)).sum()).backward()
    _close(out, want_out, what="outputs")
    for got, want in zip(finals, want_fin):
        if rnn_type == "LSTM":
            _close(got[0], want[0], what="h_n")
            _close(got[1], want[1], what="c_n")
        else:
            _close(got, want, what="h_n")
    _grad_close(xt.grad, g_x, "input")
    want_st = [a for s in g_st for a in (s if isinstance(s, tuple) else (s,))]
    for got, want in zip(leaves, want_st):
        _grad_close(got.grad, want, "initial state")
    for name, p in model.named_parameters():
        _grad_close(p.grad, _flat(g_p)[name], name)


@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("step_loop", [False, True])
def test_masked_stack_holds_the_state_through_pad(layers, step_loop):
    """An LSTM stack over ragged rows and an empty one with a mask:
    outputs (the held h past a row's end) and final states at 2e-5 of
    JAX's; the empty row's final state is its initial state exactly."""
    jm, params, model = _stacked_pair("LSTM", layers, seed=4)
    x, mask = _inputs(5, LENGTHS)
    init = _states(np.random.default_rng(6), "LSTM", layers)
    want_out, want_fin = jm.apply({"params": params}, jnp.asarray(x),
                                  _to_jax(init), mask=jnp.asarray(mask))
    with torch.no_grad():
        out, finals = use_step_loop(model, step_loop)(
            torch.from_numpy(x), _to_torch(init),
            mask=torch.from_numpy(mask))
    _close(out, want_out, what="outputs")
    for (h, c), (wh, wc), (h0, c0) in zip(finals, want_fin, init):
        _close(h, wh, what="h_n")
        _close(c, wc, what="c_n")
        assert np.array_equal(h[3].numpy(), h0[3])
        assert np.array_equal(c[3].numpy(), c0[3])


@functools.lru_cache(maxsize=None)
def _encoder_case(layers: int, bidirectional: bool):
    x, mask = _inputs(7, LENGTHS)
    dirs = 2 if bidirectional else 1
    c0 = np.random.default_rng(8).standard_normal((dirs, H)).astype(
        np.float32)
    jm = jrnn.BiLSTMEncoder(hidden_size=H, num_layers=layers,
                            bidirectional=bidirectional)
    params = jm.init(jax.random.PRNGKey(9), jnp.asarray(x),
                     jnp.asarray(mask), jnp.asarray(c0))["params"]
    w = np.random.default_rng(10).standard_normal((B, H * dirs)).astype(
        np.float32)

    def jax_f(p, xx, cc):
        out = jm.apply({"params": p}, xx, jnp.asarray(mask), cc)
        return jnp.sum(out * w), out

    (_, want), grads = jax.jit(jax.value_and_grad(
        jax_f, argnums=(0, 1, 2), has_aux=True))(
        params, jnp.asarray(x), jnp.asarray(c0))
    return x, mask, c0, params, w, want, grads


@pytest.mark.parametrize("layers", [1, 2])
@pytest.mark.parametrize("bidirectional", [True, False])
@pytest.mark.parametrize("step_loop", [False, True])
def test_bilstm_encoder_matches_jax(layers, bidirectional, step_loop):
    """The masked encoder with learned initial states over ragged rows
    and an empty row (the 2-layer bidirectional case: two independent
    stacks, each direction's layer 2 reading its own layer 1): the
    summary at 2e-5 of JAX's, the empty row's tanh(c0) per direction,
    and the gradients by the input, c0 and every parameter at 2e-3 of
    the largest entry."""
    x, mask, c0, params, w, want, (g_p, g_x, g_c0) = _encoder_case(
        layers, bidirectional)
    model = _load(trnn.BiLSTMEncoder(E, H, layers, bidirectional), params)
    xt = torch.from_numpy(x).requires_grad_(True)
    ct = torch.from_numpy(c0).requires_grad_(True)
    out = use_step_loop(model, step_loop)(xt, torch.from_numpy(mask), ct)
    (out * torch.from_numpy(w)).sum().backward()
    _close(out, want)
    np.testing.assert_allclose(out[3].detach().numpy(),
                               np.tanh(c0).reshape(-1), rtol=0, atol=1e-6)
    _grad_close(xt.grad, g_x, "input")
    _grad_close(ct.grad, g_c0, "c0")
    for name, p in model.named_parameters():
        _grad_close(p.grad, _flat(g_p)[name.replace(".", "/")], name)


@pytest.mark.parametrize("rnn_type", ["LSTM", "GRU"])
def test_single_steps_equal_the_scan_and_jax(rnn_type):
    """`step` t by t from the same initial states gives the scan's
    outputs and final states (the fused route and the step loop) and
    JAX's single_step outputs, at 2e-5."""
    jm, params, model = _stacked_pair(rnn_type, 2, seed=11)
    x, _ = _inputs(12)
    init = _states(np.random.default_rng(13), rnn_type, 2)
    with torch.no_grad():
        full, finals = model(torch.from_numpy(x), _to_torch(init))
        loop, _ = use_step_loop(model)(torch.from_numpy(x),
                                       _to_torch(init))
        st, j_st, outs = _to_torch(init), _to_jax(init), []
        for t in range(L):
            h, st = model.step(torch.from_numpy(x[:, t]), st)
            jh, j_st = jm.apply({"params": params}, jnp.asarray(x[:, t]),
                                j_st, single_step=True)
            _close(h, jh, what=f"step {t}")
            outs.append(h)
    _close(torch.stack(outs, 1), full.numpy())
    _close(loop, full.numpy())
    for a, b in zip(_final_h(st), _final_h(finals)):
        _close(a, b.numpy())


def test_the_parameters_are_torchs_own_layout():
    """The fused call takes the JAX package's w_ih / w_hh / b_ih / b_hh
    as torch's nn.LSTM and nn.GRU hold theirs (gate order i, f, g, o and
    r, z, n): loading them into torch's modules gives the same outputs,
    at 2e-6."""
    for rnn_type, cls in (("LSTM", torch.nn.LSTM), ("GRU", torch.nn.GRU)):
        _, params, model = _stacked_pair(rnn_type, 2, seed=14)
        ref = cls(E, H, num_layers=2, batch_first=True)
        with torch.no_grad():
            for layer in range(2):
                for name in ("weight_ih", "weight_hh", "bias_ih",
                             "bias_hh"):
                    ours = getattr(model, name.replace("weight", "w")
                                   .replace("bias", "b") + f"_{layer}")
                    getattr(ref, f"{name}_l{layer}").copy_(ours)
            x = torch.from_numpy(_inputs(15)[0])
            np.testing.assert_allclose(model(x)[0].numpy(),
                                       ref(x)[0].numpy(), rtol=0, atol=2e-6)


def test_plain_scans_match_jax_one_layer():
    """lstm_scan (with a mask) and gru_scan against JAX's on one
    projected input: outputs and finals at 2e-5."""
    rng = np.random.default_rng(16)
    for gates, fn in ((4, "lstm"), (3, "gru")):
        xp = rng.standard_normal((B, L, gates * H)).astype(np.float32)
        w_hh = rng.standard_normal((gates * H, H)).astype(np.float32) * 0.3
        b_hh = rng.standard_normal(gates * H).astype(np.float32)
        h0 = rng.standard_normal((B, H)).astype(np.float32)
        c0 = rng.standard_normal((B, H)).astype(np.float32)
        t = [torch.from_numpy(a) for a in (xp, w_hh, b_hh, h0, c0)]
        j = [jnp.asarray(a) for a in (xp, w_hh, b_hh, h0, c0)]
        if fn == "lstm":
            mask = _inputs(0, LENGTHS)[1]
            out, (h, c) = trnn.lstm_scan(*t, mask=torch.from_numpy(mask))
            jout, (jh, jc) = jrnn.lstm_scan(*j, mask=jnp.asarray(mask))
            _close(c, jc)
        else:
            out, h = trnn.gru_scan(*t[:4])
            jout, jh = jrnn.gru_scan(*j[:4])
        _close(out, jout)
        _close(h, jh)


def test_a_mask_with_a_hole_is_refused_and_cpu_calls_are_not_counted():
    """The fused route takes prefix masks only (the batcher's layout);
    the step loop's CUDA counter does not move on CPU tensors."""
    _, _, model = _stacked_pair("LSTM", 1, seed=17)
    x, mask = _inputs(18, LENGTHS)
    mask[0, 3] = False
    with pytest.raises(ValueError, match="prefix"):
        model(torch.from_numpy(x), mask=torch.from_numpy(mask))
    before = trnn.step_loop_cuda_calls
    use_step_loop(model)(torch.from_numpy(x))
    assert trnn.step_loop_cuda_calls == before
