"""Port token selection against the JAX package: K4's plain version (the
port of pallas_select._select_tile) against nucleus_gumbel_argmax in
interpret mode and on its jnp path, and the row-wise selection stack
(repetition penalty, top-p filter, _select_token_rows, process_logits_rowwise)
given the same Gumbel noise, made from the same uniform draws.

Chosen token ids must be identical, except that fp32 sums taken in
another order can move the nucleus threshold of a row whose kept mass sat
within rounding of top_p * z at some bisection step: such a row (relative
margin below 1e-5, two orders above fp32 rounding of these sums) may
differ, and at most one such row is tolerated per call.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_vae_tpu.models import generation as jgen
from sparse_vae_tpu.ops.pallas_select import nucleus_gumbel_argmax as j_select
from sparse_vae_tpu_torch.models import generation as tgen
from sparse_vae_tpu_torch.ops import select_kernel


def _logits(seed, n, v, scale=3.0):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal((n, v))).astype(np.float32)


def _assert_same_choices(got, want, margin):
    differ = np.nonzero(got.numpy() != np.asarray(want))[0]
    assert len(differ) <= 1, differ
    assert bool((margin[differ] < 1e-5).all()), margin[differ]


def _gumbel(seed, shape):
    key = jax.random.PRNGKey(seed)
    return np.array(jax.random.gumbel(key, shape, jnp.float32))


@pytest.mark.parametrize("temperature", [1.0, 0.7])
@pytest.mark.parametrize("top_p", [0.9, 1.0])
def test_plain_matches_pallas_interpret(temperature, top_p):
    s = _logits(0, 8, 512)
    noise = _gumbel(1, s.shape)
    want = j_select(jnp.asarray(s), jnp.asarray(noise), top_p=top_p,
                    temperature=temperature, interpret=True)
    got, _, margin = select_kernel.select_rows_plain(
        torch.from_numpy(s), torch.from_numpy(noise), top_p=top_p,
        temperature=temperature)
    _assert_same_choices(got, want, margin)


@pytest.mark.parametrize("top_p", [0.9, 1.0])
def test_plain_gives_index_0_where_every_value_is_minus_inf(top_p):
    """-inf noise on every token of rows 0 and 2: the reference chooses
    index 0 there, and so does the plain version (the CUDA kernel is held
    to the same in tests/test_torch_cuda.py)."""
    s = _logits(5, 4, 512)
    noise = _gumbel(6, s.shape)
    noise[::2] = -np.inf
    want = j_select(jnp.asarray(s), jnp.asarray(noise), top_p=top_p,
                    interpret=True)
    got, _, margin = select_kernel.select_rows_plain(
        torch.from_numpy(s), torch.from_numpy(noise), top_p=top_p)
    assert (np.asarray(want)[::2] == 0).all()
    assert (got.numpy()[::2] == 0).all()
    _assert_same_choices(got, want, margin)


@pytest.mark.parametrize("with_noise", [True, False])
def test_plain_matches_jnp_path_at_serving_width(with_noise):
    """64 rows x 32,768 logits, the serving shape, on the jnp path of the
    reference (use_pallas=False runs _select_tile directly)."""
    s = _logits(2, 64, 32768, scale=4.0)
    noise = _gumbel(3, s.shape) if with_noise else None
    want = j_select(jnp.asarray(s),
                    None if noise is None else jnp.asarray(noise),
                    top_p=0.9, temperature=1.0, use_pallas=False)
    got, _, margin = select_kernel.select_rows_plain(
        torch.from_numpy(s),
        None if noise is None else torch.from_numpy(noise), top_p=0.9)
    _assert_same_choices(got, want, margin)


def test_wrapper_runs_plain_on_cpu_and_never_counts():
    s = torch.from_numpy(_logits(4, 4, 256))
    before = select_kernel.launches
    got = select_kernel.nucleus_gumbel_argmax(s, None, top_p=0.5)
    assert torch.equal(got, select_kernel.nucleus_gumbel_argmax_plain(
        s, None, top_p=0.5))
    assert select_kernel.launches == before
    with pytest.raises(ValueError):
        select_kernel.nucleus_gumbel_argmax(s[0])
    with pytest.raises(ValueError):
        select_kernel.nucleus_gumbel_argmax(s, s[:2])


def _peaked_rows(seed, n=16, v=2048):
    """Logit rows from flat to sharply peaked, two with a dominant token."""
    rng = np.random.default_rng(seed)
    scales = np.array([1, 2, 3, 4, 6, 8, 12, 16] * (n // 8))[:, None]
    s = scales * rng.standard_normal((n, v))
    s[: 2, 7] += 12.0
    return s.astype(np.float32)


def _replay_lo(p, weight, decide, num_iters):
    """The K4 kernel's bisection: level l bins the p inside the bracket
    [a 2^-8l, (a + 1) 2^-8l) by floor(p 2^(8l + 8)) into 256 bins, sums
    the mass above it, and replays up to 8 steps from the bins (bin 0 is
    never asked for). Returns lo."""
    a, levels = 0, min(3, -(-num_iters // 8))
    for level in range(levels):
        q = np.floor(p * 2.0 ** (8 * level + 8))
        first = a * 256
        above = weight[q >= first + 256].sum()
        inside = (q > first) & (q < first + 256)
        bins = np.bincount((q[inside] - first).astype(np.int64),
                           weights=weight[inside], minlength=256)
        lo_c, hi_c = 0, 256
        for _ in range(min(8, num_iters - 8 * level)):
            c = (lo_c + hi_c) // 2
            mass = above + bins[c:hi_c].sum()
            if decide(mass):
                lo_c = c
            else:
                hi_c, above = c, mass
        a = a * 256 + lo_c
    return a * 2.0 ** (-8 * levels)


def _bisection_lo(p, weight, decide, num_iters):
    lo, hi = 0.0, 1.0
    for _ in range(num_iters):
        mid = (lo + hi) * 0.5
        if decide(weight[p >= mid].sum()):
            lo = mid
        else:
            hi = mid
    return lo


@pytest.mark.parametrize("masses", ["float64", "fixed"])
@pytest.mark.parametrize("top_p", [0.5, 0.9, 0.999])
@pytest.mark.parametrize("num_iters", [8, 16, 20, 24])
def test_histogram_replay_reaches_the_bisection_threshold(num_iters, top_p,
                                                          masses):
    """K4's exactness argument, where the CPU can check it: with max p = 1
    every mid of the first 24 steps is a multiple of 2^-24, so the level
    replay makes the bisection's decisions and reaches its lo bit for bit,
    on float64 masses and on the kernel's own fixed-point ones (integers
    in units of 2^-40, compared in fp32). Its kept set is
    select_rows_plain's on every row whose margin is not below 1e-5."""
    s = torch.from_numpy(_peaked_rows(12))
    p32 = torch.exp(s - s.amax(dim=-1, keepdim=True))
    _, thresh, margin = select_kernel.select_rows_plain(
        s, top_p=top_p, num_iters=num_iters)
    kept = (p32 >= thresh[:, None]) | (p32 == 1.0)
    held = 0
    for r in range(s.shape[0]):
        p = p32[r].double().numpy()
        if masses == "float64":
            weight = p
            target = top_p * p.sum()

            def decide(mass):
                return mass >= target
        else:
            weight = np.rint(p * 2.0 ** 40)
            z = np.float32(weight.sum() * 2.0 ** -40)
            target32 = np.float32(np.float32(top_p) * z)

            def decide(mass):
                return np.float32(mass * 2.0 ** -40) >= target32
        lo = _replay_lo(p, weight, decide, num_iters)
        assert lo == _bisection_lo(p, weight, decide, num_iters), r
        if margin[r] >= 1e-5:
            held += 1
            keep = torch.from_numpy((p >= lo) | (p == 1.0))
            assert torch.equal(keep, kept[r]), r
    assert held > 0


def test_gumbel_transform_matches_jax():
    """jax.random.gumbel is -log(-log(u)) of uniforms in [tiny, 1)."""
    u = np.random.default_rng(5).uniform(
        np.finfo(np.float32).tiny, 1.0, size=(4, 1000)).astype(np.float32)
    want = -jnp.log(-jnp.log(jnp.asarray(u)))
    got = tgen.gumbel_from_uniform(torch.from_numpy(u))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_gumbel_noise_is_reproducible_from_a_generator():
    a = tgen.gumbel_noise((3, 50), torch.Generator().manual_seed(9))
    b = tgen.gumbel_noise((3, 50), torch.Generator().manual_seed(9))
    assert torch.equal(a, b) and bool(torch.isfinite(a).all())


def test_repetition_penalty_rowwise_matches_jax():
    rng = np.random.default_rng(6)
    logits = _logits(7, 3, 64)
    tokens = rng.integers(0, 64, size=(3, 40))
    index = np.array([1, 17, 39])
    for penalty in (1.2, np.array([[1.0], [1.5], [2.0]], np.float32)):
        want = jgen.apply_repetition_penalty_rowwise(
            jnp.asarray(logits), jnp.asarray(tokens), jnp.asarray(index),
            jnp.asarray(penalty), 16)
        pen = penalty if isinstance(penalty, float) else \
            torch.from_numpy(penalty)
        got = tgen.apply_repetition_penalty_rowwise(
            torch.from_numpy(logits), torch.from_numpy(tokens),
            torch.from_numpy(index), pen, 16)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6)


def test_top_p_filter_matches_jax():
    logits = _logits(8, 5, 300)
    top_p = np.array([[0.5], [0.9], [0.95], [0.99], [0.3]], np.float32)
    want = jgen.top_p_filter(jnp.asarray(logits), jnp.asarray(top_p))
    got = tgen.top_p_filter(torch.from_numpy(logits),
                            torch.from_numpy(top_p))
    np.testing.assert_array_equal(np.isfinite(got.numpy()),
                                  np.isfinite(np.asarray(want)))


def test_select_token_rows_matches_jax():
    """Per-row overrides: sampled, greedy (temperature 0) and
    nucleus-off (top_p 1) rows in one batch, with the same noise."""
    logits = _logits(9, 4, 400)
    key = jax.random.PRNGKey(10)
    noise = np.array(jax.random.gumbel(key, logits.shape, jnp.float32))
    overrides = {"temperature": np.array([1.0, 0.0, 0.7, 1.3], np.float32),
                 "top_p": np.array([0.9, 0.9, 1.0, 0.5], np.float32)}
    params = jgen.SamplingParams()
    want = jgen._select_token_rows(
        jnp.asarray(logits), key, params,
        {k: jnp.asarray(v) for k, v in overrides.items()})
    got = tgen._select_token_rows(
        torch.from_numpy(logits), torch.from_numpy(noise),
        tgen.SamplingParams(),
        {k: torch.from_numpy(v) for k, v in overrides.items()})
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_process_logits_rowwise_prompt_and_caps_match_jax():
    """Greedy steps with forced prompt positions, a per-row cap and an end
    token: token buffers, indices and liveness match the reference."""
    b, ml, v, end = 3, 12, 50, 2
    rng = np.random.default_rng(11)
    tokens = np.zeros((b, ml), np.int32)
    tokens[:, 0] = 1
    tokens[0, 1:4] = [7, 2, 9]          # a prompt holding the end token
    j_state = jgen.RowDecodeState(
        tokens=jnp.asarray(tokens), index=jnp.ones(b, jnp.int32),
        live=jnp.ones(b, bool), rng=jax.random.PRNGKey(0),
        row_max=jnp.asarray([11, 5, 11]),
        prompt_len=jnp.asarray([4, 1, 1]))
    t_state = tgen.RowDecodeState(
        tokens=torch.from_numpy(tokens.astype(np.int64)),
        index=torch.ones(b, dtype=torch.int64),
        live=torch.ones(b, dtype=torch.bool),
        rng=torch.Generator().manual_seed(0),
        row_max=torch.tensor([11, 5, 11]), prompt_len=torch.tensor([4, 1, 1]))
    greedy_j = jgen.SamplingParams(top_k=1, repetition_penalty=1.0)
    greedy_t = tgen.SamplingParams(top_k=1, repetition_penalty=1.0)
    for step in range(10):
        logits = rng.standard_normal((b, v)).astype(np.float32)
        logits[2, end] = 10.0 if step == 6 else logits[2, end]
        j_state = jgen.process_logits_rowwise(jnp.asarray(logits), j_state,
                                              greedy_j, end)
        t_state = tgen.process_logits_rowwise(torch.from_numpy(logits),
                                              t_state, greedy_t, end)
        np.testing.assert_array_equal(t_state.tokens.numpy(),
                                      np.asarray(j_state.tokens))
        np.testing.assert_array_equal(t_state.index.numpy(),
                                      np.asarray(j_state.index))
        np.testing.assert_array_equal(t_state.live.numpy(),
                                      np.asarray(j_state.live))
    assert not t_state.live.any()
