"""Port ops against the JAX package: rotary, the sliding-window attention
plain version (K1's oracle) and its dispatcher, the attention layer, and the
decode caches (_decode_ring, decode_rowwise, fill_cache_row).

The same numpy inputs, made from a seed, go through both packages on the
CPU in fp32. Tolerances: fp32 differences in summation order across a
handful of 64-wide dot products and softmaxes stay below 1e-5 absolute on
O(1) values, so 2e-5 (5e-5 after a full attention layer's three
projections) is the bound.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze

from sparse_vae_tpu.ops import attention as jattn
from sparse_vae_tpu.ops.pallas_kernels import (
    _sliding_window_attention_fwd_pallas)
from sparse_vae_tpu.ops.rotary import apply_rotary as j_apply_rotary
from sparse_vae_tpu.ops.sliding_window_attention import (
    sliding_window_attention_xla)
from sparse_vae_tpu_torch.ops import attention as tattn
from sparse_vae_tpu_torch.ops import swa_kernel
from sparse_vae_tpu_torch.ops.rotary import apply_rotary
from sparse_vae_tpu_torch.ops.sliding_window_attention import (
    sliding_window_attention, sliding_window_attention_plain)

ATOL = 2e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _qkv(seed, b=2, h=2, L=64, d=16):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, h, L, d)).astype(np.float32)
                 for _ in range(3))


# -- rotary -----------------------------------------------------------------
@pytest.mark.parametrize("offset", [0, 37])
def test_rotary_scalar_offset(offset):
    x = np.random.default_rng(0).standard_normal((2, 3, 20, 16)).astype(
        np.float32)
    want = j_apply_rotary(jnp.asarray(x), 512.0, offset=offset)
    got = apply_rotary(_t(x), 512.0, offset=offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_rotary_per_row_offset():
    x = np.random.default_rng(1).standard_normal((3, 2, 1, 16)).astype(
        np.float32)
    offs = np.array([0, 5, 700])
    want = j_apply_rotary(jnp.asarray(x), 512.0, offset=jnp.asarray(offs))
    got = apply_rotary(_t(x), 512.0, offset=torch.tensor(offs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


# -- sliding-window attention (K1's plain version) --------------------------
@pytest.mark.parametrize("window", [1, 2, 3])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("include_cls", [True, False])
def test_swa_plain_matches_jax(window, causal, include_cls):
    """Ragged right-padded rows, as a batch of documents gives them."""
    q, k, v = _qkv(window + 10 * causal, L=64)
    lengths = np.array([64, 37])
    mask = np.arange(64)[None, :] < lengths[:, None]
    want = sliding_window_attention_xla(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
        window_size=window, block_size=8, causal=causal,
        include_cls=include_cls)
    got, lse = sliding_window_attention_plain(
        _t(q), _t(k), _t(v), _t(mask), window_size=window, block_size=8,
        causal=causal, include_cls=include_cls, return_lse=True)
    # Without [CLS], a padding query whose band holds only padding keys
    # attends nothing: the port gives 0 there (checked below), where the
    # reference averages the masked values. Every other row must agree.
    seen = np.isfinite(lse.numpy())
    if include_cls:
        assert seen.all()
    np.testing.assert_allclose(got.numpy()[seen], np.asarray(want)[seen],
                               atol=ATOL)
    assert not got.numpy()[~seen].any()


def test_swa_lse_matches_pallas_interpret():
    """One small interpret-mode run of the Pallas forward: out and lse."""
    q, k, v = _qkv(3, b=2, h=1, L=128, d=32)
    lengths = np.array([128, 70], np.int32)
    mask = np.arange(128)[None, :] < lengths[:, None]
    out, lse, _ = _sliding_window_attention_fwd_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(mask),
        window_size=2, block_size=32, causal=True, include_cls=True,
        interpret=True)
    got, got_lse = swa_kernel.swa_fwd(
        _t(q), _t(k), _t(v), torch.tensor(lengths), window_size=2,
        block_size=32, causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(out), atol=ATOL)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(lse), atol=ATOL)


def test_swa_fully_masked_row_is_zero():
    q, k, v = (_t(a) for a in _qkv(4, b=1, L=32))
    mask = torch.zeros((1, 32), dtype=torch.bool)
    out, lse = sliding_window_attention_plain(q, k, v, mask, block_size=8,
                                              return_lse=True)
    assert torch.equal(out, torch.zeros_like(out))
    assert bool(torch.isneginf(lse).all())


def test_swa_dispatch_runs_plain_on_cpu_and_never_counts():
    q, k, v = (_t(a) for a in _qkv(5, L=32))
    before = swa_kernel.launches
    out = sliding_window_attention(q, k, v, None, window_size=2,
                                   block_size=8)
    ref = sliding_window_attention_plain(q, k, v, None, window_size=2,
                                         block_size=8)
    assert torch.equal(out, ref)
    assert swa_kernel.launches == before


def test_swa_wrapper_rejects_bad_inputs():
    q, k, v = (_t(a) for a in _qkv(6, L=32))
    lengths = torch.tensor([32, 32], dtype=torch.int32)
    with pytest.raises(ValueError):
        swa_kernel.swa_fwd(q, k[:, :, :16], v, lengths, block_size=8)
    with pytest.raises(ValueError):
        swa_kernel.swa_fwd(q, k, v, lengths[:1], block_size=8)
    with pytest.raises(ValueError):
        swa_kernel.swa_fwd(q, k, v, lengths, block_size=24)


# -- masks and the attention layer --------------------------------------------
@pytest.mark.parametrize("causal", [True, False])
def test_token_mask_matches_jax(causal):
    want = jattn.sliding_window_token_mask(50, 50, 8, 3, causal)
    got = tattn.sliding_window_token_mask(50, 50, 8, 3, causal)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _attention_pair(sparse=True, d_model=32, heads=2, block=8, seed=0):
    jmod = jattn.Attention(d_model=d_model, num_heads=heads, causal=True,
                           sparse=sparse, window_size=2, block_size=block,
                           use_pallas_kernel=False)
    x0 = jnp.zeros((1, 2 * block, d_model))
    params = unfreeze(jmod.init(jax.random.PRNGKey(seed), x0, x0)["params"])
    # Non-zero biases, so a missed bias shows.
    rng = np.random.default_rng(seed)
    for name in params:
        params[name]["bias"] = jnp.asarray(
            0.1 * rng.standard_normal(params[name]["bias"].shape),
            jnp.float32)
    tmod = tattn.Attention(d_model, heads, causal=True, sparse=sparse,
                           window_size=2, block_size=block)
    state = {}
    for name, leaves in params.items():
        state[f"{name}.weight"] = _t(leaves["kernel"]).T.contiguous()
        state[f"{name}.bias"] = _t(leaves["bias"])
    tmod.load_state_dict(state)
    return jmod, {"params": params}, tmod.eval()


@pytest.mark.parametrize("sparse,length", [(True, 32), (True, 27),
                                           (False, 27)])
def test_attention_layer_matches_jax(sparse, length):
    """The blocked sparse path (L % block == 0), its masked-dense fallback
    (unaligned L) and the dense causal path, with key padding."""
    jmod, variables, tmod = _attention_pair(sparse)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, length, 32)).astype(np.float32)
    mask = np.arange(length)[None, :] < np.array([length, 19])[:, None]
    want = jmod.apply(variables, jnp.asarray(x), jnp.asarray(x),
                      kv_mask=jnp.asarray(mask))
    with torch.no_grad():
        got = tmod(_t(x), _t(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5)


def _jax_caches_to_torch(cache):
    return {k: _t(v).clone() for k, v in cache.items()}


def test_decode_ring_and_rowwise_match_jax():
    """20 steps (past the 16-position ring and the [CLS] block): the
    scalar-index ring decode and the per-row decode with rows at different
    positions, against JAX, outputs and caches."""
    jmod, variables, tmod = _attention_pair(sparse=True)
    rng = np.random.default_rng(3)
    steps, b = 20, 2
    xs = rng.standard_normal((steps, b, 1, 32)).astype(np.float32)
    j_ring = jmod.apply(variables, b, 64, method=jattn.Attention.init_cache)
    j_row = j_ring
    t_ring = tmod.init_cache(b, 64)
    t_row = tmod.init_cache(b, 64)
    offsets = np.array([0, 3])   # row 1 starts three positions in
    with torch.no_grad():
        for i in range(steps):
            x = jnp.asarray(xs[i])
            want, j_ring = jmod.apply(variables, x, j_ring, i,
                                      method=jattn.Attention.decode)
            got, t_ring = tmod.decode(_t(xs[i]), t_ring, i)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=ATOL, err_msg=f"ring step {i}")
            idx = offsets + i
            want, j_row = jmod.apply(variables, x, j_row, jnp.asarray(idx),
                                     method=jattn.Attention.decode_rowwise)
            got, t_row = tmod.decode_rowwise(_t(xs[i]), t_row,
                                             torch.tensor(idx))
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=ATOL, err_msg=f"row step {i}")
    for name in j_ring:
        np.testing.assert_allclose(t_ring[name].numpy(),
                                   np.asarray(j_ring[name]), atol=ATOL)
        np.testing.assert_allclose(t_row[name].numpy(),
                                   np.asarray(j_row[name]), atol=ATOL)


def test_dense_cache_decode_rowwise_matches_jax():
    jmod, variables, tmod = _attention_pair(sparse=False)
    rng = np.random.default_rng(4)
    b = 2
    j_cache = jmod.apply(variables, b, 24, method=jattn.Attention.init_cache)
    t_cache = tmod.init_cache(b, 24)
    with torch.no_grad():
        for i in range(10):
            x = rng.standard_normal((b, 1, 32)).astype(np.float32)
            idx = np.array([i, 2 * i])
            want, j_cache = jmod.apply(variables, jnp.asarray(x), j_cache,
                                       jnp.asarray(idx),
                                       method=jattn.Attention.decode_rowwise)
            got, t_cache = tmod.decode_rowwise(_t(x), t_cache,
                                               torch.tensor(idx))
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=ATOL)


@pytest.mark.parametrize("length", [5, 8, 21, 40])
def test_fill_cache_row_matches_jax(length):
    """Short of the [CLS] block, exactly one block, and past the ring."""
    jmod, variables, tmod = _attention_pair(sparse=True)
    rng = np.random.default_rng(length)
    k = rng.standard_normal((2, 40, 16)).astype(np.float32)
    v = rng.standard_normal((2, 40, 16)).astype(np.float32)
    j_cache = jmod.apply(variables, 3, 64, method=jattn.Attention.init_cache)
    want = jattn.fill_cache_row(j_cache, 1, jnp.asarray(k), jnp.asarray(v),
                                length)
    got = tattn.fill_cache_row(tmod.init_cache(3, 64), 1, _t(k), _t(v),
                               length)
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(),
                                      np.asarray(want[name]), err_msg=name)


def test_row_cache_write_drops_out_of_range_rows():
    buf = torch.zeros((3, 2, 4, 5))
    val = torch.ones((3, 2, 5))
    tattn.row_cache_write(buf, torch.tensor([1, 4, 3]), val)
    assert buf[0, :, 1].eq(1).all() and buf[2, :, 3].eq(1).all()
    assert buf[1].eq(0).all()
    assert buf.sum().item() == 2 * 2 * 5
