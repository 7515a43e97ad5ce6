"""The fused tied projection + cross-entropy (K3/K3b's plain versions and
the autograd Function around them) and the chunked CE, against the JAX
package.

The same numpy inputs, made from a seed, go through the JAX functions and
the port on the CPU in fp32: the Pallas kernels themselves in interpret
mode at the JAX tests' tile sizes (tt=16, vt=128), and JAX's
`chunked_cross_entropy` at the flagship's D = 512, V = 32,768 on a small
token count.

Tolerance: nll is a logsumexp over up to 32,768 fp32 logits of size ~10;
summation order moves it by ~1e-6 relative, so 1e-5 relative and 1e-5
absolute. Gradients sum up to 32,768 terms: 5e-5 absolute on values of
order 1e-2..1, with 1e-4 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_vae_tpu.ops.cross_entropy import (
    chunked_cross_entropy as j_chunked)
from sparse_vae_tpu.ops.pallas_ce import fused_tied_cross_entropy
from sparse_vae_tpu_torch.ops import ce_kernel
from sparse_vae_tpu_torch.ops.cross_entropy import (chunked_cross_entropy,
                                                    token_nll)

RTOL, ATOL = 1e-5, 1e-5
G_RTOL, G_ATOL = 1e-4, 5e-5


def _problem(seed, n=48, d=64, v=256):
    rng = np.random.default_rng(seed)
    g = (0.5 * rng.standard_normal((n, d))).astype(np.float32)
    table = (0.5 * rng.standard_normal((v, d))).astype(np.float32)
    bias = (0.1 * rng.standard_normal(v)).astype(np.float32)
    labels = rng.integers(0, v, size=n).astype(np.int32)
    w = rng.standard_normal(n).astype(np.float32)
    return g, table, bias, labels, w


@pytest.mark.parametrize("n", [48, 13])
def test_plain_matches_pallas_interpret(n):
    """nll, dg, dE and dbias of the plain versions against the Pallas
    kernels (interpret mode), aligned and unaligned token counts."""
    g, table, bias, labels, w = _problem(n)
    g, labels, w = g[:n], labels[:n], w[:n]

    def f(g, table, bias):
        nll = fused_tied_cross_entropy(g, table, bias, jnp.asarray(labels),
                                       tt=16, vt=128, interpret=True)
        return jnp.sum(nll * w), nll

    (_, want), grads = jax.value_and_grad(f, argnums=(0, 1, 2),
                                          has_aux=True)(
        jnp.asarray(g), jnp.asarray(table), jnp.asarray(bias))
    tg, tt, tb = (torch.from_numpy(a) for a in (g, table, bias))
    tl = torch.from_numpy(labels).long()
    nll, lse = ce_kernel.tied_ce_fwd(tg, tt, tb, tl)
    np.testing.assert_allclose(nll.numpy(), np.asarray(want), rtol=RTOL,
                               atol=ATOL)
    got = ce_kernel.tied_ce_bwd(tg, tt, tb, tl, lse, torch.from_numpy(w))
    for name, a, b in zip(("dg", "dE", "dbias"), got, grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=G_RTOL,
                                   atol=G_ATOL, err_msg=name)


def test_function_matches_jax_chunked_at_flagship_width():
    """FusedTiedCrossEntropy (plain versions on the CPU) against JAX's
    chunked_cross_entropy at D = 512, V = 32,768: the summed NLL over
    non-pad labels and its gradients in the hidden states, the table and
    the bias."""
    rng = np.random.default_rng(7)
    b, length, d, v = 2, 64, 512, 32768
    h = (0.05 * rng.standard_normal((b, length, d))).astype(np.float32)
    table = (0.05 * rng.standard_normal((v, d))).astype(np.float32)
    bias = (0.1 * rng.standard_normal(v)).astype(np.float32)
    labels = rng.integers(1, v, size=(b, length))
    labels[1, 40:] = 0                                 # padding

    def f(h, table, bias):
        return j_chunked(h, lambda x: x @ table.T + bias,
                         jnp.asarray(labels), chunk_size=32)

    args = (jnp.asarray(h), jnp.asarray(table), jnp.asarray(bias))
    (want_sum, want_count), grads = jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True)(*args)
    th, tt, tb = (torch.from_numpy(a).requires_grad_()
                  for a in (h, table, bias))
    flat = torch.from_numpy(labels).reshape(-1)
    nll = ce_kernel.FusedTiedCrossEntropy.apply(th.reshape(-1, d), tt, tb,
                                                flat)
    mask = (flat != 0).float()
    total = (nll * mask).sum()
    assert float(mask.sum()) == float(want_count)
    np.testing.assert_allclose(total.item(), float(want_sum), rtol=RTOL)
    got = torch.autograd.grad(total, (th, tt, tb))
    for name, a, g in zip(("dh", "dE", "dbias"), got, grads):
        np.testing.assert_allclose(a.numpy(), np.asarray(g), rtol=G_RTOL,
                                   atol=G_ATOL, err_msg=name)


def test_chunked_cross_entropy_matches_jax():
    rng = np.random.default_rng(8)
    b, length, d, v = 2, 50, 32, 300
    h = rng.standard_normal((b, length, d)).astype(np.float32)
    table = rng.standard_normal((v, d)).astype(np.float32)
    labels = rng.integers(0, v, size=(b, length))
    want = j_chunked(jnp.asarray(h), lambda x: x @ jnp.asarray(table).T,
                     jnp.asarray(labels), chunk_size=16)
    th = torch.from_numpy(h).requires_grad_()
    got = chunked_cross_entropy(th, lambda x: x @ torch.from_numpy(table).T,
                                torch.from_numpy(labels), chunk_size=16)
    np.testing.assert_allclose(float(got[0]), float(want[0]), rtol=RTOL)
    assert float(got[1]) == float(want[1])
    # Recomputed chunks give the same gradient as one dense pass.
    dense = token_nll(th @ torch.from_numpy(table).T,
                      torch.from_numpy(labels), reduce=False)[0].sum()
    for a, c in zip(torch.autograd.grad(got[0], th),
                    torch.autograd.grad(dense, th)):
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=G_RTOL,
                                   atol=G_ATOL)


def test_wrappers_reject_bad_inputs():
    g, table, bias, labels, w = (torch.from_numpy(a) for a in _problem(1))
    labels = labels.long()
    with pytest.raises(ValueError):
        ce_kernel.tied_ce_fwd(g, table[:, :32], bias, labels)
    with pytest.raises(ValueError):
        ce_kernel.tied_ce_fwd(g, table, bias[:10], labels)
    _, lse = ce_kernel.tied_ce_fwd(g, table, bias, labels)
    with pytest.raises(ValueError):
        ce_kernel.tied_ce_bwd(g, table, bias, labels, lse[:5], w)


@pytest.mark.parametrize("t, v, d, scratch", [
    (300, 1024, 64, 128 * 1024 * 2),       # 3 chunks, the last of 44
    (1000, 256, 32, 4 * 128 * 256 * 2),    # 2 chunks, the last of 488
    (129, 512, 16, 10**9),                 # 1 chunk, past one token tile
])
def test_chunked_bwd_matches_plain(t, v, d, scratch):
    """K3b's chunk loop (tied_ce_bwd_chunked), run on the CPU with its
    plain parts, against tied_ce_bwd_plain in fp32: several chunks with a
    partial last one, padding tokens (dnll 0), dl's onehot and the fix
    term that takes it back out of dg."""
    rng = np.random.default_rng(t + v)
    g = torch.from_numpy((0.5 * rng.standard_normal((t, d))).astype(np.float32))
    table = torch.from_numpy(
        (0.5 * rng.standard_normal((v, d))).astype(np.float32))
    bias = torch.from_numpy((0.1 * rng.standard_normal(v)).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, v, size=t))
    dnll = torch.from_numpy(rng.random(t).astype(np.float32))
    labels[-5:], dnll[-5:] = 0, 0.0
    _, lse = ce_kernel.tied_ce_fwd(g, table, bias, labels)
    got = ce_kernel.tied_ce_bwd_chunked(g, table, bias, labels, lse, dnll,
                                        scratch_bytes=scratch)
    want = ce_kernel.tied_ce_bwd_plain(g, table, bias, labels, lse, dnll)
    for name, a, b in zip(("dg", "dE", "dbias"), got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=G_RTOL,
                                   atol=G_ATOL, err_msg=name)


def test_bwd_chunk_bounds_the_scratch():
    """Chunks are whole token tiles, balanced, and their bf16 logit
    gradients fit the scratch bound: 7 chunks of 14,720 tokens at
    T = 102,400, V = 32,768 under 1 GB."""
    assert ce_kernel.bwd_chunk(102400, 32768) == 14720
    for t, v in [(102400, 32768), (16384, 32768), (1000, 1024), (1, 128)]:
        c = ce_kernel.bwd_chunk(t, v)
        assert c % ce_kernel.BWD_TILE == 0
        assert c * v * 2 <= max(ce_kernel.DL_SCRATCH_BYTES,
                                ce_kernel.BWD_TILE * v * 2)
        chunks = -(-t // c)
        assert c - (chunks * c - t) > 0          # no empty last chunk


@pytest.mark.parametrize("sms", [1, 78, 132])
def test_fwd_splits_are_valid_grids(sms):
    """K3's vocab split is a power of two that divides the vocab's
    128-row tiles and leaves every CTA two tiles (one for each consumer
    warpgroup), or is 1; and it is the split that finishes soonest by
    the helper's own cost: waves x (tiles per CTA + a CTA's fixed cost)."""
    for t in (1, 100, 1000, 16384, 25600, 102400):
        for v in (128, 1024, 2048, 32768):
            s = ce_kernel.fwd_splits(t, v, sms)
            tiles = v // ce_kernel.VOCAB_TILE
            assert s & (s - 1) == 0 and s <= ce_kernel.FWD_MAX_SPLITS
            assert tiles % s == 0 and (s == 1 or tiles // s >= 2)
            rows = -(-t // ce_kernel.FWD_ROWS)

            def cost(n):
                return -(-rows * n // sms) * (
                    tiles // n + ce_kernel.FWD_CTA_COST_TILES)
            others = [n for n in (1, 2, 4, 8, 16)
                      if tiles % n == 0 and (n == 1 or tiles // n >= 2)]
            assert cost(s) == min(cost(n) for n in others)


def test_fwd_splits_at_the_main_paths_token_counts():
    """On an H100's 132 SMs: one split at the train step's 16,384 tokens
    (128 CTAs, one wave), 8 at an sp-train rank's 25,600 (200 row tiles
    alone would leave most of a second wave idle), 4 at 102,400."""
    assert ce_kernel.fwd_splits(16384, 32768, 132) == 1
    assert ce_kernel.fwd_splits(25600, 32768, 132) == 8
    assert ce_kernel.fwd_splits(102400, 32768, 132) == 4
