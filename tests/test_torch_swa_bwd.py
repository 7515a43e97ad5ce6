"""The sliding-window attention backward (K2's plain version, and the
autograd Function that carries K1/K2) against the JAX package's gradients.

The same numpy inputs, made from a seed, go through `jax.grad` of
`sliding_window_attention_xla` and through the port on the CPU in fp32,
with ragged valid lengths and L >= 512 so that the [CLS] column's
beyond-band contributions run. One tiny case holds the port against the
Pallas kernel's own backward (`sliding_window_attention_pallas`, interpret
mode).

Tolerance: gradients of O(1) inputs after two 16-wide products and a
softmax differ in fp32 summation order only, below 1e-5 absolute (measured
~1e-6), so 2e-5 is the bound. Rows whose query is padding carry the
reference's -1e9-fill averaging in the forward (a documented difference,
ops/sliding_window_attention.py), so the upstream gradient there is zero,
as a masked loss makes it.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_vae_tpu.ops.pallas_kernels import sliding_window_attention_pallas
from sparse_vae_tpu.ops.sliding_window_attention import (
    sliding_window_attention_xla)
from sparse_vae_tpu_torch.ops import swa_kernel
from sparse_vae_tpu_torch.ops.sliding_window_attention import (
    SlidingWindowAttentionFn, sliding_window_attention_bwd_plain,
    sliding_window_attention_plain)

ATOL = 2e-5


def _problem(seed, b=2, h=2, L=512, d=16, lengths=(512, 301)):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((b, h, L, d)).astype(np.float32)
                   for _ in range(4))
    lens = np.array(lengths, np.int32)
    mask = np.arange(L)[None, :] < lens[:, None]
    do = do * mask[:, None, :, None]         # a masked loss's cotangent
    return q, k, v, do, lens, mask


def _jax_grads(q, k, v, do, mask, window, block, causal):
    def f(q, k, v):
        out = sliding_window_attention_xla(
            q, k, v, jnp.asarray(mask), window_size=window,
            block_size=block, causal=causal)
        return jnp.sum(out * do)
    return [np.asarray(g) for g in jax.grad(f, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [1, 2, 3])
def test_plain_backward_matches_jax(window, causal):
    q, k, v, do, lens, mask = _problem(window + 10 * causal)
    want = _jax_grads(q, k, v, do, mask, window, 128, causal)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    tlens = torch.from_numpy(lens)
    out, lse = sliding_window_attention_plain(
        tq, tk, tv, torch.from_numpy(mask), window_size=window,
        block_size=128, causal=causal, return_lse=True)
    got = sliding_window_attention_bwd_plain(
        tq, tk, tv, tlens, lse, out, tdo, window_size=window,
        block_size=128, causal=causal)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("causal", [True, False])
def test_function_gradients_match_jax(causal):
    """The autograd Function's wiring on the CPU (plain forward and
    backward) gives JAX's gradients, and never counts a kernel launch."""
    q, k, v, do, lens, mask = _problem(20 + causal, lengths=(512, 130))
    want = _jax_grads(q, k, v, do, mask, 2, 128, causal)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    before = (swa_kernel.launches, swa_kernel.bwd_launches)
    out = SlidingWindowAttentionFn.apply(tq, tk, tv, torch.from_numpy(lens),
                                         2, 128, causal, True)
    got = torch.autograd.grad((out * torch.from_numpy(do)).sum(),
                              (tq, tk, tv))
    assert (swa_kernel.launches, swa_kernel.bwd_launches) == before
    assert out.grad_fn is not None
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), w, atol=ATOL, err_msg=name)


def test_plain_backward_matches_autograd():
    """The explicit formula equals autograd of the plain forward, with a
    row that has no valid key (lse -inf) among the inputs."""
    q, k, v, do, lens, mask = _problem(3, L=256, lengths=(256, 0))
    tq, tk, tv = (torch.from_numpy(a).double().requires_grad_()
                  for a in (q, k, v))
    tdo = torch.from_numpy(do).double()
    out, lse = sliding_window_attention_plain(
        tq, tk, tv, torch.from_numpy(mask), window_size=2, block_size=64,
        return_lse=True)
    want = torch.autograd.grad((out * tdo).sum(), (tq, tk, tv))
    got = sliding_window_attention_bwd_plain(
        tq.detach(), tk.detach(), tv.detach(), torch.from_numpy(lens),
        lse.detach(), out.detach(), tdo, window_size=2, block_size=64)
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=ATOL)


def test_plain_backward_matches_pallas_interpret():
    """A tiny case through the Pallas kernel's own backward (interpret
    mode): four 32-token blocks, so block 0's [CLS] column gets the
    beyond-band contributions of blocks 2 and 3."""
    q, k, v, do, lens, mask = _problem(4, b=1, h=1, L=128, d=16,
                                       lengths=(128,))

    def f(q, k, v):
        out = sliding_window_attention_pallas(q, k, v, None, 2, 32, True,
                                              True, True)
        return jnp.sum(out * do)

    want = jax.grad(f, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    out, lse = sliding_window_attention_plain(
        tq, tk, tv, None, window_size=2, block_size=32, return_lse=True)
    got = sliding_window_attention_bwd_plain(
        tq, tk, tv, torch.from_numpy(lens), lse, out, tdo, window_size=2,
        block_size=32)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL)


def test_backward_wrapper_rejects_bad_inputs():
    q, k, v, do, lens, _ = (torch.from_numpy(a) if isinstance(a, np.ndarray)
                            else a for a in _problem(5, L=256))
    out, lse = swa_kernel.swa_fwd(q, k, v, lens)
    with pytest.raises(ValueError, match="lse"):
        swa_kernel.swa_bwd(q, k, v, lens, lse[:, :, :128], out, do)
    with pytest.raises(ValueError, match="out/do"):
        swa_kernel.swa_bwd(q, k, v, lens, lse, out[:, :1], do)
    with pytest.raises(ValueError):
        swa_kernel.swa_bwd(q, k, v, lens, lse, out, do, block_size=96)


def test_backward_wrapper_rejects_a_cls_block_it_does_not_take():
    """The broadcast [CLS] block (`cls`) takes the place of the in-band
    [CLS] slot and must be [B, H, block, D] with cls_len [B]."""
    q, k, v, do, lens, _ = (torch.from_numpy(a) if isinstance(a, np.ndarray)
                            else a for a in _problem(6, L=256))
    out, lse = swa_kernel.swa_fwd(q, k, v, lens, block_size=128,
                                  include_cls=False)
    cls = (k[:, :, :128], v[:, :, :128], torch.tensor([128, 7]))
    with pytest.raises(ValueError, match="include_cls"):
        swa_kernel.swa_bwd(q, k, v, lens, lse, out, do, cls=cls)
    with pytest.raises(ValueError, match="cls_k"):
        swa_kernel.swa_bwd(q, k, v, lens, lse, out, do, include_cls=False,
                           cls=(cls[0][:, :, :64], cls[1], cls[2]))
    with pytest.raises(ValueError, match="cls_len"):
        swa_kernel.swa_bwd(q, k, v, lens, lse, out, do, include_cls=False,
                           cls=(cls[0], cls[1], cls[2][:1]))
    grads = swa_kernel.swa_bwd(q, k, v, lens, lse, out, do,
                               include_cls=False, cls=cls)
    assert [g.shape for g in grads] == [q.shape, k.shape, v.shape,
                                        cls[0].shape, cls[1].shape]


def test_forward_wrapper_rejects_a_cls_block_it_does_not_take():
    """The forward takes the broadcast [CLS] block (`cls`) as the backward
    does: in place of the in-band [CLS] slot, [B, H, block, D] with
    cls_len [B]; the same errors."""
    q, k, v, _, lens, _ = (torch.from_numpy(a) if isinstance(a, np.ndarray)
                           else a for a in _problem(7, L=256))
    cls = (k[:, :, :128], v[:, :, :128], torch.tensor([128, 7]))
    with pytest.raises(ValueError, match="include_cls"):
        swa_kernel.swa_fwd(q, k, v, lens, cls=cls)
    with pytest.raises(ValueError, match="cls_k"):
        swa_kernel.swa_fwd(q, k, v, lens, include_cls=False,
                           cls=(cls[0][:, :, :64], cls[1], cls[2]))
    with pytest.raises(ValueError, match="cls_len"):
        swa_kernel.swa_fwd(q, k, v, lens, include_cls=False,
                           cls=(cls[0], cls[1], cls[2][:1]))
    out, lse = swa_kernel.swa_fwd(q, k, v, lens, include_cls=False,
                                  cls=cls)
    assert out.shape == q.shape and lse.shape == q.shape[:3]


@pytest.mark.parametrize(
    "num_blocks,window,causal,include_cls,broadcast,chunks,parts", [
        (100, 2, True, True, False, 13, 14),   # (100 - 2) / 8, + band part
        (100, 2, False, True, False, 13, 14),  # left 1: 99 / 8
        (2, 2, True, True, False, 0, 1),       # the band reaches block 0
        (100, 2, True, False, False, 0, 1),    # no [CLS]
        (200, 2, True, True, True, 25, 25),    # a banded shard: all 200
        (4, 1, True, True, True, 1, 1),        # window 1, q_off 0
        (9, 3, True, True, True, 2, 2)])
def test_cls_chunk_geometry(num_blocks, window, causal, include_cls,
                            broadcast, chunks, parts):
    """The [CLS] column's chunk count and scratch size that the wrappers
    allocate, as csrc/swa_bwd.cu's `launch` counts them: for key block 0
    the query blocks past the band's left extent, for the broadcast block
    of a banded shard every local query block (no band part)."""
    got = swa_kernel.cls_chunks(num_blocks, window, causal, include_cls,
                                broadcast)
    assert got == chunks
    assert swa_kernel.scratch_parts(got, broadcast) == parts
