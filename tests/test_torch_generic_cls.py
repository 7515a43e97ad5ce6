"""The [CLS] column of the generic backward (csrc/swa_generic.cu), on the
CPU: the wrappers' host-side sizing of its fp32 partials, and a plain model
of the split and of the reduce's fixed order.

- The sizing: `cls_part_blocks` below (the query blocks of each part, in
  the reduce's order) and `swa_kernel.generic_scratch_shape` agree with
  K2's `cls_chunks` and `scratch_parts` for causal and bidirectional bands,
  with and without the [CLS] slot, with the broadcast block and q_off,
  and the parts tile the query blocks that reach the [CLS] block; the
  backward wrapper allocates that scratch and passes CLS_CHUNK (the
  library replaced by a recorder, meta tensors).
- The model: key block 0's dk and dv (or the broadcast block's dcls_k,
  dcls_v), as the kernel splits them (the plain backward restricted to
  each part's query rows) and summed part by part in the reduce's order,
  equal `sliding_window_attention_bwd_plain`'s whole-column gradients to
  fp32 rounding (rtol 1e-5, atol 1e-6 of the largest entry).
"""
import numpy as np
import pytest
import torch

from sparse_vae_tpu_torch.ops import cuda_lib, swa_kernel
from sparse_vae_tpu_torch.ops.sliding_window_attention import (
    sliding_window_attention_bwd_plain, sliding_window_attention_plain)

SUM_RTOL, SUM_ATOL = 1e-5, 1e-6


def cls_part_blocks(num_blocks: int, window_size: int, causal: bool,
                    include_cls: bool, broadcast: bool = False,
                    q_off: int = 0) -> list:
    """The local query blocks [lo, hi) whose dk/dv terms of the [CLS]
    block land in each part of the generic backward's scratch, in the
    order its reduce sums them: key block 0's band part first (its band's
    query blocks; not for the broadcast block), then one chunk of
    CLS_CHUNK blocks per partial (past the band's left extent, or every
    local block for the broadcast block). Empty when the call has no
    [CLS] chunk (the band reaches every query block, or no [CLS] slot):
    then nothing is split. A plain model of csrc/swa_generic.cu's
    swa_generic_dkv_wg_kernel (its [CLS] tasks' lo, hi) and of its
    reduce's order."""
    chunks = swa_kernel.cls_chunks(num_blocks, window_size, causal,
                                   include_cls or broadcast, broadcast)
    if not chunks:
        return []
    left = window_size if causal else (window_size + 1) // 2
    first = 0 if broadcast else left
    parts = [] if broadcast else [
        (max(0, left - window_size - q_off), min(num_blocks, left - q_off))]
    for c in range(chunks):
        lo = first + c * swa_kernel.CLS_CHUNK
        parts.append((lo, min(num_blocks, lo + swa_kernel.CLS_CHUNK)))
    return parts


@pytest.mark.parametrize("num_blocks", [1, 2, 3, 10, 19, 100])
@pytest.mark.parametrize("window,causal", [(1, True), (2, True), (3, True),
                                           (2, False), (3, False),
                                           (5, False)])
@pytest.mark.parametrize("slot", ["cls", "none", "broadcast"])
def test_scratch_sizing_matches_k2s_count(num_blocks, window, causal, slot):
    include_cls = slot == "cls"
    broadcast = slot == "broadcast"
    chunks = swa_kernel.cls_chunks(num_blocks, window, causal,
                                   include_cls or broadcast, broadcast)
    parts = cls_part_blocks(num_blocks, window, causal, include_cls,
                            broadcast)
    block, d = 128, 40
    shape = swa_kernel.generic_scratch_shape(3, 2, num_blocks * block, d,
                                             block, window, causal,
                                             include_cls, broadcast)
    if chunks == 0:
        assert parts == [] and shape == (0,)
        return
    assert len(parts) == swa_kernel.scratch_parts(chunks, broadcast)
    assert shape == (2, 3, 2, len(parts), block, d)
    # The parts tile the query blocks that reach the [CLS] block: the
    # band's (key block 0's band part, first) and then every chunk's.
    left = window if causal else (window + 1) // 2
    covered = [qb for lo, hi in parts for qb in range(lo, hi)]
    assert covered == list(range(num_blocks))
    chunk_parts = parts if broadcast else parts[1:]
    assert all(hi - lo <= swa_kernel.CLS_CHUNK for lo, hi in chunk_parts)
    if not broadcast:
        assert parts[0] == (0, left)


@pytest.mark.parametrize("q_off", [1, 3])
def test_scratch_sizing_with_q_off(q_off):
    """A banded shard (q_off > 0) takes the broadcast block, never key
    block 0: every local query block reaches it through a chunk."""
    parts = cls_part_blocks(20, 2, True, False, True, q_off)
    assert parts == [(0, 8), (8, 16), (16, 20)]
    assert swa_kernel.generic_scratch_shape(1, 4, 20 * 256, 256, 256, 2,
                                            True, False, True) == \
        (2, 1, 4, 3, 256, 256)


def test_wider_heads_take_no_scratch():
    """Beyond Dh 256 the mma.sync kernels split nothing."""
    assert swa_kernel.generic_scratch_shape(2, 1, 2048, 512, 128, 2, True,
                                            True) == (0,)
    assert swa_kernel.generic_scratch_shape(2, 1, 2048, 256, 128, 2, True,
                                            True)[3] == 3


class _Recorder:
    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("svt_"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.mark.parametrize("d,L,include_cls,broadcast", [
    (256, 12800, True, False),   # bench.py --heads 2's layer: 13 chunks
    (32, 1024, True, False),     # 8 blocks: one chunk
    (32, 256, True, False),      # the band reaches every block: none
    (256, 1024, False, True),    # K6's banded shard
    (512, 1024, True, False),    # beyond Dh 256: no scratch
])
def test_backward_wrapper_allocates_the_partials(monkeypatch, d, L,
                                                 include_cls, broadcast):
    lib = _Recorder()
    monkeypatch.setattr(cuda_lib, "library", lambda: lib)
    monkeypatch.setattr(swa_kernel, "_stream", lambda device: 0)
    shapes = []
    sizing = swa_kernel.generic_scratch_shape

    def record(*args):
        shapes.append(sizing(*args))
        return shapes[-1]

    monkeypatch.setattr(swa_kernel, "generic_scratch_shape", record)
    meta = dict(device="meta", dtype=torch.bfloat16)
    b, h, q_off = 2, 2, 1 if broadcast else 0
    q = torch.empty((b, h, L, d), **meta)
    k = torch.empty((b, h, L + q_off * 128, d), **meta)
    lengths = torch.empty((b,), device="meta", dtype=torch.int32)
    lse = torch.empty((b, h, L), device="meta", dtype=torch.float32)
    cls = None
    if broadcast:
        cls = (torch.empty((b, h, 128, d), **meta),
               torch.empty((b, h, 128, d), **meta),
               torch.empty((b,), device="meta", dtype=torch.int32))
    swa_kernel.swa_bwd(q, k, k, lengths, lse, q, q, window_size=2,
                       block_size=128, include_cls=include_cls,
                       q_off=q_off, cls=cls)
    (name, args), = lib.calls
    assert name == "svt_swa_generic_bwd"
    chunks = swa_kernel.cls_chunks(L // 128, 2, True, True, broadcast)
    want = (2, b, h, swa_kernel.scratch_parts(chunks, broadcast), 128, d) \
        if chunks and d <= swa_kernel.WG_MAX_HEAD_DIM else (0,)
    assert shapes == [want]
    # cls_chunk follows q_off among the ints after the 17 pointers.
    assert args[17 + 16] == swa_kernel.CLS_CHUNK


def _problem(seed, b, h, L, d, key_len):
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    return t(b, h, L, d), t(b, h, key_len, d), t(b, h, key_len, d), \
        t(b, h, L, d)


def _summed(parts_blocks, block, grads_of):
    """The reduce: each part's fp32 partial, summed in part order."""
    total = None
    for lo, hi in parts_blocks:
        part = grads_of(lo * block, hi * block)
        total = part if total is None else [a + p for a, p in
                                            zip(total, part)]
    return total


def _close(got, want):
    scale = want.abs().max().item()
    torch.testing.assert_close(got, want, rtol=SUM_RTOL,
                               atol=SUM_ATOL * scale)


@pytest.mark.parametrize("window,causal", [(2, True), (3, False),
                                           (1, True)])
def test_key_block_0_partials_sum_to_the_plain_gradient(window, causal):
    """Key block 0 with the [CLS] slot: its band part and three or more
    chunks of query blocks, summed in order, give the plain backward's
    dk and dv of the block, on rows whose length ends inside a chunk."""
    block, d, b, h = 16, 24, 2, 2
    left = window if causal else (window + 1) // 2
    num_blocks = left + 2 * swa_kernel.CLS_CHUNK + 3
    L = num_blocks * block
    q, k, v, do = _problem(window, b, h, L, d, L)
    lengths = torch.tensor([L, (left + swa_kernel.CLS_CHUNK + 2) * block
                            + 5], dtype=torch.int32)
    kw = dict(window_size=window, block_size=block, causal=causal,
              include_cls=True)
    mask = torch.arange(L)[None, :] < lengths[:, None]
    out, lse = sliding_window_attention_plain(q, k, v, mask,
                                              return_lse=True, **kw)
    _, dk, dv = sliding_window_attention_bwd_plain(q, k, v, lengths, lse,
                                                   out, do, **kw)
    parts = cls_part_blocks(num_blocks, window, causal, True)
    assert len(parts) == 4

    def grads_of(r0, r1):
        rows = torch.zeros(L, dtype=torch.bool)
        rows[r0:r1] = True
        _, pk, pv = sliding_window_attention_bwd_plain(
            q, k, v, lengths, lse, out, do * rows[:, None], **kw)
        return [pk[:, :, :block], pv[:, :, :block]]

    got_k, got_v = _summed(parts, block, grads_of)
    _close(got_k, dk[:, :, :block])
    _close(got_v, dv[:, :, :block])


def test_broadcast_block_partials_sum_to_the_plain_gradient():
    """The broadcast [CLS] block of a banded shard (q_off > 0): one chunk
    per CLS_CHUNK local query blocks, summed in order, give the plain
    backward's dcls_k and dcls_v."""
    block, d, b, h, q_off, window = 16, 32, 2, 2, 1, 2
    num_blocks = 2 * swa_kernel.CLS_CHUNK + 5
    L = num_blocks * block
    key_len = L + q_off * block
    q, k, v, do = _problem(7, b, h, L, d, key_len)
    cls_k, cls_v = _problem(8, b, h, block, d, block)[:2]
    cls = (cls_k, cls_v, torch.tensor([block, 9], dtype=torch.int32))
    lengths = torch.tensor([key_len, key_len - 37], dtype=torch.int32)
    kw = dict(window_size=window, block_size=block, causal=True,
              include_cls=False, q_off=q_off, cls=cls)
    mask = torch.arange(key_len)[None, :] < lengths[:, None]
    out, lse = sliding_window_attention_plain(q, k, v, mask,
                                              return_lse=True, **kw)
    want = sliding_window_attention_bwd_plain(q, k, v, lengths, lse, out,
                                              do, **kw)[3:]
    parts = cls_part_blocks(num_blocks, window, True, False, True, q_off)
    assert len(parts) == 3

    def grads_of(r0, r1):
        rows = torch.zeros(L, dtype=torch.bool)
        rows[r0:r1] = True
        return list(sliding_window_attention_bwd_plain(
            q, k, v, lengths, lse, out, do * rows[:, None], **kw)[3:])

    got = _summed(parts, block, grads_of)
    for g, w in zip(got, want):
        _close(g, w)
