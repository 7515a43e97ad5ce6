"""K1/K2 and K5/K5b: the sliding-window attention forward and backward as
CUDA kernels, in the head-major layout (K1 and K2, replacing
sparse_vae_tpu/ops/pallas_kernels.py::_sliding_window_attention_fwd_pallas
and ::_bwd_pallas) and in the packed [B, L, H * Dh] projection layout (K5
and K5b, replacing ::_sliding_window_attention_fwd_packed and
::_bwd_packed). The forwards are instantiations of one templated kernel
(csrc/swa_fwd.cu) and the backwards of one templated set (csrc/swa_bwd.cu),
at Dh 64 and 128 head-major and Dh 128 packed, all at block 128. K1 and K2
also take `q_off`, the sequence-parallel form in which the JAX package's
sp_windowed_attention_pallas (K6) calls the same two Pallas kernels, and
the broadcast [CLS] block of such a shard as a slot of its own (`cls`):
ops/sp_kernel.py builds K6 on them.

The dense causal route (ops/attention.py) takes the dense causal pair of
ops/causal_kernel.py on the card at head-major Dh 64 and 128
(`SlidingWindowAttentionFn` hands it over), and these wrappers at the
other widths and on the CPU. Every other shape inside the JAX package's gates up to Dh 512
(Dh % 8 == 0, a block that is a multiple of 128) takes the generic pair of
csrc/swa_generic.cu, in either layout (one entry, given the operands'
row, head and batch strides), with the same options: `q_off`, `cls`,
causal or not, the [CLS] slot. The wrappers choose it by shape
(`instantiated`).

`route` decides up front which family a call takes, reproducing the JAX
package's gates. Each wrapper launches its kernel for tensors off the CPU
and runs its plain version (ops/sliding_window_attention.py) for CPU
tensors. There is no other fallback: a tensor no kernel takes raises, and
so does a call off the CPU that `route` gives "plain" (beyond Dh 512,
`take_plain_route`), since the JAX package runs a kernel at that shape.
"""
from __future__ import annotations

import torch

from . import cuda_lib
from .sliding_window_attention import (
    sliding_window_attention_bwd_plain,
    sliding_window_attention_packed_bwd_plain,
    sliding_window_attention_packed_plain, sliding_window_attention_plain)

# Kernel launches in this process (raised only where a kernel launches):
# K1 in `launches`, K2 in `bwd_launches`, K5 in `packed_launches`, K5b in
# `packed_bwd_launches`; K1 and K2 launched for K6's banded branch
# (`sp=True`) in `sp_launches` and `sp_bwd_launches` instead. Those count
# the head-major Dh 64 instantiation: K1 and K2 at head-major Dh 128 count
# in `hm128_launches` and `hm128_bwd_launches`, and the generic pair in
# `generic_launches` and `generic_bwd_launches`, whoever calls them. The
# dense causal pair (ops/causal_kernel.py, the dense causal route at Dh 64
# and 128) counts in `dense_launches` and `dense_bwd_launches`.
# `plain_routes` counts CPU attention calls inside the JAX package's
# kernel gates at a shape no CUDA kernel takes (`route` == "plain");
# `take_plain_route` raises it.
launches = 0
bwd_launches = 0
packed_launches = 0
packed_bwd_launches = 0
sp_launches = 0
sp_bwd_launches = 0
dense_launches = 0
dense_bwd_launches = 0
hm128_launches = 0
hm128_bwd_launches = 0
generic_launches = 0
generic_bwd_launches = 0
plain_routes = 0

# The tuned CUDA instantiations: block 128, and Dh 64 or 128 head-major
# (K1/K2) or Dh 128 packed (K5/K5b).
BLOCK_SIZE = 128
HEAD_DIM = 64
HEAD_DIMS = (HEAD_DIM, 128)
PACKED_HEAD_DIM = 128
# The generic pair's range: Dh % 8 == 0 up to MAX_HEAD_DIM (the widest head
# of any run, preset or bench width: d_model 512, one head) and any block
# that is a multiple of 128. Up to WG_MAX_HEAD_DIM its kernels are the
# Hopper ones (wgmma, the backward's [CLS] column split into partials);
# wider heads keep the mma.sync kernels, which take no [CLS] scratch.
MAX_HEAD_DIM = 512
WG_MAX_HEAD_DIM = 256


def instantiated(head_dim: int, block_size: int, packed: bool) -> bool:
    """Whether a tuned instantiation takes the shape (K1/K2 head-major,
    K5/K5b packed); the generic pair takes the rest of `in_range`."""
    dims = (PACKED_HEAD_DIM,) if packed else HEAD_DIMS
    return block_size == BLOCK_SIZE and head_dim in dims


def in_range(head_dim: int, block_size: int) -> bool:
    """Whether a CUDA kernel takes the shape: Dh % 8 == 0 up to
    MAX_HEAD_DIM and a block that is a multiple of 128."""
    return (0 < head_dim <= MAX_HEAD_DIM and head_dim % 8 == 0
            and block_size > 0 and block_size % 128 == 0)


def route(head_dim: int, block_size: int, packed_ok: bool = True) -> str:
    """The kernel family of one blocked sliding-window self-attention call
    (sparse, its own queries, lq == lk, lq % block_size == 0, kernels on),
    as the JAX package dispatches it:

    - "packed": Dh % 128 == 0 and block % 128 == 0 (its
      `Attention._packed_ok`, which also wants one tensor-parallel shard:
      packed_ok), at the K5/K5b instantiation (Dh 128, block 128);
    - "packed_generic": that gate at another shape up to Dh 512, the
      generic pair on the packed layout;
    - "head_major": otherwise block % 128 == 0 and Dh % 8 == 0 (its
      `sliding_window_attention` gate), at a K1/K2 instantiation (Dh 64
      or 128, block 128);
    - "generic": that gate at another shape up to Dh 512, the generic
      pair on the head-major layout;
    - "plain": inside a gate beyond Dh 512, where no CUDA kernel takes the
      shape: the plain version on the CPU, counted in `plain_routes`; on
      the card it raises (`take_plain_route`);
    - "outside": outside both gates: the plain version, as JAX takes XLA
      there.
    """
    if block_size % 128 == 0 and head_dim % 128 == 0 and packed_ok:
        if instantiated(head_dim, block_size, packed=True):
            return "packed"
        return "packed_generic" if in_range(head_dim, block_size) \
            else "plain"
    if block_size % 128 == 0 and head_dim % 8 == 0:
        if instantiated(head_dim, block_size, packed=False):
            return "head_major"
        return "generic" if in_range(head_dim, block_size) else "plain"
    return "outside"


def take_plain_route(device: torch.device, head_dim: int, block_size: int):
    """Account for a call that `route` gives "plain": on the CPU count it
    in `plain_routes` (the caller then runs the plain version); on any
    other device raise, as the JAX package runs a kernel at this shape and
    no CUDA kernel of the port takes it."""
    global plain_routes
    if device.type != "cpu":
        raise NotImplementedError(
            f"no CUDA kernel of the sliding-window attention at head_dim "
            f"{head_dim}, block_size {block_size}: the kernels take Dh % 8 "
            f"== 0 up to {MAX_HEAD_DIM} and blocks that are multiples of "
            f"128")
    plain_routes += 1


def _check(q, k, v, lengths, block_size: int, window_size: int,
           q_off: int = 0, include_cls: bool = False, cls=None):
    b, h, L, d = q.shape if q.ndim == 4 else (0,) * 4
    kv_shape = (b, h, L + q_off * block_size, d)
    if q.ndim != 4 or tuple(k.shape) != kv_shape or v.shape != k.shape:
        raise ValueError(f"q must be [B, H, L, D] and k/v [B, H, L + q_off "
                         f"* block, D] with q_off {q_off}, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if L % block_size:
        raise ValueError(f"length {L} is not a multiple of {block_size}")
    if q_off < 0 or (q_off and include_cls):
        raise ValueError(f"q_off must be >= 0 and takes no [CLS] slot, got "
                         f"q_off {q_off}, include_cls {include_cls}")
    if cls is not None:
        cls_k, cls_v, cls_len = cls
        if include_cls or cls_k.shape != (b, h, block_size, d) \
                or cls_v.shape != cls_k.shape or cls_len.shape != (b,):
            raise ValueError(f"cls takes no include_cls, cls_k/cls_v "
                             f"{(b, h, block_size, d)} and cls_len [{b}], "
                             f"got include_cls {include_cls}, "
                             f"{tuple(cls_k.shape)}, {tuple(cls_v.shape)}, "
                             f"{tuple(cls_len.shape)}")
        if len({t.device for t in (q, cls_k, cls_v, cls_len)}) != 1:
            raise ValueError("cls on another device than q")
    _check_rows(q, k, v, lengths, window_size)


def _check_rows(q, k, v, lengths, window_size: int):
    """The checks that do not depend on the layout: the window, one valid
    length per batch row, one device."""
    if window_size < 1:
        raise ValueError(f"window_size must be >= 1, got {window_size}")
    if lengths.shape != (q.shape[0],):
        raise ValueError(f"lengths must be [{q.shape[0]}], got "
                         f"{tuple(lengths.shape)}")
    devices = {t.device for t in (q, k, v, lengths)}
    if len(devices) != 1:
        raise ValueError(f"inputs on several devices: {devices}")


def _check_cuda(kernel: str, tensors, lengths, head_dim: int,
                block_size: int, packed: bool = False):
    """The checks of a launch: bf16 operands, int32 lengths, contiguous,
    and a shape some kernel takes (`in_range`)."""
    if any(t.dtype != torch.bfloat16 for t in tensors):
        raise TypeError(f"the {kernel} kernel takes bf16 tensors")
    if lengths.dtype != torch.int32:
        raise TypeError("lengths must be int32")
    if not in_range(head_dim, block_size):
        raise ValueError(f"no {kernel} kernel takes head_dim {head_dim} and "
                         f"block_size {block_size}: Dh % 8 == 0 up to "
                         f"{MAX_HEAD_DIM}, blocks that are multiples of 128")
    if not all(t.is_contiguous() for t in (*tensors, lengths)):
        raise ValueError(f"the {kernel} kernel takes contiguous inputs")


def _cls_tensors(kernel: str, cls):
    """(cls_k, cls_v, cls_len) of a CUDA call, three Nones without `cls`;
    raises on a cls_len the kernel does not take."""
    if cls is None:
        return None, None, None
    if cls[2].dtype != torch.int32 or not cls[2].is_contiguous():
        raise TypeError(f"the {kernel} kernel takes a contiguous int32 "
                        f"cls_len")
    return cls


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def _stream(device: torch.device) -> int:
    """The current CUDA stream of `device` as the kernels take it."""
    return torch.cuda.current_stream(device).cuda_stream


def _strides(x, packed: bool, head_dim: int) -> tuple:
    """(row, head, batch) element strides of a head-major [B, H, L, D] or
    packed [B, L, H * D] operand: the generic pair's layout."""
    if packed:
        return x.stride(1), head_dim, x.stride(0)
    return x.stride(2), x.stride(1), x.stride(0)


def _generic_fwd(q, k, v, lengths, heads: int, packed: bool, d: int, *,
                 window_size, block_size, causal, include_cls, q_off=0,
                 cls=None):
    """The generic forward (csrc/swa_generic.cu) on head-major or packed
    operands: (out in q's layout, lse [B, H, Lq] fp32)."""
    global generic_launches
    cls_k, cls_v, cls_len = _cls_tensors("generic", cls)
    b = q.shape[0]
    q_len = q.shape[1] if packed else q.shape[2]
    key_len = k.shape[1] if packed else k.shape[2]
    out = torch.empty_like(q)
    lse = torch.empty((b, heads, q_len), dtype=torch.float32,
                      device=q.device)
    code = cuda_lib.library().svt_swa_generic_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        _ptr(cls_k), _ptr(cls_v), _ptr(cls_len), out.data_ptr(),
        lse.data_ptr(), *_strides(q, packed, d), *_strides(k, packed, d), b,
        heads, q_len, key_len, d, block_size, window_size, int(causal),
        int(include_cls), q_off, d ** -0.5, _stream(q.device))
    cuda_lib.check(code, "swa_generic_fwd")
    generic_launches += 1
    return out, lse


def _generic_bwd(q, k, v, lengths, lse, out, do, heads: int, packed: bool,
                 d: int, *, window_size, block_size, causal, include_cls,
                 q_off=0, cls=None):
    """The generic backward: (dq, dk, dv) in the operands' layout, and
    dcls_k, dcls_v after them with `cls`."""
    global generic_bwd_launches
    cls_k, cls_v, cls_len = _cls_tensors("generic", cls)
    if lse.dtype != torch.float32 or not lse.is_contiguous():
        raise TypeError("the generic backward takes a contiguous fp32 lse")
    b = q.shape[0]
    q_len = q.shape[1] if packed else q.shape[2]
    key_len = k.shape[1] if packed else k.shape[2]
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    dcls_k = torch.empty_like(cls_k) if cls is not None else None
    dcls_v = torch.empty_like(cls_v) if cls is not None else None
    delta = torch.empty((b, heads, q_len), dtype=torch.float32,
                        device=q.device)
    scratch = torch.empty(generic_scratch_shape(
        b, heads, q_len, d, block_size, window_size, causal, include_cls,
        cls is not None), dtype=torch.float32, device=q.device)
    code = cuda_lib.library().svt_swa_generic_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        lse.data_ptr(), out.data_ptr(), do.data_ptr(), _ptr(cls_k),
        _ptr(cls_v), _ptr(cls_len), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), _ptr(dcls_k), _ptr(dcls_v), delta.data_ptr(),
        _ptr(scratch if scratch.numel() else None),
        *_strides(q, packed, d), *_strides(k, packed, d), b, heads, q_len,
        key_len, d, block_size, window_size, int(causal), int(include_cls),
        q_off, CLS_CHUNK, d ** -0.5, _stream(q.device))
    cuda_lib.check(code, "swa_generic_bwd")
    generic_bwd_launches += 1
    return (dq, dk, dv, dcls_k, dcls_v) if cls is not None else (dq, dk, dv)


def swa_fwd(q, k, v, lengths, *, window_size: int = 2,
            block_size: int = 128, causal: bool = True,
            include_cls: bool = True, q_off: int = 0, cls=None,
            sp: bool = False):
    """Sliding-window + [CLS] attention forward.

    q: [B, H, L, D]; k/v: [B, H, L + q_off * block_size, D] (q_off > 0:
    query block i sits at key block i + q_off, no [CLS] slot); lengths: [B]
    int32 valid key prefix per row. Returns (out [B, H, L, D] in q's
    dtype, lse [B, H, L] fp32). cls: (cls_k, cls_v [B, H, block_size, D],
    cls_len [B] int32) in place of include_cls: the broadcast [CLS] block
    that every query of a banded shard also attends (K6's forward), its
    valid keys cls_len; lse is then the joint one of the band and the
    block. Off the CPU: bf16, contiguous; K1 at D = 64 or 128 and
    block_size = 128, the generic forward at the rest of `in_range`. sp:
    the launch is K6's banded branch (ops/sp_kernel.py) and counts as K6's
    (at Dh 64).
    """
    global launches, sp_launches, hm128_launches
    _check(q, k, v, lengths, block_size, window_size, q_off, include_cls,
           cls)
    if q.device.type == "cpu":
        mask = (torch.arange(k.shape[2], device=q.device)[None, :]
                < lengths.to(torch.int64)[:, None])
        return sliding_window_attention_plain(
            q, k, v, mask, window_size=window_size, block_size=block_size,
            causal=causal, include_cls=include_cls, return_lse=True,
            q_off=q_off, cls=cls)

    cls_k, cls_v, cls_len = _cls_tensors("K1", cls)
    tensors = (q, k, v) + ((cls_k, cls_v) if cls is not None else ())
    b, h, L, d = q.shape
    _check_cuda("K1", tensors, lengths, d, block_size)
    if not instantiated(d, block_size, packed=False):
        return _generic_fwd(q, k, v, lengths, h, False, d,
                            window_size=window_size, block_size=block_size,
                            causal=causal, include_cls=include_cls,
                            q_off=q_off, cls=cls)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, L), dtype=torch.float32, device=q.device)
    lib = cuda_lib.library()
    code = lib.svt_swa_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           lengths.data_ptr(), _ptr(cls_k), _ptr(cls_v),
                           _ptr(cls_len), out.data_ptr(), lse.data_ptr(), b,
                           h, L, k.shape[2], d, block_size, window_size,
                           int(causal), int(include_cls or cls is not None),
                           q_off, d ** -0.5, _stream(q.device))
    cuda_lib.check(code, "swa_fwd")
    if d != HEAD_DIM:
        hm128_launches += 1
    elif sp:
        sp_launches += 1
    else:
        launches += 1
    return out, lse


def swa_bwd(q, k, v, lengths, lse, out, do, *, window_size: int = 2,
            block_size: int = 128, causal: bool = True,
            include_cls: bool = True, q_off: int = 0, cls=None,
            sp: bool = False):
    """Sliding-window + [CLS] attention backward.

    q/out/do: [B, H, L, D]; k/v: [B, H, L + q_off * block_size, D];
    lengths: [B] int32; lse: [B, H, L] fp32 from `swa_fwd` (-inf for a row
    with no valid key). Returns (dq, dk, dv) in q's dtype. cls: (cls_k,
    cls_v [B, H, block_size, D], cls_len [B] int32) in place of
    include_cls: the broadcast [CLS] block that every query of a banded
    shard also attends (K6's backward), its valid keys cls_len, under the
    joint lse and the merged out; then returns (dq, dk, dv, dcls_k,
    dcls_v). Off the CPU: bf16, contiguous; K2 at D = 64 or 128 and
    block_size = 128, the generic backward at the rest of `in_range`. sp:
    as in `swa_fwd`.
    """
    global bwd_launches, sp_bwd_launches, hm128_bwd_launches
    _check(q, k, v, lengths, block_size, window_size, q_off, include_cls,
           cls)
    if out.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"out/do must be {tuple(q.shape)}, got "
                         f"{tuple(out.shape)}, {tuple(do.shape)}")
    if lse.shape != q.shape[:3]:
        raise ValueError(f"lse must be {tuple(q.shape[:3])}, got "
                         f"{tuple(lse.shape)}")
    if len({t.device for t in (q, out, do, lse)}) != 1:
        raise ValueError("inputs on several devices")
    if q.device.type == "cpu":
        return sliding_window_attention_bwd_plain(
            q, k, v, lengths, lse, out, do, window_size=window_size,
            block_size=block_size, causal=causal, include_cls=include_cls,
            q_off=q_off, cls=cls)

    broadcast = cls is not None
    cls_k, cls_v, cls_len = _cls_tensors("K2", cls)
    tensors = (q, k, v, out, do) + ((cls_k, cls_v) if broadcast else ())
    b, h, L, d = q.shape
    _check_cuda("K2", tensors, lengths, d, block_size)
    if not instantiated(d, block_size, packed=False):
        return _generic_bwd(q, k, v, lengths, lse, out, do, h, False, d,
                            window_size=window_size, block_size=block_size,
                            causal=causal, include_cls=include_cls,
                            q_off=q_off, cls=cls)
    if lse.dtype != torch.float32 or not lse.is_contiguous():
        raise TypeError("the K2 kernel takes a contiguous fp32 lse")
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    dcls_k = torch.empty_like(cls_k) if broadcast else None
    dcls_v = torch.empty_like(cls_v) if broadcast else None
    delta = torch.empty((b, h, L), dtype=torch.float32, device=q.device)
    chunks = cls_chunks(L // block_size, window_size, causal,
                        include_cls or broadcast, broadcast)
    scratch = torch.empty((2, b, h, scratch_parts(chunks, broadcast),
                           block_size, d), dtype=torch.float32,
                          device=q.device)

    lib = cuda_lib.library()
    code = lib.svt_swa_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        lse.data_ptr(), out.data_ptr(), do.data_ptr(), _ptr(cls_k),
        _ptr(cls_v), _ptr(cls_len), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), _ptr(dcls_k), _ptr(dcls_v), delta.data_ptr(),
        scratch.data_ptr(), b, h, L, k.shape[2], d, block_size, window_size,
        int(causal), int(include_cls or broadcast), q_off, CLS_CHUNK,
        d ** -0.5, _stream(q.device))
    cuda_lib.check(code, "swa_bwd")
    if d != HEAD_DIM:
        hm128_bwd_launches += 1
    elif sp:
        sp_bwd_launches += 1
    else:
        bwd_launches += 1
    return (dq, dk, dv, dcls_k, dcls_v) if broadcast else (dq, dk, dv)


# Query blocks per CTA in the [CLS]-column pass of K2 and K5b.
CLS_CHUNK = 8


def cls_chunks(num_blocks: int, window_size: int, causal: bool,
               include_cls: bool, broadcast: bool = False) -> int:
    """Chunks of CLS_CHUNK query blocks that reach the [CLS] block only
    through the [CLS] slot: for key block 0 the blocks at or past the
    band's left extent; for the broadcast block of a banded shard all
    `num_blocks` local query blocks. The kernels count the same
    (csrc/swa_bwd.cu, `launch`)."""
    if not include_cls:
        return 0
    if broadcast:
        return -(-num_blocks // CLS_CHUNK)
    left = window_size if causal else (window_size + 1) // 2
    if num_blocks <= left:
        return 0
    return -(-(num_blocks - left) // CLS_CHUNK)


def scratch_parts(chunks: int, broadcast: bool) -> int:
    """fp32 [block, D] tiles per (dk or dv, row, head) of the [CLS]
    scratch: one partial per chunk, after the band part of key block 0
    unless [CLS] is the broadcast block."""
    return chunks + (not broadcast)


def generic_scratch_shape(batch: int, heads: int, q_len: int,
                          head_dim: int, block_size: int, window_size: int,
                          causal: bool, include_cls: bool,
                          broadcast: bool = False) -> tuple:
    """The fp32 [CLS] scratch of the generic backward: (2 (dk, dv), B, H,
    parts, block, Dh) with K2's count of parts (`scratch_parts` of
    `cls_chunks`: key block 0's band part, unless [CLS] is the broadcast
    block, then one partial per chunk, summed in that order); (0,) when
    the call has no [CLS] chunk or its head is wider than WG_MAX_HEAD_DIM
    (the mma.sync kernels split nothing)."""
    chunks = cls_chunks(q_len // block_size, window_size, causal,
                        include_cls or broadcast, broadcast)
    if not chunks or head_dim > WG_MAX_HEAD_DIM:
        return (0,)
    return (2, batch, heads, scratch_parts(chunks, broadcast), block_size,
            head_dim)


def _check_packed(q, k, v, lengths, num_heads: int, block_size: int,
                  window_size: int) -> int:
    """`_check` for the packed operands, on their shapes (head views cost
    more host time than the kernel at a serving shape); returns the head
    dim."""
    if q.ndim != 3 or q.shape[2] % num_heads or k.shape != q.shape \
            or v.shape != q.shape:
        raise ValueError(f"q, k, v must be [B, L, H * D] with H = "
                         f"{num_heads}, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[1] % block_size:
        raise ValueError(f"length {q.shape[1]} is not a multiple of "
                         f"{block_size}")
    _check_rows(q, k, v, lengths, window_size)
    return q.shape[2] // num_heads


def swa_fwd_packed(q, k, v, lengths, num_heads: int, *, window_size: int = 2,
                   block_size: int = 128, causal: bool = True,
                   include_cls: bool = True):
    """K5: sliding-window + [CLS] attention forward on packed operands.

    q/k/v: [B, L, H * D], head h at columns h * D; lengths: [B] int32
    valid key prefix per row. Returns (out [B, L, H * D] in q's dtype,
    lse [B, H, L] fp32). Off the CPU: bf16, contiguous; K5 at D = 128 and
    block_size = 128, the generic forward at the rest of `in_range`.
    """
    global packed_launches
    d = _check_packed(q, k, v, lengths, num_heads, block_size, window_size)
    if q.device.type == "cpu":
        return sliding_window_attention_packed_plain(
            q, k, v, lengths, num_heads, window_size=window_size,
            block_size=block_size, causal=causal, include_cls=include_cls)

    _check_cuda("K5", (q, k, v), lengths, d, block_size, packed=True)
    if not instantiated(d, block_size, packed=True):
        return _generic_fwd(q, k, v, lengths, num_heads, True, d,
                            window_size=window_size, block_size=block_size,
                            causal=causal, include_cls=include_cls)
    b, L, _ = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, num_heads, L), dtype=torch.float32,
                      device=q.device)
    lib = cuda_lib.library()
    code = lib.svt_swa_fwd_packed(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                  lengths.data_ptr(), out.data_ptr(),
                                  lse.data_ptr(), b, num_heads, L, d,
                                  block_size, window_size, int(causal),
                                  int(include_cls), d ** -0.5,
                                  _stream(q.device))
    cuda_lib.check(code, "swa_fwd_packed")
    packed_launches += 1
    return out, lse


def swa_bwd_packed(q, k, v, lengths, lse, out, do, num_heads: int, *,
                   window_size: int = 2, block_size: int = 128,
                   causal: bool = True, include_cls: bool = True):
    """K5b: the backward of `swa_fwd_packed`.

    q/k/v/out/do: [B, L, H * D]; lengths: [B] int32; lse: [B, H, L] fp32
    from `swa_fwd_packed`. Returns (dq, dk, dv) packed, in q's dtype.
    delta = rowsum(do * out) per head is computed inside the dq kernel.
    Off the CPU: bf16, contiguous; K5b at D = 128 and block_size = 128,
    the generic backward at the rest of `in_range`.
    """
    global packed_bwd_launches
    d = _check_packed(q, k, v, lengths, num_heads, block_size, window_size)
    b, L, _ = q.shape
    if out.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"out/do must be {tuple(q.shape)}, got "
                         f"{tuple(out.shape)}, {tuple(do.shape)}")
    if lse.shape != (b, num_heads, L):
        raise ValueError(f"lse must be {(b, num_heads, L)}, got "
                         f"{tuple(lse.shape)}")
    if len({t.device for t in (q, out, do, lse)}) != 1:
        raise ValueError("inputs on several devices")
    if q.device.type == "cpu":
        return sliding_window_attention_packed_bwd_plain(
            q, k, v, lengths, lse, out, do, num_heads,
            window_size=window_size, block_size=block_size, causal=causal,
            include_cls=include_cls)

    _check_cuda("K5b", (q, k, v, out, do), lengths, d, block_size,
                packed=True)
    if not instantiated(d, block_size, packed=True):
        return _generic_bwd(q, k, v, lengths, lse, out, do, num_heads, True,
                            d, window_size=window_size,
                            block_size=block_size, causal=causal,
                            include_cls=include_cls)
    if lse.dtype != torch.float32 or not lse.is_contiguous():
        raise TypeError("the K5b kernel takes a contiguous fp32 lse")
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    delta = torch.empty((b, num_heads, L), dtype=torch.float32,
                        device=q.device)
    chunks = cls_chunks(L // block_size, window_size, causal, include_cls)
    scratch = torch.empty((2, b, num_heads, scratch_parts(chunks, False),
                           block_size, d),
                          dtype=torch.float32, device=q.device)
    lib = cuda_lib.library()
    code = lib.svt_swa_bwd_packed(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        lse.data_ptr(), out.data_ptr(), do.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), delta.data_ptr(), scratch.data_ptr(),
        b, num_heads, L, d, block_size, window_size, int(causal),
        int(include_cls), CLS_CHUNK, d ** -0.5, _stream(q.device))
    cuda_lib.check(code, "swa_bwd_packed")
    packed_bwd_launches += 1
    return dq, dk, dv
