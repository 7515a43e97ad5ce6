"""Build and load the port's CUDA kernels.

Each source under `csrc/` compiles in its own nvcc process, all started
together, and one more nvcc call links the objects into one shared library
with a plain C interface (`-gencode arch=compute_90a,code=sm_90a`), loaded
with ctypes. Nothing here includes PyTorch's headers, so the build takes
seconds. The library goes to `_build/` beside this package, named by a
hash of the sources, and is built at first use: importing this module
builds nothing and needs no nvcc.

Each exported C function launches on the stream it is given and returns
`cudaGetLastError()`; `check` turns a non-zero code into an exception.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from dataclasses import dataclass
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = ("swa_fwd.cu", "swa_bwd.cu", "swa_generic.cu", "causal_fwd.cu",
           "causal_bwd.cu", "tied_ce.cu", "tied_ce_bwd.cu",
           "nucleus_select.cu")
# Included by the sources; part of the library's hash.
HEADERS = ("hopper.cuh", "swa_tiles.cuh", "tiles.cuh")
NVCC_TIMEOUT_S = 600

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    # q, k, v, lengths, cls_k, cls_v, cls_len, out, lse, batch, heads,
    # q_len, key_len, head_dim, block_size, window, causal, include_cls,
    # q_off, scale, stream
    "svt_swa_fwd": [_P] * 9 + [_I] * 10 + [_F, _P],
    # The packed layout (K5): q/k/v/out [B, L, H * D], one seq_len, no
    # q_off.
    "svt_swa_fwd_packed": [_P] * 6 + [_I] * 8 + [_F, _P],
    # q, k, v, lengths, lse, out, do, cls_k, cls_v, cls_len, dq, dk, dv,
    # dcls_k, dcls_v, delta, scratch, batch, heads, q_len, key_len,
    # head_dim, block_size, window, causal, include_cls, q_off, cls_chunk,
    # scale, stream
    "svt_swa_bwd": [_P] * 17 + [_I] * 11 + [_F, _P],
    # The packed layout (K5b): q, k, v, lengths, lse, out, do, dq, dk, dv,
    # delta, scratch, then as K2 with one seq_len and no q_off.
    "svt_swa_bwd_packed": [_P] * 12 + [_I] * 9 + [_F, _P],
    # The generic pair (csrc/swa_generic.cu), either layout: q, k, v,
    # lengths, cls_k, cls_v, cls_len, out, lse, then q's and k's (row,
    # head, batch) strides, batch, heads, q_len, key_len, head_dim,
    # block_size, window, causal, include_cls, q_off, scale, stream.
    "svt_swa_generic_fwd": [_P] * 9 + [_I] * 16 + [_F, _P],
    # q, k, v, lengths, lse, out, do, cls_k, cls_v, cls_len, dq, dk, dv,
    # dcls_k, dcls_v, delta, scratch (the [CLS] partials), then as the
    # forward with cls_chunk after q_off.
    "svt_swa_generic_bwd": [_P] * 17 + [_I] * 17 + [_F, _P],
    # The dense causal pair (csrc/causal_fwd.cu, causal_bwd.cu): q, k, v,
    # lengths, out, lse, batch, heads, len, head_dim, group, scale, stream.
    "svt_causal_fwd": [_P] * 6 + [_I] * 5 + [_F, _P],
    # q, k, v, lengths, lse, out, do, dq, dk, dv, delta, dq_acc, counters,
    # batch, heads, len, head_dim, group, scale, stream
    "svt_causal_bwd": [_P] * 13 + [_I] * 5 + [_F, _P],
    # g, table, bias, lse, part (split partials), tokens, vocab, dim,
    # splits, stream
    "svt_tied_ce_fwd": [_P] * 5 + [_I] * 4 + [_P],
    # K3b, one token chunk at a time (ce_kernel.tied_ce_bwd_chunked):
    # g, table, bias, lse, dnll, labels, dl, part, fix, tokens, vocab, dim,
    # chunk0, rows, dl_rows, stream
    "svt_tied_ce_bwd_dl": [_P] * 9 + [_I] * 6 + [_P],
    # dl, table_t, dg, tokens, vocab, dim, chunk0, rows, dl_rows, stream
    "svt_tied_ce_bwd_dg": [_P] * 3 + [_I] * 6 + [_P],
    # dl, g_t, de, tokens, tokens_padded, vocab, dim, chunk0, rows,
    # dl_rows, accumulate, stream
    "svt_tied_ce_bwd_de": [_P] * 3 + [_I] * 8 + [_P],
    # part, dbias, tiles, vocab, stream
    "svt_tied_ce_bwd_dbias": [_P] * 2 + [_I] * 2 + [_P],
    # logits, noise (may be null), out, rows, vocab, top_p, temperature,
    # num_iters, stream; the same with the instantiation (cluster 0, 1, 2)
    # before the stream
    "svt_nucleus_select": [_P, _P, _P, _I, _I, _F, _F, _I, _P],
    "svt_nucleus_select_on": [_P, _P, _P, _I, _I, _F, _F, _I, _I, _P],
}


@dataclass
class BuildInfo:
    path: Path
    seconds: float      # 0.0 when an already built library was reused
    ptxas_log: str      # nvcc -Xptxas -v output (registers, smem, spills)


_lock = threading.Lock()
_lib = None
build_info = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build() -> BuildInfo:
    """Compile every source, each in its own nvcc process and all at once,
    and link them, unless a library built from the same sources is
    already there."""
    sources = [CSRC_DIR / name for name in SOURCES]
    digest = hashlib.sha1()
    for src in (*sources, *(CSRC_DIR / name for name in HEADERS)):
        digest.update(src.read_bytes())
    out = BUILD_DIR / f"libsvt_kernels-{digest.hexdigest()[:16]}.so"
    if out.exists():
        return BuildInfo(out, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    flags = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]
    objects = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in sources]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([*flags, "-Xptxas", "-v", "-c", "-o", str(obj),
                               str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objects)]
    try:
        logs = [proc.communicate(timeout=NVCC_TIMEOUT_S)[0] for proc in procs]
        failed = [(src.name, proc.returncode, log) for src, proc, log
                  in zip(sources, procs, logs) if proc.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"{name} ({code}):\n{log}" for name, code, log in failed))
        link = subprocess.run([*flags, "-shared", "-o", str(tmp),
                               *map(str, objects)], capture_output=True,
                              text=True, timeout=NVCC_TIMEOUT_S)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stderr}")
        os.replace(tmp, out)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for path in (tmp, *objects):
            path.unlink(missing_ok=True)
    seconds = time.perf_counter() - t0
    return BuildInfo(out, seconds, "\n".join(log.strip() for log in logs))


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib, build_info
    with _lock:
        if _lib is None:
            info = build()
            lib = ctypes.CDLL(str(info.path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.svt_error_string.argtypes = [_I]
            lib.svt_error_string.restype = ctypes.c_char_p
            build_info, _lib = info, lib
    return _lib


def check(code: int, what: str) -> None:
    if code != 0:
        name = _lib.svt_error_string(code).decode()
        raise RuntimeError(f"{what} failed: CUDA error {code} ({name})")
