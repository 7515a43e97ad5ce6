"""The ctypes signatures of the port's kernel library against the C
sources: every `extern "C" int svt_*` function of
sparse_vae_tpu_torch/csrc/*.cu must have an entry in
ops/cuda_lib._SIGNATURES with the same number and order of pointer, int
and float arguments. ctypes trusts these lists, so a mismatch would show
only as a crash or a wrong launch on the card; the sources are parsed here
on the CPU.
"""
import ctypes
import re

import pytest

from sparse_vae_tpu_torch.ops import cuda_lib

PROTOTYPE = re.compile(r'extern\s+"C"\s+int\s+(svt_\w+)\s*\(([^)]*)\)')


def _kind(param: str) -> str:
    """A C parameter as the ctypes kind that binds it."""
    decl = " ".join(param.split())
    if "*" in decl:
        return "pointer"
    ctype = decl.rsplit(" ", 1)[0].replace("const ", "")
    return {"int": "int", "float": "float"}[ctype]


def _prototypes() -> dict:
    found = {}
    for name in cuda_lib.SOURCES:
        text = (cuda_lib.CSRC_DIR / name).read_text()
        for fn, params in PROTOTYPE.findall(text):
            found[fn] = [_kind(p) for p in params.split(",")]
    return found


CTYPES_KIND = {ctypes.c_void_p: "pointer", ctypes.c_int: "int",
               ctypes.c_float: "float"}


@pytest.mark.parametrize("name", sorted(cuda_lib._SIGNATURES))
def test_signature_matches_the_c_prototype(name):
    prototypes = _prototypes()
    assert name in prototypes, f"{name} is not exported by any source"
    want = prototypes[name]
    got = [CTYPES_KIND[t] for t in cuda_lib._SIGNATURES[name]]
    assert got == want, f"{name}: ctypes {got}, C {want}"


def test_every_exported_function_has_a_signature():
    exported = set(_prototypes())
    assert exported and exported == set(cuda_lib._SIGNATURES)
