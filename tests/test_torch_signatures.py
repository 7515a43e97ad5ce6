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


@pytest.mark.parametrize("name", ["svt_tied_ce_fwd", "svt_tied_ce_bwd_dl",
                                  "svt_tied_ce_bwd_dg", "svt_tied_ce_bwd_de"])
def test_tied_ce_entries_take_the_model_width(name):
    """K3/K3b's entries take the model width as their `int dim` argument
    and dispatch it to the D = 256 and D = 512 instantiations
    (ce_kernel.D_MODELS)."""
    from sparse_vae_tpu_torch.ops import ce_kernel
    texts = {src: (cuda_lib.CSRC_DIR / src).read_text()
             for src in ("tied_ce.cu", "tied_ce_bwd.cu")}
    for src, text in texts.items():
        match = {fn: params for fn, params in PROTOTYPE.findall(text)}
        if name in match:
            params = [" ".join(p.split()) for p in match[name].split(",")]
            assert "int dim" in params
            for width in ce_kernel.D_MODELS:
                assert f"<{width}>" in text and f"dim == {width}" in \
                    text.replace("dim != ", "dim == ")
            return
    raise AssertionError(f"{name} not found")


def test_every_exported_function_has_a_signature():
    exported = set(_prototypes())
    assert exported and exported == set(cuda_lib._SIGNATURES)
