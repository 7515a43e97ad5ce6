"""Checkpoint interop: the archived `runs/<name>/ckpt_bf16.npz` params and
`runs/<name>/meta.json` hparams as a torch model (`load_run`), and a model
built from hparams with the JAX package's initialisation and no archive
(`model_from_hparams`).

Archive format (tools/archive_ckpt.py): one npz entry per flax param leaf,
keyed by its '/'-joined path (`layer_0/attention/q_linear/kernel`); float
leaves are stored as uint16 bf16 bit patterns under a `::bf16` key suffix.
A flax Dense `kernel` is [in, out], the transpose of nn.Linear.weight; a
LayerNorm `scale` and an Embed `embedding` are torch's `weight`; a learned
query bank `learned_queries` is a bare [1, n, D] parameter of the same
name.

Weights are converted in memory at load time; nothing converted is written.
"""
from __future__ import annotations

import json
import re
from dataclasses import fields, replace
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .models.base import compute_dtype, resolve_device
from .models.init import init_parameters
from .models.transformer_vae import TransformerVAE, TransformerVAEHparams

REPO_ROOT = Path(__file__).resolve().parent.parent
BF16_SUFFIX = "::bf16"

# Leaves of modules this port does not have yet: none; every leaf of the
# flagship run maps to a parameter.
UNPORTED_PREFIXES = ()

_NUMBERED = {"layer": "decoder_layers", "z_projection": "z_projections",
             "middle": "middle_layers"}
_LEAF_NAMES = {"kernel": "weight", "scale": "weight", "embedding": "weight",
               "bias": "bias", "learned_queries": "learned_queries"}


def decode_leaves(flat: dict) -> dict:
    """{archive key: array} -> {leaf path: fp32 array}, decoding the
    `::bf16` bit patterns (a bf16 is the top half of an fp32)."""
    out = {}
    for key, arr in flat.items():
        arr = np.asarray(arr)
        if key.endswith(BF16_SUFFIX):
            bits = arr.astype(np.uint32) << 16
            out[key[:-len(BF16_SUFFIX)]] = bits.view(np.float32)
        else:
            out[key] = arr
    return out


def torch_key(path: str) -> tuple:
    """Map a flax leaf path to (state_dict key, transpose?)."""
    parts = []
    for part in path.split("/"):
        numbered = re.fullmatch(r"(layer|z_projection|middle)_(\d+)", part)
        parts += ([_NUMBERED[numbered.group(1)], numbered.group(2)]
                  if numbered else [part])
    leaf = parts[-1]
    if len(parts) == 1:          # a bare parameter such as output_bias
        return leaf, False
    if leaf not in _LEAF_NAMES:
        raise KeyError(f"unknown leaf kind {leaf!r} in {path!r}")
    return ".".join(parts[:-1] + [_LEAF_NAMES[leaf]]), leaf == "kernel"


def params_from_numpy(flat: dict, hparams: TransformerVAEHparams) -> dict:
    """Archive entries -> a TransformerVAE state_dict of fp32 tensors
    (`state_from_leaves` after decoding the bf16 bit patterns)."""
    return state_from_leaves(decode_leaves(flat), hparams)


def state_from_leaves(leaves: dict, hparams: TransformerVAEHparams) -> dict:
    """{flax leaf path: array} -> a TransformerVAE state_dict of fp32
    tensors.

    Every leaf either maps to a parameter of the model `hparams` describe,
    with that parameter's shape, or lies under one of UNPORTED_PREFIXES;
    anything else raises, so no leaf is silently dropped, and a parameter
    no leaf gives raises too.
    """
    with torch.device("meta"):
        expected = {k: tuple(v.shape)
                    for k, v in TransformerVAE(hparams).state_dict().items()}
    state = {}
    for path, arr in leaves.items():
        if path.startswith(UNPORTED_PREFIXES):
            continue
        key, transpose = torch_key(path)
        if key not in expected:
            raise KeyError(f"archive leaf {path!r} maps to {key!r}, which "
                           "the model has no parameter for")
        arr = np.ascontiguousarray(
            np.asarray(arr).T if transpose else np.asarray(arr))
        if arr.shape != expected[key]:
            raise ValueError(f"{path!r}: archive shape {arr.shape}, model "
                             f"shape {expected[key]}")
        state[key] = torch.from_numpy(arr).to(torch.float32)
    missing = sorted(set(expected) - set(state))
    if missing:
        raise KeyError(f"archive gives no value for {missing}")
    return state


def hparams_from_meta(meta: dict) -> TransformerVAEHparams:
    """The run's model hparams, keeping the fields this port reads."""
    if meta.get("experiment") != "transformer-vae":
        raise NotImplementedError(
            f"experiment {meta.get('experiment')!r} is not ported; only "
            "transformer-vae is")
    names = {f.name for f in fields(TransformerVAEHparams)}
    model_hp = meta["model_hparams"]
    return TransformerVAEHparams(
        **{k: v for k, v in model_hp.items() if k in names})


def load_run(name: str, device="cuda", dtype: Optional[torch.dtype] = None,
             train: bool = False, use_kernels: bool = True):
    """Load runs/<name>/ (meta.json + ckpt_bf16.npz) into a TransformerVAE
    on `device`. Returns (model, hparams, meta).

    Serving form (train=False): the whole model in `dtype`, default the
    run's compute dtype (bf16 for precision=bf16), in eval mode without
    grads. Training form (train=True): fp32 master parameters with grads,
    computing in `dtype` (default the run's compute dtype), as the JAX
    trainer keeps fp32 params under a bf16 compute dtype. use_kernels=False
    routes attention and the loss through the plain PyTorch versions
    (autograd) instead of the K1/K2 and K3/K3b Functions — the reference
    path a kernel run is held against.
    """
    device = resolve_device(device)
    run = REPO_ROOT / "runs" / name
    meta = json.loads((run / "meta.json").read_text())
    hp = hparams_from_meta(meta)
    hp.use_pallas_kernel = hp.use_pallas_kernel and use_kernels
    with np.load(run / "ckpt_bf16.npz") as npz:
        state = params_from_numpy({k: npz[k] for k in npz.files}, hp)
    model = TransformerVAE(hp)
    model.load_state_dict(state, strict=True)
    return _in_form(model, device, dtype, train), hp, meta


def model_from_hparams(hparams: TransformerVAEHparams,
                       generator: torch.Generator, device="cuda",
                       dtype: Optional[torch.dtype] = None,
                       train: bool = False, use_kernels: bool = True):
    """A TransformerVAE of `hparams` with the JAX package's initialisation
    (models/init.py) drawn on the CPU from `generator` (a CPU generator),
    then moved to `device` in the serving or training form of `load_run`.
    Returns (model, hparams); the caller's hparams are not changed."""
    device = resolve_device(device)
    hp = replace(hparams,
                 use_pallas_kernel=hparams.use_pallas_kernel and use_kernels)
    model = init_parameters(TransformerVAE(hp), generator, hp.init_scale)
    return _in_form(model, device, dtype, train), hp


def _in_form(model: TransformerVAE, device, dtype, train: bool):
    """Serving form (train=False): the whole model in `dtype`, default its
    hparams' compute dtype, in eval mode without grads. Training form: fp32
    master parameters with grads, computing in `dtype`."""
    dtype = dtype or compute_dtype(model.hparams.precision)
    if train:
        model = model.to(device=device, dtype=torch.float32)
        model.compute_dtype = dtype
        return model.train().requires_grad_(True)
    model = model.to(device=device, dtype=dtype)
    return model.eval().requires_grad_(False)
