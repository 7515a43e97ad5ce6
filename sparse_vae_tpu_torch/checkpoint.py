"""Checkpoint interop: the archived `runs/<name>/ckpt_bf16.npz` params and
`runs/<name>/meta.json` hparams as a torch model (`load_run`), a model
built from hparams with the JAX package's initialisation and no archive
(`model_from_hparams`), and the reverse, a model written as such an
archive (`export_archive`, the layout of tools/archive_ckpt.py's export).
All four families: the Transformer-VAE (`transformer-vae` runs,
TransformerVAEHparams), the Transformer LM (`transformer-lm`,
TransformerHparams), the LSTM LM (`lstm-lm`, LSTMLanguageModelHparams)
and the LSTM-VAE (`lstm-vae`, LSTMVAEHparams); `model_class` picks the
module from the hparams.

Archive format (tools/archive_ckpt.py): one npz entry per flax param leaf,
keyed by its '/'-joined path (`layer_0/attention/q_linear/kernel`); float
leaves are stored as uint16 bf16 bit patterns under a `::bf16` key suffix.
A flax Dense `kernel` is [in, out], the transpose of nn.Linear.weight; a
LayerNorm `scale` and an Embed `embedding` are torch's `weight`; a learned
query bank `learned_queries` is a bare [1, n, D] parameter of the same
name. The Transformer LM's factorised input `embedding_projection`
and untied `output_embedding` are Dense leaves (kernels transposed), its
`context_embedding` an Embed. An RNN layer's `w_ih_{l}` / `w_hh_{l}` ([gates * H, in], already
torch's layout: not transposed), `b_ih_{l}` / `b_hh_{l}`, and the bare
`c0`, `encoder_c0` and `logit_bias` keep their names; a bidirectional
encoder's stacks are `encoder/dir_{d}/...`. A mixture-of-experts layer's
`layer_{i}/moe/router/kernel` is a Dense kernel (transposed), and its
expert stacks `moe/w_in` [E, D, H], `moe/b_in` [E, H] and `moe/w_out`
[E, H, D] keep their names and layout.

Weights are converted in memory at load time; `load_run` writes nothing.
"""
from __future__ import annotations

import json
import os
import re
from dataclasses import fields, replace
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from .models.base import compute_dtype, resolve_device
from .models.init import init_parameters
from .models.lstm_lm import LSTMLanguageModel, LSTMLanguageModelHparams
from .models.lstm_vae import LSTMVAE, LSTMVAEHparams
from .models.transformer_lm import (TransformerHparams,
                                    TransformerLanguageModel)
from .models.transformer_vae import TransformerVAE, TransformerVAEHparams
from .ops.rnn import use_step_loop

REPO_ROOT = Path(__file__).resolve().parent.parent
BF16_SUFFIX = "::bf16"

# Leaves of modules this port does not have yet: none; every leaf of the
# archived runs maps to a parameter.
UNPORTED_PREFIXES = ()

# The experiments this port loads: experiment -> (hparams class, module).
FAMILIES = {"transformer-vae": (TransformerVAEHparams, TransformerVAE),
            "transformer-lm": (TransformerHparams, TransformerLanguageModel),
            "lstm-lm": (LSTMLanguageModelHparams, LSTMLanguageModel),
            "lstm-vae": (LSTMVAEHparams, LSTMVAE)}


def model_class(hparams) -> type:
    """The module of `hparams` (FAMILIES): a TransformerVAE for
    TransformerVAEHparams, a TransformerLanguageModel for plain
    TransformerHparams, and the LSTM families' likewise."""
    for hp_cls, module in FAMILIES.values():
        if type(hparams) is hp_cls:
            return module
    raise TypeError(f"no ported model takes {type(hparams).__name__}")

_NUMBERED = {"layer": "decoder_layers", "z_projection": "z_projections",
             "middle": "middle_layers"}
_WEIGHT_KINDS = ((torch.nn.Linear, "kernel"), (torch.nn.LayerNorm, "scale"),
                 (torch.nn.Embedding, "embedding"))
_RNN_LEAF = re.compile(r"[wb]_(ih|hh)_\d+")
_LEAF_NAMES = {"kernel": "weight", "scale": "weight", "embedding": "weight",
               "bias": "bias", "learned_queries": "learned_queries",
               "w_in": "w_in", "b_in": "b_in", "w_out": "w_out"}


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
    if len(parts) == 1 or _RNN_LEAF.fullmatch(leaf):
        # A bare parameter such as output_bias or c0, or an RNN matrix or
        # bias, which is already in torch's layout.
        return ".".join(parts), False
    if leaf not in _LEAF_NAMES:
        raise KeyError(f"unknown leaf kind {leaf!r} in {path!r}")
    return ".".join(parts[:-1] + [_LEAF_NAMES[leaf]]), leaf == "kernel"


def params_from_numpy(flat: dict, hparams) -> dict:
    """Archive entries -> the state_dict of `hparams`' model
    (`model_class`) in fp32 tensors (`state_from_leaves` after decoding
    the bf16 bit patterns)."""
    return state_from_leaves(decode_leaves(flat), hparams)


def state_from_leaves(leaves: dict, hparams=None,
                      template: Optional[torch.nn.Module] = None) -> dict:
    """{flax leaf path: array} -> the state_dict of `hparams`' model
    (`model_class`), or of `template` (a module built without hparams,
    such as the generic models/transformer.py Transformer, whose
    `layer_i` are its `decoder_layers`), in fp32 tensors. JAX parameters
    as numpy arrays cross into the port here.

    Every leaf either maps to a parameter of the model `hparams` describe,
    with that parameter's shape, or lies under one of UNPORTED_PREFIXES;
    anything else raises, so no leaf is silently dropped, and a parameter
    no leaf gives raises too.
    """
    if template is None:
        with torch.device("meta"):
            template = model_class(hparams)(hparams)
    expected = {k: tuple(v.shape) for k, v in template.state_dict().items()}
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


def flax_path(model: torch.nn.Module, key: str) -> tuple:
    """The inverse of `torch_key`: a state_dict key of `model` to (flax
    leaf path, transpose?). The leaf's name follows its module's type: an
    nn.Linear weight is a `kernel` (transposed), a LayerNorm's a `scale`,
    an Embedding's an `embedding`."""
    *prefix, leaf = key.split(".")
    owner = model.get_submodule(".".join(prefix))
    kind = leaf
    if leaf == "weight":
        kinds = [name for cls, name in _WEIGHT_KINDS
                 if isinstance(owner, cls)]
        if not kinds:
            raise KeyError(f"no flax leaf kind for {key!r}")
        kind = kinds[0]
    parts, numbered = [], {v: k for k, v in _NUMBERED.items()}
    it = iter(prefix)
    for part in it:
        parts.append(f"{numbered[part]}_{next(it)}" if part in numbered
                     else part)
    return "/".join(parts + [kind]), kind == "kernel"


def export_archive(model: torch.nn.Module, meta: dict, out_dir,
                   step: int = 0, compress: bool = True) -> Path:
    """Write `model` as an archive `load_run(out_dir)` reads:
    ckpt_bf16.npz (each parameter under its flax leaf path with the
    `::bf16` suffix, its value rounded to bf16 (to nearest, ties to even)
    and stored as the uint16 bit pattern, Dense kernels transposed back to
    [in, out]; zip-compressed unless compress is False, which writes
    faster and reads the same), meta.json (`meta`) and ckpt_meta.json
    (experiment, name, step, each leaf's dtype, meta). Returns out_dir."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    arrays, dtypes = {}, {}
    with torch.no_grad():
        for key, value in model.state_dict().items():
            path, transpose = flax_path(model, key)
            value = value.detach().to(device="cpu", dtype=torch.bfloat16)
            value = value.T if transpose else value
            arrays[path + BF16_SUFFIX] = value.contiguous().view(
                torch.int16).numpy().view(np.uint16)
            dtypes[path] = "float32"
    save = np.savez_compressed if compress else np.savez
    save(out_dir / "ckpt_bf16.npz", **arrays)
    (out_dir / "meta.json").write_text(json.dumps(meta, indent=2) + "\n")
    (out_dir / "ckpt_meta.json").write_text(json.dumps(
        {"experiment": meta.get("experiment"), "name": meta.get("name"),
         "step": int(step), "dtypes": dtypes, "meta": meta},
        indent=2) + "\n")
    return out_dir


def run_directory(name) -> Path:
    """`name` itself when it is a path (absolute, or holding a separator),
    such as an archive `export_archive` wrote; else runs/<name>/ of the
    repo, whatever the working directory holds."""
    path = Path(name)
    if path.is_absolute() or "/" in str(name) or os.sep in str(name):
        return path
    return REPO_ROOT / "runs" / str(name)


def hparams_from_meta(meta: dict):
    """The run's model hparams (its experiment's class in FAMILIES),
    keeping the fields this port reads."""
    experiment = meta.get("experiment")
    if experiment not in FAMILIES:
        raise NotImplementedError(
            f"experiment {experiment!r} is not ported; "
            f"{' and '.join(sorted(FAMILIES))} are")
    hp_cls = FAMILIES[experiment][0]
    names = {f.name for f in fields(hp_cls)}
    model_hp = meta["model_hparams"]
    return hp_cls(**{k: v for k, v in model_hp.items() if k in names})


def load_run(name: str, device="cuda", dtype: Optional[torch.dtype] = None,
             train: bool = False, use_kernels: bool = True):
    """Load runs/<name>/ (meta.json + ckpt_bf16.npz), or the archive
    directory `name` (`run_directory`), into its model (`model_class`) on
    `device`. Returns (model, hparams, meta).

    Serving form (train=False): the whole model in `dtype`, default the
    run's compute dtype (bf16 for precision=bf16), in eval mode without
    grads. Training form (train=True): fp32 master parameters with grads,
    computing in `dtype` (default the run's compute dtype), as the JAX
    trainer keeps fp32 params under a bf16 compute dtype. use_kernels=False
    routes attention and the loss through the plain PyTorch versions
    (autograd) instead of the K1/K2 and K3/K3b Functions — the reference
    path a kernel run is held against; for the LSTM families, the RNN's
    step loop instead of the fused RNN (ops/rnn.py). An LSTM model's
    compute dtype is fp32.
    """
    device = resolve_device(device)
    run = run_directory(name)
    meta = json.loads((run / "meta.json").read_text())
    hp = _with_kernels(hparams_from_meta(meta), use_kernels)
    with np.load(run / "ckpt_bf16.npz") as npz:
        state = params_from_numpy({k: npz[k] for k in npz.files}, hp)
    model = model_class(hp)(hp)
    model.load_state_dict(state, strict=True)
    return _in_form(model, device, dtype, train, use_kernels), hp, meta


def _with_kernels(hparams, use_kernels: bool):
    """A copy of `hparams` whose use_pallas_kernel (a transformer's) is
    off unless use_kernels; the LSTM families have none."""
    if not hasattr(hparams, "use_pallas_kernel"):
        return replace(hparams)
    return replace(hparams, use_pallas_kernel=hparams.use_pallas_kernel
                   and use_kernels)


def model_from_hparams(hparams, generator: torch.Generator, device="cuda",
                       dtype: Optional[torch.dtype] = None,
                       train: bool = False, use_kernels: bool = True):
    """The model of `hparams` (`model_class`) with the JAX package's
    initialisation (models/init.py) drawn on the CPU from `generator` (a
    CPU generator), then moved to `device` in the serving or training form
    of `load_run`. Returns (model, hparams); the caller's hparams are not
    changed."""
    device = resolve_device(device)
    hp = _with_kernels(hparams, use_kernels)
    model = init_parameters(model_class(hp)(hp), generator, hp.init_scale)
    return _in_form(model, device, dtype, train, use_kernels), hp


def serving_form(model: torch.nn.Module) -> torch.nn.Module:
    """A copy of `model` (say, a training form) in the serving form of
    `load_run`: every parameter rounded to its hparams' compute dtype,
    eval mode, no grads."""
    import copy
    served = copy.deepcopy(model)
    served.compute_dtype = None
    return _in_form(served, model.device, None, train=False)


def _in_form(model: torch.nn.Module, device, dtype, train: bool,
             use_kernels: Optional[bool] = None):
    """Serving form (train=False): the whole model in `dtype`, default its
    hparams' compute dtype (fp32 where they have no precision, as the LSTM
    families), in eval mode without grads. Training form: fp32 master
    parameters with grads, computing in `dtype`. use_kernels (unless
    None) puts an LSTM model's RNNs on the fused RNN or, False, on their
    step loop."""
    if use_kernels is not None:
        use_step_loop(model, not use_kernels)
    dtype = dtype or compute_dtype(getattr(model.hparams, "precision",
                                           "fp32"))
    if train:
        model = model.to(device=device, dtype=torch.float32)
        model.compute_dtype = dtype
        return model.train().requires_grad_(True)
    model = model.to(device=device, dtype=dtype)
    return model.eval().requires_grad_(False)


def load_draft(spec: str, draft_k: int, device="cuda"):
    """The draft of draft-model speculative decoding, `spec` =
    "<experiment>:<run>" (`load_run`'s run, its serving form) of a
    language model: returns (draft_propose(state, last, noise),
    fresh_state(length)). A transformer's state is its (caches, index)
    sized for length + draft_k + 2 positions, the chunk's over-proposal
    included, and is written in place: take a fresh one for every
    document. An LSTM's is its `initial_rnn_state(1)`."""
    experiment, name = spec.split(":", 1)
    model, _, meta = load_run(name, device=device)
    if meta.get("experiment") != experiment:
        raise SystemExit(f"draft run {name!r} is a "
                         f"{meta.get('experiment')!r} run, not "
                         f"{experiment!r}")
    if not hasattr(model, "draft_propose"):
        raise SystemExit(f"a {experiment!r} model cannot draft: drafts "
                         "are language models (transformer-lm, lstm-lm)")

    def propose(state, last, noise):
        return model.draft_propose(state, last, noise, draft_k)

    def fresh_state(length: int):
        if hasattr(model, "initial_rnn_state"):
            return model.initial_rnn_state(1)
        return model.draft_init_state(1, length + draft_k + 2)
    return propose, fresh_state
