"""The rest of the JAX package's library surface in the port, on the CPU.

- The package's public names: every name of sparse_vae_tpu/__init__.py
  resolves to the port's counterpart or is listed, with its reason, in
  `NO_COUNTERPART` and README.md; `build_model` gives JAX's hparams for
  the four families, with and without overrides, and JAX's error for an
  unknown name; `cast_float_params`; importing the package in a fresh
  interpreter loads no torch.
- The generic `Transformer` (models/transformer.py) against JAX's, on
  logits from JAX's initialisation carried across (`state_from_leaves`
  with a template): sparse (the K1 Function's plain version) and dense
  causal (the dense route's), with and without a key mask, at real
  positions, within 2e-5 of the largest |logit|.
- The Transformer LM's options against JAX: a factorised input embedding
  (d_embedding 16 beside d_model 32), an untied output embedding, and
  cross-attention to a context with a separate or a shared context
  embedding: logits within 2e-5 of the largest |logit|, the loss within
  2e-5 relative and every gradient within 2e-3 of its tensor's largest
  entry (+1e-7); the ValueError for a context without cross_attention;
  each new leaf through `export_archive` and `load_run` (bf16 rounding).
- utils/profiling.py: a trace with an annotated span written as a Chrome
  trace.

Worker time: about 30 s.
"""
import json
import subprocess
import sys
from dataclasses import asdict
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core import unfreeze
from flax.traverse_util import flatten_dict

import sparse_vae_tpu as jpkg
import sparse_vae_tpu_torch as tpkg
from sparse_vae_tpu.models.transformer import Transformer as JTransformer
from sparse_vae_tpu_torch import checkpoint as ckpt
from sparse_vae_tpu_torch.models.transformer import Transformer
from sparse_vae_tpu_torch.models.transformer_lm import (
    TransformerHparams, TransformerLanguageModel)
from sparse_vae_tpu_torch.utils import profiling

REPO = Path(__file__).resolve().parent.parent
LOGIT_REL = 2e-5
LOSS_RTOL = 2e-5
GRAD_REL, GRAD_ATOL = 2e-3, 1e-7


def _leaves(tree) -> dict:
    return {"/".join(k): np.array(v)
            for k, v in flatten_dict(unfreeze(tree)).items()}


# -- the package's public surface ------------------------------------------------
def _jax_public() -> list:
    return [n for n in vars(jpkg) if not n.startswith("_")
            and not isinstance(vars(jpkg)[n], type(jpkg))]


def test_every_public_name_resolves_or_is_listed():
    readme = (REPO / "README.md").read_text()
    names = _jax_public()
    assert "build_model" in names and "Transformer" in names
    for name in names:
        if name in tpkg.NO_COUNTERPART:
            assert f"`{name}`" in readme, name
            continue
        value = getattr(tpkg, name)
        mod = getattr(value, "__module__", None) or ""
        assert not mod.startswith("sparse_vae_tpu."), (name, mod)
    assert tpkg.Transformer is Transformer
    assert set(tpkg.MODEL_REGISTRY) == set(jpkg.MODEL_REGISTRY)
    for experiment, entry in tpkg.MODEL_REGISTRY.items():
        assert tuple(c.__name__ for c in entry) == tuple(
            c.__name__ for c in jpkg.MODEL_REGISTRY[experiment])


@pytest.mark.parametrize("experiment", ["lstm-lm", "lstm-vae",
                                        "transformer-lm", "transformer-vae"])
def test_build_model_gives_jax_hparams(experiment):
    over = ({"d_model": 64, "num_layers": 1, "vocab_size": 128}
            if experiment.startswith("transformer") else
            {"d_model": 32, "vocab_size": 128})
    for overrides in (None, over):
        if overrides is None and experiment.startswith("lstm"):
            continue   # full-size LSTMs: only the small build here
        _, jhp, jobj = jpkg.build_model(experiment, overrides)
        module, hp, obj = tpkg.build_model(experiment, overrides,
                                           device="cpu")
        port = asdict(hp)
        assert port == {k: v for k, v in asdict(jhp).items() if k in port}
        assert set(asdict(jhp)) - set(port) <= {"dtype"}
        assert type(module) is tpkg.MODEL_REGISTRY[experiment][0]
        assert type(obj).__name__ == type(jobj).__name__
        assert next(module.parameters()).device.type == "cpu"


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present")
def test_build_model_runs_on_the_card_unless_asked():
    """build_model's module is on CUDA by default: without a card it
    raises instead of building on the CPU."""
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tpkg.build_model("transformer-lm", {"d_model": 64, "num_layers": 1,
                                            "vocab_size": 128})


def test_build_model_refuses_an_unknown_name_as_jax_does():
    with pytest.raises(ValueError) as jax_error:
        jpkg.build_model("gpt")
    with pytest.raises(ValueError) as port_error:
        tpkg.build_model("gpt")
    assert str(port_error.value) == str(jax_error.value)


def test_cast_float_params():
    state = {"w": torch.ones(2, 3), "step": torch.tensor(4),
             "h": torch.ones(2, dtype=torch.float16)}
    for same in ("fp32", "float32", "", None):
        assert tpkg.cast_float_params(state, same) is state
    cast = tpkg.cast_float_params(state, "bf16")
    assert cast["w"].dtype == cast["h"].dtype == torch.bfloat16
    assert cast["step"].dtype == torch.int64 and torch.equal(
        cast["w"].float(), state["w"])
    assert state["w"].dtype == torch.float32
    assert tpkg.cast_float_params(state, "bfloat16")["w"].dtype == \
        torch.bfloat16
    with pytest.raises(ValueError, match="fp32 or bf16, got 'fp16'"):
        tpkg.cast_float_params(state, "fp16")


def test_importing_the_package_loads_no_torch():
    code = ("import sys, sparse_vae_tpu_torch as p; "
            "assert 'torch' not in sys.modules, 'eager'; "
            "p.CLS_ID; assert 'torch' not in sys.modules, 'CLS_ID'; "
            "p.Transformer; assert 'torch' in sys.modules")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                   timeout=120)


# -- the generic Transformer --------------------------------------------------------
def _transformer_case(sparse: bool, masked: bool):
    width = 256 if sparse else 512
    lengths = [width, width - 70]
    rng = np.random.default_rng(7)
    ids = rng.integers(3, 64, size=(2, width))
    mask = np.arange(width)[None, :] < np.array(lengths)[:, None]
    kw = dict(vocab_size=64, d_model=128, num_heads=2, num_layers=2,
              causal=True, sparse_self_attention=sparse, window_size=2,
              block_size=128)
    return kw, ids, mask if masked else None


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("sparse", [True, False])
def test_generic_transformer_matches_jax(sparse, masked):
    kw, ids, mask = _transformer_case(sparse, masked)
    jmodel = JTransformer(**kw)
    jids = jnp.asarray(ids, jnp.int32)
    params = jmodel.init(jax.random.PRNGKey(0), jids[:1])["params"]
    jmask = None if mask is None else jnp.asarray(mask)
    want = np.asarray(jmodel.apply({"params": params}, jids, jmask))
    model = Transformer(**kw)
    leaves = _leaves(params)
    model.load_state_dict(ckpt.state_from_leaves(leaves, template=model))
    # ... and back: every parameter names its JAX leaf (export_archive's).
    assert {ckpt.flax_path(model, k)[0] for k in model.state_dict()} == \
        set(leaves)
    with torch.no_grad():
        got = model(torch.from_numpy(ids),
                    None if mask is None else torch.from_numpy(mask))
    real = np.ones(ids.shape, bool) if mask is None else mask
    err = np.abs(got.numpy() - want)[real].max()
    assert err <= LOGIT_REL * np.abs(want).max(), err


# -- the Transformer LM's options -----------------------------------------------------
OPTIONS = {
    "factorised": dict(d_embedding=16),
    "untied": dict(tie_embedding_weights=False),
    "cross_separate": dict(cross_attention=True),
    "cross_shared": dict(cross_attention=True,
                         separate_context_embedding=False),
}
BASE = dict(vocab_size=64, d_model=32, num_heads=2, num_layers=2,
            sparse_self_attention=True, attn_window_size=2,
            attn_block_size=8, loss_chunk_size=16, precision="fp32")


def _lm_case(option: str):
    cfg = {**BASE, **OPTIONS[option]}
    module, _, _ = jpkg.build_model("transformer-lm", cfg)
    rng = np.random.default_rng(3)
    ids = rng.integers(3, 64, size=(2, 32))
    ids[1, 21:] = 0
    ctx = None
    if cfg.get("cross_attention"):
        ctx = rng.integers(3, 64, size=(2, 5))
        ctx[0, 3:] = 0
    # flax makes the cross-attention's leaves only when a context is given.
    params = module.init(
        jax.random.PRNGKey(1), jnp.asarray(ids[:1], jnp.int32), True,
        None if ctx is None else jnp.asarray(ctx[:1], jnp.int32))["params"]
    hp = TransformerHparams(**cfg)
    model = TransformerLanguageModel(hp)
    model.load_state_dict(ckpt.state_from_leaves(_leaves(params), hp),
                          strict=True)
    return module, params, model, cfg, ids, ctx


@pytest.mark.parametrize("option", list(OPTIONS))
def test_lm_option_matches_jax(option):
    module, params, model, cfg, ids, ctx = _lm_case(option)
    cls = type(module)
    jids = jnp.asarray(ids, jnp.int32)
    jctx = None if ctx is None else jnp.asarray(ctx, jnp.int32)
    labels = np.pad(ids[:, 1:], ((0, 0), (0, 1)))
    real = labels != 0

    def loss_fn(p):
        logits = module.apply({"params": p}, jids, True, jctx)
        logp = jax.nn.log_softmax(logits.astype(jnp.float32), -1)
        picked = jnp.take_along_axis(logp, jnp.asarray(labels)[..., None],
                                     -1)[..., 0]
        return -jnp.sum(picked * real) / real.sum(), logits

    (j_loss, j_logits), j_grads = jax.value_and_grad(
        loss_fn, has_aux=True)(params)
    logits = model(torch.from_numpy(ids),
                   context_ids=None if ctx is None else torch.from_numpy(ctx))
    logp = torch.log_softmax(logits.float(), -1)
    picked = logp.gather(-1, torch.from_numpy(labels)[..., None])[..., 0]
    loss = -(picked * torch.from_numpy(real)).sum() / real.sum()
    loss.backward()
    want = np.asarray(j_logits)
    assert np.abs(logits.detach().numpy() - want).max() <= \
        LOGIT_REL * np.abs(want).max()
    np.testing.assert_allclose(loss.item(), float(j_loss), rtol=LOSS_RTOL)
    named = dict(model.named_parameters())
    grads = _leaves(j_grads)
    assert len(grads) == len(named)
    for path, w in grads.items():
        key, transpose = ckpt.torch_key(path)
        g = named[key].grad.numpy()
        g = g.T if transpose else g
        assert np.abs(g - w).max() <= GRAD_REL * np.abs(w).max() + \
            GRAD_ATOL, path
    # The chunked loss: the untied head routes outside the fused tied CE.
    hidden = model.forward_hidden(
        torch.from_numpy(ids),
        context_ids=None if ctx is None else torch.from_numpy(ctx))
    nll, count = model.sequence_nll(hidden, model.labels_for(
        torch.from_numpy(ids)))
    j_nll, j_count = module.apply(
        {"params": params},
        module.apply({"params": params}, jids, context_ids=jctx,
                     method=cls.forward_hidden),
        cls.shifted_labels(jids), method=cls.sequence_nll)
    np.testing.assert_allclose(nll.item(), float(j_nll), rtol=LOSS_RTOL)
    assert count.item() == float(j_count)


def test_lm_option_leaves_and_context_errors():
    _, params, model, _, ids, _ = _lm_case("cross_separate")
    assert {"context_embedding/embedding"} <= set(_leaves(params))
    plain = TransformerLanguageModel(TransformerHparams(**BASE))
    with pytest.raises(ValueError, match="context requires "
                       "cross_attention=True"):
        plain.forward_hidden(torch.from_numpy(ids),
                             context_ids=torch.from_numpy(ids[:, :4]))
    assert not hasattr(plain, "output_embedding")
    assert plain.embedding_projection is None \
        and plain.context_embedding is None
    shared = _lm_case("cross_shared")[2]
    assert shared.context_embedding is None
    untied = _lm_case("untied")[2]
    assert not hasattr(untied, "output_bias")
    assert torch.equal(untied.table(), untied.output_embedding.weight)


@pytest.mark.parametrize("option", ["factorised", "untied",
                                    "cross_separate"])
def test_lm_option_leaves_round_trip_through_an_archive(tmp_path, option):
    _, params, model, cfg, _, _ = _lm_case(option)
    meta = {"experiment": "transformer-lm", "name": option,
            "model_hparams": cfg}
    ckpt.export_archive(model, meta, tmp_path / option)
    loaded, hp, _ = ckpt.load_run(str(tmp_path / option), device="cpu",
                                  dtype=torch.float32)
    assert json.loads((tmp_path / option / "meta.json").read_text()) == meta
    new = {"factorised": "embedding_projection.",
           "untied": "output_embedding.",
           "cross_separate": "context_embedding."}[option]
    state = loaded.state_dict()
    keys = [k for k in model.state_dict() if k.startswith(new)]
    assert keys
    for key, value in model.state_dict().items():
        assert torch.equal(state[key], value.to(torch.bfloat16).float()), key


# -- utils/profiling.py ----------------------------------------------------------------
def test_trace_writes_a_chrome_trace_with_the_annotated_span(tmp_path):
    @profiling.annotate_fn("double")
    def double(x):
        return x * 2

    with profiling.trace(tmp_path, device=torch.device("cpu")):
        with profiling.annotate("outer"):
            double(torch.ones(4))
    with profiling.trace(tmp_path / "off", enabled=False):
        double(torch.ones(2))
    traces = list(tmp_path.glob("trace_*.json"))
    assert len(traces) == 1 and not (tmp_path / "off").exists()
    names = {e.get("name") for e in json.loads(traces[0].read_text())[
        "traceEvents"]}
    assert {"outer", "double"} <= names
