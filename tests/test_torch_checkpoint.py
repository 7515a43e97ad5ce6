"""Port checkpoint interop (sparse_vae_tpu_torch/checkpoint.py): every leaf
of the archived flagship run is accounted for, the decoded values equal the
JAX package's own decoding, and the port imports nothing of JAX.

Also home of the shared r5 loaders the other test_torch_* files use.
"""
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_vae_tpu_torch import checkpoint as ckpt
from sparse_vae_tpu_torch.models.transformer_vae import TransformerVAE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R5 = os.path.join(REPO, "runs", "real-prose-vae-r5")


@functools.lru_cache(maxsize=None)
def r5_archive():
    with np.load(os.path.join(R5, "ckpt_bf16.npz")) as npz:
        return {k: npz[k] for k in npz.files}


def r5_meta():
    with open(os.path.join(R5, "meta.json")) as fh:
        return json.load(fh)


def jax_params_from_archive(flat):
    """The JAX package's decoding (tools/archive_ckpt.py restore): bf16
    bits viewed as jnp.bfloat16, cast to fp32, nested by path."""
    params = {}
    for key, arr in flat.items():
        base = key[:-len(ckpt.BF16_SUFFIX)]
        value = jnp.asarray(arr).view(jnp.bfloat16).astype(jnp.float32)
        node = params
        parts = base.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return params


def jax_r5(precision: str = "fp32"):
    """(module, params) of the JAX flagship r5 model computing in
    `precision` ("fp32" or "bf16"; the params are fp32 either way)."""
    from sparse_vae_tpu import build_model
    hp = dict(r5_meta()["model_hparams"])
    hp.update(precision=precision, grad_checkpointing=False)
    module, _, _ = build_model("transformer-vae", hp)
    return module, jax_params_from_archive(r5_archive())


def torch_r5():
    model, _, _ = ckpt.load_run("real-prose-vae-r5", device="cpu",
                                dtype=torch.float32)
    return model


def test_every_r5_leaf_is_accounted_for():
    """All 165 leaves map to a parameter, the encoder's and the
    posterior's included: none is skipped."""
    flat = r5_archive()
    assert len(flat) == 165
    assert ckpt.UNPORTED_PREFIXES == ()
    hp = ckpt.hparams_from_meta(r5_meta())
    expected = set(TransformerVAE(hp).state_dict())
    mapped = {ckpt.torch_key(key[:-len(ckpt.BF16_SUFFIX)])[0]
              for key in flat}
    assert mapped == expected
    assert len(mapped) == 165
    assert {k.split(".")[0] for k in mapped} >= {"encoder",
                                                 "q_of_z_given_x"}


def test_encoder_leaf_names_map():
    assert ckpt.torch_key("encoder/first_layer/attention/learned_queries") \
        == ("encoder.first_layer.attention.learned_queries", False)
    assert ckpt.torch_key("encoder/middle_0/cross_attention/q_linear/kernel") \
        == ("encoder.middle_layers.0.cross_attention.q_linear.weight", True)
    assert ckpt.torch_key("q_of_z_given_x/linear/bias") \
        == ("q_of_z_given_x.linear.bias", False)


def test_training_and_serving_forms():
    """train=True: fp32 master parameters with grads, computing in the
    run's bf16; the serving form stays bf16 without grads."""
    model, hp, _ = ckpt.load_run("real-prose-vae-r5", device="cpu",
                                 train=True)
    params = list(model.parameters())
    assert len(params) == 165
    assert all(p.dtype == torch.float32 and p.requires_grad for p in params)
    assert model.dtype == torch.bfloat16
    assert model.embed(torch.ones((1, 4), dtype=torch.long)).dtype \
        == torch.bfloat16
    serve, _, _ = ckpt.load_run("real-prose-vae-r5", device="cpu")
    assert all(p.dtype == torch.bfloat16 and not p.requires_grad
               for p in serve.parameters())
    assert serve.dtype == torch.bfloat16
    plain, _, _ = ckpt.load_run("real-prose-vae-r5", device="cpu",
                                train=True, use_kernels=False)
    assert not plain.hparams.use_pallas_kernel
    assert hp.use_pallas_kernel


def test_decoded_values_match_jax_decoding():
    flat = r5_archive()
    state = ckpt.params_from_numpy(flat, ckpt.hparams_from_meta(r5_meta()))
    ref = jax_params_from_archive(flat)
    pairs = {
        "layer_3/attention/q_linear/kernel":
            ("decoder_layers.3.attention.q_linear.weight", True),
        "layer_0/ffn_out/kernel": ("decoder_layers.0.ffn_out.weight", True),
        "layer_5/ffn_layer_norm/scale":
            ("decoder_layers.5.ffn_layer_norm.weight", False),
        "input_embedding/embedding": ("input_embedding.weight", False),
        "z_projection_2/bias": ("z_projections.2.bias", False),
        "output_bias": ("output_bias", False),
        "head_dense/kernel": ("head_dense.weight", True),
    }
    for path, (key, transposed) in pairs.items():
        node = ref
        for p in path.split("/"):
            node = node[p]
        want = np.asarray(node)
        got = state[key].numpy()
        np.testing.assert_array_equal(got.T if transposed else got, want,
                                      err_msg=path)


def test_round_trip_reproduces_jax_values():
    """Every ported parameter of the loaded model equals the JAX value
    bit for bit (bf16 -> fp32 is exact)."""
    model = torch_r5()
    ref = jax_params_from_archive(r5_archive())
    sd = model.state_dict()
    for key in r5_archive():
        path = key[:-len(ckpt.BF16_SUFFIX)]
        if path.startswith(ckpt.UNPORTED_PREFIXES):
            continue
        tkey, transposed = ckpt.torch_key(path)
        node = ref
        for p in path.split("/"):
            node = node[p]
        got = sd[tkey].numpy()
        np.testing.assert_array_equal(got.T if transposed else got,
                                      np.asarray(node), err_msg=path)


def test_unknown_leaf_raises():
    hp = ckpt.hparams_from_meta(r5_meta())
    flat = dict(r5_archive())
    for extra in ("decoder_extra/kernel::bf16",
                  "layer_6/ffn_out/kernel::bf16"):
        with pytest.raises(KeyError, match="no parameter"):
            ckpt.params_from_numpy(
                {**flat, extra: np.zeros((2, 2), np.uint16)}, hp)
    flat.pop("layer_2/ffn_in/bias::bf16")
    with pytest.raises(KeyError, match="no value"):
        ckpt.params_from_numpy(flat, hp)


def test_unported_experiment_raises():
    """Every family of the JAX package is ported (the LSTM families
    since the LSTM slice); an experiment of none of them raises."""
    meta = r5_meta()
    meta["experiment"] = "gpt"
    with pytest.raises(NotImplementedError, match="not ported"):
        ckpt.hparams_from_meta(meta)
    assert set(ckpt.FAMILIES) == {"transformer-vae", "transformer-lm",
                                  "lstm-lm", "lstm-vae"}


def test_entry_point_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present; this checks the no-card refusal")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ckpt.load_run("real-prose-vae-r5")


def test_package_imports_nothing_of_jax():
    """Import every module of the port, and chip_smoke.py, with jax, flax,
    the JAX package and tools blocked, and the tokenizer library too (the
    data modules import it inside the functions that train or load a
    tokenizer only), and check that the corpus pipeline, the trainer and
    the CLI, the evaluation entry and its estimators, the language-model
    objective and the LM's entry points (train, test, serve,
    profile_train), the mixture-of-experts FFN and the latent tooling's
    entries are among the modules imported."""
    code = r"""
import importlib, pkgutil, sys
for name in ("jax", "jaxlib", "flax", "optax", "orbax", "sparse_vae_tpu",
             "tools", "tokenizers", "datasets"):
    sys.modules[name] = None
import sparse_vae_tpu_torch
names = [m.name for m in pkgutil.walk_packages(
    sparse_vae_tpu_torch.__path__, "sparse_vae_tpu_torch.")]
for name in names:
    importlib.import_module(name)
for name in ("data.batching", "data.datasets", "data.local_corpus",
             "data.native", "data.text_data_module", "data.tokenizer",
             "utils.config", "utils.metrics", "hparam_presets", "cli",
             "training.checkpointing", "training.trainer", "train",
             "test", "utils.math_utils", "models.vae",
             "training.objectives", "models.transformer_lm", "serve",
             "server", "serving", "profile_train", "models.moe",
             "gather_latents", "knn", "tsne", "reconstruct", "vae_console"):
    assert "sparse_vae_tpu_torch." + name in names, name
import chip_smoke
bad = [m for m in sys.modules
       if m.split(".")[0] in ("jax", "jaxlib", "flax", "sparse_vae_tpu",
                              "tools") and sys.modules[m] is not None]
assert not bad, bad
print(len(names))
"""
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 43
