"""Rematerialisation (sparse_vae_tpu_torch/models/remat.py, the decoder
layers under grad_checkpointing) on the CPU.

- Remat against no remat in the port, bit for bit, for no remat and each
  of the five policies: the Transformer LM with its input and FFN dropout
  on (masks from the step's generator), the Transformer-VAE's objective,
  and an MoE LM's forward with its balance statistics. The loss, every
  gradient and the generator's state after the step are identical; the
  MoE statistics are appended once a layer, not again in the recompute.
- What each policy recomputes: the attention forward (K1's plain version
  inside its Function) runs once a layer in the forward, and once more a
  layer in the backward under full, dots and offload, never under
  dots_attn and dots_attn_qkv, which keep its (out, lse); the products
  (`F.linear`) run again in the backward under full only; the q/k/v
  copies are made under dots_attn_qkv alone, three a layer in the
  forward and none in the backward.
- An unknown policy name raises ValueError even with grad_checkpointing
  off, with the JAX package's message.
- The port's remat against JAX's, policy for policy, on the LM's loss and
  the VAE decoder's NLL from JAX's initialisation: losses within 2e-5
  relative, gradients within 2e-3 of their tensor's largest entry
  (+1e-7), the fp32 bounds of tests/test_torch_lm.py.

The shapes sit inside the JAX package's kernel gate (Dh 64, block 128),
so the attention goes through the port's K1/K2 Functions (their plain
versions here). Worker time: about 40 s (the JAX gradients of the ten
parity cases take most of it).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict
from flax.core import unfreeze

from sparse_vae_tpu import build_model
from sparse_vae_tpu.models.transformer_lm import \
    checkpoint_policy as j_checkpoint_policy
from sparse_vae_tpu_torch import checkpoint as ckpt
from sparse_vae_tpu_torch.models import remat
from sparse_vae_tpu_torch.models.remat import POLICIES
from sparse_vae_tpu_torch.models.transformer_lm import (
    TransformerHparams, TransformerLanguageModel, checkpoint_policy)
from sparse_vae_tpu_torch.models.transformer_vae import (
    TransformerVAE, TransformerVAEHparams)
from sparse_vae_tpu_torch.models.vae import VAEObjective
from sparse_vae_tpu_torch.ops import swa_kernel
from sparse_vae_tpu_torch.training.objectives import ARObjective

LOSS_RTOL = 2e-5
GRAD_REL, GRAD_ATOL = 2e-3, 1e-7
NAMES = ["full", "dots", "dots_attn", "dots_attn_qkv", "offload"]

# Dh 64 and block 128: inside the kernel gate, so K1/K2's Functions run.
LM = dict(vocab_size=64, d_model=128, num_heads=2, num_layers=2,
          sparse_self_attention=True, attn_window_size=2,
          attn_block_size=128, loss_chunk_size=64, precision="fp32",
          input_dropout=0.1)
VAE = dict(LM, input_dropout=0.0, latent_depth=8, num_encoder_latents=4)
MOE = dict(LM, sparse_self_attention=False, num_experts=4)
LENGTHS = [256, 190]


def _ids(seed: int = 0, width: int = 256):
    rng = np.random.default_rng(seed)
    ids = np.zeros((len(LENGTHS), width), np.int64)
    for row, n in enumerate(LENGTHS):
        ids[row, 0] = 1
        ids[row, 1:n] = rng.integers(3, 64, size=n - 1)
    return torch.from_numpy(ids)


def _hparams(cfg, name):
    cls = TransformerVAEHparams if "latent_depth" in cfg \
        else TransformerHparams
    return cls(**cfg, grad_checkpointing=name is not None,
               remat_policy=name or "full")


_STATE = {}


def _model(family: str, name):
    """The family's model under policy `name` (None: no remat), all with
    the same parameters."""
    cfg = {"lm": LM, "vae": VAE, "moe": MOE}[family]
    hp = _hparams(cfg, name)
    model = (TransformerVAE if family == "vae"
             else TransformerLanguageModel)(hp)
    if family not in _STATE:
        torch.manual_seed(0)
        _STATE[family] = {k: torch.randn_like(v) * 0.05
                          for k, v in model.state_dict().items()}
    model.load_state_dict(_STATE[family])
    return model


def _step(family: str, name):
    """(loss, {name: grad}, the generator's state after the step, the
    moe_stats list of the forward)."""
    model = _model(family, name)
    ids = _ids()
    generator = torch.Generator().manual_seed(11)
    stats = None
    if family == "vae":
        eps = torch.randn(len(LENGTHS), 1, 8, generator=generator)
        mi = torch.randn(10, len(LENGTHS), 8, generator=generator)
        batch = {"token_ids": ids,
                 "num_tokens": torch.tensor(LENGTHS)}
        loss, _ = VAEObjective(model.hparams).loss(
            model, batch, 0, {"eps": eps, "mi": mi})
    elif family == "lm":
        batch = {"token_ids": ids, "num_tokens": torch.tensor(LENGTHS)}
        loss, _ = ARObjective(model.hparams).loss(model, batch, 0,
                                                  generator=generator)
    else:
        stats = []
        hidden = model.forward_hidden(ids, False, generator,
                                      moe_stats=stats)
        nll, count = model.sequence_nll(hidden, model.labels_for(ids))
        loss = nll / count + sum(s["z"] for s in stats)
        assert len(stats) == model.hparams.num_layers
    loss.backward()
    grads = {k: p.grad for k, p in model.named_parameters()}
    return loss.detach(), grads, generator.get_state(), stats


_PLAIN = {}


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("family", ["lm", "vae", "moe"])
def test_remat_equals_no_remat_bit_for_bit(family, name):
    if family not in _PLAIN:
        _PLAIN[family] = _step(family, None)
    loss0, grads0, state0, stats0 = _PLAIN[family]
    loss, grads, state, stats = _step(family, name)
    assert torch.equal(loss, loss0)
    assert set(grads) == set(grads0)
    for key, g in grads0.items():
        assert g is not None and torch.equal(grads[key], g), key
    assert torch.equal(state, state0)
    if stats is not None:     # appended once a layer, not in the recompute
        assert len(stats) == len(stats0) == MOE["num_layers"]
        for got, want in zip(stats, stats0):
            for k in want:
                assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("name", NAMES + [None])
def test_each_policy_recomputes_the_attention_forward_as_stated(
        monkeypatch, name):
    """The attention forward: once a layer in the forward, again in the
    backward under full, dots and offload. The products: again in the
    backward under full only. The q/k/v copies: three a layer in the
    forward under dots_attn_qkv, none in the backward."""
    counts = {"attention": 0, "linear": 0, "copies": 0}
    model = _model("lm", name)
    # fp32: a decoder layer's Linear hands F.linear its own parameter.
    layer_weights = {id(p) for layer in model.decoder_layers
                     for p in layer.parameters()}

    def counted(key, real, counts_call=lambda *args: True):
        def call(*args, **kwargs):
            counts[key] += counts_call(*args)
            return real(*args, **kwargs)
        return call

    monkeypatch.setattr(swa_kernel, "swa_fwd",
                        counted("attention", swa_kernel.swa_fwd))
    monkeypatch.setattr(
        torch.nn.functional, "linear",
        counted("linear", torch.nn.functional.linear,
                lambda x, weight, *rest: id(weight) in layer_weights))
    monkeypatch.setattr(remat, "_copy", counted("copies", remat._copy))
    ids = _ids()
    hidden = model.forward_hidden(ids)
    forward = dict(counts)
    nll, _ = model.sequence_nll(hidden, model.labels_for(ids))
    nll.backward()
    again = {key: counts[key] - forward[key] for key in counts}
    layers = LM["num_layers"]
    assert forward["attention"] == layers
    assert again["attention"] == (layers if name in ("full", "dots",
                                                     "offload") else 0)
    assert forward["linear"] >= 6 * layers
    assert (again["linear"] > 0) == (name == "full")
    assert forward["copies"] == (3 * layers if name == "dots_attn_qkv"
                                 else 0)
    assert again["copies"] == 0


PRODUCTS = ["rows", "contiguous", "strided", "no_bias", "bf16", "bmm"]


@pytest.mark.parametrize("case", PRODUCTS)
def test_kept_products_give_autograd_s_gradients(monkeypatch, case):
    """A product that `dots` keeps (models/remat.py `linear`, `bmm`) is
    computed once, in the forward, and its backward gives the gradients
    autograd gives the plain product, bit for bit: rows [N, D], a
    contiguous and a strided [B, L, D] input, no bias, bf16 compute over
    fp32 leaves, and the experts' batched product."""
    rng = np.random.default_rng(PRODUCTS.index(case))

    def leaf(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).requires_grad_(True)

    if case == "bmm":
        inputs = (leaf(3, 40, 16), leaf(3, 16, 24))
    else:
        x = {"rows": lambda: leaf(50, 16),
             "strided": lambda: leaf(30, 2, 16)}.get(
                 case, lambda: leaf(2, 30, 16))()
        inputs = (x, leaf(24, 16), None if case == "no_bias" else leaf(24))
    dtype = torch.bfloat16 if case == "bf16" else torch.float32

    def fn(*tensors, generator=None, moe_stats=None):
        args = [t if t is None else t.to(dtype) for t in tensors]
        if case == "strided":
            args[0] = args[0].transpose(0, 1)
        y = (remat.bmm(*args) if case == "bmm" else remat.linear(*args))
        return torch.nn.functional.gelu(y.float()).square().sum()

    def grads(policy):
        for t in inputs:
            if t is not None:
                t.grad = None
        loss = (fn(*inputs) if policy is None else remat.checkpoint_layer(
            fn, policy, *inputs))
        loss.backward()
        return loss, [None if t is None else t.grad for t in inputs]

    plain_loss, plain = grads(None)
    calls = []
    for name in ("linear", "bmm"):
        real = getattr(torch.nn.functional if name == "linear" else torch,
                       name)
        monkeypatch.setattr(
            torch.nn.functional if name == "linear" else torch, name,
            lambda *a, _real=real, **k: calls.append(1) or _real(*a, **k))
    kept_loss, kept = grads(POLICIES["dots"])
    assert len(calls) == 1       # the forward's product; none recomputed
    assert torch.equal(kept_loss, plain_loss)
    for got, want in zip(kept, plain):
        assert (got is None) == (want is None)
        assert want is None or torch.equal(got, want)


def test_an_unknown_policy_raises_as_in_jax():
    with pytest.raises(ValueError) as jax_error:
        j_checkpoint_policy("bogus")
    with pytest.raises(ValueError) as port_error:
        checkpoint_policy("bogus")
    assert str(port_error.value) == str(jax_error.value)
    with pytest.raises(ValueError, match="remat_policy 'bogus'"):
        TransformerLanguageModel(TransformerHparams(
            **{**LM, "grad_checkpointing": False,
               "remat_policy": "bogus"}))
    assert sorted(POLICIES) == sorted(NAMES)
    assert all(checkpoint_policy(n).name == n for n in NAMES)


def _leaves(tree) -> dict:
    return {"/".join(k): np.array(v)
            for k, v in flatten_dict(unfreeze(tree)).items()}


def _assert_grads_match(model, jax_grads: dict):
    named = dict(model.named_parameters())
    assert len(jax_grads) == len(named)
    for path, want in jax_grads.items():
        key, transpose = ckpt.torch_key(path)
        grad = named[key].grad      # None: a leaf the loss does not read
        if grad is None:
            got = np.zeros(want.shape, np.float32)
        else:
            got = grad.numpy().T if transpose else grad.numpy()
        bound = GRAD_REL * np.abs(want).max() + GRAD_ATOL
        assert np.abs(got - want).max() <= bound, path


@pytest.mark.parametrize("name", NAMES)
def test_port_remat_matches_jax_remat(name):
    """The LM's chunked loss (no dropout) and the VAE decoder's NLL at a
    fixed z, both packages under grad_checkpointing with `name`."""
    ids = _ids(seed=4)
    jids = jnp.asarray(ids.numpy(), jnp.int32)
    for cfg, experiment in ((LM, "transformer-lm"),
                            (VAE, "transformer-vae")):
        cfg = dict(cfg, input_dropout=0.0, grad_checkpointing=True,
                   remat_policy=name)
        module, _, _ = build_model(experiment, cfg)
        vae = experiment == "transformer-vae"
        key = jax.random.PRNGKey(3)
        params = module.init({"params": key, "sample": key}, jids[:1])[
            "params"]
        z = np.random.default_rng(5).standard_normal(
            (len(LENGTHS), 1, 8)).astype(np.float32)
        cls = type(module)

        def loss_fn(p):
            if vae:
                h = module.apply({"params": p}, jids, jnp.asarray(z),
                                 method=cls.reconstruct_hidden)
            else:
                h = module.apply({"params": p}, jids,
                                 method=cls.forward_hidden)
            nll, count = module.apply(
                {"params": p}, h, cls.shifted_labels(jids),
                method=cls.sequence_nll)
            return nll / count

        j_loss, j_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
        hp = (TransformerVAEHparams if vae else TransformerHparams)(**cfg)
        model = (TransformerVAE if vae else TransformerLanguageModel)(hp)
        model.load_state_dict(ckpt.state_from_leaves(_leaves(params), hp))
        assert all(layer.remat.name == name
                   for layer in model.decoder_layers)
        h = (model.reconstruct_hidden(ids, torch.from_numpy(z)) if vae
             else model.forward_hidden(ids))
        nll, count = model.sequence_nll(h, model.labels_for(ids))
        loss = nll / count
        loss.backward()
        np.testing.assert_allclose(loss.item(), float(j_loss),
                                   rtol=LOSS_RTOL)
        _assert_grads_match(model, _leaves(j_grads))
