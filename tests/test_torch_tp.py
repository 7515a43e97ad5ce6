"""Tensor parallelism in the port (sparse_vae_tpu_torch/parallel/tp.py, the
`model` axis of parallel/mesh.py) against the JAX package on the CPU.

One spawn of 4 gloo ranks on the CPU (data 2 x model 2) runs, in
tests/torch_mesh_worker.py (which imports no JAX):
- the f/g pair, `vocab_parallel_embed` and `tied_vocab_parallel_nll`:
  each model shard's values and adjoints against JAX's, computed under
  `jax.shard_map` on a `model` 2 mesh of conftest's virtual CPU devices
  (values 2e-5, gradients 2e-3 of the largest |value|: fp32, a different
  summation order), and `sharded_global_norm` against the full norm
  (1e-6 relative);
- a tensor-parallel Transformer LM step (dense causal attention, the
  tied vocabulary sharded, dropout off, two micro-batches) against
  JAX's tensor-parallel shard_map step on data 2 x model 2 (the twin of
  tests/test_parallel.py's TestTensorParallelStep): loss 2e-5 relative,
  grad_norm 1e-4 relative, every gathered gradient within 2e-3 of its
  tensor's largest |value| (+1e-7);
- an r5-shaped Transformer-VAE step (r5's depth, block, window and loss
  chunk at d_model 128) with explicit eps against the port's unsharded
  step, which tests/test_torch_train.py holds against JAX: loss 1e-5
  relative, each gradient within 1e-4 of its tensor's largest |value|;
  the replicated parameters after the step bitwise equal on the two
  model shards; the same step with every decoder layer rematerialised
  (dots_attn_qkv, the collectives issued again in the recompute) equal
  to it bit for bit.
The slicing rules' round trip and the guards run in this process.

Worker time: about 30 s (4 ranks); the JAX steps about 15 s here.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.core import unfreeze
from flax.traverse_util import flatten_dict
from jax.sharding import PartitionSpec as P

from sparse_vae_tpu import build_model
from sparse_vae_tpu.parallel import tp as jtp
from sparse_vae_tpu.parallel.mesh import create_mesh as j_create_mesh
from sparse_vae_tpu.parallel.spmd import make_train_step, shard_batch
from sparse_vae_tpu_torch import checkpoint as ckpt
from sparse_vae_tpu_torch.models.lstm_lm import (LSTMLanguageModel,
                                                 LSTMLanguageModelHparams)
from sparse_vae_tpu_torch.models.transformer_lm import TransformerHparams
from sparse_vae_tpu_torch.models.transformer_vae import (
    TransformerVAE, TransformerVAEHparams)
from sparse_vae_tpu_torch.parallel import tp
from sparse_vae_tpu_torch.parallel.group import AxisGroup, spawn
from sparse_vae_tpu_torch.training.optimizer import make_optimizer
from tests.torch_mesh_worker import run_steps, single_step

WORLD = 4
RANK_TIMEOUT_S = 600
VALUE_REL, GRAD_REL, GRAD_ATOL = 2e-5, 2e-3, 1e-7
LOSS_RTOL, NORM_RTOL = 2e-5, 1e-4
# The sharded step against the port's unsharded one.
SELF_LOSS_RTOL, SELF_GRAD_REL = 1e-5, 1e-4

LM = dict(vocab_size=512, d_model=64, num_heads=4, num_layers=2,
          sparse_self_attention=False, use_pallas_kernel=False,
          loss_chunk_size=64, precision="fp32", grad_checkpointing=False)
R5_SHAPED = dict(vocab_size=512, d_model=128, num_heads=2, num_layers=6,
                 latent_depth=8, num_encoder_latents=8,
                 sparse_self_attention=True, attn_window_size=2,
                 attn_block_size=128, loss_chunk_size=2048,
                 precision="fp32")


def _close(got, want, what, rel=VALUE_REL):
    want = np.asarray(want, np.float64)
    bound = rel * max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= bound, f"{what}: max err {err:.3g} > {bound:.3g}"


def _leaves(tree):
    return {"/".join(p): np.array(v)
            for p, v in flatten_dict(unfreeze(tree)).items()}


# -- the collectives against JAX's under shard_map --------------------------------
def collective_inputs() -> dict:
    rng = np.random.default_rng(0)
    f32 = np.float32
    return {"x": rng.standard_normal((2, 3, 5)).astype(f32),
            "cot": rng.standard_normal((2, 3, 5)).astype(f32),
            "table": rng.standard_normal((16, 4)).astype(f32),
            "bias": rng.standard_normal(16).astype(f32),
            "ids": rng.integers(0, 16, size=(3, 5)),
            "embed_cot": rng.standard_normal((3, 5, 4)).astype(f32),
            "g": rng.standard_normal((6, 4)).astype(f32),
            "labels": rng.integers(0, 16, size=6),
            "dnll": rng.standard_normal(6).astype(f32)}


def _jax_collectives(inp: dict) -> dict:
    """Each model shard's values and adjoints (stacked on a leading shard
    axis, or concatenated where a result is sharded)."""
    mesh = j_create_mesh(num_devices=2, model_axis=2,
                         devices=jax.devices("cpu"))
    m = P("model")

    def smap(fn, in_specs, out_specs):
        return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                                     out_specs=out_specs, check_vma=False))

    def f(x, cot):
        y, vjp = jax.vjp(lambda a: jtp.reduce_activations(a, "model"), x[0])
        return y[None], vjp(cot)[0][None]

    def g(x, cot):
        y, vjp = jax.vjp(lambda a: jtp.replicate_gradient(a, "model"), x)
        return y[None], vjp(cot[0])[0][None]

    def embed(table, ids, cot):
        y, vjp = jax.vjp(
            lambda t: jtp.vocab_parallel_embed(t, ids, "model"), table)
        return y[None], vjp(cot)[0]

    def nll(g_, table, bias, labels, dnll):
        y, vjp = jax.vjp(lambda a, t, b: jtp.tied_vocab_parallel_nll(
            a, t, b, labels, "model"), g_, table, bias)
        dg, dt, db = vjp(dnll)
        return y[None], dg[None], dt, db

    j = {k: jnp.asarray(v) for k, v in inp.items()}
    return {
        "f": smap(f, (m, P()), (m, m))(j["x"], j["cot"][0]),
        "g": smap(g, (P(), m), (m, m))(j["x"][0], j["cot"]),
        "embed": smap(embed, (m, P(), P()), (m, m))(
            j["table"], j["ids"], j["embed_cot"]),
        "nll": smap(nll, (P(), m, m, P(), P()), (m, m, m, m))(
            j["g"], j["table"], j["bias"], j["labels"], j["dnll"])}


# -- the steps -------------------------------------------------------------------------
class _Deterministic:
    """JAX's objective with no rng: no dropout, as the port's step runs
    with its dropout at rate 0."""

    def __init__(self, inner):
        self.inner = inner

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def loss_sums(self, module, params, batch, step, rng):
        return self.inner.loss_sums(module, params, batch, step, None)


def _documents(seed, k, b, length, vocab):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(length // 2, length + 1, size=(k, b))
    tokens = rng.integers(3, vocab, size=(k, b, length))
    tokens = tokens * (np.arange(length)[None, None] < lengths[..., None])
    return tokens, lengths


def jax_sharded_step(experiment, cfg, mesh_kw, localize, seed, k, b,
                     length, scale_router=False):
    """JAX's shard_map step with optax.sgd(1.0), so its gradients are the
    parameters' change, and the port's case of the same step."""
    module, _, objective = build_model(experiment, cfg)
    tokens, lengths = _documents(seed, k, b, length, cfg["vocab_size"])
    params = jax.jit(module.init)(jax.random.PRNGKey(seed),
                                  jnp.asarray(tokens[0][:1]))["params"]
    if scale_router:
        # Decisive routing margins (tests/test_moe.py): ulp-level
        # differences must not flip a near-tied top-k choice.
        params = unfreeze(params)
        for name in params:
            if "moe" in params[name]:
                router = params[name]["moe"]["router"]
                router["kernel"] = router["kernel"] * 30.0
    mesh = j_create_mesh(devices=jax.devices("cpu"), **mesh_kw)
    opt = optax.sgd(1.0)
    batch = {"token_ids": jnp.asarray(tokens, jnp.int32),
             "num_tokens": jnp.asarray(lengths, jnp.int32),
             "num_bytes": jnp.asarray(lengths, jnp.int32)}
    step = make_train_step(localize(module), _Deterministic(objective), opt,
                           mesh=mesh)
    new, _, metrics = step(jax.tree.map(jnp.array, params),
                           opt.init(params),
                           shard_batch(batch, mesh, stacked=True),
                           jnp.asarray(0), jax.random.PRNGKey(seed + 1))
    leaves = _leaves(params)
    grads = {p: leaves[p] - v for p, v in _leaves(new).items()}
    port_cfg = {**cfg, "use_pallas_kernel": True}
    hp = (TransformerVAEHparams if "latent_depth" in cfg
          else TransformerHparams)(**port_cfg)
    case = {"hparams": hp, "state": ckpt.state_from_leaves(leaves, hp),
            "batches": [{"token_ids": torch.tensor(t),
                         "num_tokens": torch.tensor(n)}
                        for t, n in zip(tokens, lengths)],
            "noise": None, "step": 0}
    return case, {"metrics": {n: float(v) for n, v in metrics.items()},
                  "grads": grads}


def assert_matches_jax(record: dict, jax_out: dict, hparams,
                       metrics=("loss",)):
    for name in metrics:
        want = jax_out["metrics"][name]
        assert abs(record["metrics"][name] - want) <= LOSS_RTOL * abs(want), \
            (name, record["metrics"][name], want)
    want = jax_out["metrics"]["grad_norm"]
    assert abs(record["metrics"]["grad_norm"] - want) <= NORM_RTOL * want
    template = _template(hparams)
    got = {}
    for key, g in record["grads"].items():
        path, transpose = ckpt.flax_path(template, key)
        g = g.float().numpy()
        got[path] = g.T if transpose else g
    assert set(got) == set(jax_out["grads"])
    for path, w in jax_out["grads"].items():
        bound = GRAD_REL * np.abs(w).max() + GRAD_ATOL
        err = np.abs(got[path] - w).max()
        assert err <= bound, f"{path}: max err {err:.3g} > {bound:.3g}"


def _template(hparams):
    with torch.device("meta"):
        return ckpt.model_class(hparams)(hparams)


def assert_matches_single(record: dict, single: dict):
    want = single["metrics"]["loss"]
    assert abs(record["metrics"]["loss"] - want) <= SELF_LOSS_RTOL * abs(want)
    assert record["grads"].keys() == single["grads"].keys()
    for name, w in single["grads"].items():
        _close(record["grads"][name], w, name, SELF_GRAD_REL)


def vae_case(cfg, seed=3, k=2, b=4, length=256, mesh=None):
    """An unsharded-reference case of the Transformer-VAE from the JAX
    initialisation (checkpoint.model_from_hparams), with explicit global
    eps."""
    hp = TransformerVAEHparams(**cfg)
    model, _ = ckpt.model_from_hparams(hp, torch.Generator().manual_seed(
        seed), "cpu")
    tokens, lengths = _documents(seed, k, b, length, hp.vocab_size)
    gen = torch.Generator().manual_seed(seed)
    noise = [{"eps": torch.randn((b, 1, hp.latent_depth), generator=gen),
              "mi": torch.randn((10, b, hp.latent_depth), generator=gen)}
             for _ in range(k)]
    return {"hparams": hp,
            "state": {n: v.float().clone()
                      for n, v in model.state_dict().items()},
            "batches": [{"token_ids": torch.tensor(t),
                         "num_tokens": torch.tensor(n),
                         "num_bytes": torch.tensor(n)}
                        for t, n in zip(tokens, lengths)],
            "noise": noise, "step": 3, **(mesh or {})}


@pytest.fixture(scope="module")
def tp_run():
    lm_case, lm_jax = jax_sharded_step(
        "transformer-lm", LM, dict(num_devices=4, model_axis=2),
        lambda m: jtp.tp_localize(m, 2), seed=1, k=2, b=4, length=128)
    lm_case["tp"] = 2
    vae = vae_case(R5_SHAPED, mesh={"tp": 2})
    remat = vae_case(dict(R5_SHAPED, grad_checkpointing=True,
                          remat_policy="dots_attn_qkv"), mesh={"tp": 2})
    inputs = collective_inputs()
    records = spawn(run_steps, WORLD, "cpu", ([lm_case, vae, remat],
                                              inputs),
                    timeout=RANK_TIMEOUT_S)
    return {"records": records, "inputs": inputs,
            "jax_collectives": _jax_collectives(inputs),
            "lm": (lm_case, lm_jax), "vae": (vae, single_step(vae))}


def test_collectives_match_jax_under_shard_map(tp_run):
    want = tp_run["jax_collectives"]
    for rank, rec in enumerate(tp_run["records"]):
        got = rec["collectives"]
        shard = rank % 2                    # the model coordinate
        for name in ("f", "g"):
            _close(got[name][0], want[name][0][shard], f"{name} value")
            _close(got[name][1], want[name][1][shard], f"{name} adjoint",
                   GRAD_REL)
        rows = slice(8 * shard, 8 * shard + 8)
        _close(got["embed"][0], want["embed"][0][shard], "embed value")
        _close(got["embed"][1], want["embed"][1][rows], "embed dtable",
               GRAD_REL)
        _close(got["nll"][0], want["nll"][0][shard], "nll value")
        _close(got["nll"][1], want["nll"][1][shard], "nll dg", GRAD_REL)
        _close(got["nll"][2], want["nll"][2][rows], "nll dtable", GRAD_REL)
        _close(got["nll"][3], want["nll"][3][rows], "nll dbias", GRAD_REL)


def test_sharded_global_norm_is_the_full_norm(tp_run):
    inp = tp_run["inputs"]
    want = np.sqrt(np.square(inp["table"].astype(np.float64)).sum()
                   + np.square(inp["bias"].astype(np.float64)).sum())
    for rec in tp_run["records"]:
        assert abs(rec["collectives"]["norm"] - want) <= 1e-6 * want


def test_tp_lm_step_matches_jax_tp_step(tp_run):
    case, jax_out = tp_run["lm"]
    for rec in tp_run["records"]:
        assert_matches_jax(rec["steps"][0], jax_out, case["hparams"])


@pytest.mark.parametrize("which", ["loss_and_grads", "replicated_params"])
def test_r5_shaped_tp_vae_step_matches_the_unsharded_step(tp_run, which):
    vae, single = tp_run["vae"]
    recs = [r["steps"][1] for r in tp_run["records"]]
    if which == "loss_and_grads":
        for rec in recs:
            assert_matches_single(rec, single)
        return
    specs = tp.param_specs(_template(vae["hparams"]),
                           tp.shards_vocab(vae["hparams"], 2))
    for a, b in ((0, 1), (2, 3), (0, 2)):
        for name, value in recs[a]["local"].items():
            if name not in specs:
                assert torch.equal(value, recs[b]["local"][name]), name
    for name in specs:                      # data peers hold one shard
        assert torch.equal(recs[0]["local"][name], recs[2]["local"][name])
        assert torch.equal(recs[1]["local"][name], recs[3]["local"][name])


def test_tp_vae_step_under_remat_equals_the_step_without(tp_run):
    """The r5-shaped step again with every decoder layer rematerialised
    (dots_attn_qkv): the recompute issues the layers' f/g collectives
    again in the backward on every rank, and the loss, the gradients and
    the parameters after the step equal the step without remat bit for
    bit on every rank."""
    for rec in tp_run["records"]:
        plain, remat = rec["steps"][1], rec["steps"][2]
        assert remat["metrics"] == plain["metrics"]
        for part in ("grads", "local"):
            assert remat[part].keys() == plain[part].keys()
            for name, value in plain[part].items():
                assert torch.equal(remat[part][name], value), (part, name)


@pytest.mark.parametrize("family", ["transformer-vae", "transformer-lm"])
def test_shard_then_gather_round_trip(family):
    """Every rank's shard of a full state, joined along each leaf's dim,
    gives the full state back, identical; the shards have the twin's
    shapes."""
    cfg = {**R5_SHAPED, "d_model": 128, "num_layers": 2}
    if family == "transformer-lm":
        cfg = {k: v for k, v in cfg.items()
               if k not in ("latent_depth", "num_encoder_latents")}
        cfg["num_experts"] = 4
    hp = (TransformerVAEHparams if family == "transformer-vae"
          else TransformerHparams)(**cfg)
    model = ckpt.model_class(hp)(hp)
    specs = tp.param_specs(model, tp.shards_vocab(hp, 2))
    assert "input_embedding.weight" in specs and "output_bias" in specs
    full = model.state_dict()
    shards = [tp.shard_state(full, specs, r, 2) for r in range(2)]
    twin = _template(dataclasses.replace(hp, tp_size=2))
    for name, v in twin.state_dict().items():
        assert shards[0][name].shape == v.shape, name
    for name, value in full.items():
        joined = (torch.cat([s[name] for s in shards], dim=specs[name])
                  if name in specs else shards[1][name])
        assert torch.equal(joined, value), name


def test_lstm_and_lamb_raise_under_tensor_parallelism():
    group = AxisGroup(0, 2, torch.device("cpu"), "gloo")
    lstm = LSTMLanguageModel(LSTMLanguageModelHparams(
        d_embedding=8, d_model=16, vocab_size=32))
    with pytest.raises(ValueError, match="data-parallel only"):
        tp.tp_localize(lstm, group)
    hp = TransformerVAEHparams(**{**R5_SHAPED, "num_layers": 2})
    with pytest.raises(NotImplementedError, match="LAMB"):
        make_optimizer(TransformerVAE(hp).parameters(), lr=1e-3,
                       lr_decay_steps=None, grad_clip_threshold=1.0,
                       lamb=True, tp_size=2)
