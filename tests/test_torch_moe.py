"""The port's mixture-of-experts decoders (models/moe.py, the MoE branch of
models/transformer_layer.py, both transformer families, ARObjective and
VAEObjective with the balance losses, the checkpoint's MoE leaves)
against the JAX package on the CPU, on tiny JAX-initialised models
carried across by `checkpoint.state_from_leaves` / `params_from_numpy`,
in fp32. The capacity factor is small (0.5) so that tokens are dropped,
the batches hold [PAD] tokens, and the routers have their random
initialisation (no ties).

Tolerances, each stated where it is used:
- MoE outputs, statistics and gradients: fp32 products over widths of
  8-128 and a softmax over 4 experts, 2e-5 of the largest |value|;
  `load` and `nv` are counts and must be equal;
- losses and metrics 2e-5 relative; gradients per tensor |port - jax|
  <= 2e-3 * max|jax| + 1e-7, as tests/test_torch_lm.py's;
- logits 2e-5; sampled and decoded tokens exact.

Worker time: about 55 s in one process, 65 s in the suite's 6-worker
run; most of it JAX's compiles.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from sparse_vae_tpu import build_model
from sparse_vae_tpu.models import generation as jgen
from sparse_vae_tpu.models import moe as jmoe
from sparse_vae_tpu.models.transformer_lm import (
    TransformerLanguageModel as JLM)
from sparse_vae_tpu_torch import checkpoint as ckpt
from sparse_vae_tpu_torch.models import generation as tgen
from sparse_vae_tpu_torch.models.moe import (
    MoEFFN, collect_moe_stats, compose_moe_losses, expert_capacity,
    moe_loss_terms, top_k_lowest_first)
from sparse_vae_tpu_torch.models.transformer_lm import (
    TransformerHparams, TransformerLanguageModel)
from sparse_vae_tpu_torch.models.transformer_vae import (
    TransformerVAE, TransformerVAEHparams)
from sparse_vae_tpu_torch.models.vae import VAEObjective
from sparse_vae_tpu_torch.training.objectives import ARObjective
from tests.test_torch_lm import (_assert_grads_match, _leaf_grads,
                                 _port_grads, _without_dropout)

REL = 2e-5
LOSS_RTOL = 2e-5
GREEDY, J_TOP1 = tgen.SamplingParams(top_k=1), jgen.SamplingParams(top_k=1)
MOE = dict(num_experts=4, moe_capacity_factor=0.5)
LM = dict(vocab_size=64, d_model=32, num_heads=4, num_layers=2,
          sparse_self_attention=False, use_pallas_kernel=False,
          loss_chunk_size=16, precision="fp32", grad_checkpointing=False,
          **MOE)
VAE = dict(LM, latent_depth=8, num_encoder_latents=4)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _close(got, want, what=""):
    want = np.asarray(want)
    bound = REL * max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= bound, f"{what}: max err {err:.3g} > {bound:.3g}"


# -- the FFN alone -------------------------------------------------------------

def _ffn_pair(d=8, h=16, e=4, k=2, cf=0.5, seed=0, x=None, mask=None):
    """(JAX MoEFFN, its params, the port's MoEFFN with them)."""
    jm = jmoe.MoEFFN(d_model=d, d_hidden=h, num_experts=e, top_k=k,
                     capacity_factor=cf)
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed), x, mask)["params"]
    tm = MoEFFN(d, h, e, k, cf)
    with torch.no_grad():
        tm.router.weight.copy_(torch.from_numpy(
            np.array(params["router"]["kernel"]).T))
        for name in ("w_in", "b_in", "w_out"):
            getattr(tm, name).copy_(torch.from_numpy(np.array(
                params[name])))
    return jm, params, tm


def _jax_ffn(jm, params, x, mask):
    y, lvars = jm.apply({"params": params}, x, mask, mutable=["losses"])
    return y, jmoe.collect_moe_stats(lvars["losses"])


def _inputs(b, l, d, seed, pad_from=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, l, d)).astype(np.float32)
    mask = np.ones((b, l), bool)
    if pad_from is not None:
        mask[-1, pad_from:] = False
    return x, mask


@pytest.mark.parametrize("k", [1, 2])
def test_ffn_output_statistics_and_gradients_match_jax(k):
    """[2, 24, 8] with the last row padded from 10, E 4, capacity factor
    0.5 (tokens dropped): the output, imp, load, z and nv, and the
    gradients of sum(y * r) + sum(imp * c) + 0.1 z in x and every
    parameter, within REL of JAX's."""
    x, mask = _inputs(2, 24, 8, seed=k, pad_from=10)
    jm, params, tm = _ffn_pair(k=k, x=jnp.asarray(x),
                               mask=jnp.asarray(mask))
    rng = np.random.default_rng(10 + k)
    r = rng.standard_normal(x.shape).astype(np.float32)
    c = rng.standard_normal(4).astype(np.float32)

    def j_obj(p, xx):
        y, s = _jax_ffn(jm, p, xx, jnp.asarray(mask))
        return jnp.sum(y * r) + jnp.sum(s["imp"][0] * c) + 0.1 * s["z"], (
            y, s)

    (_, (jy, js)), (jgp, jgx) = jax.jit(jax.value_and_grad(
        j_obj, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    tx = torch.from_numpy(x).requires_grad_(True)
    y, stats = tm(tx, torch.from_numpy(mask))
    (torch.sum(y * torch.from_numpy(r)) + torch.sum(
        stats["imp"] * torch.from_numpy(c)) + 0.1 * stats["z"]).backward()
    _close(y.detach(), jy, "y")
    _close(stats["imp"].detach(), js["imp"][0], "imp")
    _close(stats["z"].detach(), js["z"], "z")
    np.testing.assert_array_equal(stats["load"].numpy(),
                                  np.asarray(js["load"][0]))
    assert stats["nv"].item() == float(js["nv"]) == 34.0
    cap = expert_capacity(48, 4, k, 0.5)
    dropped = int(mask.sum()) * k - int(stats["keep"].sum())
    assert cap == jmoe.expert_capacity(48, 4, k, 0.5) and dropped > 0
    assert float(y.detach()[1, 10:].abs().max()) == 0.0
    _close(tx.grad, jgx, "dx")
    _close(tm.router.weight.grad.T, jgp["router"]["kernel"], "router")
    for name in ("w_in", "b_in", "w_out"):
        _close(getattr(tm, name).grad, jgp[name], name)


def _port_ffn(d=8, h=16, e=4, k=2, cf=0.5, seed=0):
    """The port's MoEFFN with N(0, 0.02) weights from a seeded generator
    (models/init.py's draws), b_in random too."""
    gen = torch.Generator().manual_seed(seed)
    tm = MoEFFN(d, h, e, k, cf)
    with torch.no_grad():
        for p in tm.parameters():
            p.normal_(0.0, 0.02, generator=gen)
    return tm


def _oracle(tm, x_flat, mask_flat, top_k, capacity=None):
    """The JAX tests' per-token loop (tests/test_moe.py::_oracle) on the
    port's parameters: each token's top-k expert mix, a dispatch past its
    expert's capacity dropped in (slot, token) order."""
    w_r = tm.router.weight.detach().numpy().T
    w_in, b_in = tm.w_in.detach().numpy(), tm.b_in.detach().numpy()
    w_out = tm.w_out.detach().numpy()
    logits = x_flat @ w_r
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    idx = np.argsort(-probs, axis=-1, kind="stable")[:, :top_k]
    gv = np.take_along_axis(probs, idx, -1)
    if top_k > 1:
        gv = gv / np.maximum(gv.sum(-1, keepdims=True), 1e-9)
    used, out = {}, np.zeros_like(x_flat)
    for s in range(top_k):
        for t in range(x_flat.shape[0]):
            if not mask_flat[t]:
                continue
            e = int(idx[t, s])
            used[e] = used.get(e, 0) + 1
            if capacity is not None and used[e] > capacity:
                continue
            h = x_flat[t] @ w_in[e] + b_in[e]
            h = 0.5 * h * (1 + np.tanh(np.sqrt(2 / np.pi)
                                       * (h + 0.044715 * h ** 3)))
            out[t] += gv[t, s] * (h @ w_out[e])
    return out


@pytest.mark.parametrize("top_k", [1, 2])
def test_matches_per_token_oracle(top_k):
    """tests/test_moe.py's oracle case on the port: no drops (capacity
    factor E), the second row padded from 10."""
    b, l, d, e = 2, 16, 8, 4
    x, mask = _inputs(b, l, d, seed=21, pad_from=10)
    tm = _port_ffn(k=top_k, cf=float(e))
    with torch.no_grad():
        y, _ = tm(torch.from_numpy(x), torch.from_numpy(mask))
    want = _oracle(tm, x.reshape(-1, d), mask.reshape(-1), top_k)
    np.testing.assert_allclose(y.numpy().reshape(-1, d), want, atol=3e-5)


def test_capacity_dropping_priority():
    """Overflowing tokens get zero MoE output; priority is slot-major,
    then token order: the oracle's loop order (tests/test_moe.py)."""
    b, l, d, e = 1, 32, 8, 2
    x, _ = _inputs(b, l, d, seed=22)
    tm = _port_ffn(e=e, k=2, cf=0.25)
    cap = expert_capacity(b * l, e, 2, 0.25)
    assert cap == 8
    with torch.no_grad():
        y, _ = tm(torch.from_numpy(x))
    want = _oracle(tm, x.reshape(-1, d), np.ones(b * l, bool), 2,
                   capacity=cap)
    np.testing.assert_allclose(y.numpy().reshape(-1, d), want, atol=3e-5)
    assert np.any(np.all(want == 0.0, axis=-1))


def test_pads_excluded_everywhere():
    """Pad tokens give zero output, take no slot, and count in no
    statistic."""
    b, l, d, e = 2, 16, 8, 4
    x, _ = _inputs(b, l, d, seed=23)
    mask = np.ones((b, l), bool)
    mask[:, 8:] = False
    tm = _port_ffn(k=1, cf=float(e))
    with torch.no_grad():
        y, stats = tm(torch.from_numpy(x), torch.from_numpy(mask))
    assert float(y[:, 8:].abs().max()) == 0.0
    assert stats["nv"].item() == 16.0 and stats["load"].sum().item() == 16.0
    assert stats["imp"].sum().item() == pytest.approx(16.0, rel=1e-5)
    assert not bool(stats["keep"].view(b, l)[:, 8:].any())


def test_aux_composition_value():
    """compose_moe_losses on hand-built statistics: the Switch aux loss
    E * sum f_e P_e and the z-loss, as JAX's."""
    imp = torch.tensor([[2.0, 1.0, 1.0, 0.0]])
    load = torch.tensor([[3.0, 1.0, 0.0, 0.0]])
    sums = {"moe_imp_sum": imp, "moe_z_sum": torch.tensor(8.0)}
    counts = {"moe_load": load, "moe_nv": torch.tensor(4.0)}
    loss, metrics = compose_moe_losses(sums, counts, 0.5, 0.25)
    expect_aux = 4 * (3 * 2 + 1 * 1) / 16.0
    assert metrics["train_moe_aux"].item() == pytest.approx(expect_aux)
    assert metrics["train_moe_z"].item() == 2.0
    assert loss.item() == pytest.approx(0.5 * expect_aux + 0.25 * 2.0)
    j_loss, _ = jmoe.compose_moe_losses(
        {k: jnp.asarray(v.numpy()) for k, v in sums.items()},
        {k: jnp.asarray(v.numpy()) for k, v in counts.items()}, 0.5, 0.25)
    assert loss.item() == pytest.approx(float(j_loss), rel=1e-7)


def test_balanced_router_aux_near_one():
    """A fresh, near-uniform router gives aux ~ 1."""
    x, _ = _inputs(4, 32, 16, seed=24)
    tm = _port_ffn(d=16, h=32, e=8, k=2, cf=2.0)
    with torch.no_grad():
        _, stats = tm(torch.from_numpy(x))
    sums, counts = {}, {}
    moe_loss_terms(collect_moe_stats([stats]), sums, counts)
    _, metrics = compose_moe_losses(sums, counts, 1.0, 0.0)
    assert 0.7 < metrics["train_moe_aux"].item() < 1.5


def test_ties_go_to_the_lower_expert():
    """Rows with tied probabilities: the chosen experts and their order
    are jax.lax.top_k's (the lower index first)."""
    probs = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4],
                      [0.3, 0.2, 0.3, 0.2], [0.0, 0.5, 0.5, 0.0]],
                     np.float32)
    for k in (1, 2, 3):
        values, idx = top_k_lowest_first(torch.from_numpy(probs), k)
        j_values, j_idx = jax.lax.top_k(jnp.asarray(probs), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
        np.testing.assert_array_equal(values.numpy(), np.asarray(j_values))


def test_guards_raise_as_jax_and_name_item_8():
    """The JAX package's guards; expert and tensor parallelism alone are
    ported (tests/test_torch_ep.py), both together raise as in JAX, and
    MoE over a seq group binds every layer (its routing per length shard,
    tests/test_torch_seq_mesh.py)."""
    with pytest.raises(ValueError, match="top_k=5 > E=4"):
        MoEFFN(8, 16, 4, top_k=5)
    assert MoEFFN(8, 16, 4, ep_size=2).w_in.shape == (2, 8, 16)
    assert MoEFFN(8, 16, 4, tp_size=2).w_out.shape == (4, 8, 8)
    with pytest.raises(ValueError, match="not divisible by ep_size=3"):
        MoEFFN(8, 16, 4, ep_size=3)
    with pytest.raises(NotImplementedError, match="not composed"):
        MoEFFN(8, 16, 4, ep_size=2, tp_size=2)
    # An expert-parallel twin builds (check_ported, which refused the LM
    # options, is gone).
    twin = TransformerLanguageModel(_port_hp({**LM, "ep_size": 2}))
    assert twin.decoder_layers[0].moe.w_in.shape[0] == LM["num_experts"] // 2
    from sparse_vae_tpu_torch.parallel.group import AxisGroup
    model = TransformerLanguageModel(_port_hp(LM))
    group = AxisGroup(1, 2, torch.device("cpu"), "gloo")
    model.bind_seq_group(group)
    assert model.seq_group is group and model.hparams.sp_size == 2
    assert all(layer.attention.seq_group is group
               for layer in model.decoder_layers)


# -- the models ----------------------------------------------------------------

def _port_hp(cfg, vae=False):
    return (TransformerVAEHparams if vae else TransformerHparams)(**cfg)


def _pair(vae=False, seed=0, **over):
    """(JAX module, its objective, params, the port model with them in its
    training form), the port's built by state_from_leaves from JAX's
    initialisation."""
    cfg = {**(VAE if vae else LM), **over}
    module, _, objective = build_model(
        "transformer-vae" if vae else "transformer-lm", cfg)
    rngs = ({"params": jax.random.PRNGKey(seed),
             "sample": jax.random.PRNGKey(seed + 1)} if vae
            else jax.random.PRNGKey(seed))
    params = jax.jit(module.init)(rngs, jnp.ones((1, 16), jnp.int32))[
        "params"]
    hp = _port_hp(cfg, vae)
    model = (TransformerVAE if vae else TransformerLanguageModel)(hp)
    leaves = {k: np.array(v) for k, v in _leaf_grads(params).items()}
    assert any("/moe/router/kernel" in k for k in leaves)
    model.load_state_dict(ckpt.state_from_leaves(leaves, hp), strict=True)
    return module, objective, params, _without_dropout(model)


@pytest.fixture(scope="module")
def lm():
    return _pair()


@pytest.fixture(scope="module")
def vae():
    return _pair(vae=True)


def _documents(seed, rows=4, width=32, vocab=64):
    rng = np.random.default_rng(seed)
    lengths = [width, 27, 13, 20][:rows]
    ids = np.zeros((rows, width), np.int64)
    for row, n in enumerate(lengths):
        ids[row, 0] = 1
        ids[row, 1:n - 1] = rng.integers(3, vocab, size=n - 2)
        ids[row, n - 1] = 2
    return {"token_ids": ids, "num_tokens": np.array(lengths, np.int64),
            "num_bytes": np.array([4 * n for n in lengths], np.int64)}


def _to_torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("chunk", [16, 0])
def test_ar_objective_loss_metrics_and_gradients_match_jax(chunk, lm):
    """ARObjective on an MoE LM, chunked (forward_hidden + sequence_nll)
    and unchunked (full logits): the loss, train_nll, train_moe_aux and
    train_moe_z within LOSS_RTOL and every gradient, the routers' and the
    expert stacks' included, as test_torch_lm's; validation leaves the
    balance terms out."""
    module, objective, params, model = lm
    objective = type(objective)(dataclasses.replace(
        objective.hp, loss_chunk_size=chunk))
    port = ARObjective(dataclasses.replace(model.hparams,
                                           loss_chunk_size=chunk))
    model.zero_grad(set_to_none=True)
    batch = _documents(31)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    rng = None if chunk else jax.random.PRNGKey(0)

    def f(p):
        return objective.loss(module, p, jb, 0, rng)

    (j_loss, j_metrics), j_grads = jax.jit(jax.value_and_grad(
        f, has_aux=True))(params)
    loss, metrics = port.loss(model, _to_torch(batch), 0)
    loss.backward()
    assert loss.item() == pytest.approx(float(j_loss), rel=LOSS_RTOL)
    assert set(metrics) == set(j_metrics) == {"train_nll", "train_moe_aux",
                                              "train_moe_z"}
    for name, want in j_metrics.items():
        assert metrics[name].item() == pytest.approx(float(want),
                                                     rel=LOSS_RTOL), name
    _assert_grads_match(_port_grads(model), _leaf_grads(j_grads))
    with torch.no_grad():
        stats = port.eval_stats(model, _to_torch(batch))
    want = jax.jit(lambda p: objective.eval_stats(
        module, p, jb, jax.random.PRNGKey(0)))(params)
    assert set(stats) == set(want)
    for name in want:
        assert float(stats[name]) == pytest.approx(float(want[name]),
                                                   rel=LOSS_RTOL), name


def test_compose_loss_is_linear_in_the_moe_sums():
    """The sharded step's contract: d compose_loss / d sums is the same at
    two points, for both objectives with the MoE terms, and the values
    equal JAX's compose_loss."""
    from sparse_vae_tpu.models.vae import VAEObjective as JVAEObjective
    from sparse_vae_tpu.training.objectives import ARObjective as JAR
    rng = np.random.default_rng(5)
    counts = {"token_count": torch.tensor(90.0),
              "row_count": torch.tensor(4.0),
              "moe_load": torch.from_numpy(rng.integers(
                  0, 30, (2, 4)).astype(np.float32)),
              "moe_nv": torch.tensor(90.0)}
    base = {"nll_sum": 300.0, "kl_sum": 6.0, "raw_kl_sum": 40.0,
            "moe_imp_sum": rng.random((2, 4)).astype(np.float32) * 20,
            "moe_z_sum": 150.0}
    for obj, jobj, names in (
            (ARObjective(_port_hp(LM)), JAR(_port_hp(LM)),
             ("nll_sum", "moe_imp_sum", "moe_z_sum")),
            (VAEObjective(_port_hp(VAE, True)),
             JVAEObjective(_port_hp(VAE, True)),
             ("nll_sum", "kl_sum", "raw_kl_sum", "moe_imp_sum",
              "moe_z_sum"))):
        grads = []
        for scale in (1.0, 3.0):
            sums = {n: torch.tensor(np.asarray(base[n]) * scale + 1.0,
                                    dtype=torch.float32, requires_grad=True)
                    for n in names}
            loss, _ = obj.compose_loss(sums, counts, 0)
            grads.append(torch.autograd.grad(loss, list(sums.values()),
                                             allow_unused=True))
            want, _ = jobj.compose_loss(
                {k: jnp.asarray(v.detach().numpy()) for k, v in sums.items()},
                {k: jnp.asarray(v.numpy()) for k, v in counts.items()}, 0)
            assert loss.item() == pytest.approx(float(want), rel=1e-6)
        for a, b in zip(*grads):
            if a is None:
                assert b is None
            else:
                np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-7)


def test_moe_vae_elbo_and_metrics_match_jax(vae):
    """VAEObjective with an MoE decoder (the Perceiver stays dense) on the
    chunked path: eps and the marginal-KL draws are the ones JAX's loss
    draws from its rng; the loss and every metric (train_moe_aux and
    train_moe_z among them) as JAX's. (The MoE gradients are held on the
    LM above.)"""
    module, objective, params, model = vae
    model.zero_grad(set_to_none=True)
    assert not any("moe" in k for k in dict(model.named_parameters())
                   if k.startswith("encoder"))
    batch = _documents(32)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    key = jax.random.PRNGKey(6)
    drop, sample, mi = jax.random.split(key, 3)
    eps = jax.jit(lambda p: (lambda q, _, z: (z - q.loc) / q.scale)(
        *module.apply({"params": p}, jb["token_ids"],
                      rngs={"dropout": drop, "sample": sample},
                      method=type(module).posterior_and_z)))(params)
    noise = {"eps": torch.from_numpy(np.array(eps)),
             "mi": torch.from_numpy(np.array(jax.random.normal(
                 mi, (objective.mi_samples, 4, 8))))}

    j_loss, j_metrics = jax.jit(lambda p: objective.loss(
        module, p, jb, 0, key))(params)
    with torch.no_grad():
        loss, metrics = VAEObjective(model.hparams).loss(
            model, _to_torch(batch), 0, noise)
    assert loss.item() == pytest.approx(float(j_loss), rel=LOSS_RTOL)
    assert set(metrics) == set(j_metrics)
    assert {"train_moe_aux", "train_moe_z", "train_kl"} <= set(metrics)
    # The KL of a fresh posterior (~1e-5 nats) and the mutual information
    # (kl - marginal_kl, a logsumexp over 10 draws and 4 documents) are
    # differences of O(1) fp32 terms: their rounding is absolute, 1e-6
    # and 1e-5.
    for name, want in j_metrics.items():
        assert metrics[name].item() == pytest.approx(
            float(want), rel=LOSS_RTOL,
            abs=1e-5 if name == "train_mc_mutual_info" else 1e-6), name


def test_dead_rows_do_not_steal_decode_capacity():
    """tests/test_moe.py's invariance check on the port: at capacity
    factor 0.25 (one slot an expert at 4 rows), a live token's logits are
    the same behind three dead ([PAD]) rows as in front of them, and
    JAX's; without the mask the dead rows would take its slot."""
    module, _, params, model = _pair(num_experts=2, moe_top_k=1,
                                     moe_capacity_factor=0.25)
    model.eval()

    def step_logits(tokens):
        with torch.no_grad():
            logits, _ = model.decode_step(torch.tensor(tokens),
                                          model.init_caches(4, 16), 0)
        return logits.numpy()

    @jax.jit
    def jax_step(tokens):
        caches = module.apply({"params": params}, 4, 16,
                              method=JLM.init_caches)
        return module.apply({"params": params}, tokens, caches,
                            jnp.asarray(0), method=JLM.decode_step)[0]

    def jax_logits(tokens):
        return np.asarray(jax_step(jnp.asarray(tokens, jnp.int32)))

    for t in range(3, 11):
        behind = step_logits([0, 0, 0, t])[3]
        np.testing.assert_allclose(behind, step_logits([t, 0, 0, 0])[0],
                                   atol=1e-6, err_msg=f"token {t}")
        np.testing.assert_allclose(behind, jax_logits([0, 0, 0, t])[3],
                                   atol=2e-5, err_msg=f"token {t}")


def _replayed_noise(rng, steps, b, v):
    """JAX `sample`'s per-step Gumbel draws (tests/test_torch_sample.py)."""
    out = []
    for _ in range(steps):
        rng, sample_rng = jax.random.split(rng)
        out.append(torch.from_numpy(np.array(jax.random.gumbel(
            sample_rng, (b, v), jnp.float32))))
    return out


def test_moe_sample_matches_jax(lm):
    """An MoE LM at batch 3 x 40 (decode capacity 2 slots an expert, so
    live tokens are dropped): greedy `sample` token for token JAX's, and
    the lockstep steps fed JAX's per-step noise give JAX's nucleus sample,
    rows ending on the way (dead rows fed [PAD])."""
    module, _, params, model = lm
    b, ml = 3, 40
    want = np.asarray(module.apply({"params": params}, jax.random.PRNGKey(0),
                                   ml, b, J_TOP1, method=JLM.sample))
    np.testing.assert_array_equal(model.sample(0, ml, b, GREEDY).numpy(),
                                  want)
    key = jax.random.PRNGKey(2)
    want = np.asarray(module.apply({"params": params}, key, ml, b,
                                   jgen.SamplingParams(), end_token=5,
                                   method=JLM.sample))
    noise = _replayed_noise(key, ml, b, 64)
    state = tgen.init_decode_state(b, ml, 1, torch.Generator())
    caches, step = model.init_caches(b, ml), 0
    with torch.no_grad():
        while tgen.should_continue(state):
            logits, caches = model.decode_step(tgen.prev_tokens(state),
                                               caches, state.index - 1)
            state = tgen.process_logits(logits, state, tgen.SamplingParams(),
                                        5, fused=False, noise=noise[step])
            step += 1
    got = tgen.final_output(state).numpy()
    np.testing.assert_array_equal(got, want)
    assert (want == 0).any() and len(set(want.ravel().tolist())) > 10


def test_chunk_peek_masks_pad_drafts_as_jax(lm):
    """The speculative-verification chunk of an MoE LM (its capacity from
    the chunk's N = B * C) with [PAD] draft slots, which take no expert
    slot: the logits of a 6-token peek after a committed 6-token chunk as
    JAX's, within 2e-5."""
    module, _, params, model = lm
    tokens = np.random.default_rng(8).integers(3, 64, size=(3, 12))
    tokens[1, 8:] = 0
    tokens[2, 7] = 0

    @jax.jit
    def jax_peek(p):
        caches = module.apply({"params": p}, 3, 16, method=JLM.init_caches)
        _, kvs = module.apply({"params": p}, jnp.asarray(tokens[:, :6]),
                              caches, 0, method=JLM.decode_chunk)
        caches = module.apply({"params": p}, caches, kvs, 0, 6,
                              method=JLM.commit_chunk)
        return module.apply({"params": p}, jnp.asarray(tokens[:, 6:]),
                            caches, 6, method=JLM.decode_chunk)[0]

    with torch.no_grad():
        caches = model.init_caches(3, 16)
        _, kvs = model.decode_chunk(torch.from_numpy(tokens[:, :6]), caches,
                                    0)
        caches = model.commit_chunk(caches, kvs, 0, 6)
        got, _ = model.decode_chunk(torch.from_numpy(tokens[:, 6:]), caches,
                                    6)
    _close(got.numpy(), jax_peek(params), "chunk logits")


def test_moe_archive_round_trip(tmp_path, lm):
    """export_archive writes the MoE leaves under JAX's paths
    (layer_i/moe/router/kernel transposed, moe/w_in, b_in, w_out as they
    are), and load_run reads them back into the same bf16-rounded
    parameters and the same logits."""
    model = lm[3]
    meta = {"experiment": "transformer-lm", "name": "moe-tiny",
            "model_hparams": dataclasses.asdict(model.hparams)}
    out = ckpt.export_archive(model, meta, tmp_path / "moe", step=3)
    with np.load(out / "ckpt_bf16.npz") as npz:
        keys = set(npz.files)
    for leaf in ("moe/router/kernel", "moe/w_in", "moe/b_in", "moe/w_out"):
        assert f"layer_1/{leaf}{ckpt.BF16_SUFFIX}" in keys
    loaded, hp, _ = ckpt.load_run(str(out), device="cpu",
                                  dtype=torch.float32)
    assert hp.num_experts == 4 and hp.moe_capacity_factor == 0.5
    for name, p in model.state_dict().items():
        assert torch.equal(loaded.state_dict()[name],
                           p.to(torch.bfloat16).float()), name
    ids = torch.from_numpy(_documents(33)["token_ids"])
    rounded = ckpt.serving_form(model)
    with torch.no_grad():
        for p in rounded.parameters():
            p.copy_(p.to(torch.bfloat16).float())
        assert torch.equal(loaded(ids), rounded(ids))
