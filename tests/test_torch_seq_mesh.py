"""The `seq` axis inside a mesh (sparse_vae_tpu_torch/parallel/mesh.py,
spmd.py, the attention's `_sp_call` beside tensor parallelism, the
Transformer LM and its MoE twin over `seq`, Trainer.fit on a seq mesh)
against the JAX package on the CPU.

One spawn of 8 gloo ranks on the CPU runs, in tests/torch_seq_mesh_worker.py
and tests/torch_mesh_worker.py (which import no JAX):
- the data 2 x seq 2 x model 2 and data 4 x pipe 2 layouts as each rank
  sees them (`model` and `pipe` innermost, as the JAX package lays them
  out) and a sum over each `sums_group`;
- one Transformer-VAE step at tests/test_sp.py::Test3AxisMesh's config
  (d_model 128, 4 heads, 2 layers, vocab 256, window 2, block 16, chunk
  32, tied and vocab-sharded) on data 2 x seq 2 x model 2, against JAX's
  shard_map step on the same mesh of conftest's virtual CPU devices, eps
  read off JAX's own rng splits;
- the sparse Transformer LM over data 4 x seq 2, one step without
  dropout, against JAX's;
- the MoE LM of tests/test_moe.py::test_moe_under_sequence_parallel_eval_exact
  over data 4 x seq 2: its eval statistics against JAX's make_eval_step,
  and one train step against the port's unsharded step (capacity 8: no
  token is dropped, so the layouts agree).
Tolerances: loss 2e-5 relative, grad_norm 1e-4, every gathered gradient
within 2e-3 of its tensor's largest |value| (+1e-7); eval statistics
2e-5; the step against the port's unsharded one as tests/test_torch_tp.py
(loss 1e-5, gradients 1e-4).

A second spawn, of 4 ranks, runs Trainer.fit over data 2 x seq 2 (a tiny
Transformer-VAE, 2 steps, a validation and a checkpoint each step, the
bucket quantum 256 padded to lcm(256, 2 x 2 x 128) = 512): its quantum and
first groups' shapes equal the JAX Trainer's on the same corpus, the
resumed step is the run's step 2 bit for bit, the gathered checkpoint
gives the trained logits; and each rank's dropped MoE dispatches by layer
on data 2 x expert 2 at capacity 1.25 against the drops JAX's shard_map
expert forward gives the same rows (its routers' logits through the JAX
package's dispatch rule).

Worker time: about 60 s (8 ranks) and 35 s (4 ranks); the JAX steps about
40 s here.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.core import unfreeze
from jax.sharding import PartitionSpec as P

from sparse_vae_tpu import build_model
from sparse_vae_tpu.data import text_data_module as jt
from sparse_vae_tpu.models.moe import expert_capacity as j_capacity
from sparse_vae_tpu.parallel import ep as jep
from sparse_vae_tpu.parallel import sp as jsp
from sparse_vae_tpu.parallel import tp as jtp
from sparse_vae_tpu.parallel.mesh import create_mesh as j_create_mesh
from sparse_vae_tpu.parallel.spmd import (make_eval_step, make_train_step,
                                          shard_batch)
from sparse_vae_tpu.training.trainer import Trainer as JTrainer
from sparse_vae_tpu.utils.config import TrainerHparams as JTrainerHparams
from sparse_vae_tpu_torch import checkpoint as ckpt
from sparse_vae_tpu_torch import load_checkpoint_for_name
from sparse_vae_tpu_torch.models.transformer_lm import TransformerHparams
from sparse_vae_tpu_torch.models.transformer_vae import TransformerVAEHparams
from sparse_vae_tpu_torch.parallel.group import spawn
from tests.test_torch_tp import (_Deterministic, _documents, _leaves,
                                 assert_matches_jax, assert_matches_single)
from tests.torch_mesh_worker import single_step
from tests.torch_seq_mesh_worker import run_four, run_seq

RANK_TIMEOUT_S = 600
EVAL_RTOL = 2e-5
# tests/test_sp.py::Test3AxisMesh.
VAE3 = dict(d_model=128, num_heads=4, num_layers=2, latent_depth=8,
            vocab_size=256, num_encoder_latents=4,
            sparse_self_attention=True, attn_window_size=2,
            attn_block_size=16, tie_embedding_weights=True,
            use_pallas_kernel=False, loss_chunk_size=32, precision="fp32",
            grad_checkpointing=False)
SPARSE_LM = dict(vocab_size=256, d_model=64, num_heads=4, num_layers=2,
                 sparse_self_attention=True, attn_window_size=2,
                 attn_block_size=16, use_pallas_kernel=False,
                 loss_chunk_size=32, precision="fp32",
                 grad_checkpointing=False)
# tests/test_moe.py::test_moe_under_sequence_parallel_eval_exact.
MOE_SEQ = dict(vocab_size=64, d_model=32, num_heads=4, num_layers=2,
               sparse_self_attention=True, attn_window_size=1,
               attn_block_size=16, use_pallas_kernel=False,
               loss_chunk_size=16, num_experts=4, moe_capacity_factor=8.0,
               precision="fp32", grad_checkpointing=False)
# tests/test_torch_ep.py's MoE LM at the run's capacity factor.
MOE_EP = dict(vocab_size=64, d_model=32, num_heads=4, num_layers=2,
              sparse_self_attention=False, use_pallas_kernel=False,
              loss_chunk_size=16, precision="fp32", grad_checkpointing=False,
              num_experts=4, moe_top_k=2, moe_capacity_factor=1.25)
FIT_MODEL = dict(d_model=128, num_heads=2, num_layers=2, latent_depth=8,
                 num_encoder_latents=8, vocab_size=1024, lr=1e-3,
                 lr_decay_steps=1000, loss_chunk_size=64, log_samples=False)
FIT_TRAINER = dict(max_steps=2, log_every_n_steps=1,
                   checkpoint_every_n_steps=1, accumulate_grad_batches=2,
                   val_check_interval=1e-3, limit_val_batches=2,
                   num_devices=4, seq_parallel=2)
FIT_DATA = dict(dataset_name="synthetic", synthetic_docs=200,
                vocab_size=1024, min_tokens_per_sample=16,
                max_tokens_per_sample=512, tokens_per_batch=4096,
                pad_to_multiple_of=256)


def _cpu_mesh(**kw):
    return j_create_mesh(devices=jax.devices("cpu"), **kw)


def grads_keeper() -> optax.GradientTransformation:
    """An optax "optimizer" that keeps the step's gradients as its state
    and leaves the parameters: JAX's gradients exactly, where params -
    new params would round them to the parameters' ulp."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda grads, state, params=None: (
            jax.tree.map(jnp.zeros_like, grads), grads))


def jax_step(twin, objective, mesh, params, tokens, lengths, step_rng):
    """JAX's shard_map step on `mesh`: (metrics, {leaf path: gradient})."""
    opt = grads_keeper()
    batch = {"token_ids": jnp.asarray(tokens, jnp.int32),
             "num_tokens": jnp.asarray(lengths, jnp.int32),
             "num_bytes": jnp.asarray(lengths, jnp.int32)}
    step = make_train_step(twin, objective, opt, mesh=mesh)
    _, grads, metrics = step(jax.tree.map(jnp.array, params),
                             opt.init(params),
                             shard_batch(batch, mesh, stacked=True),
                             jnp.asarray(0), step_rng)
    return ({n: float(v) for n, v in metrics.items()}, _leaves(grads))


def _port_case(hparams_cls, cfg, leaves, tokens, lengths, noise, **mesh):
    port_cfg = {k: v for k, v in cfg.items() if k != "grad_checkpointing"}
    port_cfg["use_pallas_kernel"] = True
    hp = hparams_cls(**port_cfg)
    return {"hparams": hp, "state": ckpt.state_from_leaves(leaves, hp),
            "batches": [{"token_ids": torch.tensor(t),
                         "num_tokens": torch.tensor(n),
                         "num_bytes": torch.tensor(n)}
                        for t, n in zip(tokens, lengths)],
            "noise": noise, "step": 0, **mesh}


def jax_vae_3axis(seed=5, k=2, b=4, length=256):
    """JAX's step on data 2 x seq 2 x model 2 (`jax_step`), and the port's
    case of the same step with the eps and marginal-KL draws of JAX's rng
    splits: the step rng folded by the data shard, split per micro-batch,
    then into (dropout, sample, mi)."""
    module, jhp, jobj = build_model("transformer-vae", VAE3)
    tokens, lengths = _documents(seed, k, b, length, jhp.vocab_size)
    key = jax.random.PRNGKey(seed)
    params = module.init({"params": key, "sample": key},
                         jnp.asarray(tokens[0][:1]))["params"]
    mesh = _cpu_mesh(num_devices=8, seq_axis=2, model_axis=2)
    twin = jsp.sp_localize(jtp.tp_localize(module, 2), 2)
    step_rng = jax.random.PRNGKey(seed + 8)
    metrics, grads = jax_step(twin, jobj, mesh, params, tokens, lengths,
                              step_rng)
    leaves = _leaves(params)
    rows = b // 2
    cls = type(module)
    noise = [{"eps": [], "mi": []} for _ in range(k)]
    for d in range(2):
        rngs = jax.random.split(jax.random.fold_in(step_rng, d), k)
        for i in range(k):
            drop, sample, mi = jax.random.split(rngs[i], 3)
            ids = jnp.asarray(tokens[i][d * rows:(d + 1) * rows])
            q, _, z = module.apply({"params": params}, ids,
                                   rngs={"dropout": drop, "sample": sample},
                                   method=cls.posterior_and_z)
            noise[i]["eps"].append(np.array((z - q.loc) / q.scale))
            noise[i]["mi"].append(np.array(jax.random.normal(
                mi, (jobj.mi_samples, rows, jhp.latent_depth))))
    noise = [{"eps": torch.tensor(np.concatenate(n["eps"], 0)),
              "mi": torch.tensor(np.concatenate(n["mi"], 1))}
             for n in noise]
    case = _port_case(TransformerVAEHparams, VAE3, leaves, tokens, lengths,
                      noise, tp=2, sp=2)
    return case, {"metrics": metrics, "grads": grads}


def jax_sparse_lm(seed=2, k=2, b=4, length=128):
    """JAX's step of the sparse LM over data 4 x seq 2 without dropout
    (`jax_step`), and the port's case of it."""
    module, jhp, jobj = build_model("transformer-lm", SPARSE_LM)
    tokens, lengths = _documents(seed, k, b, length, jhp.vocab_size)
    params = jax.jit(module.init)(jax.random.PRNGKey(seed),
                                  jnp.asarray(tokens[0][:1]))["params"]
    metrics, grads = jax_step(
        jsp.sp_localize(module, 2), _Deterministic(jobj),
        _cpu_mesh(num_devices=8, seq_axis=2), params, tokens, lengths,
        jax.random.PRNGKey(seed + 1))
    case = _port_case(TransformerHparams, SPARSE_LM, _leaves(params), tokens,
                      lengths, None, sp=2)
    return case, {"metrics": metrics, "grads": grads}


def _scaled_router_params(module, ids, seed):
    """JAX-initialised parameters with every router scaled by 30
    (tests/test_moe.py): decisive top-k margins, so that no near-tied
    choice flips on an ulp between the packages."""
    params = unfreeze(jax.jit(module.init)(jax.random.PRNGKey(seed),
                                           jnp.asarray(ids[:1]))["params"])
    for name in params:
        if isinstance(params[name], dict) and "moe" in params[name]:
            router = params[name]["moe"]["router"]
            router["kernel"] = router["kernel"] * 30.0
    return params


def jax_moe_seq_eval(seed=0, b=4, length=64):
    """JAX's eval statistics of the MoE LM over data 4 x seq 2, and the
    port's case of the same parameters and batch (also stepped: see
    test_moe_lm_step_over_seq_matches_the_unsharded_step)."""
    module, jhp, jobj = build_model("transformer-lm", MOE_SEQ)
    tokens, lengths = _documents(seed, 2, b, length, jhp.vocab_size)
    params = _scaled_router_params(module, tokens[0], seed)
    mesh = _cpu_mesh(num_devices=8, seq_axis=2)
    batch = {"token_ids": jnp.asarray(tokens[0], jnp.int32),
             "num_tokens": jnp.asarray(lengths[0], jnp.int32),
             "num_bytes": jnp.asarray(lengths[0], jnp.int32)}
    stats = make_eval_step(jsp.sp_localize(module, 2), jobj, mesh=mesh)(
        jax.tree.map(jnp.array, params), shard_batch(batch, mesh),
        jax.random.PRNGKey(seed))
    case = _port_case(TransformerHparams, MOE_SEQ, _leaves(params), tokens,
                      lengths, None, sp=2, eval=True)
    return case, {k: float(v) for k, v in stats.items()}


@pytest.fixture(scope="module")
def seq_run():
    vae, vae_jax = jax_vae_3axis()
    lm, lm_jax = jax_sparse_lm()
    moe, moe_jax = jax_moe_seq_eval()
    records = spawn(run_seq, 8, "cpu", ([vae, lm, moe],),
                    timeout=RANK_TIMEOUT_S)
    return {"records": records, "vae": (vae, vae_jax), "lm": (lm, lm_jax),
            "moe": (moe, moe_jax, single_step(moe))}


def test_seq_and_pipe_layouts_follow_the_jax_package(seq_run):
    """(data, seq, model) with `model` innermost, (data, pipe) with `pipe`
    innermost; the sums group of a seq mesh is data x seq (the ranks of
    one model coordinate), of a pipe mesh `data`."""
    for r, rec in enumerate(seq_run["records"]):
        three, pipe = rec["layouts"]
        d, s, m = r // 4, (r // 2) % 2, r % 2
        assert three["shape"] == {"data": 2, "seq": 2, "model": 2}
        assert three["coords"] == {"data": d, "seq": s, "model": m}
        assert three["groups"]["model"] == [r - m, r - m + 1]
        assert three["groups"]["seq"] == [4 * d + m, 4 * d + 2 + m]
        assert three["groups"]["data"] == [2 * s + m, 4 + 2 * s + m]
        assert three["groups"]["data_seq"] == [m, 2 + m, 4 + m, 6 + m]
        assert three["row_shard"] == d and three["sums"] == 4 * m + 16
        assert pipe["shape"] == {"data": 4, "pipe": 2}
        assert pipe["coords"] == {"data": r // 2, "pipe": r % 2}
        assert pipe["groups"]["pipe"] == [r - r % 2, r - r % 2 + 1]
        assert pipe["groups"]["data"] == [r % 2 + 2 * i for i in range(4)]
        assert pipe["row_shard"] == r // 2
        assert pipe["sums"] == 4 * (r % 2) + 16


@pytest.mark.parametrize("name", ["vae", "lm"])
def test_seq_mesh_step_matches_the_jax_step(seq_run, name):
    """data 2 x seq 2 x model 2 (the VAE: K6's route, the replicated
    gradient inputs of the sharded heads, the vocab-parallel loss across
    seq shards) and data 4 x seq 2 (the sparse LM) against JAX's shard_map
    steps: loss, grad_norm and every gathered gradient."""
    index = ["vae", "lm"].index(name)
    case, jax_out = seq_run[name]
    for rec in seq_run["records"]:
        assert_matches_jax(rec["steps"][index], jax_out, case["hparams"])


def test_moe_lm_eval_over_seq_matches_jax(seq_run):
    case, jax_stats, _ = seq_run["moe"]
    for rec in seq_run["records"]:
        got = rec["evals"][0]
        assert got.keys() == jax_stats.keys()
        for name, want in jax_stats.items():
            assert abs(got[name] - want) <= EVAL_RTOL * max(abs(want), 1.0), \
                (name, got[name], want)


def test_moe_lm_step_over_seq_matches_the_unsharded_step(seq_run):
    """Routing and capacity per length shard; the balance sums summed over
    data x seq: at capacity 8 the sharded step is the unsharded one."""
    _, _, single = seq_run["moe"]
    for rec in seq_run["records"]:
        step = rec["steps"][2]
        assert_matches_single(step, single)
        for metric in ("train_moe_aux", "train_moe_z"):
            want = single["metrics"][metric]
            assert abs(step["metrics"][metric] - want) <= 1e-5 * abs(want)


def test_replicated_parameters_are_bitwise_equal_on_the_seq_peers(seq_run):
    """Each rank's parameters after the step: equal bit for bit across
    the seq and data peers of a model coordinate (every leaf), and
    across every rank for the unsharded LM steps."""
    recs = seq_run["records"]
    for index, peers in ((0, [(0, 2), (0, 4), (1, 7), (3, 5)]),
                         (1, [(0, r) for r in range(1, 8)])):
        for a, b in peers:
            for name, value in recs[a]["steps"][index]["local"].items():
                assert torch.equal(value,
                                   recs[b]["steps"][index]["local"][name]), \
                    (index, a, b, name)


# -- four ranks: fit over data x seq; the expert mesh's drops --------------------
def _logits_ids():
    tokens, _ = _documents(9, 1, 2, 64, FIT_MODEL["vocab_size"])
    return tokens[0]


def _drops_case(seed=4, rows=8, length=32):
    module, jhp, _ = build_model("transformer-lm", MOE_EP)
    tokens, lengths = _documents(seed, 1, rows, length, jhp.vocab_size)
    params = _scaled_router_params(module, tokens[0], seed)
    case = _port_case(TransformerHparams, MOE_EP, _leaves(params), tokens,
                      lengths, None)
    return case, params, tokens[0]


def jax_ep_drops(params, tokens) -> list:
    """Each rank's [valid, kept] dispatches by layer on data 2 x expert 2:
    JAX's shard_map forward of the expert-parallel twin gives each rank's
    router logits (capture_intermediates), and the JAX package's dispatch
    rule (sparse_vae_tpu/models/moe.py: top-k, k-major joint positions,
    capacity from the rank's own tokens) gives its kept dispatches."""
    module, jhp, _ = build_model("transformer-lm", MOE_EP)
    twin = jep.ep_localize(module, 2)
    mesh = _cpu_mesh(num_devices=4, expert_axis=2)

    def routers(p, ids):
        _, state = twin.apply(
            {"params": p}, ids, True, method=type(twin).forward_hidden,
            capture_intermediates=lambda mdl, _: mdl.name == "router",
            mutable=["intermediates", "losses"])
        inter = state["intermediates"]
        return jnp.stack([inter[f"layer_{i}"]["moe"]["router"]["__call__"][0]
                          for i in range(jhp.num_layers)])[None]

    rows = P(("data", "expert"))
    mapped = jax.jit(jax.shard_map(
        routers, mesh=mesh, in_specs=(jep.ep_param_specs(params), rows),
        out_specs=rows, check_vma=False))
    logits = np.asarray(mapped(params, jnp.asarray(tokens, jnp.int32)))
    per = tokens.shape[0] // 4
    k, e = jhp.moe_top_k, jhp.num_experts
    out = []
    for r in range(4):
        valid = (tokens[r * per:(r + 1) * per] != 0).reshape(-1)
        n = valid.size
        cap = j_capacity(n, e, k, jhp.moe_capacity_factor)
        layers = []
        for lg in logits[r]:
            probs = np.exp(lg - lg.max(-1, keepdims=True))
            assign = np.argsort(-probs, axis=-1, kind="stable")[:, :k]
            assign_kn = assign.T.reshape(-1)
            valid_kn = np.tile(valid, k)
            onehot = np.eye(e, dtype=np.int64)[assign_kn] * valid_kn[:, None]
            pos = np.cumsum(onehot, axis=0) - onehot
            pos_a = pos[np.arange(k * n), assign_kn]
            layers.append([int(valid_kn.sum()),
                           int((valid_kn & (pos_a < cap)).sum())])
        out.append(layers)
    return out


@pytest.fixture(scope="module")
def four_run(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("seq_fit")
    drops, params, tokens = _drops_case()
    hp = TransformerVAEHparams(**FIT_MODEL)
    fit = (str(workdir), hp, FIT_TRAINER, FIT_DATA, _logits_ids())
    records = spawn(run_four, 4, "cpu",
                    (fit, (drops["hparams"], drops["state"],
                           drops["batches"][0], 1.25)),
                    timeout=RANK_TIMEOUT_S)
    return {"records": records, "workdir": workdir,
            "jax_drops": jax_ep_drops(params, tokens)}


def test_seq_fit_pads_and_groups_as_the_jax_trainer(four_run, tmp_path,
                                                    monkeypatch):
    """The bucket quantum override lcm(256, seq 2 x window 2 x block 128)
    = 512 and the first two accumulation groups' [k, rows, L] shapes
    equal the JAX Trainer's on a data 2 x seq 2 mesh and the same corpus."""
    monkeypatch.chdir(tmp_path)
    dm = jt.TextDataModule(jt.TextDataModuleHparams(**FIT_DATA))
    dm.prepare_data()
    module, jhp, jobj = build_model("transformer-vae",
                                    {**FIT_MODEL, "use_pallas_kernel": False})
    thp = JTrainerHparams(**FIT_TRAINER)
    trainer = JTrainer(module, jhp, jobj, dm, thp,
                       mesh=_cpu_mesh(num_devices=4, seq_axis=2),
                       enable_logging=False)
    groups = trainer._accum_groups(thp.seed)
    shapes = [tuple(next(groups)[0]["token_ids"].shape) for _ in range(2)]
    for rec in four_run["records"]:
        fit = rec["fit"]
        assert fit["pad_multiple"] == trainer._pad_multiple == 512
        assert fit["group_shapes"] == shapes
        assert all(s[-1] % 512 == 0 for s in shapes)


def test_seq_fit_validates_saves_and_resumes_bit_for_bit(four_run):
    fits = [rec["fit"] for rec in four_run["records"]]
    assert [f["step"] for f in fits] == [2] * 4
    assert [h["step"] for h in fits[0]["history"]] == [1, 2]
    assert all(np.isfinite(h["val_loss"]) for h in fits[0]["history"])
    assert all(f["history"] == fits[0]["history"] for f in fits)
    assert all(f["resumed_equal"] and f["generator_equal"] for f in fits)


def test_seq_fit_checkpoint_gives_the_trained_logits(four_run):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        model, hp, _, state, _ = load_checkpoint_for_name(
            "transformer-vae", "mesh", root=four_run["workdir"] / "logs",
            device="cpu")
        assert state["step"] == 2 and hp.sp_size == 1
        with torch.no_grad():
            logits = model(torch.tensor(_logits_ids()),
                           torch.zeros(2, 1, hp.latent_depth))[0]
    finally:
        torch.set_num_threads(threads)
    assert torch.equal(logits, four_run["records"][0]["fit"]["logits"])


def test_expert_mesh_drops_equal_the_jax_expert_step(four_run):
    """Capacity comes from each rank's own tokens, in both packages: at
    1.25 on a pool of 2 rows the dropped dispatches by layer are the
    same on every rank (the 0-16.8% mesh-ep printed on the card is this
    design, not a fault)."""
    got = [rec["drops"] for rec in four_run["records"]]
    assert got == four_run["jax_drops"]
    assert any(valid > kept for rank in got for valid, kept in rank)


def test_dense_lm_over_seq_raises_as_jax():
    """A dense LM (real-prose-lm-moe as archived is one) over a seq group
    raises JAX's ValueError, word for word."""
    from sparse_vae_tpu_torch.models.transformer_lm import (
        TransformerLanguageModel)
    from sparse_vae_tpu_torch.parallel.group import AxisGroup
    from sparse_vae_tpu_torch.parallel.sp import sp_localize
    dense = {**SPARSE_LM, "sparse_self_attention": False}
    port_cfg = {k: v for k, v in dense.items() if k != "grad_checkpointing"}
    group = AxisGroup(0, 2, torch.device("cpu"), "gloo")
    with pytest.raises(ValueError) as port:
        sp_localize(TransformerLanguageModel(TransformerHparams(**port_cfg)),
                    group)
    module, _, _ = build_model("transformer-lm", dense)
    with pytest.raises(ValueError) as jax_err:
        jsp.sp_localize(module, 2)
    assert str(port.value) == str(jax_err.value)
