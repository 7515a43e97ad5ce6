"""Expert parallelism in the port (sparse_vae_tpu_torch/parallel/ep.py, the
`expert` axis of parallel/mesh.py) and mixture-of-experts layers under
tensor parallelism, against the JAX package on the CPU.

One spawn of 4 gloo ranks on the CPU runs, in tests/torch_mesh_worker.py
(which imports no JAX), two steps of a tiny MoE Transformer LM (4
experts, top-2, dense causal attention, dropout off, two micro-batches
of [8, 32] ragged documents), each against JAX's shard_map step on the
same mesh shape (tests/test_moe.py's EP and MoE x TP steps are the
twins):
- data 2 x expert 2: the experts' all-to-all, rows over data x expert,
  at capacity factor 0.5, which drops tokens: capacity comes from each
  rank's own tokens, so the per-(shard, expert) drop pools are checked;
- data 2 x model 2: each expert's hidden dimension split, the tied
  vocabulary sharded, at the same capacity factor.
Tolerances: loss and the balance losses train_moe_aux / train_moe_z 2e-5
relative, grad_norm 1e-4 relative, every gathered gradient within 2e-3
of its tensor's largest |value| (+1e-7). The routers are scaled by 30,
as in tests/test_moe.py, so that no near-tied top-2 choice flips on an
ulp. The ep x tp guards run in this process.

Worker time: about 15 s (4 ranks); the JAX steps about 20 s here.
"""
import pytest
import torch

from sparse_vae_tpu.parallel import ep as jep
from sparse_vae_tpu.parallel import tp as jtp
from sparse_vae_tpu_torch.models.moe import MoEFFN, expert_capacity
from sparse_vae_tpu_torch.parallel.group import AxisGroup, spawn
from sparse_vae_tpu_torch.parallel.mesh import create_mesh
from tests.test_torch_tp import _documents, assert_matches_jax, \
    jax_sharded_step
from tests.torch_mesh_worker import run_steps

WORLD = 4
RANK_TIMEOUT_S = 600
MOE_LM = dict(vocab_size=64, d_model=32, num_heads=4, num_layers=2,
              sparse_self_attention=False, use_pallas_kernel=False,
              loss_chunk_size=16, precision="fp32", grad_checkpointing=False,
              num_experts=4, moe_top_k=2, moe_capacity_factor=0.5)
K, ROWS, LENGTH, SEED = 2, 8, 32, 4
METRICS = ("loss", "train_moe_aux", "train_moe_z")


@pytest.fixture(scope="module")
def ep_run():
    ep_case, ep_jax = jax_sharded_step(
        "transformer-lm", MOE_LM, dict(num_devices=4, expert_axis=2),
        lambda m: jep.ep_localize(m, 2), SEED, K, ROWS, LENGTH,
        scale_router=True)
    ep_case["ep"] = 2
    tp_case, tp_jax = jax_sharded_step(
        "transformer-lm", MOE_LM, dict(num_devices=4, model_axis=2),
        lambda m: jtp.tp_localize(m, 2), SEED, K, ROWS, LENGTH,
        scale_router=True)
    tp_case["tp"] = 2
    records = spawn(run_steps, WORLD, "cpu", ([ep_case, tp_case],),
                    timeout=RANK_TIMEOUT_S)
    return {"records": records, "ep": (ep_case, ep_jax),
            "tp": (tp_case, tp_jax)}


def test_capacity_drops_tokens_on_every_rank():
    """At capacity factor 0.5 each rank's experts have fewer slots than
    its valid dispatches: the steps below run with dropped tokens."""
    tokens, lengths = _documents(SEED, K, ROWS, LENGTH,
                                 MOE_LM["vocab_size"])
    per_rank = ROWS // WORLD
    cap = expert_capacity(per_rank * LENGTH, 4, 2, 0.5)
    for mb in lengths:
        for r in range(WORLD):
            valid = int(mb[r * per_rank:(r + 1) * per_rank].sum())
            assert 2 * valid > 4 * cap


@pytest.mark.parametrize("layout", ["ep", "tp"])
def test_moe_step_matches_jax_sharded_step(ep_run, layout):
    case, jax_out = ep_run[layout]
    step = 0 if layout == "ep" else 1
    for rec in ep_run["records"]:
        assert_matches_jax(rec["steps"][step], jax_out, case["hparams"],
                           METRICS)
        assert rec["steps"][step]["metrics"]["train_moe_aux"] > 0


def test_expert_and_model_axes_together_raise():
    with pytest.raises(NotImplementedError, match="not composed"):
        MoEFFN(8, 16, 4, ep_size=2, tp_size=2)
    world = AxisGroup(0, 4, torch.device("cpu"), "gloo")
    with pytest.raises(NotImplementedError, match="'data' axis only"):
        create_mesh(world, model_axis=2, expert_axis=2)
