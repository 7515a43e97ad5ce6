"""Rank functions for tests/test_torch_sp.py, in a module that imports
torch and the port only: every rank the tests spawn imports it, and must
not load JAX.

`run_rank` runs on each rank of a gloo group on the CPU and returns
everything the tests check: the collectives' values and adjoints on
seeded inputs, and one sequence-parallel optimizer step (plus the
sharded `reconstruct_ll`) for each case the tests give.
"""
import numpy as np
import torch

from sparse_vae_tpu_torch.models.transformer_vae import (
    TransformerVAE, TransformerVAEHparams)
from sparse_vae_tpu_torch.models.vae import VAEObjective
from sparse_vae_tpu_torch.ops import launches
from sparse_vae_tpu_torch.parallel.sp import (halo_from_left,
                                              max_over_shards,
                                              seq_parallel_cross_attention,
                                              shard_length, sp_localize,
                                              sp_shifted_labels,
                                              sum_over_shards)
from sparse_vae_tpu_torch.training.optimizer import make_optimizer
from sparse_vae_tpu_torch.training.train_step import train_step


def collective_inputs(size: int) -> dict:
    """Seeded global inputs of the collective checks, the same on every
    rank and in the test process."""
    rng = np.random.default_rng(0)
    f32 = np.float32
    return {
        "x": rng.standard_normal((size, 3, 5)).astype(f32),
        "cot": rng.standard_normal((size, 3, 5)).astype(f32),
        "tokens": rng.integers(3, 100, size=(3, 64)),
        "q": rng.standard_normal((2, 2, 6, 8)).astype(f32),
        "k": rng.standard_normal((2, 2, 64, 8)).astype(f32),
        "v": rng.standard_normal((2, 2, 64, 8)).astype(f32),
        "kv_mask": rng.random((2, 64)) < 0.7,
        "attn_cot": rng.standard_normal((2, 2, 6, 8)).astype(f32),
    }


def _collectives(group) -> dict:
    inp = collective_inputs(group.size)
    r = group.rank
    out = {}
    for name, fn in (("halo", halo_from_left), ("sum", sum_over_shards),
                     ("max", max_over_shards)):
        x = torch.tensor(inp["x"][r], requires_grad=True)
        y = fn(x, group)
        (y * torch.tensor(inp["cot"][r])).sum().backward()
        out[name] = (y.detach(), x.grad)
    out["labels"] = sp_shifted_labels(
        shard_length(torch.tensor(inp["tokens"]), group), group)
    q = torch.tensor(inp["q"], requires_grad=True)
    k, v = (shard_length(torch.tensor(inp[n]), group, dim=2)
            .clone().requires_grad_() for n in ("k", "v"))
    y = seq_parallel_cross_attention(
        q, k, v, shard_length(torch.tensor(inp["kv_mask"]), group), group)
    # The output is the same on every rank; its loss term counts once,
    # on rank 0, as the train step counts per-row terms.
    (y * torch.tensor(inp["attn_cot"]) * float(r == 0)).sum().backward()
    out["cross"] = (y.detach(), q.grad, k.grad, v.grad)
    return out


def _step(group, hparams: dict, state: dict, batches: list, noise: list,
          step: int, optimizer: dict, z) -> dict:
    hp = TransformerVAEHparams(**hparams)
    model = TransformerVAE(hp)
    model.load_state_dict(state, strict=True)
    sp_localize(model, group)
    mbs = [{"token_ids": shard_length(b["token_ids"], group).contiguous(),
            "num_tokens": b["num_tokens"]} for b in batches]
    with torch.no_grad():
        ll = model.reconstruct_ll(mbs[0]["token_ids"], z)
    launches.reset()
    opt = make_optimizer(model.parameters(), **optimizer)
    metrics = train_step(model, VAEObjective(hp), opt, mbs, step, noise)
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "params": {k: v.detach().clone()
                       for k, v in model.state_dict().items()},
            "reconstruct_ll": ll, "launches": launches.read()}


def run_rank(group, cases: list) -> dict:
    torch.set_num_threads(1)
    return {"collectives": _collectives(group),
            "steps": [_step(group, **case) for case in cases]}
