"""The continuous VAE's ELBO objective (port of sparse_vae_tpu/models/vae.py:
`kl_sums`, `normalized_kl` and `VAEObjective`'s single-sample ELBO with
KL annealing and free bits, the mutual-information diagnostic, and the
validation statistics `eval_stats` / `reduce_eval`).

As in the reference, `loss_sums` returns numerator sums and count
denominators, and `compose_loss` divides them: the loss stays linear in
the sums. The training forwards run without dropout, as the reference's
VAE training does. The posterior noise comes in explicitly (`noise`: eps
for z and the marginal-KL draws) or from a torch.Generator.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..ops.cross_entropy import bits_per_byte, token_nll
from ..utils.distributions import DiagonalGaussian
from ..utils.math_utils import marginal_kl
from ..utils.schedules import kl_weight_schedule


def kl_sums(raw_kl, num_tokens):
    """(sum over real rows of per-doc KL / doc tokens, sum of raw per-doc
    KL, real-row count). A row with num_tokens == 0 is batch filler and
    counts nowhere."""
    per_doc = raw_kl.reshape(raw_kl.shape[0], -1).sum(-1)
    real = num_tokens > 0
    denom = num_tokens.clamp_min(1).to(per_doc.dtype)
    kl_sum = torch.where(real, per_doc / denom, 0.0).sum()
    raw_sum = torch.where(real, per_doc, 0.0).sum()
    return kl_sum, raw_sum, real.sum().to(per_doc.dtype)


def normalized_kl(raw_kl, num_tokens):
    """(per-token KL, raw KL), each averaged over real rows."""
    kl_sum, raw_sum, rows = kl_sums(raw_kl, num_tokens)
    rows = rows.clamp_min(1)
    return kl_sum / rows, raw_sum / rows


class VAEObjective:
    """loss = nll + kl_weight(step) * kl, with the linear annealing
    schedule, the free-bits floor and the mutual-information diagnostic
    (logged, not in the loss)."""

    # Per-ROW statistics: the same on every shard of a length-sharded
    # batch, so the sequence-parallel step counts them on shard 0 only
    # (parallel/spmd.py). nll_sum and token_count are local to a shard.
    ROW_SUMS = ("kl_sum", "raw_kl_sum", "marginal_kl_rows")
    ROW_COUNTS = ("row_count",)

    def __init__(self, hparams, mutual_info_samples: int = 10):
        self.hp = hparams
        self.mi_samples = mutual_info_samples
        if getattr(hparams, "train_mc_samples", 1) > 1:
            raise NotImplementedError(
                "train_mc_samples > 1 (the IWAE/DReG bound) is not ported "
                "yet: sparse_vae_tpu/models/vae.py::iwae_dreg_loss and "
                "VAEObjective._multi_sample_sums")
        if getattr(hparams, "num_experts", 0) > 1:
            raise NotImplementedError(
                "mixture-of-experts losses are not ported yet: "
                "sparse_vae_tpu/models/moe.py")

    def kl_weight(self, step) -> float:
        return kl_weight_schedule(step, self.hp.kl_weight_start,
                                  self.hp.kl_weight_end,
                                  self.hp.kl_annealing_steps)

    def loss_sums(self, model, batch: dict, noise: Optional[dict] = None,
                  generator: Optional[torch.Generator] = None
                  ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """(differentiable sums, counts) of the ELBO on one batch
        {"token_ids": [B, L], "num_tokens": [B]}.

        noise: {"eps": [B, 1, latent], "mi": [S, B, latent]} standard
        normal draws for z and for the marginal-KL diagnostic; whatever is
        missing is drawn from `generator`."""
        noise = noise or {}
        ids = batch["token_ids"]
        if self.hp.loss_chunk_size:
            nll_sum, count, raw_kl, posterior, _ = model.forward_chunked_nll(
                ids, noise.get("eps"), generator)
        else:
            logits, raw_kl, posterior, _ = model(ids, noise.get("eps"),
                                                 generator)
            nll, mask = token_nll(logits[:, :-1], ids[:, 1:], reduce=False)
            nll_sum, count = nll.sum(), mask.sum()
        fb = self.hp.free_bits
        kl_for_loss = raw_kl.clamp_min(fb) if fb > 0.0 else raw_kl
        kl_sum, _, rows = kl_sums(kl_for_loss, batch["num_tokens"])
        _, raw_kl_sum, _ = kl_sums(raw_kl, batch["num_tokens"])
        sums = {"nll_sum": nll_sum, "kl_sum": kl_sum,
                "raw_kl_sum": raw_kl_sum}
        counts = {"token_count": count, "row_count": rows}
        if ids.shape[0] > 1:
            with torch.no_grad():
                detached = DiagonalGaussian(posterior.loc.detach(),
                                            posterior.scale.detach())
                mi = noise.get("mi")
                if mi is None:
                    mi = torch.randn(
                        (self.mi_samples, *detached.loc.reshape(
                            ids.shape[0], -1).shape),
                        generator=generator, device=ids.device)
                sums["marginal_kl_rows"] = marginal_kl(detached, mi) * rows
        return sums, counts

    def compose_loss(self, sums, counts, step):
        """(loss, metrics) from the sums and counts."""
        tokens = counts["token_count"].clamp_min(1.0)
        rows = counts["row_count"].clamp_min(1.0)
        nll = sums["nll_sum"] / tokens
        kl = sums["kl_sum"] / rows
        weight = self.kl_weight(step)
        loss = nll + weight * kl
        metrics = {"train_nll": nll, "train_kl": sums["raw_kl_sum"] / rows,
                   "kl_weight": torch.tensor(weight)}
        if "marginal_kl_rows" in sums:
            metrics["train_mc_mutual_info"] = kl - (
                sums["marginal_kl_rows"] / rows)
        return loss, metrics

    def loss(self, model, batch, step, noise=None, generator=None):
        sums, counts = self.loss_sums(model, batch, noise, generator)
        return self.compose_loss(sums, counts, step)

    def eval_stats(self, model, batch: dict, noise: Optional[dict] = None,
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, torch.Tensor]:
        """Validation sums of one batch {"token_ids", "num_tokens",
        "num_bytes"}, the model's forward with z = loc + scale * eps (eps
        from noise["eps"] or drawn from `generator`), to be summed over
        batches and reduced by `reduce_eval`. The KL is the raw one, free
        bits aside. Call under torch.no_grad."""
        ids, num_tokens = batch["token_ids"], batch["num_tokens"]
        eps = (noise or {}).get("eps")
        if self.hp.loss_chunk_size:
            nll_sum, token_count, raw_kl, _, _ = model.forward_chunked_nll(
                ids, eps, generator)
        else:
            logits, raw_kl, _, _ = model(ids, eps, generator)
            nll, mask = token_nll(logits[:, :-1], ids[:, 1:], reduce=False)
            nll_sum, token_count = nll.sum(), mask.sum()
        kl, _ = normalized_kl(raw_kl, num_tokens)
        real_rows = (num_tokens > 0).sum()
        return {"nll_sum": nll_sum, "token_count": token_count,
                "byte_count": batch["num_bytes"].sum().float(),
                "kl_weighted_rows": kl * real_rows,
                "row_count": real_rows.float()}

    @staticmethod
    def reduce_eval(stats: Dict[str, float]) -> Dict[str, float]:
        """val_nll (per token), val_bpb (bits per byte), val_kl (per
        token, averaged over documents) and val_loss = val_nll + val_kl
        from `eval_stats` summed over the validation batches."""
        tokens = max(stats["token_count"], 1.0)
        nll = stats["nll_sum"] / tokens
        kl = stats["kl_weighted_rows"] / max(stats["row_count"], 1.0)
        return {"val_nll": nll,
                "val_bpb": bits_per_byte(stats["nll_sum"],
                                         stats["byte_count"]),
                "val_kl": kl,
                "val_loss": nll + kl}
