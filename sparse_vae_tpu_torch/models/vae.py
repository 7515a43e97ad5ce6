"""The continuous VAE's objectives and estimators (port of
sparse_vae_tpu/models/vae.py): `kl_sums`, `normalized_kl`,
`VAEObjective` (the single-sample ELBO with KL annealing and free bits,
the mutual-information diagnostic, the K-sample IWAE bound with the DReG
gradient for train_mc_samples > 1, and the validation statistics
`eval_stats` / `reduce_eval`), and the importance-weighted estimators
`iwae_dreg_loss`, `iwae_dreg_sums` and `estimate_log_prob_iw`.

As in the reference, `loss_sums` returns numerator sums and count
denominators, and `compose_loss` divides them: the loss stays linear in
the sums. The training forwards run without dropout, as the reference's
VAE training does. The posterior noise comes in explicitly (`noise`: eps
for z and the marginal-KL draws) or from a torch.Generator.

The estimators take `reconstruct(token_ids, z)`, the model's
`reconstruct` (logits [N, L, V]) or `reconstruct_ll` (log p(x | z) [N]).
Where the reference vmaps it over K samples of z, they stack the samples
as rows: z [K, B, 1, latent] goes in as [K * B, 1, latent] beside the
token ids repeated sample-major (`ids.repeat(K, 1)`: row k * B + b is
document b under sample k). Log-weights and their logsumexp are fp32.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from ..ops.cross_entropy import (bits_per_byte, sequence_log_likelihood,
                                 token_nll)
from ..utils.distributions import DiagonalGaussian, standard_normal_log_prob
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
    (logged, not in the loss); with train_mc_samples K > 1 instead the
    K-sample IWAE bound per token with the DReG gradient
    (`iwae_dreg_sums`), where the KL schedule does not apply."""

    # Per-ROW statistics: the same on every shard of a length-sharded
    # batch, so the sequence-parallel step counts them on shard 0 only
    # (parallel/spmd.py). nll_sum and token_count are local to a shard.
    ROW_SUMS = ("kl_sum", "raw_kl_sum", "marginal_kl_rows",
                "neg_bound_sum", "bound_sum")
    ROW_COUNTS = ("row_count",)

    def __init__(self, hparams, mutual_info_samples: int = 10):
        self.hp = hparams
        self.mi_samples = mutual_info_samples
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
        missing is drawn from `generator`. With train_mc_samples K > 1:
        {"eps": [K, B, 1, latent]} (`_multi_sample_sums`)."""
        noise = noise or {}
        ids = batch["token_ids"]
        if getattr(self.hp, "train_mc_samples", 1) > 1:
            if getattr(self.hp, "free_bits", 0.0) > 0.0:
                # The IWAE bound has no separate KL term to floor.
                raise ValueError(
                    "free_bits requires train_mc_samples=1: the multi-"
                    "sample (IWAE/DReG) objective has no per-dimension KL "
                    "term to clamp")
            return self._multi_sample_sums(model, batch, noise.get("eps"),
                                           generator)
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
        if "neg_bound_sum" in sums:     # the multi-sample DReG branch
            loss = sums["neg_bound_sum"] / rows
            return loss, {"train_iwae_log_prob": sums["bound_sum"] / rows}
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

    def _multi_sample_sums(self, model, batch, eps=None, generator=None):
        """K-sample IWAE-DReG sums (train_mc_samples K > 1): per-document
        log p(x | z) through `reconstruct_ll` when the loss is chunked,
        else through the logits of `reconstruct`. The counts carry
        token_count 0: the bound is per document."""
        ids = batch["token_ids"]
        posterior = model.posterior(ids)
        use_ll = bool(self.hp.loss_chunk_size)
        if model.hparams.sp_size > 1 and not use_ll:
            raise ValueError(
                "multi-sample training on a 'seq' mesh requires the chunked "
                "per-document path (loss_chunk_size > 0 and a reconstruct_ll "
                "method): full logits are length-sharded and the bound is "
                "nonlinear in per-shard partial likelihoods")
        reconstruct = model.reconstruct_ll if use_ll else model.reconstruct
        neg_sum, bound_sum, rows = iwae_dreg_sums(
            reconstruct, posterior, ids, batch["num_tokens"],
            self.hp.train_mc_samples, eps, generator)
        return ({"neg_bound_sum": neg_sum, "bound_sum": bound_sum},
                {"token_count": rows.new_zeros(()), "row_count": rows})

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


def _scale_gradient(x, s):
    """Value x; the gradient flowing back through it scaled
    elementwise by s."""
    return x * s - (x * s - x).detach()


def _sample_noise(num_samples: int, posterior: DiagonalGaussian, eps,
                  generator) -> torch.Tensor:
    """eps [K, *loc.shape] fp32: the given draws, or standard normal ones
    from `generator`."""
    shape = (num_samples, *posterior.loc.shape)
    if eps is None:
        return torch.randn(shape, generator=generator, dtype=torch.float32,
                           device=posterior.loc.device)
    if tuple(eps.shape) != shape:
        raise ValueError(f"eps must be {list(shape)}, got "
                         f"{list(eps.shape)}")
    return eps.to(device=posterior.loc.device, dtype=torch.float32)


def _log_px(reconstruct, token_ids, z) -> torch.Tensor:
    """Per-document log p(x | z) [K, B] fp32 of z [K, B, ...latent], the K
    samples stacked as rows beside the ids repeated sample-major. A
    reconstruct giving logits [K * B, L, V] is reduced here with the
    next-token shift (logits[:, :-1] against ids[:, 1:]); one giving
    [K * B] has already reduced."""
    k, b = z.shape[:2]
    ids = token_ids.repeat(k, 1)
    out = reconstruct(ids, z.reshape(k * b, *z.shape[2:]))
    if out.ndim > 1:
        out = sequence_log_likelihood(out[:, :-1], ids[:, 1:])
    return out.float().reshape(k, b)


def _log_weights(reconstruct, q: DiagonalGaussian, token_ids, z):
    """log p(x | z) + log p(z) - log q(z | x) [K, B] in fp32."""
    k, b = z.shape[:2]
    z32 = z.float()
    log_p_z = standard_normal_log_prob(z32.reshape(k, b, -1))
    log_q_z = q.log_prob(z32).reshape(k, b, -1).sum(-1)
    return _log_px(reconstruct, token_ids, z) + log_p_z - log_q_z


def iwae_dreg_loss(reconstruct, posterior: DiagonalGaussian, token_ids,
                   num_tokens, num_samples: int,
                   eps: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None):
    """The K-sample IWAE training bound with the DReG gradient estimator
    (Tucker et al. 2018): log q(z | x) with the posterior's parameters
    detached; the decoder's gradient weighted by the importance weights
    w~; z's gradient scaled by w~, so the encoder's carries w~^2.

    eps: [K, B, 1, latent] standard normal draws (z = loc + scale * eps),
    or drawn from `generator`. Returns (loss, bound): `loss` is minimised,
    per token and averaged over real rows (num_tokens > 0); its value is
    -bound per token and its gradient the DReG surrogate's. `bound` [B]
    is the per-document IWAE log p(x)."""
    loc, scale = posterior
    eps = _sample_noise(num_samples, posterior, eps, generator)
    z = loc[None] + scale[None] * eps.to(loc.dtype)      # [K, B, 1, latent]
    q_detached = DiagonalGaussian(loc.detach(), scale.detach())

    # Pass 1, without gradients: the importance weights.
    with torch.no_grad():
        lw_val = _log_weights(reconstruct, q_detached, token_ids,
                              z.detach())
    w_tilde = torch.softmax(lw_val, dim=0)               # [K, B]

    # Pass 2: z's gradient scaled by w~, the encoder's weight w~^2.
    z_scaled = _scale_gradient(
        z, w_tilde.reshape(*w_tilde.shape, *([1] * (z.ndim - 2))))
    lw = _log_weights(reconstruct, q_detached, token_ids, z_scaled)
    surrogate = (w_tilde * lw).sum(0)                    # [B]
    bound = torch.logsumexp(lw_val, dim=0) - math.log(num_samples)

    per_doc = bound + (surrogate - surrogate.detach())
    real = num_tokens > 0
    denom = num_tokens.clamp_min(1).to(per_doc.dtype)
    loss = -torch.where(real, per_doc / denom, 0.0).sum() / real.sum(
        ).clamp_min(1)
    return loss, bound


def iwae_dreg_sums(reconstruct, posterior: DiagonalGaussian, token_ids,
                   num_tokens, num_samples: int,
                   eps: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None):
    """(-sum over real rows of the per-token surrogate bound, the
    detached sum of the per-document bounds, the real-row count): the
    first over the third is `iwae_dreg_loss`'s loss."""
    loss, bound = iwae_dreg_loss(reconstruct, posterior, token_ids,
                                 num_tokens, num_samples, eps, generator)
    real = num_tokens > 0
    rows = real.sum().to(loss.dtype)
    bound_sum = torch.where(real, bound, 0.0).sum().detach()
    return loss * rows.clamp_min(1), bound_sum, rows


def estimate_log_prob_iw(reconstruct, posterior: DiagonalGaussian,
                         token_ids, num_samples: int, num_iter: int = 1,
                         eps: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None):
    """Importance-weighted log p(x) [B] over `num_samples` samples of the
    posterior, in `num_iter` sequential chunks of num_samples / num_iter
    samples (each chunk one reconstruct call over chunk * B rows), to
    bound memory. eps: [num_samples, B, 1, latent], chunk i taking
    eps[i * chunk:(i + 1) * chunk], or drawn chunk by chunk from
    `generator`. Gradients are the caller's business: evaluation runs it
    under torch.no_grad()."""
    if num_samples % num_iter:
        raise ValueError(f"num_samples {num_samples} is not a multiple of "
                         f"num_iter {num_iter}")
    chunk = num_samples // num_iter
    log_ws = []
    for i in range(num_iter):
        eps_i = None if eps is None else eps[i * chunk:(i + 1) * chunk]
        eps_i = _sample_noise(chunk, posterior, eps_i, generator)
        z = posterior.loc[None] + posterior.scale[None] * eps_i.to(
            posterior.loc.dtype)
        log_ws.append(_log_weights(reconstruct, posterior, token_ids, z))
    log_ws = torch.cat(log_ws)                           # [K, B]
    return torch.logsumexp(log_ws, dim=0) - math.log(num_samples)
