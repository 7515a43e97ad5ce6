"""The autoregressive objective of the language-model families (port of
sparse_vae_tpu/training/objectives.py): `ARObjective` and `batch_arrays`.

Teacher-forced next-token NLL over non-pad tokens, for training (the
per-token mean) and validation (the summed statistics of token-weighted
val_nll and val_bpb). With `loss_chunk_size` set and a model that has
`forward_hidden`, the head and the loss run over the hidden states
(`sequence_nll`: the fused tied CE, K3/K3b on the card) so [B, L, V]
logits never exist; otherwise the full logits go through `token_nll`.
As in the reference, `loss_sums` returns numerator sums and count
denominators and `compose_loss` divides them, linear in the sums. A model
with mixture-of-experts FFNs (num_experts > 1, models/moe.py) adds its
balance statistics on both branches (`moe_imp_sum` / `moe_z_sum` in the
sums, `moe_load` / `moe_nv` in the counts), and `compose_loss` adds
moe_aux_weight * aux + moe_zloss_weight * z with the metrics
`train_moe_aux` and `train_moe_z`; validation leaves them out. They are
token statistics, local to a length shard, so they are not in
ROW_SUMS / ROW_COUNTS. Under sequence parallelism (a model bound to a
seq group) the labels shift across the shards (`labels_for`) and the
dropout generator folds by the seq shard, as the JAX package folds its
dropout rng by the seq index.

The methods take the arguments of models/vae.py's VAEObjective, so the
trainer and train_step drive either: `noise` is unused (a language model
draws no latent), and `generator` draws the dropout masks of training
(the input dropout and each layer's FFN dropout at the reference's 0.1)
on the chunked path, where the reference applies them; its unchunked
path and validation run without dropout.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..models.moe import (collect_moe_stats, compose_moe_losses,
                          moe_loss_terms)
from ..ops.cross_entropy import token_nll


def batch_arrays(batch, device="cpu") -> Dict[str, torch.Tensor]:
    """A TextBatch (host numpy) -> {"token_ids", "num_tokens",
    "num_bytes"} int64 tensors on `device`."""
    return {name: torch.from_numpy(np.asarray(getattr(batch, name))).to(
                device, torch.int64)
            for name in ("token_ids", "num_tokens", "num_bytes")}


class ARObjective:
    """The plain language-model objective (the Transformer LM; the LSTM
    LM, which has no `forward_hidden`, through its full logits): loss =
    the NLL per real token."""

    # Per-ROW statistics, counted once under a length-sharded batch
    # (parallel/spmd.py): none in training; the byte count in validation.
    ROW_SUMS: tuple = ()
    ROW_COUNTS: tuple = ()
    ROW_EVAL: tuple = ("byte_count",)

    def __init__(self, hparams=None):
        self.hp = hparams

    def _chunked(self, model) -> bool:
        return bool(getattr(self.hp, "loss_chunk_size", 0)) and hasattr(
            type(model), "forward_hidden")

    @staticmethod
    def _moe_on(model) -> bool:
        return getattr(model.hparams, "num_experts", 0) > 1

    def _nll_sums(self, model, ids, deterministic: bool,
                  generator: Optional[torch.Generator],
                  moe_stats: Optional[list] = None):
        """(nll_sum, token_count) of one batch of token ids [B, L]; the
        dropout (deterministic False) applies on the chunked path only.
        moe_stats: a list the MoE layers' statistics are appended to."""
        if self._chunked(model):
            group = getattr(model, "seq_group", None)
            if generator is not None and group is not None:
                # Length shards hold different tokens: the dropout stream
                # folds by the seq shard, or every shard would drop the
                # same positions.
                from ..parallel.spmd import fold_generator
                generator = fold_generator(generator, group.rank)
            hidden = model.forward_hidden(ids, deterministic, generator,
                                          moe_stats=moe_stats)
            return model.sequence_nll(hidden, model.labels_for(ids))
        logits = (model(ids) if moe_stats is None
                  else model(ids, moe_stats=moe_stats))
        nll, mask = token_nll(logits[:, :-1], ids[:, 1:], reduce=False)
        return nll.sum(), mask.sum()

    def loss_sums(self, model, batch: dict, noise: Optional[dict] = None,
                  generator: Optional[torch.Generator] = None
                  ) -> Tuple[Dict[str, torch.Tensor],
                             Dict[str, torch.Tensor]]:
        """(differentiable sums, counts) of one batch {"token_ids":
        [B, L], ...}: {"nll_sum"}, {"token_count"}, and an MoE model's
        balance statistics (`moe_loss_terms`)."""
        stats = [] if self._moe_on(model) else None
        nll_sum, count = self._nll_sums(model, batch["token_ids"], False,
                                        generator, stats)
        sums, counts = {"nll_sum": nll_sum}, {"token_count": count.float()}
        if stats is not None:
            moe_loss_terms(collect_moe_stats(stats), sums, counts)
        return sums, counts

    @staticmethod
    def sum_names(rows: int) -> Tuple[tuple, tuple]:
        """The names of loss_sums' sums and counts without experts."""
        return ("nll_sum",), ("token_count",)

    def compose_loss(self, sums, counts, step):
        """(loss, metrics): the NLL per real token, plus the MoE balance
        losses where the sums hold them."""
        nll = sums["nll_sum"] / counts["token_count"].clamp_min(1.0)
        loss, metrics = nll, {"train_nll": nll}
        if "moe_imp_sum" in sums:
            extra, moe_metrics = compose_moe_losses(
                sums, counts, getattr(self.hp, "moe_aux_weight", 1e-2),
                getattr(self.hp, "moe_zloss_weight", 1e-3))
            loss = nll + extra
            metrics.update(moe_metrics)
        return loss, metrics

    def loss(self, model, batch, step, noise=None, generator=None):
        sums, counts = self.loss_sums(model, batch, noise, generator)
        return self.compose_loss(sums, counts, step)

    def eval_stats(self, model, batch: dict, noise: Optional[dict] = None,
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, torch.Tensor]:
        """Validation sums of one batch {"token_ids", "num_bytes", ...},
        without dropout, to be summed over batches and reduced by
        `reduce_eval`. Call under torch.no_grad."""
        nll_sum, count = self._nll_sums(model, batch["token_ids"], True,
                                        None)
        return {"nll_sum": nll_sum, "token_count": count,
                "byte_count": batch["num_bytes"].sum().float(),
                "loss_sum": nll_sum}

    @staticmethod
    def reduce_eval(stats: Dict[str, float]) -> Dict[str, float]:
        """val_nll (per token), val_bpb (bits per byte) and val_loss from
        `eval_stats` summed over the validation batches."""
        tokens = max(stats["token_count"], 1.0)
        return {"val_nll": stats["nll_sum"] / tokens,
                "val_bpb": stats["nll_sum"] / max(stats["byte_count"], 1.0)
                / math.log(2.0),
                "val_loss": stats["loss_sum"] / tokens}
