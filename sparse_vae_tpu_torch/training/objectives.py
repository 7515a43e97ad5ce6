"""The autoregressive objective of the language-model families (port of
sparse_vae_tpu/training/objectives.py): `ARObjective` and `batch_arrays`.

Teacher-forced next-token NLL over non-pad tokens, for training (the
per-token mean) and validation (the summed statistics of token-weighted
val_nll and val_bpb). With `loss_chunk_size` set and a model that has
`forward_hidden`, the head and the loss run over the hidden states
(`sequence_nll`: the fused tied CE, K3/K3b on the card) so [B, L, V]
logits never exist; otherwise the full logits go through `token_nll`.
As in the reference, `loss_sums` returns numerator sums and count
denominators and `compose_loss` divides them, linear in the sums.

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
        if getattr(hparams, "num_experts", 0) > 1:
            raise NotImplementedError(
                "mixture-of-experts losses are not ported yet: "
                "sparse_vae_tpu/models/moe.py")

    def _chunked(self, model) -> bool:
        return bool(getattr(self.hp, "loss_chunk_size", 0)) and hasattr(
            type(model), "forward_hidden")

    @staticmethod
    def _check_device_layout(model):
        if getattr(model, "seq_group", None) is not None:
            raise NotImplementedError(
                "the language-model objective over a seq group "
                "(sparse_vae_tpu/training/objectives.py ARObjective with "
                "sp_size > 1, parallel/spmd.py) is not ported yet")

    def _nll_sums(self, model, ids, deterministic: bool,
                  generator: Optional[torch.Generator]):
        """(nll_sum, token_count) of one batch of token ids [B, L]; the
        dropout (deterministic False) applies on the chunked path only."""
        self._check_device_layout(model)
        if self._chunked(model):
            hidden = model.forward_hidden(ids, deterministic, generator)
            return model.sequence_nll(hidden, model.labels_for(ids))
        logits = model(ids)
        nll, mask = token_nll(logits[:, :-1], ids[:, 1:], reduce=False)
        return nll.sum(), mask.sum()

    def loss_sums(self, model, batch: dict, noise: Optional[dict] = None,
                  generator: Optional[torch.Generator] = None
                  ) -> Tuple[Dict[str, torch.Tensor],
                             Dict[str, torch.Tensor]]:
        """(differentiable sums, counts) of one batch {"token_ids":
        [B, L], ...}: {"nll_sum"}, {"token_count"}."""
        nll_sum, count = self._nll_sums(model, batch["token_ids"], False,
                                        generator)
        return {"nll_sum": nll_sum}, {"token_count": count.float()}

    def compose_loss(self, sums, counts, step):
        """(loss, metrics): the NLL per real token."""
        nll = sums["nll_sum"] / counts["token_count"].clamp_min(1.0)
        return nll, {"train_nll": nll}

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
