"""Decoder-only causal transformer language model: the pieces the VAE
shares (port of sparse_vae_tpu/models/transformer_lm.py: `embed`,
`pre_logits`, the tied `project`, `sequence_nll`, `sequence_ll_rows`,
`shifted_labels` / `labels_for` and `init_caches`).

Ported configurations: tied input/output embedding with
d_embedding == d_model, dense FFNs, no decoder cross-attention, one
device or a length axis sharded over a `seq` group (`bind_seq_group`,
through parallel.sp.sp_localize). The model computes in `compute_dtype`
(default: its parameters' dtype); models/base.py states the rule.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import ce_kernel
from ..ops.ce_kernel import FusedTiedCrossEntropy
from ..ops.cross_entropy import chunked_nll_rows
from .base import LAYER_NORM_EPS, LanguageModelHparams, LayerNorm, Linear
from .transformer_layer import TransformerLayer


@dataclass
class TransformerHparams(LanguageModelHparams):
    d_embedding: Optional[int] = None   # None => d_model
    d_model: int = 512
    num_heads: int = 8
    num_layers: int = 6
    # Read by the Transformer LM family; the VAE trains without dropout
    # in both packages.
    input_dropout: float = 0.0
    tie_embedding_weights: bool = True
    cross_attention: bool = False
    # Rematerialisation (the JAX package's jax.checkpoint policy): read,
    # not applied; it trades memory for time and changes no value.
    grad_checkpointing: bool = False
    separate_context_embedding: bool = True
    attn_window_size: int = 2           # in attn_block_size blocks
    attn_block_size: int = 128
    sparse_self_attention: bool = True
    loss_chunk_size: int = 0            # > 0: chunked projection + CE
    use_pallas_kernel: bool = True      # here: the port's CUDA kernels
    precision: str = "fp32"
    remat_policy: str = "full"
    tp_size: int = 1
    sp_size: int = 1                    # set by parallel.sp.sp_localize
    num_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 1e-2
    moe_zloss_weight: float = 1e-3
    ep_size: int = 1

    def check_ported(self):
        """Raise for a configuration this port does not run yet."""
        unported = {
            "d_embedding != d_model": self.d_embedding not in (
                None, self.d_model),
            "untied output embedding": not self.tie_embedding_weights,
            "cross_attention": self.cross_attention,
            "tensor parallelism": self.tp_size > 1,
            "mixture-of-experts FFNs (sparse_vae_tpu/models/moe.py)":
                self.num_experts > 1,
            "expert parallelism (sparse_vae_tpu/parallel/ep.py)":
                self.ep_size > 1,
        }
        bad = [name for name, on in unported.items() if on]
        if bad:
            raise NotImplementedError(f"not ported yet: {', '.join(bad)}")


class TransformerLanguageModel(nn.Module):
    def __init__(self, hparams: TransformerHparams):
        super().__init__()
        hparams.check_ported()
        if hparams.sp_size != 1:
            raise ValueError(
                "build the model with sp_size 1 and bind it to a seq group "
                "with parallel.sp.sp_localize, which sets sp_size")
        hp = self.hparams = hparams
        self.seq_group = None       # a parallel.group.SeqGroup when bound
        # None: compute in the parameters' dtype. Training sets bf16 over
        # fp32 master parameters (checkpoint.load_run(train=True)).
        self.compute_dtype: Optional[torch.dtype] = None
        self.input_embedding = nn.Embedding(hp.vocab_size, hp.d_model)
        self.decoder_layers = nn.ModuleList([
            TransformerLayer(hp.d_model, hp.num_heads, causal=True,
                             sparse_self_attention=hp.sparse_self_attention,
                             window_size=hp.attn_window_size,
                             block_size=hp.attn_block_size,
                             use_kernel=hp.use_pallas_kernel)
            for _ in range(hp.num_layers)])
        self.head_dense = Linear(hp.d_model, hp.d_model)
        self.head_norm = LayerNorm(hp.d_model, eps=LAYER_NORM_EPS)
        self.output_bias = nn.Parameter(torch.zeros(hp.vocab_size))

    def bind_seq_group(self, group):
        """Shard the length axis over `group` (parallel/sp.py): the decoder
        attention takes the halo / [CLS] path and the labels shift across
        shards. The parameters do not change."""
        self.seq_group = group
        self.hparams = replace(self.hparams, sp_size=group.size)
        for layer in self.decoder_layers:
            layer.bind_seq_group(group)

    @property
    def dtype(self) -> torch.dtype:
        return self.compute_dtype or self.input_embedding.weight.dtype

    @property
    def device(self) -> torch.device:
        return self.input_embedding.weight.device

    def embed(self, token_ids):
        return self.input_embedding(token_ids).to(self.dtype)

    def table(self):
        """The tied output table in the compute dtype."""
        return self.input_embedding.weight.to(self.dtype)

    def pre_logits(self, h):
        """The head before the vocab projection: Dense -> GELU -> LN."""
        return self.head_norm(F.gelu(self.head_dense(h), approximate="tanh"))

    def project(self, h):
        """Head + tied output projection, [..., D] -> fp32 [..., V]. The
        product rounds to the compute dtype before the fp32 bias is added,
        as the reference's bf16 dot plus fp32 bias does."""
        logits = F.linear(self.pre_logits(h), self.table())
        return logits.float() + self.output_bias.float()

    def _nll_rows(self, hidden, labels):
        """(per-row NLL sums [B], token_count) over non-pad labels without
        [B, L, V] logits. hidden: [B, L', D]; labels: [B, L'] (0 = pad).

        Where `ce_kernel.route` gives "kernel" (use_pallas_kernel, the
        reference's gate V % 1024 == 0, and the kernels' D = 512): flatten,
        the head on [T, D], then the fused tied CE (K3/K3b on the card,
        their plain versions on the CPU). Otherwise the chunked projection
        + CE; inside the gate at another width that runs on the CPU only
        (`ce_kernel.take_plain_route`)."""
        hp = self.hparams
        route = (ce_kernel.route(True, hp.vocab_size, hp.d_model)
                 if hp.use_pallas_kernel else "outside")
        if route == "kernel":
            b, length, d = hidden.shape
            g = self.pre_logits(hidden.reshape(b * length, d))
            flat = labels.reshape(-1)
            nll = FusedTiedCrossEntropy.apply(
                g.contiguous(), self.table(), self.output_bias.float(),
                flat)
            mask = (flat != 0).float()
            return (nll * mask).reshape(b, length).sum(-1), mask.sum()
        if route == "plain":
            ce_kernel.take_plain_route(hidden.device, hp.d_model)
        return chunked_nll_rows(hidden, self.project, labels,
                                hp.loss_chunk_size or 2048)

    def sequence_nll(self, hidden, labels):
        """(nll_sum, token_count) over non-pad labels without [B, L, V]
        logits (`_nll_rows` summed)."""
        rows, count = self._nll_rows(hidden, labels)
        return rows.sum(), count

    def sequence_ll_rows(self, hidden, labels):
        """Per-row summed log p(labels | hidden) over non-pad labels, [B]
        fp32 (the per-document statistic of the IWAE bound)."""
        return -self._nll_rows(hidden, labels)[0]

    @staticmethod
    def shifted_labels(token_ids):
        """Next-token labels aligned with the full-length hidden states:
        position t's label is token t+1, with [PAD] = 0 at the last
        position."""
        return F.pad(token_ids[:, 1:], (0, 1))

    def labels_for(self, token_ids):
        """Next-token labels for this module's layout: the end-padded
        shift on one device; under sequence parallelism each shard's last
        label is its right neighbour's first token."""
        if self.seq_group is not None:
            from ..parallel.sp import sp_shifted_labels
            return sp_shifted_labels(token_ids, self.seq_group)
        return self.shifted_labels(token_ids)

    def init_caches(self, batch_size: int, max_length: int) -> list:
        return [layer.init_cache(batch_size, max_length, self.device,
                                 self.dtype)
                for layer in self.decoder_layers]
