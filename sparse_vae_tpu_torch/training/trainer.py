"""The training harness (port of sparse_vae_tpu/training/trainer.py).

A host loop around `train_step`: one optimizer step per group of
`accumulate_grad_batches` micro-batches of one (rows, L) shape, the lr
scaled by the square root of the tokens a step takes and decayed on the
cosine schedule, validation every `val_check_interval` of an epoch
(token-weighted val_nll, val_bpb, val_loss and, for a VAE, val_kl), early
stopping armed after the KL annealing, checkpoints every N steps and at
the best validation metric, the sampling callback every
`sample_every_n_steps` (an unconditional sample and, for a VAE, the
reconstruction of the last batch's first document with its BLEU-2 as
`train_bleu`, when `log_samples` and the callbacks are given), and the
`lr_schedule_complete` and `max_steps` stops.

Batches are numpy on the host (data/batching.py); a group is copied to the
device once and split into its micro-batches there. Each group's shape is
one length bucket's, so the kernels see every bucket's shape, from many
short rows to one long one.

Random streams, each a function of the seed: the initialisation draws
from a CPU torch.Generator, the ELBO noise from a generator on the device
whose state the checkpoints carry, validation at step s from a
generator seeded from (seed, s), so two validations of the same
parameters at the same step agree bit for bit, and the sampling callback
at step s from the sampling seed derived from (seed, s).

On a mesh (parallel/mesh.py: `data` x `model`, `data` x `seq` x
`model` or `data` x `expert`, one process a rank, `mesh=` given;
trainer.num_devices, model_parallel, seq_parallel and expert_parallel
must describe it) every rank runs this loop on the same batches, planned
with rows a multiple of data x expert (and, on a seq mesh, lengths a
multiple of lcm(pad_to_multiple_of, seq x window x block), printed once:
a per-call override, the data hparams unchanged), and keeps its rows
(and its slice of their length); it holds its shard of the parameters
and of the optimizer state (parallel.spmd.localize: the JAX
initialisation drawn whole on every rank, then cut), steps through the
mesh step, validates through the mesh's summed eval statistics on the
global batch's noise, and saves checkpoints gathered to the
single-device format, which rank 0 writes: a mesh run's checkpoint loads
on one device (checkpoint.load_run), and a resume cuts it again. Rank 0 alone logs, samples (on the gathered model)
and profiles. fit's outcome holds the gathered model on every rank.

Resuming restores the parameters, the optimizer, the step and the noise
generator, and then does what the JAX trainer does: the data stream starts
again at epoch 0 with seed + 0, the partial accumulation groups, the best
metric and the patience start empty. A resumed run therefore does not see
the batches an unbroken run would have seen next.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..checkpoint import model_from_hparams
from ..data.text_data_module import TextDataModule
from ..models.base import resolve_device
from ..parallel.sp import sp_pad_multiple
from ..utils.config import TrainerHparams, to_dict
from ..utils.math_utils import bleu_score_corpus
from ..utils.metrics import MetricsWriter
from ..utils.profiling import start_trace, stop_trace
from ..utils.schedules import scaled_lr
from ..utils.seeds import derived_seed
from .checkpointing import CheckpointManager, run_dir
from .optimizer import make_optimizer
from .train_step import train_step


@dataclass
class TrainOutcome:
    step: int
    best_metric: Optional[float]
    stopped_reason: str
    model: Any
    metrics_history: list


# The streams under the run's seed (derived_seed keys).
INIT_STREAM, NOISE_STREAM, VALIDATION_STREAM, SAMPLING_STREAM = 0, 1, 2, 3


def stack_microbatches(batches: list) -> dict:
    """k same-shape TextBatches as [k, rows, ...] arrays (the JAX
    package's parallel/spmd.py::stack_microbatches)."""
    return {"token_ids": np.stack([b.token_ids for b in batches]),
            "num_tokens": np.stack([b.num_tokens for b in batches]),
            "num_bytes": np.stack([b.num_bytes for b in batches])}


def defer_accum_groups(batch_iter, k: int, pending: Dict[tuple, list]):
    """Collect same-shape TextBatches into full groups of k, keeping a
    partial group in `pending` (keyed by the token_ids shape) for a later
    call, typically the next epoch, rather than emitting a smaller one.
    Yields (stacked arrays [k, rows, L], the group's last TextBatch)."""
    for batch in batch_iter:
        key = batch.token_ids.shape
        pending.setdefault(key, []).append(batch)
        if len(pending[key]) == k:
            group = pending.pop(key)
            yield stack_microbatches(group), group[-1]


def early_stop_start_step(thp: TrainerHparams, hp) -> int:
    """The first step at which early stopping is armed: the explicit
    `early_stopping_start_step`, else the end of the KL annealing when the
    KL weight moves (validation NLL is not comparable across steps while
    it does), else 0."""
    if thp.early_stopping_start_step is not None:
        return int(thp.early_stopping_start_step)
    ws = getattr(hp, "kl_weight_start", None)
    we = getattr(hp, "kl_weight_end", None)
    if ws is not None and we is not None and we != ws:
        return int(getattr(hp, "kl_annealing_steps", 0) or 0)
    return 0


def check_layout(thp: TrainerHparams, mesh=None):
    """Raise for a mesh that is not the one the trainer hparams describe,
    or a layout that needs a mesh and has none."""
    from ..parallel.mesh import EXPERT, MODEL, SEQ
    want = (thp.num_devices, thp.model_parallel, thp.expert_parallel,
            thp.seq_parallel)
    if mesh is None:
        if (thp.num_devices or 1) > 1 or want[1:] != (1, 1, 1):
            raise ValueError(
                f"num_devices={thp.num_devices}, model_parallel="
                f"{thp.model_parallel}, expert_parallel="
                f"{thp.expert_parallel}, seq_parallel={thp.seq_parallel} "
                "need a mesh: start the ranks with `python -m "
                "sparse_vae_tpu_torch.train <experiment> "
                "trainer.num_devices=N ...` (which spawns them) or under "
                "torchrun")
        return
    have = (mesh.world.size, mesh.size(MODEL), mesh.size(EXPERT),
            mesh.size(SEQ))
    if have[1:] != want[1:] or want[0] not in (None, have[0]):
        raise ValueError(f"the mesh has (ranks, model, expert, seq) = "
                         f"{have}, the trainer hparams ask for {want}")


class Trainer:
    def __init__(
        self,
        model_hparams,
        objective,
        data: TextDataModule,
        trainer_hparams: Optional[TrainerHparams] = None,
        experiment: str = "transformer-vae",
        name: str = "default",
        log_root: Optional[Path] = None,
        enable_logging: bool = True,
        device="cuda",
        sample_fn: Optional[Callable] = None,
        reconstruct_fn: Optional[Callable] = None,
        mesh=None,
    ):
        self.hp = model_hparams
        self.objective = objective
        self.data = data
        self.thp = trainer_hparams or TrainerHparams()
        check_layout(self.thp, mesh)
        self.mesh = mesh
        self.rank0 = mesh is None or mesh.world.rank == 0
        self._rows_multiple = 1 if mesh is None else mesh.row_shards
        # A per-call override of the bucket quantum: the data hparams are
        # not changed.
        seq = 1 if mesh is None else mesh.size("seq")
        cur = data.hparams.pad_to_multiple_of
        pad = sp_pad_multiple(model_hparams, seq, cur) if seq > 1 else cur
        self._pad_multiple = None if pad == cur else pad
        if self._pad_multiple is not None and self.rank0:
            print(f"seq_parallel={seq}: padding batch lengths to multiples "
                  f"of {pad} (was {cur})", flush=True)
        self.device = resolve_device(device) if mesh is None \
            else mesh.device
        self.experiment = experiment
        self.name = name
        self.sample_fn = sample_fn
        self.reconstruct_fn = reconstruct_fn
        self._pending_groups: Dict[tuple, list] = {}
        self._val_batches: Optional[list] = None

        self.run_dir = run_dir(experiment, name, log_root)
        logging = enable_logging and self.rank0
        self.writer = MetricsWriter(self.run_dir if logging else None,
                                    enabled=logging)
        self.ckpt = CheckpointManager(experiment, name, log_root) \
            if enable_logging else None
        tokens_per_step = (self.data.hparams.tokens_per_batch
                           * self.thp.accumulate_grad_batches)
        self.lr = scaled_lr(self.hp.lr, tokens_per_step,
                            self.hp.base_batch_size)

    # -- setup --------------------------------------------------------------
    def init_state(self, generator: torch.Generator):
        """(model, optimizer): the JAX package's initialisation drawn from
        `generator` (a CPU generator), fp32 master parameters computing in
        the hparams' precision on the trainer's device, and RAdam behind
        the global-norm clip at the scaled lr."""
        model, _ = model_from_hparams(self.hp, generator, self.device,
                                      train=True)
        norm_fn, sizes = None, {}
        if self.mesh is not None:
            from ..parallel.mesh import EXPERT, MODEL
            from ..parallel.spmd import localize, mesh_norm_fn
            model = localize(model, self.mesh)
            norm_fn = mesh_norm_fn(model, self.mesh)
            sizes = {"tp_size": self.mesh.size(MODEL),
                     "ep_size": self.mesh.size(EXPERT)}
        optimizer = make_optimizer(
            model.parameters(), lr=self.lr,
            lr_decay_steps=self.hp.lr_decay_steps,
            grad_clip_threshold=self.hp.grad_clip_threshold,
            weight_decay=self.hp.weight_decay, lamb=self.hp.lamb,
            norm_fn=norm_fn, **sizes)
        return model, optimizer

    def _to_device(self, arrays: dict) -> dict:
        return {k: torch.from_numpy(v).to(self.device, torch.int64)
                for k, v in arrays.items()}

    def _accum_groups(self, seed: int):
        """The epoch's batches in full groups of accumulate_grad_batches
        of one shape; partial groups wait in `_pending_groups` for the
        next epoch's batches of their shape (defer_accum_groups), so every
        step of a bucket has the one [k, rows, L] shape, and at most k - 1
        micro-batches a bucket go unused at the end of training."""
        yield from defer_accum_groups(
            self.data.epoch_batches("train", seed=seed,
                                    rows_multiple_of=self._rows_multiple,
                                    pad_to_multiple_of=self._pad_multiple),
            self.thp.accumulate_grad_batches, self._pending_groups)

    def _local_rows(self, arrays: dict, stacked: bool = False) -> dict:
        """This rank's part of a batch on a mesh (its rows; on a seq mesh
        its slice of their length); the batch itself on one device."""
        if self.mesh is None:
            return arrays
        from ..parallel.mesh import shard_batch
        return shard_batch(arrays, self.mesh, stacked)

    def _step(self, model, optimizer, stacked: dict, step: int,
              generator: torch.Generator) -> dict:
        """One optimizer step on a group [k, rows, L] (on a mesh, this
        rank's rows of it)."""
        arrays = self._to_device(self._local_rows(stacked, stacked=True))
        microbatches = [{name: arr[i] for name, arr in arrays.items()}
                        for i in range(arrays["token_ids"].shape[0])]
        return train_step(model, self.objective, optimizer, microbatches,
                          step, generator=generator)

    # -- validation ---------------------------------------------------------
    def validate(self, model, generator: Optional[torch.Generator] = None,
                 max_batches: Optional[int] = None,
                 step: int = 0) -> Dict[str, float]:
        """Validation metrics of `model` on the test split, a function of
        (parameters, data, step): the noise comes from a generator seeded
        from (seed, step) unless one is given. The validation batches are
        packed once (seed 0) and reused."""
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(
                derived_seed(self.thp.seed, VALIDATION_STREAM, step))
        limit = max_batches or self.thp.limit_val_batches
        if self._val_batches is None:
            self._val_batches = list(self.data.epoch_batches(
                "test", seed=0, rows_multiple_of=self._rows_multiple,
                pad_to_multiple_of=self._pad_multiple))
        totals: Dict[str, float] = {}
        with torch.no_grad():
            for i, batch in enumerate(self._val_batches):
                if limit is not None and i >= limit:
                    break
                if self.mesh is None:
                    stats = self.objective.eval_stats(
                        model, self._to_device(batch._asdict()),
                        generator=generator)
                else:
                    from ..parallel.spmd import mesh_eval_stats
                    local = self._to_device(self._local_rows(
                        {k: np.asarray(v)
                         for k, v in batch._asdict().items()}))
                    stats = mesh_eval_stats(self.objective, model, local,
                                            self.mesh, generator=generator)
                for k, v in stats.items():
                    totals[k] = totals.get(k, 0.0) + float(v)
        return {k: float(v) for k, v in
                self.objective.reduce_eval(totals).items()}

    # -- sampling callback --------------------------------------------------
    def _sampling_callback(self, model, step: int, last_batch):
        """With log_samples and a callback: up to two unconditional
        samples as `unconditional_sample` texts, and the reconstruction of
        `last_batch`'s first document (cli.make_sample_fns) with its BLEU-2
        against the original as `train_bleu` and both texts as
        `reconstruction`. A sampling exception is logged as
        `sampling_error`, and training goes on."""
        if not self.hp.log_samples or (self.sample_fn is None
                                       and self.reconstruct_fn is None):
            return
        if self.mesh is not None:
            model = self.full_model(model)   # every rank gathers
            if not self.rank0:
                return
        tokenizer = self.data.tokenizer
        seed = derived_seed(self.thp.seed, SAMPLING_STREAM, step)

        def decode(rows):
            return [tokenizer.decode([int(t) for t in row if t != 0])
                    for row in np.asarray(torch.as_tensor(rows).cpu())]

        if self.sample_fn is not None:
            try:
                tokens = self.sample_fn(model, seed, step=step)
            except Exception as e:  # sampling must never stop training
                self.writer.text("sampling_error", repr(e), step)
                tokens = None
            if tokens is not None:
                for text in decode(tokens)[:2]:
                    self.writer.text("unconditional_sample", text, step)

        if self.reconstruct_fn is not None and last_batch is not None:
            try:
                recon = self.reconstruct_fn(model, seed, last_batch,
                                            step=step)
            except Exception as e:
                self.writer.text("sampling_error", repr(e), step)
                recon = None
            if recon is not None:
                original = last_batch.token_ids[0][
                    :int(last_batch.num_tokens[0])]
                original_str = tokenizer.decode(
                    [int(t) for t in original if t != 0])
                recon_strs = decode(recon)
                bleu = bleu_score_corpus(
                    [s.split(" ") for s in recon_strs],
                    [[original_str.split(" ")]] * len(recon_strs), max_n=2)
                self.writer.scalar("train_bleu", bleu, step)
                msg = "**Original**:  \n" + original_str
                for i, s in enumerate(recon_strs, start=1):
                    msg += f"  \n**Reconstruction {i}**:  \n" + s
                self.writer.text("reconstruction", msg, step)

    # -- the loop -----------------------------------------------------------
    def fit(self, max_epochs: int = 10 ** 9,
            resume: bool = False) -> TrainOutcome:
        seed = self.thp.seed
        model, optimizer = self.init_state(
            torch.Generator().manual_seed(derived_seed(seed, INIT_STREAM)))
        generator = torch.Generator(device=self.device).manual_seed(
            derived_seed(seed, NOISE_STREAM))
        step = 0
        self._pending_groups = {}
        if resume and self.ckpt is not None:
            step = self.restore(model, optimizer, generator)

        k_accum = self.thp.accumulate_grad_batches
        num_train_batches = max(1, self.data.num_batches("train"))
        val_every = max(1, int(num_train_batches * self.thp.val_check_interval
                               / k_accum))
        self.val_every = val_every

        best_metric, patience_left = None, self.thp.early_stopping_patience
        history, stopped = [], "max_epochs"
        metric_name = self.hp.early_stopping_metric
        es_start = early_stop_start_step(self.thp, self.hp)
        t0, tokens_seen = time.time(), 0

        # A torch.profiler trace of a few steps after the first ones,
        # written as a Chrome trace under the run directory.
        profile_n = self.thp.profile_steps
        profile_start, profiler = (3 if step < 3 else step + 2), None

        for epoch in range(max_epochs):
            for stacked, batch in self._accum_groups(seed + epoch):
                tokens_seen += int(stacked["num_tokens"].sum())
                metrics = self._step(model, optimizer, stacked, step,
                                     generator)
                step += 1

                if (profile_n and self.rank0 and profiler is None
                        and step == profile_start):
                    profiler = start_trace(self.device)
                elif (profiler is not None
                      and step >= profile_start + profile_n):
                    self._stop_profile(profiler, profile_start, step)
                    profiler, profile_n = None, 0

                if step % self.thp.log_every_n_steps == 0:
                    logged = {k: float(v) for k, v in metrics.items()}
                    elapsed = max(time.time() - t0, 1e-6)
                    logged["tokens_per_sec"] = tokens_seen / elapsed
                    self.writer.scalars(logged, step)

                if step % self.thp.sample_every_n_steps == 0:
                    self._sampling_callback(model, step, batch)

                if (self.ckpt is not None
                        and step % self.thp.checkpoint_every_n_steps == 0):
                    self._save(model, optimizer, step, generator)

                if step % val_every == 0:
                    val_metrics = self.validate(model, step=step)
                    self.writer.scalars(val_metrics, step)
                    history.append({"step": step, **val_metrics})
                    monitored = val_metrics.get(metric_name)
                    if monitored is not None and step >= es_start:
                        if best_metric is None or monitored < best_metric:
                            best_metric = monitored
                            patience_left = self.thp.early_stopping_patience
                            if self.ckpt is not None:
                                self._save(model, optimizer, step,
                                           generator, best=True)
                        else:
                            patience_left -= 1
                            if patience_left <= 0:
                                stopped = "early_stopping"
                                break

                if (self.hp.lr_decay_steps
                        and step >= self.hp.lr_decay_steps):
                    stopped = "lr_schedule_complete"
                    break
                if self.thp.max_steps and step >= self.thp.max_steps:
                    stopped = "max_steps"
                    break
            else:
                continue
            break

        if profiler is not None:
            self._stop_profile(profiler, profile_start, step)
        leftover = sum(len(g) for g in self._pending_groups.values())
        if leftover and self.rank0:
            print(f"fit: {leftover} deferred microbatch(es) left unused at "
                  "training end (partial accumulation groups; see "
                  "_accum_groups)")
        if self.ckpt is not None:
            self._save(model, optimizer, step, generator)
        self.writer.close()
        if self.mesh is not None:
            model = self.full_model(model)
        return TrainOutcome(step=step, best_metric=best_metric,
                            stopped_reason=stopped, model=model,
                            metrics_history=history)

    def _stop_profile(self, profiler, first: int, last: int):
        stop_trace(profiler, self.device,
                   self.run_dir / f"trace_steps_{first}-{last}.json")

    # -- checkpoints --------------------------------------------------------
    def meta(self) -> dict:
        return {"experiment": self.experiment, "name": self.name,
                "model_hparams": to_dict(self.hp),
                "data_hparams": to_dict(self.data.hparams),
                "trainer_hparams": to_dict(self.thp)}

    def full_model(self, model):
        """The single-device model of a mesh rank's shard: every sharded
        parameter gathered (every rank calls this)."""
        from ..parallel.spmd import gather_full_state
        from ..parallel.tp import localized_twin
        return localized_twin(model, self.hp,
                              gather_full_state(model, self.mesh))

    def state(self, model, optimizer, step: int,
              generator: torch.Generator) -> dict:
        """What a checkpoint holds (training/checkpointing.py), in the
        single-device format: on a mesh the parameters and the optimizer's
        moments gathered (every rank calls this)."""
        params, opt = model.state_dict(), optimizer.state_tensors()
        if self.mesh is not None:
            from ..parallel.spmd import (gather_full_state,
                                         gather_optimizer_state)
            params = gather_full_state(model, self.mesh)
            opt = gather_optimizer_state(model, self.mesh, opt)
        return {"params": params, "optimizer": opt, "step": step,
                "generator": generator.get_state()}

    def _save(self, model, optimizer, step, generator, best: bool = False):
        state = self.state(model, optimizer, step, generator)
        if self.rank0:
            self.ckpt.save(step, state, meta=self.meta(), best=best)
        if self.mesh is not None:
            from ..parallel.group import barrier
            barrier(self.mesh.world)    # written before any rank reads it

    def restore(self, model, optimizer, generator,
                step: Optional[int] = None) -> int:
        """Load the checkpoint at `step` (default the newest) into model,
        optimizer and generator, on a mesh each rank's shard of it;
        returns its step."""
        state = self.ckpt.restore(step, map_location=self.device)
        params, opt = state["params"], state["optimizer"]
        if self.mesh is not None:
            from ..parallel.spmd import (shard_full_state,
                                         shard_optimizer_state)
            params = shard_full_state(model, self.mesh, params)
            opt = shard_optimizer_state(model, self.mesh, opt)
        model.load_state_dict(params, strict=True)
        optimizer.load_state_tensors(opt)
        generator.set_state(state["generator"].cpu())
        return int(state["step"])
