"""The training harness (port of sparse_vae_tpu/training/trainer.py, its
single-device path).

A host loop around `train_step`: one optimizer step per group of
`accumulate_grad_batches` micro-batches of one (rows, L) shape, the lr
scaled by the square root of the tokens a step takes and decayed on the
cosine schedule, validation every `val_check_interval` of an epoch
(token-weighted val_nll, val_bpb, val_kl, val_loss), early stopping armed
after the KL annealing, checkpoints every N steps and at the best
validation metric, and the `lr_schedule_complete` and `max_steps` stops.

Batches are numpy on the host (data/batching.py); a group is copied to the
device once and split into its micro-batches there. Each group's shape is
one length bucket's, so the kernels see every bucket's shape, from many
short rows to one long one.

Random streams, each a function of the seed: the initialisation draws
from a CPU torch.Generator, the ELBO noise from a generator on the device
whose state the checkpoints carry, and validation at step s from a
generator seeded from (seed, s), so two validations of the same
parameters at the same step agree bit for bit.

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
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..checkpoint import model_from_hparams
from ..data.text_data_module import TextDataModule
from ..models.base import resolve_device
from ..utils.config import TrainerHparams, to_dict
from ..utils.metrics import MetricsWriter
from ..utils.schedules import scaled_lr
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


def derived_seed(seed: int, *keys: int) -> int:
    """A 64-bit seed for the stream named by `keys` under `seed`."""
    return int(np.random.SeedSequence([seed, *keys]).generate_state(
        1, np.uint64)[0])


# The streams under the run's seed (derived_seed keys).
INIT_STREAM, NOISE_STREAM, VALIDATION_STREAM = 0, 1, 2


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


def check_single_device(thp: TrainerHparams):
    """Raise for a device mesh this trainer does not run."""
    if (thp.num_devices or 1) > 1:
        raise NotImplementedError(
            f"num_devices={thp.num_devices}: the data-parallel mesh "
            "(sparse_vae_tpu/training/trainer.py Trainer.__init__ with a "
            "mesh, sparse_vae_tpu/parallel/spmd.py) is not ported; this "
            "trainer runs on one device")
    if thp.seq_parallel > 1:
        raise NotImplementedError(
            f"seq_parallel={thp.seq_parallel}: fit over a seq mesh "
            "(sparse_vae_tpu/training/trainer.py:146-163, "
            "sparse_vae_tpu/parallel/spmd.py) is not ported; train "
            "sequence-parallel steps with `python -m "
            "sparse_vae_tpu_torch.train transformer-vae <run-name> sp=N`")
    if thp.model_parallel > 1 or thp.expert_parallel > 1:
        raise NotImplementedError(
            f"model_parallel={thp.model_parallel}, expert_parallel="
            f"{thp.expert_parallel}: sparse_vae_tpu/parallel/tp.py and "
            "ep.py are not ported")


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
    ):
        self.hp = model_hparams
        self.objective = objective
        self.data = data
        self.thp = trainer_hparams or TrainerHparams()
        check_single_device(self.thp)
        self.device = resolve_device(device)
        self.experiment = experiment
        self.name = name
        self._pending_groups: Dict[tuple, list] = {}
        self._val_batches: Optional[list] = None

        self.run_dir = run_dir(experiment, name, log_root)
        self.writer = MetricsWriter(self.run_dir if enable_logging else None,
                                    enabled=enable_logging)
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
        optimizer = make_optimizer(
            model.parameters(), lr=self.lr,
            lr_decay_steps=self.hp.lr_decay_steps,
            grad_clip_threshold=self.hp.grad_clip_threshold,
            weight_decay=self.hp.weight_decay, lamb=self.hp.lamb)
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
            self.data.epoch_batches("train", seed=seed),
            self.thp.accumulate_grad_batches, self._pending_groups)

    def _step(self, model, optimizer, stacked: dict, step: int,
              generator: torch.Generator) -> dict:
        """One optimizer step on a group [k, rows, L]."""
        arrays = self._to_device(stacked)
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
            self._val_batches = list(self.data.epoch_batches("test",
                                                             seed=0))
        totals: Dict[str, float] = {}
        with torch.no_grad():
            for i, batch in enumerate(self._val_batches):
                if limit is not None and i >= limit:
                    break
                stats = self.objective.eval_stats(
                    model, self._to_device(batch._asdict()),
                    generator=generator)
                for k, v in stats.items():
                    totals[k] = totals.get(k, 0.0) + float(v)
        return {k: float(v) for k, v in
                self.objective.reduce_eval(totals).items()}

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
        if self.hp.log_samples:
            print("fit: samples and train_bleu are not logged: "
                  "TransformerVAE.sample is not ported", flush=True)
        if self.hp.grad_checkpointing:
            print(f"fit: grad_checkpointing (remat_policy="
                  f"{self.hp.remat_policy!r}) is not applied: remat is not "
                  "ported (ROADMAP.md Queue 1 item 1), so the backward keeps "
                  "every activation", flush=True)

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
            for stacked, _ in self._accum_groups(seed + epoch):
                tokens_seen += int(stacked["num_tokens"].sum())
                metrics = self._step(model, optimizer, stacked, step,
                                     generator)
                step += 1

                if profile_n and profiler is None and step == profile_start:
                    profiler = self._start_profile()
                elif (profiler is not None
                      and step >= profile_start + profile_n):
                    self._stop_profile(profiler, profile_start, step)
                    profiler, profile_n = None, 0

                if step % self.thp.log_every_n_steps == 0:
                    logged = {k: float(v) for k, v in metrics.items()}
                    elapsed = max(time.time() - t0, 1e-6)
                    logged["tokens_per_sec"] = tokens_seen / elapsed
                    self.writer.scalars(logged, step)

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
        if leftover:
            print(f"fit: {leftover} deferred microbatch(es) left unused at "
                  "training end (partial accumulation groups; see "
                  "_accum_groups)")
        if self.ckpt is not None:
            self._save(model, optimizer, step, generator)
        self.writer.close()
        return TrainOutcome(step=step, best_metric=best_metric,
                            stopped_reason=stopped, model=model,
                            metrics_history=history)

    def _start_profile(self):
        from torch.profiler import ProfilerActivity, profile
        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        profiler = profile(activities=activities)
        profiler.__enter__()
        return profiler

    def _stop_profile(self, profiler, first: int, last: int):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        profiler.__exit__(None, None, None)
        self.run_dir.mkdir(parents=True, exist_ok=True)
        profiler.export_chrome_trace(
            str(self.run_dir / f"trace_steps_{first}-{last}.json"))

    # -- checkpoints --------------------------------------------------------
    def meta(self) -> dict:
        return {"experiment": self.experiment, "name": self.name,
                "model_hparams": to_dict(self.hp),
                "data_hparams": to_dict(self.data.hparams),
                "trainer_hparams": to_dict(self.thp)}

    def state(self, model, optimizer, step: int,
              generator: torch.Generator) -> dict:
        """What a checkpoint holds (training/checkpointing.py)."""
        return {"params": model.state_dict(),
                "optimizer": optimizer.state_tensors(), "step": step,
                "generator": generator.get_state()}

    def _save(self, model, optimizer, step, generator, best: bool = False):
        self.ckpt.save(step, self.state(model, optimizer, step, generator),
                       meta=self.meta(), best=best)

    def restore(self, model, optimizer, generator,
                step: Optional[int] = None) -> int:
        """Load the checkpoint at `step` (default the newest) into model,
        optimizer and generator; returns its step."""
        state = self.ckpt.restore(step, map_location=self.device)
        model.load_state_dict(state["params"], strict=True)
        optimizer.load_state_tensors(state["optimizer"])
        generator.set_state(state["generator"].cpu())
        return int(state["step"])
