"""Checkpoints of a training run (port of
sparse_vae_tpu/training/checkpointing.py, without orbax).

The JAX package's layout: ``sparse-vae-logs/<experiment>/<name>/
checkpoints/step_<N>/`` per saved step, ``meta.json`` (the run's hparams)
and ``best.json`` ({"step": the best validation step}) beside them;
`latest_checkpoint_step` resolves the newest step, and the manager keeps
the `keep` newest steps plus the best one.

A step's directory holds one `torch.save` file, state.pt: the fp32
parameters, the optimizer's state (both RAdam moments of every parameter
and its step count), the step and the ELBO-noise torch.Generator's state.
That is everything a resume needs: the KL weight and the lr are functions
of the step, and an epoch's batches are a function of the seed and the
epoch (training/trainer.py).
"""
from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Any, Dict, Optional

import torch

STATE_FILE = "state.pt"


def run_dir(experiment: str, name: str, root: Optional[Path] = None) -> Path:
    root = root or (Path.cwd() / "sparse-vae-logs")
    return Path(root) / experiment / name


def checkpoints_dir(experiment: str, name: str,
                    root: Optional[Path] = None) -> Path:
    return run_dir(experiment, name, root) / "checkpoints"


def _steps(ckpt_dir: Path) -> list:
    steps = []
    if ckpt_dir.exists():
        for child in ckpt_dir.iterdir():
            if child.name.startswith("step_") and child.is_dir():
                try:
                    steps.append(int(child.name[len("step_"):]))
                except ValueError:
                    continue
    return sorted(steps)


def latest_checkpoint_step(ckpt_dir: Path) -> Optional[int]:
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def get_checkpoint_path_for_name(experiment: str, name: str,
                                 root: Optional[Path] = None) -> Path:
    """The newest step directory of a run."""
    ckpt_dir = checkpoints_dir(experiment, name, root)
    step = latest_checkpoint_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"No checkpoints under {ckpt_dir}")
    return ckpt_dir / f"step_{step}"


class CheckpointManager:
    def __init__(self, experiment: str, name: str,
                 root: Optional[Path] = None, keep: int = 3):
        self.dir = checkpoints_dir(experiment, name, root)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    def save(self, step: int, state: Dict[str, Any],
             meta: Optional[Dict[str, Any]] = None, best: bool = False):
        """Write `state` as step_<step>/state.pt (replacing one already
        there: written beside it, then renamed over it), the meta and, with
        `best`, best.json; then drop the old steps."""
        path = self.dir / f"step_{step}"
        path.mkdir(parents=True, exist_ok=True)
        tmp = path / (STATE_FILE + ".tmp")
        torch.save(state, tmp)
        tmp.replace(path / STATE_FILE)
        if meta is not None:
            (self.dir / "meta.json").write_text(json.dumps(meta, indent=2))
        if best:
            (self.dir / "best.json").write_text(json.dumps({"step": step}))
        self._gc(keep_step=step)

    def _gc(self, keep_step: int):
        """Remove every step but the `keep` newest, the best and
        `keep_step`."""
        best = self.best_step()
        for s in _steps(self.dir)[:-self.keep]:
            if s != best and s != keep_step:
                shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)

    def best_step(self) -> Optional[int]:
        best_file = self.dir / "best.json"
        if best_file.exists():
            return json.loads(best_file.read_text()).get("step")
        return None

    def restore(self, step: Optional[int] = None,
                map_location=None) -> Dict[str, Any]:
        """The state saved at `step` (default the newest)."""
        step = step if step is not None else latest_checkpoint_step(self.dir)
        if step is None:
            raise FileNotFoundError(f"No checkpoints under {self.dir}")
        return restore_checkpoint(self.dir / f"step_{step}", map_location)


def load_run_meta(experiment: str, name: str,
                  root: Optional[Path] = None) -> Optional[Dict[str, Any]]:
    """The run's saved hparams (meta.json), or None when absent."""
    meta_file = checkpoints_dir(experiment, name, root) / "meta.json"
    return json.loads(meta_file.read_text()) if meta_file.exists() else None


def restore_checkpoint(path: Path, map_location=None) -> Dict[str, Any]:
    """The state saved in a step directory. Only tensors, numbers,
    strings and containers of them are read (weights_only)."""
    return torch.load(Path(path) / STATE_FILE, map_location=map_location,
                      weights_only=True)
