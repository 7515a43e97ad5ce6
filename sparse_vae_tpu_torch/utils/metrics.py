"""The metrics writer (port of sparse_vae_tpu/utils/metrics.py, its JSONL
path): one JSON object a line in ``<run dir>/metrics.jsonl``,
{"t": unix time, "step": step, <name>: value} for a scalar, with the
JAX package's names (train_nll, train_kl, kl_weight, train_mc_mutual_info, loss,
grad_norm, tokens_per_sec, val_nll, val_bpb, val_kl, val_loss,
train_bleu, ...), and {"t", "step", "text_<tag>": content} for a text
(unconditional_sample, reconstruction, sampling_error).
"""
from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Optional


class MetricsWriter:
    def __init__(self, log_dir: Optional[Path], enabled: bool = True):
        self.enabled = enabled and log_dir is not None
        self._jsonl = None
        if not self.enabled:
            return
        log_dir = Path(log_dir)
        log_dir.mkdir(parents=True, exist_ok=True)
        self._jsonl = open(log_dir / "metrics.jsonl", "a")

    def _write(self, record: dict):
        if self._jsonl is not None:
            self._jsonl.write(json.dumps(record) + "\n")
            self._jsonl.flush()

    def scalar(self, name: str, value, step: int):
        if self.enabled:
            self._write({"t": time.time(), "step": step,
                         name: float(value)})

    def scalars(self, metrics: dict, step: int):
        for k, v in metrics.items():
            self.scalar(k, v, step)

    def text(self, tag: str, content: str, step: int):
        if self.enabled:
            self._write({"t": time.time(), "step": step,
                         "text_" + tag: content})

    def close(self):
        if self._jsonl is not None:
            self._jsonl.close()
            self._jsonl = None
