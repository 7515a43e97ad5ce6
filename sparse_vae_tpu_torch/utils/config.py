"""Layered dataclass configuration (port of sparse_vae_tpu/utils/config.py).

Hparams are plain dataclasses merged from (1) code defaults, (2) a named
preset (hparam_presets.py) and (3) a command-line dotlist
(``model.d_model=256``). Values are coerced to the declared field types,
and an unknown key raises at once.
"""
from __future__ import annotations

import dataclasses
import json
import typing
from dataclasses import dataclass, fields, is_dataclass
from typing import Any, Dict, List, Optional, Union


def _strip_optional(tp):
    """Optional[T] -> T (other types unchanged)."""
    origin = typing.get_origin(tp)
    if origin is Union:
        args = [a for a in typing.get_args(tp) if a is not type(None)]
        if len(args) == 1:
            return args[0]
    return tp


def coerce_value(raw: Any, tp) -> Any:
    """A raw (usually string) command-line value in the declared type."""
    tp = _strip_optional(tp)
    if raw is None:
        return None
    if isinstance(raw, str):
        low = raw.strip().lower()
        if low in ("none", "null"):
            return None
        if tp is bool:
            if low in ("true", "1", "yes"):
                return True
            if low in ("false", "0", "no"):
                return False
            raise ValueError(f"Cannot parse {raw!r} as bool")
        if tp is int:
            return int(raw.replace("_", ""))
        if tp is float:
            return float(raw)
        if tp is str:
            return raw
        # Lists, tuples and dicts as JSON literals.
        try:
            return json.loads(raw)
        except (json.JSONDecodeError, ValueError):
            return raw
    if tp in (int, float, bool, str):
        return tp(raw)
    return raw


def parse_dotlist(items: List[str]) -> Dict[str, Any]:
    """['a.b=1', 'c=true'] -> {'a': {'b': '1'}, 'c': 'true'}; values stay
    raw."""
    out: Dict[str, Any] = {}
    for item in items:
        if "=" not in item:
            raise ValueError(
                f"Dotlist entry {item!r} must look like key=value")
        key, value = item.split("=", 1)
        node = out
        parts = key.strip().split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
            if not isinstance(node, dict):
                raise ValueError(f"Conflicting dotlist key {key!r}")
        node[parts[-1]] = value
    return out


def merge_into_dataclass(cfg, overrides: Dict[str, Any]):
    """A copy of dataclass `cfg` with `overrides` applied recursively; an
    unknown key raises ValueError."""
    if not overrides:
        return cfg
    valid = {f.name: f for f in fields(cfg)}
    updates = {}
    for key, value in overrides.items():
        if key not in valid:
            raise ValueError(
                f"Unknown hparam {key!r} for {type(cfg).__name__}; "
                f"valid keys: {sorted(valid)}")
        current = getattr(cfg, key)
        if is_dataclass(current) and isinstance(value, dict):
            updates[key] = merge_into_dataclass(current, value)
        elif isinstance(value, dict):
            updates[key] = value
        else:
            updates[key] = coerce_value(value, _resolve_type(cfg, key))
    return dataclasses.replace(cfg, **updates)


def _resolve_type(cfg, key):
    return typing.get_type_hints(type(cfg)).get(key, str)


def to_dict(cfg) -> Dict[str, Any]:
    if is_dataclass(cfg):
        return {f.name: to_dict(getattr(cfg, f.name)) for f in fields(cfg)}
    if isinstance(cfg, dict):
        return {k: to_dict(v) for k, v in cfg.items()}
    if isinstance(cfg, (list, tuple)):
        return [to_dict(v) for v in cfg]
    return cfg


@dataclass
class TrainerHparams:
    """The training harness's flags (the JAX package's TrainerHparams,
    field for field, so a run's meta.json reads in either package)."""
    accumulate_grad_batches: int = 2
    precision: str = "bf16"           # 'bf16' | 'fp32'
    max_steps: Optional[int] = None   # None: until the lr decays to zero
    val_check_interval: float = 1.0   # fraction of an epoch between runs
    limit_val_batches: Optional[int] = None
    log_every_n_steps: int = 50
    sample_every_n_steps: int = 500
    checkpoint_every_n_steps: int = 1000
    early_stopping_patience: int = 3
    # The step before which early stopping is disarmed (no best metric, no
    # patience); None: the end of the model's KL annealing when it has
    # one, else 0 (training/trainer.py::early_stop_start_step).
    early_stopping_start_step: Optional[int] = None
    # The device mesh (parallel/mesh.py): num_devices ranks, data x
    # seq_parallel x model_parallel or data x expert_parallel.
    num_devices: Optional[int] = None
    seq_parallel: int = 1
    model_parallel: int = 1
    expert_parallel: int = 1
    seed: int = 7295
    profile_steps: int = 0            # > 0: a torch.profiler trace
