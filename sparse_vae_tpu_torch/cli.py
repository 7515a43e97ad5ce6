"""Configuration assembly of the training CLI (port of sparse_vae_tpu/cli.py).

Code defaults, then the command-line dotlist, then a named preset (merged
after the dotlist, so a preset's values win, as in the JAX package), plus
the top-level flags preset, from_checkpoint, name, no_log and
anomaly_detection. The JAX package's platform set-up
(`apply_platform_env`) has no counterpart: the device is an argument of
the entry points here. Its `make_sample_fns` waits for
TransformerVAE.sample.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from .data.text_data_module import TextDataModule, TextDataModuleHparams
from .hparam_presets import hparam_presets
from .utils.config import TrainerHparams, merge_into_dataclass, parse_dotlist

# The JAX package's model families and the module each lives in; this
# package builds the Transformer-VAE.
FAMILIES = {"lstm-lm": "sparse_vae_tpu/models/lstm_lm.py",
            "lstm-vae": "sparse_vae_tpu/models/lstm_vae.py",
            "transformer-lm": "sparse_vae_tpu/models/transformer_lm.py "
                              "with training/objectives.py ARObjective",
            "transformer-vae": None}


@dataclass
class CLIConfig:
    experiment: str
    model_overrides: Dict[str, Any] = field(default_factory=dict)
    data: TextDataModuleHparams = field(default_factory=TextDataModuleHparams)
    trainer: TrainerHparams = field(default_factory=TrainerHparams)
    preset: Optional[str] = None
    from_checkpoint: Optional[str] = None
    name: str = "default"
    no_log: bool = False
    anomaly_detection: bool = False


def assemble_config(experiment: str, dotlist: List[str],
                    base_meta: Optional[Dict[str, Any]] = None) -> CLIConfig:
    """base_meta: a run's saved meta.json, the base of a resumed run's
    hparams (the dotlist's keys still win, e.g. trainer.max_steps=8000
    to lift a step cap)."""
    raw = parse_dotlist(dotlist)
    cfg = CLIConfig(experiment=experiment)

    cfg.preset = raw.pop("preset", None)
    cfg.from_checkpoint = raw.pop("from_checkpoint", None)
    cfg.name = raw.pop("name", cfg.from_checkpoint or "default")
    cfg.no_log = str(raw.pop("no_log", "false")).lower() in ("true", "1")
    cfg.anomaly_detection = str(raw.pop("anomaly_detection",
                                        "false")).lower() in ("true", "1")

    model_over = dict(raw.pop("model", {}))
    data_over = dict(raw.pop("data", {}))
    trainer_over = dict(raw.pop("trainer", {}))
    if base_meta:
        model_over = {**base_meta.get("model_hparams", {}), **model_over}
        data_over = {**base_meta.get("data_hparams", {}), **data_over}
        trainer_over = {**base_meta.get("trainer_hparams", {}),
                        **trainer_over}
    if raw:
        raise ValueError(f"Unrecognized CLI keys: {sorted(raw)} "
                         f"(prefix with model./data./trainer.)")

    if cfg.preset:
        preset = hparam_presets.get(cfg.preset)
        if not preset:
            raise ValueError(f"Preset name '{cfg.preset}' not recognized.")
        model_over.update(preset.get("model", {}))
        data_over.update(preset.get("data", {}))
        trainer_over.update(preset.get("trainer", {}))

    cfg.model_overrides = model_over
    cfg.data = merge_into_dataclass(cfg.data, data_over)
    cfg.trainer = merge_into_dataclass(cfg.trainer, trainer_over)
    return cfg


def build_hparams(experiment: str, model_hparams_overrides=None):
    """(hparams, objective) of an experiment with the overrides merged
    (the JAX package's build_model; the module itself is built by
    Trainer.init_state or checkpoint.model_from_hparams). Families this
    package does not build raise NotImplementedError."""
    if experiment not in FAMILIES:
        raise ValueError(f"Unrecognized model type '{experiment}'. "
                         f"Choose from {sorted(FAMILIES)}")
    if FAMILIES[experiment] is not None:
        raise NotImplementedError(
            f"model {experiment!r} is not ported ({FAMILIES[experiment]}); "
            "transformer-vae is")
    from .models.transformer_vae import TransformerVAEHparams
    from .models.vae import VAEObjective

    hparams = merge_into_dataclass(TransformerVAEHparams(),
                                   model_hparams_overrides or {})
    return hparams, VAEObjective(hparams)


def build_data(cfg: CLIConfig) -> TextDataModule:
    dm = TextDataModule(cfg.data)
    dm.prepare_data()
    return dm


def seed_everything(seed: int = 7295):
    """numpy's and Python's global generators; the training streams have
    explicit generators of their own (training/trainer.py)."""
    np.random.seed(seed)
    import random
    random.seed(seed)
