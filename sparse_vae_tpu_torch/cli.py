"""Configuration assembly of the training CLI (port of sparse_vae_tpu/cli.py).

Code defaults, then the command-line dotlist, then a named preset (merged
after the dotlist, so a preset's values win, as in the JAX package), plus
the top-level flags preset, from_checkpoint, name, no_log and
anomaly_detection; the tokenizer of a trained run (`tokenizer_for_run`)
and the trainer's sampling callbacks (`make_sample_fns`). The JAX
package's platform set-up (`apply_platform_env`) has no counterpart: the
device is an argument of the entry points here.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

import numpy as np

from .data.text_data_module import TextDataModule, TextDataModuleHparams
from .hparam_presets import hparam_presets
from .utils.config import TrainerHparams, merge_into_dataclass, parse_dotlist

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
    Trainer.init_state or checkpoint.model_from_hparams)."""
    from .checkpoint import FAMILIES
    if experiment not in FAMILIES:
        raise ValueError(f"Unrecognized model type '{experiment}'. "
                         f"Choose from {sorted(FAMILIES)}")
    hparams = merge_into_dataclass(FAMILIES[experiment][0](),
                                   model_hparams_overrides or {})
    return hparams, objective_for(hparams)


def objective_for(hparams):
    """The training objective of `hparams`' family: VAEObjective for the
    Transformer-VAE and the LSTM-VAE, ARObjective for the language
    models."""
    from .models.transformer_vae import TransformerVAEHparams
    from .models.vae import ContinuousVAEHparams
    if isinstance(hparams, (TransformerVAEHparams, ContinuousVAEHparams)):
        from .models.vae import VAEObjective
        return VAEObjective(hparams)
    from .training.objectives import ARObjective
    return ARObjective(hparams)


def build_data(cfg: CLIConfig) -> TextDataModule:
    dm = TextDataModule(cfg.data)
    dm.prepare_data()
    return dm


def tokenizer_for_run(experiment: str, meta: dict):
    """The tokenizer a trained run used, from the run's recorded data
    hparams (meta.json): the one cached in the working directory under
    the run's dataset name, else one trained on that dataset's texts, as
    the run's data module resolves it. Unlike the JAX package's, it does
    not prepare the corpus: the tokenizer is all an entry needs."""
    from .checkpoint import FAMILIES
    if experiment not in FAMILIES:
        raise ValueError(f"Unrecognized model type '{experiment}'")
    return TextDataModule(TextDataModuleHparams(
        **meta.get("data_hparams", {}))).tokenizer


def make_sample_fns(experiment: str, objective, max_len: int = 512):
    """(sample_fn, reconstruct_fn) for the Trainer's sampling callback:
    sample_fn(model, seed, step) -> tokens [1, max_len - 1] or None;
    reconstruct_fn(model, seed, batch, step) -> tokens or None, batch a
    TextBatch. A VAE refuses to sample while the annealed kl_weight is
    below 1; reconstruction decodes the batch's first document from its
    posterior mean at temperature 0.7 (`reconstruct.reconstruct`, at
    most max_len or its length + 16 positions; an LM reconstructs
    nothing).
    Nucleus selection goes through K4 for the transformer families
    (`sample`'s default) and through the unfused bisection for the LSTM
    families (their `sample`, as the JAX package's)."""
    is_vae = experiment.endswith("vae")

    def sample_fn(model, seed: int, step: int = 0):
        if is_vae and float(objective.kl_weight(step)) < 1.0:
            return None
        return model.sample(seed, max_len, 1)

    def reconstruct_fn(model, seed: int, batch, step: int = 0):
        if not is_vae:
            return None
        import torch
        from .reconstruct import reconstruct
        tokens = torch.as_tensor(np.asarray(batch.token_ids[:1]),
                                 dtype=torch.int64, device=model.device)
        return reconstruct(model, tokens, seed,
                           min(max_len, int(batch.num_tokens[0]) + 16))

    return sample_fn, reconstruct_fn


def seed_everything(seed: int = 7295):
    """numpy's and Python's global generators; the training streams have
    explicit generators of their own (training/trainer.py)."""
    np.random.seed(seed)
    import random
    random.seed(seed)
