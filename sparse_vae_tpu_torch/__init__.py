"""sparse-vae-tpu's PyTorch/CUDA port for NVIDIA Hopper.

The JAX package (`sparse_vae_tpu/`) is the reference. Module names mirror it
(`ops/attention.py`, `models/transformer_vae.py`, `server.py`, ...) so each
counterpart is easy to find. This package imports torch, never jax, and
nothing of `sparse_vae_tpu/` or `tools/`.

Every TPU kernel on a ported path is a hand-written CUDA kernel under
`csrc/`, built with nvcc into one plain-C shared library at first use
(`ops/cuda_lib.py`). Each kernel's wrapper runs the kernel for CUDA tensors
and its plain PyTorch version for CPU tensors.

The public surface is the JAX package's (`sparse_vae_tpu/__init__.py`):
each name resolves to its counterpart here on first access (`__getattr__`,
`PUBLIC`), so importing the package loads no torch; `MODEL_REGISTRY`,
`build_model`, `cast_float_params` and `load_checkpoint_for_name` are
defined here. `radam`, an optax transformation, has none: the port's
optimizer is the `RAdam` class that `make_optimizer` builds.
"""
import importlib

# Public name -> the module (relative to this package) that defines it.
PUBLIC = {
    "TextBatch": "data.batching",
    "TextDataModule": "data.text_data_module",
    "TextDataModuleHparams": "data.text_data_module",
    "CLS_ID": "data.tokenizer", "PAD_ID": "data.tokenizer",
    "SEP_ID": "data.tokenizer",
    "hparam_presets": "hparam_presets",
    "LanguageModelHparams": "models.base", "VOCAB_SIZE": "models.base",
    "ConditionalGaussian": "models.conditional_gaussian",
    "DecodeState": "models.generation", "SamplingParams": "models.generation",
    "decode_loop": "models.generation", "final_output": "models.generation",
    "init_decode_state": "models.generation",
    "LSTMLanguageModel": "models.lstm_lm",
    "LSTMLanguageModelHparams": "models.lstm_lm",
    "LSTMVAE": "models.lstm_vae", "LSTMVAEHparams": "models.lstm_vae",
    "Perceiver": "models.perceiver",
    "Transformer": "models.transformer",
    "TransformerLayer": "models.transformer_layer",
    "TransformerHparams": "models.transformer_lm",
    "TransformerLanguageModel": "models.transformer_lm",
    "TransformerVAE": "models.transformer_vae",
    "TransformerVAEHparams": "models.transformer_vae",
    "ContinuousVAEHparams": "models.vae", "VAEObjective": "models.vae",
    "estimate_log_prob_iw": "models.vae",
    "CheckpointManager": "training.checkpointing",
    "get_checkpoint_path_for_name": "training.checkpointing",
    "restore_checkpoint": "training.checkpointing",
    "ARObjective": "training.objectives",
    "batch_arrays": "training.objectives",
    "make_optimizer": "training.optimizer",
    "Trainer": "training.trainer",
    "TrainerHparams": "utils.config",
    "merge_into_dataclass": "utils.config", "parse_dotlist": "utils.config",
}

# The JAX package's public names with no counterpart here, and why.
NO_COUNTERPART = {
    "radam": "an optax GradientTransformation; the port's RAdam/LAMB is "
             "the torch.optim.Optimizer `training.optimizer.RAdam`, built "
             "by `make_optimizer`",
}

def __getattr__(name: str):
    if name in PUBLIC:
        module = importlib.import_module(f".{PUBLIC[name]}", __name__)
        value = getattr(module, name)
    elif name == "MODEL_REGISTRY":
        # experiment -> (module class, hparams class, objective class):
        # checkpoint.FAMILIES with each family's objective.
        from .checkpoint import FAMILIES
        from .cli import objective_for
        value = {experiment: (module, hp_cls, type(objective_for(hp_cls())))
                 for experiment, (hp_cls, module) in FAMILIES.items()}
    else:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(PUBLIC) | {"MODEL_REGISTRY"})


def cast_float_params(params: dict, dtype="fp32") -> dict:
    """Serving-time weight cast of a state dict: 'bf16' (or 'bfloat16')
    casts every floating tensor to bf16, halving the weights each decode
    step reads; 'fp32', 'float32', '' or None returns the dict unchanged;
    anything else raises ValueError. Training keeps fp32 masters."""
    if dtype in (None, "", "fp32", "float32"):
        return params
    if dtype not in ("bf16", "bfloat16"):
        raise ValueError(f"params_dtype must be fp32 or bf16, got {dtype!r}")
    import torch
    return {name: (t.to(torch.bfloat16)
                   if torch.is_tensor(t) and t.is_floating_point() else t)
            for name, t in params.items()}


def build_model(experiment: str, model_hparams_overrides=None,
                device="cuda"):
    """experiment name -> (module, hparams, objective), the train entry's
    model dispatch (`cli.build_hparams`, with the JAX package's error for
    an unknown name). The module has the JAX package's initialisation
    (models/init.py) from a generator seeded 0, in the trainer's training
    form on `device` (`checkpoint.model_from_hparams`; pass device='cpu'
    for the CPU)."""
    import torch

    from .checkpoint import model_from_hparams
    from .cli import build_hparams
    hparams, objective = build_hparams(experiment, model_hparams_overrides)
    module, _ = model_from_hparams(hparams, torch.Generator().manual_seed(0),
                                   device, train=True)
    return module, hparams, objective


def load_checkpoint_for_name(experiment: str, name: str, root=None,
                             step=None, device="cuda"):
    """Restore a run that this package's trainer saved under
    sparse-vae-logs/<experiment>/<name>/checkpoints/ (or `root`): returns
    (model, hparams, objective, state dict, meta). step: None for the
    newest, "best" for the best validation step (the newest, with a
    warning, when best.json is missing), or a step number. The model is
    the trainer's training form on `device` (fp32 parameters computing in
    the run's precision) holding the saved parameters; the state is what
    training/checkpointing.py saved (parameters, optimizer, step,
    generator)."""
    import json
    import warnings

    import torch

    from .checkpoint import model_from_hparams
    from .cli import build_hparams
    from .training.checkpointing import (checkpoints_dir,
                                         get_checkpoint_path_for_name,
                                         restore_checkpoint)

    path = get_checkpoint_path_for_name(experiment, name, root)
    if step == "best":
        best_file = checkpoints_dir(experiment, name, root) / "best.json"
        if best_file.exists():
            step = json.loads(best_file.read_text()).get("step")
        else:
            warnings.warn(
                f"step='best' requested but {best_file} does not exist "
                "(no best-val checkpoint was recorded for this run); "
                "falling back to the NEWEST checkpoint, which may be a "
                "later, overfit step.", stacklevel=2)
            step = None
    if step is not None:
        path = path.parent / f"step_{int(step)}"
    meta = json.loads((path.parent / "meta.json").read_text())
    hparams, objective = build_hparams(experiment, meta["model_hparams"])
    model, hparams = model_from_hparams(hparams, torch.Generator(), device,
                                        train=True)
    state = restore_checkpoint(path, map_location=model.device)
    model.load_state_dict(state["params"], strict=True)
    return model, hparams, objective, state, meta
