"""sparse-vae-tpu's PyTorch/CUDA port for NVIDIA Hopper.

The JAX package (`sparse_vae_tpu/`) is the reference. Module names mirror it
(`ops/attention.py`, `models/transformer_vae.py`, `server.py`, ...) so each
counterpart is easy to find. This package imports torch, never jax, and
nothing of `sparse_vae_tpu/` or `tools/`.

Every TPU kernel on a ported path is a hand-written CUDA kernel under
`csrc/`, built with nvcc into one plain-C shared library at first use
(`ops/cuda_lib.py`). Each kernel's wrapper runs the kernel for CUDA tensors
and its plain PyTorch version for CPU tensors.
"""


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
