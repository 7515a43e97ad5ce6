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
