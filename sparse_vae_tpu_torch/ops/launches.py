"""Every kernel launch counter of the port in one place, by kernel name.

Each wrapper raises its own counter where it launches its kernel and
nowhere else (ops/swa_kernel.py, ops/causal_kernel.py, ops/ce_kernel.py,
ops/select_kernel.py);
the counters are plain integers of this process. `plain_routes` counts
calls inside a JAX kernel gate that ran a plain version on the CPU, and
`rnn_step_loop` the RNN step loop's calls on CUDA tensors (ops/rnn.py:
the oracle's; no path runs it on the card).
"""
from __future__ import annotations

from . import ce_kernel, rnn, select_kernel, swa_kernel

COUNTERS = {
    "swa_fwd": (swa_kernel, "launches"),                    # K1
    "swa_bwd": (swa_kernel, "bwd_launches"),                # K2
    "swa_fwd_packed": (swa_kernel, "packed_launches"),      # K5
    "swa_bwd_packed": (swa_kernel, "packed_bwd_launches"),  # K5b
    "sp_windowed_attention": (swa_kernel, "sp_launches"),   # K6
    "sp_windowed_attention_bwd": (swa_kernel, "sp_bwd_launches"),
    # The dense causal pair (ops/causal_kernel.py), the dense route at Dh
    # 64 and 128.
    "swa_fwd_dense": (swa_kernel, "dense_launches"),
    "swa_bwd_dense": (swa_kernel, "dense_bwd_launches"),
    "swa_fwd_hm128": (swa_kernel, "hm128_launches"),        # K1, Dh 128
    "swa_bwd_hm128": (swa_kernel, "hm128_bwd_launches"),    # K2, Dh 128
    "swa_fwd_generic": (swa_kernel, "generic_launches"),    # generic pair
    "swa_bwd_generic": (swa_kernel, "generic_bwd_launches"),
    "tied_ce_fwd": (ce_kernel, "fwd_launches"),             # K3
    "tied_ce_bwd": (ce_kernel, "bwd_launches"),             # K3b
    "tied_ce_fwd_d256": (ce_kernel, "fwd_launches_d256"),   # K3, D = 256
    "tied_ce_bwd_d256": (ce_kernel, "bwd_launches_d256"),   # K3b, D = 256
    "nucleus_select": (select_kernel, "launches"),          # K4
    "swa_plain_routes": (swa_kernel, "plain_routes"),
    "ce_plain_routes": (ce_kernel, "plain_routes"),
    "rnn_step_loop": (rnn, "step_loop_cuda_calls"),
}


def reset() -> None:
    for module, attr in COUNTERS.values():
        setattr(module, attr, 0)


def read() -> dict:
    return {name: getattr(module, attr)
            for name, (module, attr) in COUNTERS.items()}
