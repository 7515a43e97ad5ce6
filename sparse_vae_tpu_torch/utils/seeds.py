"""Seeds of named random streams under one run seed."""
from __future__ import annotations

import numpy as np


def derived_seed(seed: int, *keys: int) -> int:
    """A 64-bit seed for the stream named by `keys` under `seed`."""
    return int(np.random.SeedSequence([seed, *keys]).generate_state(
        1, np.uint64)[0])
