"""Seeds derived from a run's ``--seed``: one independent stream for
each use, so that any seed a run is given (a non-negative integer of
any size) draws the same data every time."""

import numpy as np
import torch


def derive(seed: int, *stream: int) -> int:
    """A 63-bit seed for the stream ``stream`` of run seed ``seed``."""
    ss = np.random.SeedSequence([int(seed), *map(int, stream)])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def generator(seed: int, *stream: int, device="cpu") -> torch.Generator:
    """A torch generator on ``device`` seeded for ``stream``."""
    return torch.Generator(device=device).manual_seed(derive(seed, *stream))


def numpy_rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng(derive(seed, *stream))
