"""Named random streams: the port's counterpart of ``jax.random.fold_in``.

A stream is named by a path of non-negative integers, e.g. ``(seed,
target, fold)``; a child's name is its parent's with one more integer.
The path goes through ``numpy.random.SeedSequence`` to a torch seed, as
the train step's ``dropout_seed`` does, so that two names give
independent streams and a stream does not depend on what else ran.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

Key = Tuple[int, ...]


def stream_seed(key: Key) -> int:
    """The torch seed of the stream named ``key``."""
    return int(np.random.SeedSequence(list(key)).generate_state(1)[0])


def key_generator(key: Key, device: str | torch.device = 'cpu') -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded for the stream ``key``."""
    return torch.Generator(device=device).manual_seed(stream_seed(key))
