"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = 'cuda') -> torch.device:
    """``device`` as a ``torch.device``; raises if it names CUDA and no card
    is present, so that a CUDA entry point never falls back to the CPU."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            'CUDA is not available: pass device="cpu" to run the port on '
            'the CPU')
    return device
