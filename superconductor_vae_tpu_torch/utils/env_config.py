"""Runtime environment detection -> training configuration overrides
(port of utils/env_config.py).

The JAX package reads the accelerator platform, its device count and
memory, and the host's cores, and maps them to a global batch size and an
RLOO sample count.  Here the devices are ``torch.cuda``'s and the
processes are ``torch.distributed``'s (or ``torchrun``'s ``WORLD_SIZE``
before the group is joined); the batch table is the JAX package's GPU
branch, scaled by the device count.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict

import torch


@dataclasses.dataclass
class EnvironmentInfo:
    platform: str               # 'gpu' | 'cpu'
    device_kind: str
    n_devices: int
    n_hosts: int                # processes of the job (torch.distributed / WORLD_SIZE)
    host_cpu_count: int
    hbm_gb_per_device: float
    suggested_batch_size: int
    suggested_rloo_samples: int
    suggested_prefetch: int

    def as_overrides(self) -> Dict[str, int]:
        return {
            'batch_size': self.suggested_batch_size,
            'n_samples_rloo': self.suggested_rloo_samples,
        }


def _world_size() -> int:
    if torch.distributed.is_available() and torch.distributed.is_initialized():
        return torch.distributed.get_world_size()
    return int(os.environ.get('WORLD_SIZE', 1))


def detect_environment() -> EnvironmentInfo:
    if torch.cuda.is_available():
        platform = 'gpu'
        n_devices = torch.cuda.device_count()
        props = torch.cuda.get_device_properties(0)
        kind, hbm = props.name, props.total_memory / 1e9
        # the JAX package's GPU branch (env_config.py:63-65)
        per_chip = 128 if hbm >= 38 else 64 if hbm >= 15 else 48
        rloo = 4
    else:
        platform, kind, n_devices, hbm = 'cpu', 'cpu', 1, 0.0
        per_chip, rloo = 32, 2
    return EnvironmentInfo(
        platform=platform,
        device_kind=str(kind),
        n_devices=n_devices,
        n_hosts=_world_size(),
        host_cpu_count=os.cpu_count() or 1,
        hbm_gb_per_device=hbm,
        suggested_batch_size=per_chip * n_devices,
        suggested_rloo_samples=rloo,
        suggested_prefetch=2,
    )
