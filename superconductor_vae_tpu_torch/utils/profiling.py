"""Tracing and profiling utilities (port of utils/profiling.py).

A phase wall-timer that synchronises the device at phase boundaries (the
honest way to time asynchronous launches), a ``torch.profiler`` trace
context whose timeline opens in TensorBoard or Perfetto, and named
regions in that timeline (``torch.profiler.record_function``).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict

import torch
from torch.utils._pytree import tree_leaves


def _synchronize(sync) -> None:
    """Waits for the devices of the tensors in ``sync`` (a tensor or a
    structure of them), as ``jax.block_until_ready`` waits for arrays."""
    for dev in {t.device for t in tree_leaves(sync) if isinstance(t, torch.Tensor)}:
        if dev.type == 'cuda':
            torch.cuda.synchronize(dev)


class PhaseTimer:
    """Named-phase wall timing with optional device synchronization.

    Usage:
        timer = PhaseTimer()
        with timer.phase('data_load'):
            batch = next(it)
        with timer.phase('train_step', sync=metrics['total']):
            state, metrics = step(state, batch, seed, dyn)
        print(timer.summary())

    ``sync`` is a tensor (or a structure of tensors) whose device the
    phase waits for before it stops the clock.
    """

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, sync=None):
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                _synchronize(sync)
            dt = time.perf_counter() - t0
            self.totals[name] += dt
            self.counts[name] += 1

    def reset(self):
        self.totals.clear()
        self.counts.clear()

    def summary(self) -> str:
        total = sum(self.totals.values()) or 1e-9
        rows = sorted(self.totals.items(), key=lambda kv: -kv[1])
        lines = [f'  {name:<18} {t:8.3f}s  {t / total:6.1%}  '
                 f'({self.counts[name]}x, {t / max(self.counts[name], 1) * 1e3:.1f}ms avg)'
                 for name, t in rows]
        return 'phase timing:\n' + '\n'.join(lines)

    def as_dict(self) -> Dict[str, float]:
        return dict(self.totals)


@contextlib.contextmanager
def trace_context(logdir: str = 'outputs/torch_trace', enabled: bool = True):
    """A ``torch.profiler`` trace of the block (the CPU, and the card when
    there is one), written to ``logdir`` as a Chrome/Perfetto trace;
    yields the profiler (None when disabled)."""
    if not enabled:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    Path(logdir).mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(str(logdir))) as prof:
        yield prof


@contextlib.contextmanager
def named_scope(name: str):
    """Annotate a region in the profiler timeline."""
    with torch.profiler.record_function(name):
        yield
