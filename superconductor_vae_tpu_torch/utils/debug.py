"""Numerical sanitizer: NaN/Inf localization for the training path (port
of utils/debug.py).

JAX's debug mode sets ``jax_debug_nans``: every jitted call is checked on
return and, on a hit, re-run op by op so that the error names the op.
PyTorch runs op by op already, so the checks sit on the ops themselves:

- ``enable_nan_debugging(*modules)`` turns on autograd's anomaly mode
  (a NaN produced in the backward pass raises naming its backward op and
  the forward call that made it), checks the output of every op for NaN
  (a ``TorchDispatchMode``), and puts a finite check on the output of
  every submodule of ``modules``.  A hit raises ``FloatingPointError``
  naming the innermost module running and the op.  It waits for the
  device after every op: a debugging mode.  ``TrainConfig.debug_numerics``
  (``--set debug_numerics=true``) turns it on for ``train()``, which then
  runs one step a dispatch, without the device-resident epoch runner.
- ``checkify_fn(fn)`` wraps ONE function: ``(*args) -> (err, out)``, with
  every op's output checked for NaN; ``err.throw()`` raises on the host
  at the first offending op, as with ``checkify``.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch
from torch import nn
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


def _nonfinite(out, nan_only: bool) -> bool:
    for t in tree_leaves(out):
        if isinstance(t, torch.Tensor) and t.is_floating_point() and t.numel():
            bad = torch.isnan(t) if nan_only else ~torch.isfinite(t)
            if bool(bad.any()):
                return True
    return False


class _NanCheck(TorchDispatchMode):
    """Checks the output of every op for NaN.  With ``raise_now`` a hit
    raises at once, naming the op and the innermost module of ``scope``;
    otherwise the first hit is kept in ``first``."""

    def __init__(self, raise_now: bool, scope: Optional[List[str]] = None):
        super().__init__()
        self.raise_now, self.scope = raise_now, scope if scope is not None else []
        self.first: Optional[str] = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        # an allocation's memory is not yet written (empty, empty_like, ...)
        if (self.first is None and 'empty' not in func.__name__
                and _nonfinite(out, nan_only=True)):
            where = f' in module {self.scope[-1]}' if self.scope else ''
            self.first = f'NaN produced by op {func}{where}'
            if self.raise_now:
                raise FloatingPointError(self.first)
        return out


class NanDebugging:
    """The state ``enable_nan_debugging`` installs; ``remove()`` takes it
    out again."""

    def __init__(self, modules):
        self.scope: List[str] = []
        self.handles = []
        for root in modules:
            if root is None:
                continue
            for name, m in root.named_modules():
                label = f'{type(root).__name__}.{name}' if name else type(root).__name__
                label = f'{label} ({type(m).__name__})'
                self.handles.append(m.register_forward_pre_hook(self._enter(label)))
                self.handles.append(m.register_forward_hook(self._leave(label)))
        self.anomaly = torch.is_anomaly_enabled()
        torch.autograd.set_detect_anomaly(True)
        self.mode = _NanCheck(raise_now=True, scope=self.scope)
        self.mode.__enter__()

    def _enter(self, label):
        def hook(module, args):
            self.scope.append(label)
        return hook

    def _leave(self, label):
        def hook(module, args, out):
            if self.scope and self.scope[-1] == label:
                self.scope.pop()
            if _nonfinite(out, nan_only=False):
                raise FloatingPointError(f'non-finite output of module {label}')
        return hook

    def remove(self) -> None:
        self.mode.__exit__(None, None, None)
        torch.autograd.set_detect_anomaly(self.anomaly)
        for h in self.handles:
            h.remove()
        self.handles = []


def enable_nan_debugging(*modules: nn.Module) -> NanDebugging:
    """Anomaly mode, a NaN check on every op's output and a finite check
    on every submodule's output of ``modules``, until ``remove()``."""
    return NanDebugging(modules)


class CheckError:
    """The result of a ``checkify_fn`` call: ``throw()`` raises
    ``FloatingPointError`` naming the first op that produced a NaN, and
    does nothing when none did."""

    def __init__(self, message: Optional[str]):
        self.message = message

    def get(self) -> Optional[str]:
        return self.message

    def throw(self) -> None:
        if self.message is not None:
            raise FloatingPointError(self.message)


def checkify_fn(fn: Callable) -> Callable:
    """``fn`` with every op's output checked for NaN: returns a function
    ``(*args, **kwargs) -> (err, out)``; ``err.throw()`` raises at the
    first offending op."""
    def wrapped(*args, **kwargs):
        mode = _NanCheck(raise_now=False)
        with mode:
            out = fn(*args, **kwargs)
        return CheckError(mode.first), out
    return wrapped
