"""Global-batch loss semantics under data parallelism.

The JAX package's data parallelism is GSPMD over one global array, so
every mean and every normalizer of its losses counts the GLOBAL batch.
Under ``torch.distributed`` each rank holds a contiguous shard of that
batch, and the ranks hold different token and superconductor counts, so
averaging per-rank means (plain DDP) gives another loss.  Here each rank
computes its SHARE of every term instead: its local numerator over the
global denominator.  A sum of the shares over the ranks is the global
term, so the gradient all-reduce is a sum, and the logged metrics are
sums of shares.

The loss modules call the functions below.  Outside a ``global_batch``
context (one process) they are the plain operations: ``global_mean`` is
``x.mean()``, ``global_count`` the identity, the gathers the identity.
Inside one they reduce over the context's process group:
- ``global_mean(x)``: ``x.mean()`` over the world size, for any tensor
  whose size is proportional to the local batch (every rank holds the
  same number of rows);
- ``global_count(c)``: a detached count summed over the ranks (a plain
  ``all_reduce``: no gradient flows through a denominator);
- ``share(x)``: a mean over this rank's rows, or a value that every rank
  computes alike from gathered rows, over the world size, so that the sum
  over the ranks is the global value;
- ``gather_rows`` (no gradient) and ``gather_rows_grad`` (its backward
  sums the gradient over the ranks and keeps this rank's rows): the
  global batch on every rank, for the RL rollouts and SupCon.

Every rank must run the same sequence of these calls: none of them sits
on a branch that depends on a rank's data.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Iterator, Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class GlobalBatch:
    """This rank's place in the global batch: ``world`` ranks of
    ``local_rows`` rows each, this rank's rows starting at
    ``rank * local_rows``."""
    rank: int
    world: int
    local_rows: int
    group: Optional[dist.ProcessGroup] = None

    @property
    def offset(self) -> int:
        return self.rank * self.local_rows


# the loss functions read it, as autocast's state is read: no signature of
# the losses changes, and outside a ``global_batch`` block nothing does
_ACTIVE: contextvars.ContextVar[Optional[GlobalBatch]] = contextvars.ContextVar(
    'global_batch', default=None)


@contextlib.contextmanager
def global_batch(gb: Optional[GlobalBatch]) -> Iterator[Optional[GlobalBatch]]:
    """Makes ``gb`` the active global batch inside the block (None: one
    process, the plain operations)."""
    token = _ACTIVE.set(gb)
    try:
        yield gb
    finally:
        _ACTIVE.reset(token)


def active() -> Optional[GlobalBatch]:
    return _ACTIVE.get()


def _on_gloo(gb: GlobalBatch, x: torch.Tensor) -> bool:
    """True when a collective on ``x`` goes through gloo with a CUDA
    tensor, which is staged through host memory here."""
    return x.is_cuda and dist.get_backend(gb.group) == 'gloo'


def all_reduce_sum_(x: torch.Tensor, group: Optional[dist.ProcessGroup] = None
                    ) -> torch.Tensor:
    """``x`` summed in place over ``group``'s ranks (CUDA tensors under
    gloo through a host copy); returns ``x``."""
    if x.is_cuda and dist.get_backend(group) == 'gloo':
        host = x.cpu()
        dist.all_reduce(host, group=group)
        x.copy_(host)
    else:
        dist.all_reduce(x, group=group)
    return x


def global_rows(local_rows: int) -> int:
    """The global batch's row count for a shard of ``local_rows``."""
    gb = _ACTIVE.get()
    return local_rows if gb is None else local_rows * gb.world


def global_mean(x: torch.Tensor) -> torch.Tensor:
    """This rank's share of the mean of ``x`` over the global batch."""
    return share(x.mean())


def global_count(c: torch.Tensor) -> torch.Tensor:
    """The count ``c`` (a scalar of this rank's rows) summed over the
    ranks, detached."""
    gb = _ACTIVE.get()
    if gb is None:
        return c
    return all_reduce_sum_(c.detach().clone(), gb.group)


def share(x: torch.Tensor) -> torch.Tensor:
    """``x`` over the world size: this rank's share of a mean over its
    own rows (every rank holds as many), or of a value that every rank
    computes alike from gathered rows."""
    gb = _ACTIVE.get()
    return x if gb is None else x / gb.world


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """The global batch of ``x`` (rows in rank order), without gradient."""
    gb = _ACTIVE.get()
    if gb is None:
        return x
    src = x.detach().contiguous()
    if _on_gloo(gb, src):
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(gb.world)]
    dist.all_gather(parts, src, group=gb.group)
    return torch.cat(parts, dim=0).to(x.device)


def local_rows(x_global: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a global-batch tensor."""
    gb = _ACTIVE.get()
    if gb is None:
        return x_global
    return x_global[gb.offset:gb.offset + gb.local_rows]


class _GatherRows(torch.autograd.Function):
    """All-gather along rows whose backward sums the incoming gradient
    over the ranks and returns this rank's rows: every rank's loss term is
    its ``share`` (a 1/world of the value), so the sum is the
    gradient of the whole term with respect to this rank's rows."""

    @staticmethod
    def forward(ctx, x):
        ctx.gb = _ACTIVE.get()
        return gather_rows(x)

    @staticmethod
    def backward(ctx, grad):
        gb = ctx.gb
        grad = all_reduce_sum_(grad.contiguous().clone(), gb.group)
        return grad[gb.offset:gb.offset + gb.local_rows]


def gather_rows_grad(x: torch.Tensor) -> torch.Tensor:
    """``gather_rows`` with a gradient to this rank's rows (see
    ``_GatherRows``); the loss built on it must be taken as a
    ``share``."""
    if _ACTIVE.get() is None:
        return x
    return _GatherRows.apply(x)
