"""Megatron-style tensor-parallel layers over a model group (port of the
collectives that GSPMD inserts for parallel/mesh.py's ``model`` axis).

JAX annotates the weights' shardings and lets GSPMD insert the
collectives.  Here the layers hold this rank's shard and run the
collectives themselves, on the ``model`` group of a ``parallel.mesh.Grid``
(``tp``: ``model_group``, ``model_index``, ``n_model``):
- ``ColumnParallelDense`` holds rows ``[r * out/n, (r + 1) * out/n)`` of
  the weight ``[out, in]`` and of the bias: its output is this rank's
  slice of the features (for attention, this rank's heads).  Its input
  must come through ``copy_to_model`` (Megatron's ``f``: the identity
  forward, a sum of the gradient over the group backward), taken once for
  every layer that reads the same input;
- ``RowParallelDense`` holds columns ``[r * in/n, (r + 1) * in/n)`` of the
  weight and reads this rank's slice of the features; its partial product
  goes through ``reduce_from_model`` (``g``: a sum over the group forward,
  the identity backward), and the bias, replicated, is added once after
  the sum;
- ``VocabParallelEmbed`` holds rows ``[r * V/n, (r + 1) * V/n)`` of the
  table: a lookup of the ids this rank holds, zeros elsewhere, summed over
  the group (exact: one term of the sum is the row, the others zero).

The sums are bit-equal on every rank of the group (a ring all-reduce
sums each element in one order and hands the result round), so the
replicated activations and everything computed from them are the same on
every rank.  Under ``torch.no_grad`` (rollouts) ``f`` is the identity and
``g`` one all-reduce.  CUDA tensors under gloo go through host memory
(``global_batch.all_reduce_sum_``).  A bf16 partial product is summed in
float32 and rounded once after the bias.

Dropout on a shard (``shard_dropout``) draws the mask of the whole
feature dimension from the generator that every rank of the group holds
alike, and keeps this rank's slice: the group's generators stay in step,
and the shards' masks are the slices of one mask.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..models.layers import PARAM_DTYPE, Dense, Embed
from .global_batch import all_reduce_sum_


def _reduce(x: torch.Tensor, tp) -> torch.Tensor:
    """A float32 copy of ``x`` summed over ``tp``'s model group."""
    y = x.float().clone() if x.dtype != torch.float32 else x.clone()
    return all_reduce_sum_(y, tp.model_group)


class _CopyToModel(torch.autograd.Function):
    """Megatron's ``f``: identity forward, gradient summed over the group."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _reduce(grad.contiguous(), ctx.tp).to(grad.dtype), None


class _ReduceFromModel(torch.autograd.Function):
    """Megatron's ``g``: sum over the group forward (float32 for a
    narrower dtype), identity backward."""

    @staticmethod
    def forward(ctx, x, tp):
        ctx.dtype = x.dtype
        return _reduce(x.contiguous(), tp)

    @staticmethod
    def backward(ctx, grad):
        return grad.to(ctx.dtype), None


def copy_to_model(x: torch.Tensor, tp) -> torch.Tensor:
    """``f``: ``x`` (replicated) as the input of column-parallel layers;
    their partial gradients are summed over the model group backward."""
    if tp is None or not torch.is_grad_enabled() or not x.requires_grad:
        return x
    return _CopyToModel.apply(x, tp)


def reduce_from_model(x: torch.Tensor, tp) -> torch.Tensor:
    """``g``: the partial results ``x`` summed over the model group
    (float32 when ``x`` is narrower)."""
    return _ReduceFromModel.apply(x, tp)


def _chunk(n: int, tp) -> tuple[int, int]:
    """[start, stop) of this rank's slice of a dimension of ``n``."""
    w = n // tp.n_model
    return tp.model_index * w, (tp.model_index + 1) * w


class ColumnParallelDense(Dense):
    """``Dense(in, out)`` sharded on its output features: holds
    ``out / n_model`` of them.  Its input must come through
    ``copy_to_model``."""

    def __init__(self, in_features: int, out_features: int, tp, device=None,
                 dtype=torch.float32):
        if out_features % tp.n_model:
            raise ValueError(f'{out_features} output features do not divide over '
                             f'{tp.n_model} model ranks')
        super().__init__(in_features, out_features // tp.n_model, device=device, dtype=dtype)
        self.tp = tp
        self.tp_dims = {'weight': 0, 'bias': 0}


class RowParallelDense(Dense):
    """``Dense(in, out)`` sharded on its input features: holds ``in /
    n_model`` of them, reads this rank's slice of the features and returns
    the whole output, summed over the model group, with the bias added
    once."""

    def __init__(self, in_features: int, out_features: int, tp, device=None,
                 dtype=torch.float32):
        if in_features % tp.n_model:
            raise ValueError(f'{in_features} input features do not divide over '
                             f'{tp.n_model} model ranks')
        super().__init__(in_features // tp.n_model, out_features, device=device, dtype=dtype)
        self.tp = tp
        self.tp_dims = {'weight': 1, 'bias': None}

    def forward(self, x):
        w, b = self.weights()
        y = reduce_from_model(F.linear(x.to(w.dtype), w), self.tp)
        if self.dtype == PARAM_DTYPE:
            return y + b
        return (y + b.float()).to(self.dtype)


class VocabParallelEmbed(Embed):
    """``Embed(V, d)`` sharded on the vocabulary: holds ``V / n_model``
    rows; a lookup returns the whole row on every rank."""

    def __init__(self, num: int, features: int, tp, device=None, dtype=torch.float32):
        if num % tp.n_model:
            raise ValueError(f'a vocabulary of {num} does not divide over {tp.n_model} '
                             'model ranks')
        super().__init__(num // tp.n_model, features, device=device, dtype=dtype)
        self.tp = tp
        self.tp_dims = {'weight': 0}
        self.vocab_start = tp.model_index * self.num_embeddings

    def forward(self, idx):
        local = idx - self.vocab_start
        held = (local >= 0) & (local < self.num_embeddings)
        rows = F.embedding(local.masked_fill(~held, 0), self.weight)
        out = reduce_from_model(rows.masked_fill(~held[..., None], 0.0), self.tp)
        return out if self.dtype == PARAM_DTYPE else out.to(self.dtype)

    def soft(self, probs: torch.Tensor) -> torch.Tensor:
        """``probs @ E`` over the whole vocabulary ([..., V] probability
        rows, the result in their dtype): this rank's slice of ``probs``
        against its rows, summed over the model group."""
        lo = self.vocab_start
        part = copy_to_model(probs, self.tp)[..., lo:lo + self.num_embeddings]
        return reduce_from_model(part @ self.weight.to(probs.dtype), self.tp).to(probs.dtype)


def shard_dropout(x: torch.Tensor, p: float, training: bool, tp) -> torch.Tensor:
    """Dropout on this rank's slice of the last dimension: the mask of the
    whole dimension drawn as ``F.dropout`` draws it on the CPU (a
    Bernoulli(1 - p) draw of the input's shape), this rank's slice kept."""
    if tp is None:
        return F.dropout(x, p, training)
    if not training or p == 0.0:
        return x
    full = (*x.shape[:-1], x.shape[-1] * tp.n_model)
    lo, hi = _chunk(full[-1], tp)
    keep = torch.empty(full, dtype=x.dtype, device=x.device).bernoulli_(1.0 - p)
    return x * keep[..., lo:hi].div_(1.0 - p)


def tp_sharded(module: torch.nn.Module) -> dict:
    """{parameter name: the dimension it is sharded on} over the
    tensor-parallel layers of ``module`` (their replicated biases left
    out)."""
    out = {}
    for prefix, m in module.named_modules():
        for leaf, dim in getattr(m, 'tp_dims', {}).items():
            if dim is not None:
                out[f'{prefix}.{leaf}' if prefix else leaf] = dim
    return out


def check_equal_across(x: torch.Tensor, tp, what: str) -> None:
    """Raises on every rank unless ``x`` (an integer tensor) is the same
    on every rank of the model group: one all-reduce of its maximum and of
    its negated minimum."""
    both = torch.stack([x, -x]).to(torch.int64)
    host = both.cpu() if both.is_cuda and dist.get_backend(tp.model_group) == 'gloo' else both
    dist.all_reduce(host, op=dist.ReduceOp.MAX, group=tp.model_group)
    lo, hi = -host[1], host[0]
    if not torch.equal(lo, hi):
        diff = (lo != hi).reshape(lo.shape[0], -1) if lo.dim() > 1 else (lo != hi)[None]
        raise RuntimeError(f'tensor parallelism: {what} differ across the model group '
                           f'({int(diff.sum())} entries; first at '
                           f'{tuple(int(i) for i in diff.nonzero()[0])})')


def all_across(flag: torch.Tensor, tp) -> bool:
    """True only if ``flag`` (a bool scalar) is True on every rank of the
    model group (one all-reduce of its minimum), so that every rank takes
    the same branch."""
    v = flag.to(torch.int64).reshape(1)
    host = v.cpu() if v.is_cuda and dist.get_backend(tp.model_group) == 'gloo' else v
    dist.all_reduce(host, op=dist.ReduceOp.MIN, group=tp.model_group)
    return bool(host.item())
