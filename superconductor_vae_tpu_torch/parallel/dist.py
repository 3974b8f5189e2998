"""Data parallelism over ``torch.distributed`` (port of parallel/mesh.py's
data axis).

JAX builds a (data, model) mesh and lets GSPMD shard the batch on
``data``, replicate the parameters and insert the gradient all-reduce.
Here:
- ``init_distributed`` joins the process group that ``torchrun`` (or the
  caller) describes: NCCL on CUDA, gloo on the CPU, one card a local rank;
- ``shard_batch`` keeps this rank's contiguous block of a global batch
  (``data/sampler.py`` ``shard_batch_indices``, as a JAX host keeps its
  shard);
- ``replicate`` broadcasts every parameter and buffer from rank 0;
- ``all_reduce_grads_`` sums the gradients over the ranks: with the
  global-batch shares of ``parallel/global_batch.py`` the sum is the
  gradient of the global batch's loss.

The ``model`` axis (tensor parallelism) is parallel/mesh.py's grid and
parallel/tensor.py's layers.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from ..data.sampler import shard_batch_indices
from .global_batch import all_reduce_sum_


def world() -> tuple[int, int]:
    """(rank, world size) of the default process group; (0, 1) without
    one."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def init_distributed(device: str | torch.device = 'cuda',
                     init_method: Optional[str] = None,
                     rank: Optional[int] = None, world_size: Optional[int] = None,
                     local_rank: Optional[int] = None,
                     backend: Optional[str] = None) -> torch.device:
    """Joins the default process group and returns this rank's device.

    Rank, world size and local rank default to ``torchrun``'s ``RANK``,
    ``WORLD_SIZE`` and ``LOCAL_RANK`` (0, 1, 0 without them); the address
    to ``init_method`` or ``env://`` (``MASTER_ADDR`` / ``MASTER_PORT``).
    The backend is NCCL for CUDA and gloo for the CPU unless ``backend``
    says otherwise.  On CUDA the device is ``cuda:<local_rank>``, made the
    current device.  A group already joined is kept."""
    rank = int(os.environ.get('RANK', 0)) if rank is None else rank
    world_size = (int(os.environ.get('WORLD_SIZE', 1)) if world_size is None
                  else world_size)
    local_rank = (int(os.environ.get('LOCAL_RANK', 0)) if local_rank is None
                  else local_rank)
    device = torch.device(device)
    if device.type == 'cuda':
        device = torch.device('cuda', local_rank)
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        backend = backend or ('nccl' if device.type == 'cuda' else 'gloo')
        kwargs = {'device_id': device} if backend == 'nccl' else {}
        dist.init_process_group(backend, init_method=init_method or 'env://',
                                rank=rank, world_size=world_size, **kwargs)
    return device


def shard_batch(batch: Dict[str, np.ndarray | torch.Tensor],
                group: Optional[dist.ProcessGroup] = None) -> Dict:
    """This rank's contiguous block of every array of a global batch."""
    if not dist.is_initialized():
        return batch
    rank, n = dist.get_rank(group), dist.get_world_size(group)
    return {k: v[shard_batch_indices(np.arange(len(v)), rank, n)]
            for k, v in batch.items()}


def broadcast_(tensors: Sequence[torch.Tensor],
               group: Optional[dist.ProcessGroup] = None, src: int = 0) -> None:
    """Broadcasts ``tensors`` in place from the global rank ``src`` (CUDA
    tensors under gloo through a host copy), one flat buffer a dtype."""
    by_dtype: Dict[torch.dtype, List[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    gloo = dist.get_backend(group) == 'gloo'
    for ts in by_dtype.values():
        flat = torch.cat([t.detach().reshape(-1) for t in ts])
        buf = flat.cpu() if (gloo and flat.is_cuda) else flat
        dist.broadcast(buf, src=src, group=group)
        if buf is not flat:
            flat.copy_(buf)
        torch._foreach_copy_([t.data for t in ts],
                             [p.view_as(t) for p, t in zip(flat.split([t.numel() for t in ts]),
                                                           ts)])


def broadcast_object(obj, group: Optional[dist.ProcessGroup] = None, src: int = 0):
    """``obj`` (picklable) from rank ``src`` on every rank; the other
    ranks pass anything (None)."""
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=group)
    return box[0]


def replicate(modules: Iterable[Optional[nn.Module]],
              group: Optional[dist.ProcessGroup] = None) -> None:
    """Every parameter and buffer of ``modules`` broadcast from rank 0
    (the counterpart of ``replicate(mesh)``'s ``P()``)."""
    if not dist.is_initialized():
        return
    tensors = [t for m in modules if m is not None
               for t in (*m.parameters(), *m.buffers())]
    if tensors:
        broadcast_(tensors, group)


def all_reduce_grads_(params: Sequence[torch.Tensor],
                      group: Optional[dist.ProcessGroup] = None) -> None:
    """Sums the gradients of ``params`` over the ranks in place, through
    one flat buffer (every parameter has a gradient)."""
    grads = [p.grad for p in params]
    flat = torch.cat([g.reshape(-1) for g in grads])
    all_reduce_sum_(flat, group)
    torch._foreach_copy_(grads, [f.view_as(g) for f, g in
                                 zip(flat.split([g.numel() for g in grads]), grads)])


def all_reduce_metrics(metrics: Dict[str, torch.Tensor],
                       group: Optional[dist.ProcessGroup] = None) -> Dict[str, torch.Tensor]:
    """Each metric (a share) summed over the ranks: one collective."""
    keys = list(metrics)
    flat = all_reduce_sum_(torch.stack([metrics[k].float() for k in keys]), group)
    return dict(zip(keys, flat.unbind()))
