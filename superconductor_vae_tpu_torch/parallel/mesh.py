"""A (data, model) grid of ranks and the tensor-parallel sharding rules
(port of parallel/mesh.py's ``make_mesh`` and its Megatron-style rules).

JAX reshapes its devices into a (data, model) mesh and annotates each
weight with a ``PartitionSpec``; GSPMD inserts the collectives.  Here:
- ``make_grid`` splits the ``torch.distributed`` world the same way: rank
  r is data index ``r // n_model`` and model index ``r % n_model``; a
  model group is ``n_model`` consecutive ranks (they hold the same rows),
  a data group the ranks of one model index (they hold the same shards);
- ``tp_param_specs`` is ``_tp_spec`` on torch's names and layout: the
  dimension of each state-dict entry that is sharded, or None.
  ``nn.Linear.weight`` is ``[out, in]``, so JAX's column-parallel kernel
  axis 1 is dim 0 here (with the bias), and its row-parallel axis 0 is
  dim 1 (the bias replicated); the decoder's token embedding shards its
  vocabulary (dim 0);
- ``shard_params_tp`` cuts a whole train state (or decoder) into this
  rank's shards: the decoder becomes a tensor-parallel one
  (models/decoder.py with ``tp``, parallel/tensor.py's layers), its AdamW
  moments are cut alike, and the rest is copied; ``gather_params_tp``
  puts the whole state back together on every rank.  Checkpoints stay
  whole: gather, then save.

Only the formula decoder has layers that the rules shard; the encoder,
the projection and the set decoder stay replicated, as JAX's dryrun
shards ``enc_params`` (where nothing matches) and ``dec_params``.
"""

from __future__ import annotations

import copy
import dataclasses
import inspect
import re
from typing import Dict, List, Mapping, Optional

import torch
import torch.distributed as dist
from torch import nn

from .tensor import tp_sharded

_TP_COL = re.compile(r'(self|cross)_[qkv]$|^ff1$|^out_d1$')
_TP_ROW = re.compile(r'(self|cross)_o$|^ff2$|^out_d2$')


@dataclasses.dataclass(frozen=True)
class Grid:
    """This rank's place in an ``n_data`` x ``n_model`` grid and the two
    process groups it belongs to."""
    n_data: int
    n_model: int
    rank: int
    data_group: Optional[dist.ProcessGroup]
    model_group: Optional[dist.ProcessGroup]

    @property
    def data_index(self) -> int:
        return self.rank // self.n_model

    @property
    def model_index(self) -> int:
        return self.rank % self.n_model


def make_grid(n_data: Optional[int] = None, n_model: int = 1) -> Grid:
    """The (data, model) grid over the default process group's ranks
    (``n_data`` defaults to world / n_model).  Every rank must call it, in
    the same order as its other group creations: it creates every model
    group, then every data group, on every rank."""
    rank, world = dist.get_rank(), dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f'a {n_data} x {n_model} grid needs {n_data * n_model} ranks, '
                         f'the world has {world}')
    model_groups = [dist.new_group(list(range(d * n_model, (d + 1) * n_model)))
                    for d in range(n_data)]
    data_groups = [dist.new_group(list(range(m, world, n_model))) for m in range(n_model)]
    return Grid(n_data=n_data, n_model=n_model, rank=rank,
                data_group=data_groups[rank % n_model],
                model_group=model_groups[rank // n_model])


def _tp_dim(name: str, shape, n_model: int) -> Optional[int]:
    """``_tp_spec`` for one state-dict entry in torch's layout."""
    if n_model <= 1:
        return None
    *mods, leaf = name.split('.')
    module = mods[-1] if mods else ''
    if (leaf == 'weight' and len(shape) == 2 and module == 'token_embedding'
            and shape[0] % n_model == 0):
        return 0
    col, row = _TP_COL.search(module), _TP_ROW.search(module)
    if leaf == 'weight' and len(shape) == 2:
        if col and shape[0] % n_model == 0:
            return 0
        if row and shape[1] % n_model == 0:
            return 1
    if leaf == 'bias' and len(shape) == 1 and col and shape[0] % n_model == 0:
        return 0
    return None


def tp_param_specs(module: nn.Module | Mapping[str, torch.Tensor],
                   n_model: int) -> Dict[str, Optional[int]]:
    """{state-dict name: the dimension sharded over ``n_model`` model
    ranks, or None} of a whole module (or its state dict)."""
    sd = module.state_dict() if isinstance(module, nn.Module) else module
    return {k: _tp_dim(k, tuple(v.shape), n_model) for k, v in sd.items()}


def _slice(t: torch.Tensor, dim: Optional[int], grid: Grid) -> torch.Tensor:
    """This rank's shard of ``t`` (a copy; all of it where ``dim`` is
    None: an optimizer loads its state without copying)."""
    if dim is None:
        return t.clone()
    return t.chunk(grid.n_model, dim)[grid.model_index].clone()


def all_gather_cat(t: torch.Tensor, dim: int, grid: Grid) -> torch.Tensor:
    """The model group's shards of ``t`` concatenated along ``dim`` (a CUDA
    tensor under gloo through host memory)."""
    src = t.detach().contiguous()
    if src.is_cuda and dist.get_backend(grid.model_group) == 'gloo':
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(grid.n_model)]
    dist.all_gather(parts, src, group=grid.model_group)
    return torch.cat(parts, dim).to(t.device)


def _gather(t: torch.Tensor, dim: Optional[int], grid: Grid) -> torch.Tensor:
    return t.clone() if dim is None else all_gather_cat(t, dim, grid)


def _map_optimizer_state(sd: Mapping, dims: List[Optional[int]], fn) -> Dict:
    """An optimizer's ``state_dict`` (AdamW's, or a ``MultiSteps``' with its
    accumulators) with each parameter's tensors through ``fn(t, dim)``;
    the step counts (scalars) as they are."""
    def adamw(s):
        return dict(s, state={i: {k: fn(v, dims[i]) if torch.is_tensor(v) and v.dim() else v
                                  for k, v in st.items()} for i, st in s['state'].items()})
    if 'inner' in sd:
        return dict(sd, inner=adamw(sd['inner']),
                    acc_grads=[fn(a, d) for a, d in zip(sd['acc_grads'], dims, strict=True)])
    return adamw(sd)


def _optimizer_like(opt, params):
    """A new optimizer of ``opt``'s kind and settings over ``params``."""
    from ..training.train_step import MultiSteps
    inner = getattr(opt, 'inner', opt)
    takes = inspect.signature(torch.optim.AdamW).parameters
    new = torch.optim.AdamW(params, **{k: v for k, v in inner.defaults.items() if k in takes})
    return MultiSteps(new, opt.every_k) if isinstance(opt, MultiSteps) else new


def _decoder_dims(decoder: nn.Module, n_model: int) -> List[Optional[int]]:
    specs = tp_param_specs(decoder, n_model)
    return [specs[n] for n, _ in decoder.named_parameters()]


def _tp_decoder(decoder, grid: Grid):
    """A tensor-parallel twin of the whole ``decoder`` holding this rank's
    shards, in its mode; raises unless its sharded parameters are the
    ones ``tp_param_specs`` names, on the same dimensions."""
    from ..models.decoder import FormulaDecoder
    specs = tp_param_specs(decoder, grid.n_model)
    tp = FormulaDecoder(decoder.cfg, device=decoder.pos_table.device, dtype=decoder.dtype,
                        tp=grid)
    want = {k: d for k, d in specs.items() if d is not None}
    if tp_sharded(tp) != want:
        raise RuntimeError(f'the tensor-parallel decoder shards {tp_sharded(tp)}, the rules '
                           f'{want}')
    tp.load_state_dict({k: _slice(v, specs[k], grid)
                        for k, v in decoder.state_dict().items()}, strict=True)
    return tp.train(decoder.training)


def _whole_decoder(decoder):
    """The whole decoder put together from the model group's shards of the
    tensor-parallel ``decoder`` (every rank of the group calls it)."""
    from ..models.decoder import FormulaDecoder
    grid = decoder.tp
    dims = tp_sharded(decoder)
    whole = FormulaDecoder(decoder.cfg, device=decoder.pos_table.device, dtype=decoder.dtype)
    whole.load_state_dict({k: _gather(v, dims.get(k), grid)
                           for k, v in decoder.state_dict().items()}, strict=True)
    return whole.train(decoder.training)


def shard_params_tp(obj, grid: Grid):
    """This rank's shards of a whole ``TrainState`` or ``FormulaDecoder``
    (``obj`` is left as it is): the decoder tensor-parallel on ``grid``'s
    model group, its optimizer's moments (and accumulators) cut alike,
    the other modules and optimizers copied.  With ``n_model`` 1 a
    copy."""
    from ..models.decoder import FormulaDecoder
    from ..training.train_step import TrainState
    if grid.n_model == 1:
        return copy.deepcopy(obj)
    if isinstance(obj, FormulaDecoder):
        return _tp_decoder(obj, grid)
    if not isinstance(obj, TrainState):
        raise TypeError(f'shard_params_tp: a TrainState or a FormulaDecoder, not {type(obj)}')
    dims = _decoder_dims(obj.decoder, grid.n_model)
    state = copy.deepcopy(dataclasses.replace(obj, decoder=None, dec_opt=None))
    state.decoder = _tp_decoder(obj.decoder, grid)
    state.dec_opt = _optimizer_like(obj.dec_opt, state.decoder.parameters())
    state.dec_opt.load_state_dict(_map_optimizer_state(
        obj.dec_opt.state_dict(), dims, lambda t, d: _slice(t, d, grid)))
    return state


def gather_params_tp(obj, grid: Grid):
    """The whole ``TrainState`` or ``FormulaDecoder`` (one process's) from
    this rank's shards, on every rank; every rank of the model group must
    call it.  The inverse of ``shard_params_tp``."""
    from ..models.decoder import FormulaDecoder
    from ..training.train_step import TrainState
    if grid.n_model == 1:
        return copy.deepcopy(obj)
    if isinstance(obj, FormulaDecoder):
        return _whole_decoder(obj)
    if not isinstance(obj, TrainState):
        raise TypeError(f'gather_params_tp: a TrainState or a FormulaDecoder, not {type(obj)}')
    sharded = tp_sharded(obj.decoder)
    dims = [sharded.get(n) for n, _ in obj.decoder.named_parameters()]
    state = copy.deepcopy(dataclasses.replace(obj, decoder=None, dec_opt=None))
    state.decoder = _whole_decoder(obj.decoder)
    state.dec_opt = _optimizer_like(obj.dec_opt, state.decoder.parameters())
    state.dec_opt.load_state_dict(_map_optimizer_state(
        obj.dec_opt.state_dict(), dims, lambda t, d: _gather(t, d, grid)))
    return state
