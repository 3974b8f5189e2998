"""The multi-task train step (port of training/train_step.py).

One step: encoder forward in train mode, the decoder's conditioning
(``heads_pred_for_decoder``, ``stoich_conditioning``), the decoder's
teacher-forced forward, with ``rl_enabled`` the SCST or RLOO loss
(ops/rl.py: rollouts without gradient, a TF re-score with it), the
physics-Z loss through the learnable Magpie projection, the 17-term
``multitask_loss``, the A5 round-trip loss (``use_round_trip``:
ops/round_trip.py, a greedy rollout of a tenth of the batch, through K1
under ``pallas_decode``, re-encoded), the theory loss (at its weight, 0
by default) and the set decoder's Hungarian matching loss
(``hungarian_enabled``: models/set_decoder.py, ops/hungarian.py), added
in the JAX step's order; then backward, and a separate global-norm clip
and AdamW update for each of four parameter groups: the encoder, the
decoder, the physics-Z projection and the set decoder, as the JAX step
runs ``tx_enc``, ``tx_dec``, a second ``tx_enc`` state and a second
``tx_dec`` state.  With ``accumulation_steps`` k > 1 each group's
optimizer is a ``MultiSteps`` (``optax.MultiSteps``): the clip and AdamW
run every k-th step on the mean of the k gradients.
``make_epoch_runner`` runs the step over an epoch's batches gathered on
the device, keeping the metric sums there.

``TrainConfig.compute_dtype`` is the models' compute dtype, as the JAX
loop passes it to ``create_train_state``: with 'bfloat16' the models
compute in bf16 on float32 parameters (models/layers.py), the gradients
and AdamW moments are float32, and the models' outputs are cast to
float32 at the loss boundary (``_f32``), so every loss, the RL branch's
family predictions included, is computed in float32.

Differences from the JAX step, all in how and none in what it computes:
- the state holds ``nn.Module``s and ``torch.optim.AdamW``s and is updated
  IN PLACE (the step returns the same object);
- dropout masks come from torch's generator, seeded from the step's seed
  and the state's step count (the counterpart of
  ``jax.random.fold_in(rng, state.step)``), so they cannot equal JAX's;
- the rollouts sample from a ``torch.Generator`` on the models' device,
  seeded from the same pair on a stream of its own (the counterpart of
  the ``rl_rng`` half of ``jax.random.split``);
- ``dyn`` holds plain numbers rather than traced scalars
  (``entropy_pos_w`` a [T] tensor);
- the round trip's rollout runs under ``no_grad`` (JAX traces it under
  ``value_and_grad``, which raises with the Pallas decode kernel; its
  gradient is zero either way: ops/round_trip.py).
With ``soft_token_enabled`` the decoder's forward is the two-pass
soft-token forward (training/soft_token.py) at ``dyn['soft_ratio']``,
whose second pass replays the first's dropout masks, as JAX's two passes
share one ``rngs``.

Data parallelism (``group``, a ``torch.distributed`` process group): each
rank runs the step on its contiguous shard of the global batch inside a
``parallel.global_batch`` context, so every loss term and metric is its
share of the global batch's value (parallel/global_batch.py); the
gradients are summed over the ranks before the clip, so every rank clips
the same global norm and takes the same AdamW updates, and the metrics
are summed into the global batch's.  The round trip runs on the global
batch's first rows, which under contiguous shards are rank 0's.  Dropout
masks are drawn per rank (rank 0's from the one-process seed), so parity
with one process holds at dropout 0.

Tensor parallelism (``group`` a ``parallel.mesh.Grid``): the decoder is
the rank's shard of a tensor-parallel one (``parallel.mesh.shard_params_tp``)
and the batch its data index's shard.  The ranks of a model group hold the
same rows, so the global batch, its shares, its row gathers, the gradient
sum and the metrics run over the data group alone (nothing of them with
one data index); the round trip runs on data index 0's ranks, each on its
heads of the rows.  Every rank of a model group draws the dropout masks
of its data index, so the replicated activations take the same masks
(parallel/tensor.py ``shard_dropout``: a shard's mask is its slice of the
whole one), and its rollouts sample from the same generator over the
same whole logits.  The replicated parameters' gradients are the same
on every rank of the group (``f`` and ``g`` of parallel/tensor.py), the
shards' are their own; the global-norm clip sums the shards' squares over
the model group once and counts the replicated ones once: the whole
gradient's norm, as optax's ``clip_by_global_norm`` takes it of JAX's
sharded arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..data.sampler import shard_batch_indices
from ..models import FormulaDecoder, MaterialsEncoder, SetFormulaDecoder, init_params
from ..models.config import ModelConfig
from ..ops.hungarian import hungarian_matching_loss
from ..ops.losses import multitask_loss, tc_kelvin
from ..ops.physics_z_loss import init_magpie_proj, physics_z_loss
from ..ops.rl import rloo_loss, scst_loss
from ..ops.round_trip import round_trip_loss
from ..ops.theory import theory_loss
from ..parallel.dist import all_reduce_grads_, all_reduce_metrics
from ..parallel.global_batch import (GlobalBatch, active, all_reduce_sum_, global_batch,
                                     global_rows)
from ..parallel.mesh import Grid
from ..parallel.tensor import tp_sharded
from ..tokenizer import FractionAwareTokenizer
from ..utils.device import resolve_device
from ..utils.rng import stream_seed
from .config import TrainConfig
from .soft_token import soft_token_forward

# optax.adamw's defaults
ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def build_luts(tokenizer: FractionAwareTokenizer,
               device='cuda') -> Dict[str, torch.Tensor]:
    """The tokenizer's dense LUTs as tensors on ``device``."""
    device = resolve_device(device)
    return {
        'fraction_values': torch.as_tensor(tokenizer.fraction_value_table, device=device),
        'token_value_table': torch.as_tensor(tokenizer.token_value_table, device=device),
        'token_to_z': torch.as_tensor(tokenizer.token_to_element_z, device=device),
        'type_masks': torch.as_tensor(tokenizer.type_masks, device=device),
        'type_table': torch.as_tensor(tokenizer.token_type_table, device=device),
    }


def stoich_conditioning(batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """[B, 13] = ground-truth fractions (12) + element count (1)."""
    em = batch['element_mask'].float()
    count = em.sum(dim=1, keepdim=True)
    return torch.cat([batch['element_fractions'] * em, count], dim=1)


COMPUTE_DTYPES = {'float32': torch.float32, 'bfloat16': torch.bfloat16}


def compute_dtype(tcfg: TrainConfig) -> torch.dtype:
    """The torch dtype of ``tcfg.compute_dtype``; raises ``ValueError``
    for a name other than 'float32' or 'bfloat16'."""
    if tcfg.compute_dtype not in COMPUTE_DTYPES:
        raise ValueError(f'compute_dtype must be one of {sorted(COMPUTE_DTYPES)}, '
                         f'got {tcfg.compute_dtype!r}')
    return COMPUTE_DTYPES[tcfg.compute_dtype]


def _f32(out: Dict[str, Optional[torch.Tensor]]) -> Dict[str, Optional[torch.Tensor]]:
    """The loss boundary: every floating tensor of a model's outputs in
    float32 (the identity on float32 outputs)."""
    return {k: v.float() if isinstance(v, torch.Tensor) and v.is_floating_point() else v
            for k, v in out.items()}


class MultiSteps:
    """``optax.MultiSteps`` around a torch AdamW: gradient accumulation over
    ``every_k`` mini-steps.  ``accumulate`` keeps the running mean of the
    gradients of mini-steps 0..i as optax updates it,
    ``acc + (g - acc) / (i + 1)`` (Welford's form of
    ``(g + i * acc) / (i + 1)``); on the k-th it writes the mean into the
    gradients and returns True, and the caller clips them and steps the
    inner AdamW, whose count therefore counts applied updates.  Its state
    (the inner AdamW's, the mini-step, the accumulators) is one
    ``state_dict``."""

    def __init__(self, inner: torch.optim.AdamW, every_k: int):
        self.inner, self.every_k = inner, every_k
        self.mini_step = 0
        self.acc_grads = [torch.zeros_like(p) for g in inner.param_groups
                          for p in g['params']]

    @property
    def param_groups(self):
        return self.inner.param_groups

    @property
    def state(self):
        return self.inner.state

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.inner.zero_grad(set_to_none=set_to_none)

    def step(self) -> None:
        self.inner.step()

    def accumulate(self, grads: List[torch.Tensor]) -> bool:
        """Folds ``grads`` into the running mean; on the k-th mini-step
        copies the mean into ``grads``, resets, and returns True."""
        i = self.mini_step
        delta = torch._foreach_sub(grads, self.acc_grads)
        torch._foreach_div_(delta, float(i + 1))
        torch._foreach_add_(self.acc_grads, delta)
        if i + 1 < self.every_k:
            self.mini_step = i + 1
            return False
        torch._foreach_copy_(grads, self.acc_grads)
        torch._foreach_zero_(self.acc_grads)
        self.mini_step = 0
        return True

    def state_dict(self) -> Dict:
        return {'inner': self.inner.state_dict(), 'mini_step': self.mini_step,
                'acc_grads': [a.clone() for a in self.acc_grads]}

    def load_state_dict(self, sd: Mapping) -> None:
        self.inner.load_state_dict(sd['inner'])
        self.mini_step = int(sd['mini_step'])
        for a, saved in zip(self.acc_grads, sd['acc_grads'], strict=True):
            a.copy_(saved)


def make_optimizer(tcfg: TrainConfig, params):
    """AdamW as ``optax.adamw`` runs it: betas (0.9, 0.999), eps 1e-8
    outside the square root, bias correction from step 1, weight decay
    decoupled and applied to every parameter; wrapped in ``MultiSteps``
    when ``accumulation_steps`` > 1.  The global-norm clip that the JAX
    chain puts in front is ``clip_by_global_norm_``, called by the step;
    the learning rate is set with ``set_learning_rate``."""
    opt = torch.optim.AdamW(params, lr=tcfg.learning_rate, betas=ADAM_BETAS,
                            eps=ADAM_EPS, weight_decay=tcfg.weight_decay)
    if tcfg.accumulation_steps > 1:
        return MultiSteps(opt, tcfg.accumulation_steps)
    return opt


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float):
    """Sets the learning rate of every parameter group (the inner AdamW's
    of a ``MultiSteps``); returns the optimizer."""
    for group in optimizer.param_groups:
        group['lr'] = lr
    return optimizer


def global_norm(grads: List[torch.Tensor], sharded: Optional[List[bool]] = None,
                model_group=None) -> torch.Tensor:
    """sqrt of the sum of squares of every element (``optax.global_norm``).
    With ``sharded`` (a flag a gradient: this rank's shard of a
    tensor-parallel parameter) the shards' squares are summed over
    ``model_group`` and the other gradients' (the same on every rank of
    it) counted once: the norm of the whole gradients, on every rank."""
    norms = torch.stack(torch._foreach_norm(grads))
    if not sharded or not any(sharded):
        return torch.linalg.vector_norm(norms)
    sq = norms.square()
    mask = torch.tensor(sharded, device=sq.device)
    return torch.sqrt(all_reduce_sum_(sq[mask].sum(), model_group) + sq[~mask].sum())


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float,
                         sharded: Optional[List[bool]] = None,
                         model_group=None) -> torch.Tensor:
    """``optax.clip_by_global_norm`` in place: when the global norm is at
    least ``max_norm`` every gradient becomes ``(g / norm) * max_norm``,
    else it is left alone; no epsilon (``torch.nn.utils.clip_grad_norm_``
    divides by norm + 1e-6 instead).  Returns the norm before clipping.
    Decided on the device: no wait for the host.  ``sharded`` and
    ``model_group`` as ``global_norm``'s."""
    norm = global_norm(grads, sharded, model_group)
    keep = norm < max_norm
    one = torch.ones((), device=norm.device, dtype=norm.dtype)
    torch._foreach_div_(grads, torch.where(keep, one, norm))
    torch._foreach_mul_(grads, torch.where(keep, one, one * max_norm))
    return norm


@dataclasses.dataclass
class TrainState:
    """Step count, models and their optimizers.  ``pz_proj`` is the
    learnable Magpie projection of the physics-Z loss (None: the fixed
    one), with its own optimizer ``pz_opt``; ``set_decoder`` the set
    decoder (None without ``hungarian_enabled``), with ``set_opt``."""
    step: int
    encoder: MaterialsEncoder
    decoder: FormulaDecoder
    enc_opt: torch.optim.AdamW | MultiSteps
    dec_opt: torch.optim.AdamW | MultiSteps
    pz_proj: Optional[nn.Linear] = None
    pz_opt: Optional[torch.optim.AdamW | MultiSteps] = None
    set_decoder: Optional[SetFormulaDecoder] = None
    set_opt: Optional[torch.optim.AdamW | MultiSteps] = None

    @classmethod
    def from_modules(cls, encoder: MaterialsEncoder, decoder: FormulaDecoder,
                     tcfg: TrainConfig, pz_proj: Optional[nn.Linear] = None,
                     step: int = 0,
                     set_decoder: Optional[SetFormulaDecoder] = None) -> 'TrainState':
        """A state over existing modules with fresh optimizers."""
        def opt(m):
            return make_optimizer(tcfg, m.parameters()) if m is not None else None
        return cls(step=step, encoder=encoder, decoder=decoder,
                   enc_opt=opt(encoder), dec_opt=opt(decoder),
                   pz_proj=pz_proj, pz_opt=opt(pz_proj),
                   set_decoder=set_decoder, set_opt=opt(set_decoder))

    def groups(self) -> List[Tuple[List[nn.Parameter], torch.optim.AdamW | MultiSteps]]:
        """(parameters, optimizer) of each clip-and-update group: the
        encoder, the decoder, then the projection and the set decoder where
        present."""
        return [(list(m.parameters()), opt) for m, opt in (
            (self.encoder, self.enc_opt), (self.decoder, self.dec_opt),
            (self.pz_proj, self.pz_opt), (self.set_decoder, self.set_opt))
            if m is not None]


def make_set_decoder(mcfg: ModelConfig, tcfg: TrainConfig, device='cuda',
                     dtype=torch.float32) -> SetFormulaDecoder:
    """The set decoder at ``tcfg``'s hungarian_* widths over ``mcfg``'s
    latent, one slot an element slot; its dropout is its own default (0.1),
    as in JAX.  Parameters are left to ``init_params``."""
    return SetFormulaDecoder(
        latent_dim=mcfg.latent_dim, d_model=tcfg.hungarian_d_model,
        num_layers=tcfg.hungarian_num_layers,
        dim_feedforward=tcfg.hungarian_dim_feedforward, n_slots=mcfg.max_elements,
        n_z_tokens=tcfg.hungarian_n_z_tokens, device=device, dtype=dtype)


def create_train_state(mcfg: ModelConfig, tcfg: TrainConfig, seed: int = 0,
                       device='cuda') -> TrainState:
    """Encoder, decoder, (with ``use_physics_z`` and
    ``magpie_proj_learnable``) the Magpie projection and (with
    ``hungarian_enabled``) the set decoder on ``device``, with float32
    weights drawn from ``seed`` in that order (models/init.py), the models
    computing in ``tcfg.compute_dtype``, and fresh optimizers."""
    dtype = compute_dtype(tcfg)
    device = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    encoder = init_params(MaterialsEncoder(mcfg, device=device, dtype=dtype), gen)
    decoder = init_params(FormulaDecoder(mcfg, device=device, dtype=dtype), gen)
    pz_proj = set_decoder = None
    if tcfg.use_physics_z and tcfg.magpie_proj_learnable:
        pz_proj = init_magpie_proj(gen, mcfg.magpie_dim, device=device)
    if tcfg.hungarian_enabled:
        set_decoder = init_params(make_set_decoder(mcfg, tcfg, device, dtype), gen)
    return TrainState.from_modules(encoder, decoder, tcfg, pz_proj,
                                   set_decoder=set_decoder)


def default_dyn(tcfg: TrainConfig) -> Dict[str, float]:
    """The host scheduler's per-step scalars at their defaults (physics-Z
    weight 0, every skip multiplier 1)."""
    return {
        'tc_w': tcfg.tc_weight,
        'magpie_w': tcfg.magpie_weight,
        'rl_w': tcfg.rl_weight,
        'physz_w': 0.0,
        'rl_temperature': tcfg.rl.temperature,
        'entropy_weight': tcfg.rl.entropy_weight,
        'm_magpie': 1.0, 'm_tc_class': 1.0,
        'm_hp': 1.0, 'm_sc': 1.0,
        'm_stop': 1.0, 'm_site_dup': 1.0,
        'm_family': 1.0, 'm_physics_z': 1.0,
        'soft_ratio': tcfg.soft_token_start_ratio,
    }


def dropout_seed(seed: int, step: int, rank: int = 0) -> int:
    """The torch seed of the dropout masks of step ``step`` on data-parallel
    rank ``rank`` (rank 0's is the one-process seed)."""
    return stream_seed((seed, step)) if rank == 0 else stream_seed((seed, step, rank))


def rollout_seed(seed: int, step: int) -> int:
    """The seed of the rollouts' generator at step ``step``: a stream of
    its own, apart from ``dropout_seed``'s."""
    return int(np.random.SeedSequence([seed, step]).spawn(1)[0].generate_state(1)[0])


def train_loss(state: TrainState, tcfg: TrainConfig, luts: Mapping[str, torch.Tensor],
               batch: Mapping[str, torch.Tensor], dyn: Mapping[str, float],
               generator: Optional[torch.Generator] = None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The JAX step's ``loss_fn``: (total, metrics).  With a ``generator``
    the RL branch runs, its rollouts sampling from it.  The round trip and
    the set decoder's loss follow ``tcfg`` with or without it, as in JAX."""
    enc, dec = state.encoder, state.decoder
    enc_out = enc(batch['element_indices'], batch['element_fractions'],
                  batch['element_mask'], batch['magpie'], batch['tc'])
    heads_vec = enc.heads_pred_for_decoder(enc_out)
    stoich = stoich_conditioning(batch)
    if tcfg.soft_token_enabled:
        # soft-token scheduled sampling: the second pass sees
        # probability-weighted embedding mixtures at the epoch's ratio
        dec_out = soft_token_forward(dec, enc_out['z'], batch['tokens'], stoich, heads_vec,
                                     dyn['soft_ratio'],
                                     temperature=tcfg.soft_token_temperature)
    else:
        dec_out = dec(enc_out['z'], batch['tokens'], stoich, heads_vec)
    # the loss boundary; heads_vec stays in the compute dtype, as in JAX
    enc_out, dec_out = _f32(enc_out), _f32(dec_out)
    rl = reward_mean = None
    if generator is not None:
        # SCST or RLOO on the batch's targets, superconductors weighted 1
        kwargs = dict(family_predictions=enc_out['family_composed_14'],
                      sc_weight=(batch['is_sc'] == 1).float(),
                      temperature=dyn['rl_temperature'])
        if tcfg.rl.method == 'rloo':
            kwargs['entropy_weight'] = dyn['entropy_weight']
        if 'entropy_pos_w' in dyn:
            kwargs['position_entropy_w'] = dyn['entropy_pos_w']
        rl_fn = scst_loss if tcfg.rl.method == 'scst' else rloo_loss
        rl, reward_mean, _, rl_extras = rl_fn(dec, enc_out['z'], stoich, heads_vec,
                                              batch['tokens'][:, 1:], generator, tcfg.rl,
                                              luts, **kwargs)
    pz = None
    if tcfg.use_physics_z:
        pz = physics_z_loss(enc_out['z'], batch['comp_targets'], batch['magpie'],
                            batch['tc'], proj=state.pz_proj)['total']
    total, metrics = multitask_loss(tcfg.loss, enc_out, dec_out, batch,
                                    luts['type_table'], rl_loss=rl,
                                    rl_reward_mean=reward_mean, dyn=dyn, physz_loss=pz)
    if generator is not None:
        metrics['reward_var'] = rl_extras['reward_var']
    if tcfg.use_round_trip and tcfg.a5_weight > 0:
        # A5 round-trip cycle consistency on the first tenth of the
        # (global) batch: under data parallelism, this rank's rows of it
        b = batch['tokens'].shape[0]
        subset = max(int(global_rows(b) * tcfg.round_trip_subset_fraction), 1)
        gb = active()
        mine = subset if gb is None else min(max(subset - gb.offset, 0), b)
        if mine > 0:
            rt = round_trip_loss(enc, dec, enc_out['z'], stoich, heads_vec,
                                 enc_out['magpie_pred'], enc_out['tc_pred'], luts, mine,
                                 z_weight=tcfg.a5_z_weight, tc_weight=tcfg.a5_tc_weight,
                                 max_len=dec.cfg.max_len,
                                 global_subset=None if gb is None else subset)
        else:
            zero = torch.zeros((), device=total.device)
            rt = {'round_trip_loss': zero, 'z_mse': zero, 'tc_mse': zero}
        total = total + (tcfg.loss.constraint_zoo_weight * tcfg.a5_weight
                         * rt['round_trip_loss'])
        metrics['a5_z_mse'] = rt['z_mse']
        metrics['a5_tc_mse'] = rt['tc_mse']
        metrics['total'] = total
    if tcfg.use_theory_loss:
        th = theory_loss(tc_kelvin(enc_out['tc_pred'], tcfg.loss), batch['family'],
                         batch['element_fractions'], batch['element_indices'],
                         batch['element_mask'])
        total = total + dyn.get('theory_w', tcfg.theory_weight) * th['total']
        metrics['theory_loss'] = th['total']
        metrics['total'] = total
    if tcfg.hungarian_enabled:
        # the set decoder: a parallel path on the same z
        if state.set_decoder is None:
            raise ValueError('hungarian_enabled: the train state has no set decoder')
        z_set = enc_out['z'].detach() if tcfg.hungarian_mode == 'set_only' else enc_out['z']
        set_out = _f32(state.set_decoder(z_set))
        h = hungarian_matching_loss(
            set_out['element_logits'], set_out['fraction_pred'],
            set_out['presence_logits'], batch['element_indices'],
            batch['element_fractions'], batch['element_mask'],
            element_weight=tcfg.hungarian_element_weight,
            fraction_weight=tcfg.hungarian_fraction_weight,
            no_object_weight=tcfg.hungarian_no_object_weight,
            presence_weight=tcfg.hungarian_presence_weight)
        total = total + tcfg.hungarian_loss_weight * h['total']
        metrics['hungarian_loss'] = h['total']
        metrics['set_element_accuracy'] = h['element_accuracy']
        metrics['set_exact'] = h['set_exact']
        metrics['total'] = total
    return total, metrics


def make_train_step(tcfg: TrainConfig, luts: Mapping[str, torch.Tensor],
                    rl_enabled: bool = False, group=None):
    """Returns ``step(state, batch, seed, dyn) -> (state, metrics)``.

    ``batch`` holds element_indices / element_fractions / element_mask
    [B, 12], magpie [B, M], tc [B], tokens [B, max_len], is_sc, hp, family
    [B] and comp_targets [B, 15] on the models' device.  ``metrics`` are
    detached scalars on the device (reading one waits for the step):
    ``multitask_loss``'s, with ``use_round_trip`` ``a5_z_mse`` and
    ``a5_tc_mse``, ``theory_loss``, with ``hungarian_enabled``
    ``hungarian_loss``, ``set_element_accuracy`` and ``set_exact``, and
    ``grad_norm``, the global norm of the encoder and decoder gradients
    before clipping (the other groups' are not in it, as in JAX).  With
    ``rl_enabled`` the step adds the SCST or RLOO loss (``tcfg.rl.method``)
    at ``dyn['rl_w']``, and its mean reward and ``reward_var`` to the
    metrics.  ``state.step`` counts steps (mini-steps under
    accumulation).  A compute dtype other than float32 or bfloat16 raises
    ``ValueError``.

    With a process ``group`` (``torch.distributed.group.WORLD`` for the
    default one) ``batch`` is this rank's shard of the global batch and the
    step is data-parallel (see the module's docstring); the state's
    parameters must be equal on every rank (``parallel.replicate``).  With
    a ``parallel.mesh.Grid`` the step is data- and tensor-parallel: the
    state is this rank's ``shard_params_tp`` of one whole state, and
    ``batch`` its data index's shard of the global batch."""
    compute_dtype(tcfg)
    grid = group if isinstance(group, Grid) else None
    data_group = grid.data_group if grid is not None else group
    data_parallel = group is not None and (grid is None or grid.n_data > 1)
    model_group = grid.model_group if grid is not None else None

    def step(state: TrainState, batch: Mapping[str, torch.Tensor], seed: int,
             dyn: Mapping[str, float]) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        for m in (state.encoder, state.decoder, state.set_decoder):
            if m is not None:
                m.train()
        groups = state.groups()
        device = groups[0][0][0].device
        cuda = [device] if device.type == 'cuda' else []
        gb = None
        if data_parallel:
            gb = GlobalBatch(rank=torch.distributed.get_rank(data_group),
                             world=torch.distributed.get_world_size(data_group),
                             local_rows=batch['tokens'].shape[0], group=data_group)
        shards = ({id(p) for n, p in state.decoder.named_parameters()
                   if n in tp_sharded(state.decoder)} if grid is not None else set())
        generator = None
        if rl_enabled:
            generator = torch.Generator(device=device).manual_seed(
                rollout_seed(seed, state.step))
        with torch.random.fork_rng(devices=cuda):
            torch.manual_seed(dropout_seed(seed, state.step, gb.rank if gb else 0))
            for _, opt in groups:
                opt.zero_grad(set_to_none=True)
            with global_batch(gb):
                total, metrics = train_loss(state, tcfg, luts, batch, dyn, generator)
                total.backward()
        norms = []
        for params, opt in groups:
            # a parameter the loss does not reach has a zero gradient, and
            # AdamW still decays it (as optax does)
            for p in params:
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            if gb is not None:
                all_reduce_grads_(params, data_group)
            grads = [p.grad for p in params]
            sharded = [id(p) in shards for p in params]
            if isinstance(opt, MultiSteps):
                # the metric is this mini-step's norm; the clip sees the mean
                norms.append(global_norm(grads, sharded, model_group))
                if not opt.accumulate(grads):
                    continue
                clip_by_global_norm_(grads, tcfg.grad_clip, sharded, model_group)
            else:
                norms.append(clip_by_global_norm_(grads, tcfg.grad_clip, sharded,
                                                  model_group))
            opt.step()
        state.step += 1
        metrics = {k: v.detach() for k, v in metrics.items()}
        if gb is not None:
            metrics = all_reduce_metrics(metrics, data_group)
        metrics['grad_norm'] = torch.sqrt(norms[0] ** 2 + norms[1] ** 2)
        return state, metrics

    return step


def make_epoch_runner(tcfg: TrainConfig, luts: Mapping[str, torch.Tensor],
                      rl_enabled: bool = False, group=None):
    """Returns ``run(state, data, idx_mat, seed, dyn) -> (state, sums)``:
    the train step over the rows ``idx_mat`` [n_batches, B] of the
    device-resident dataset ``data`` (``ds.batch`` of every row as
    tensors on the device), one batch a row, each gathered on the device
    with ``index_select``.  The port of the JAX runner's ``lax.scan``: the
    host sends the indices once, and nothing in the epoch waits for the
    device (no ``.item()``, no copy to the host).  ``sums`` holds each
    metric summed over the steps, as device tensors; the caller reads
    them once.  With a process ``group`` ``idx_mat`` is the global batches'
    rows, of which each rank takes its contiguous block of columns, and the
    sums are the global batches'.  With a ``parallel.mesh.Grid`` the
    columns are split over the data indices."""
    step = make_train_step(tcfg, luts, rl_enabled=rl_enabled, group=group)

    def run(state: TrainState, data: Mapping[str, torch.Tensor], idx_mat, seed: int,
            dyn: Mapping[str, float]) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        device = next(iter(data.values())).device
        idx_mat = np.asarray(idx_mat)
        if group is not None:
            if isinstance(group, Grid):
                rank, n = group.data_index, group.n_data
            else:
                rank, n = (torch.distributed.get_rank(group),
                           torch.distributed.get_world_size(group))
            if idx_mat.shape[1] % n:
                raise ValueError(f'batch of {idx_mat.shape[1]} rows does not divide '
                                 f'over {n} ranks')
            idx_mat = shard_batch_indices(idx_mat.T, rank, n).T
        idx = torch.as_tensor(idx_mat, dtype=torch.long)
        if device.type == 'cuda':     # from pinned memory the copy does not wait
            idx = idx.pin_memory()
        idx_dev = idx.to(device, non_blocking=True)
        sums: Dict[str, torch.Tensor] = {}
        for idx in idx_dev:
            batch = {k: v.index_select(0, idx) for k, v in data.items()}
            state, metrics = step(state, batch, seed, dyn)
            if sums:
                torch._foreach_add_(list(sums.values()), [metrics[k] for k in sums])
            else:
                sums = {k: v.clone() for k, v in metrics.items()}
        return state, sums

    return run
