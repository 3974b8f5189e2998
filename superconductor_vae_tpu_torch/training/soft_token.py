"""Soft-token scheduled sampling: differentiable exposure-bias training
(port of training/soft_token.py).

Instead of sampling a discrete token for the decoder's input (which breaks
differentiability), the second of two passes is fed a mixture of

    hard  = E[target_token]                      (teacher forcing)
    soft  = softmax(first_pass_logits / T) @ E   (expected embedding)

with ``mixed = (1 - r) * hard + r * soft``.  The gradient flows through the
second pass only: the first, teacher-forced pass runs without gradient.
The ratio r ramps per epoch on the host (``soft_token_ratio``).

In train mode both passes draw the same dropout masks, as the JAX package's
two passes do with one ``rngs``: the second pass replays the torch
generator of the first from the state it started at.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

__all__ = ['SoftTokenSchedule', 'soft_token_ratio', 'mix_embeddings',
           'soft_token_forward']


@dataclass(frozen=True)
class SoftTokenSchedule:
    """The ratio schedule: ``start_ratio`` until ``warmup_epochs``, then a
    ramp to ``end_ratio`` over the remaining epochs in the chosen shape."""
    n_epochs: int = 300
    start_ratio: float = 0.0
    end_ratio: float = 0.5
    warmup_epochs: int = 0
    schedule: str = 'linear'  # 'linear' | 'cosine' | 'exponential'


def soft_token_ratio(epoch: int, cfg: SoftTokenSchedule) -> float:
    """The ratio of epoch ``epoch`` (a host-side controller decision)."""
    if epoch < cfg.warmup_epochs:
        return cfg.start_ratio
    effective = max(1, cfg.n_epochs - cfg.warmup_epochs)
    p = min(1.0, (epoch - cfg.warmup_epochs) / effective)
    if cfg.schedule == 'linear':
        shaped = p
    elif cfg.schedule == 'cosine':
        shaped = 0.5 * (1.0 - math.cos(math.pi * p))
    elif cfg.schedule == 'exponential':
        shaped = (math.exp(p) - 1.0) / (math.e - 1.0)
    else:
        raise ValueError(f'unknown soft-token schedule: {cfg.schedule}')
    return cfg.start_ratio + shaped * (cfg.end_ratio - cfg.start_ratio)


def mix_embeddings(hard: torch.Tensor, soft: torch.Tensor, soft_ratio,
                   position_mask=None) -> torch.Tensor:
    """(1 - r) * hard + r * soft, with r and 1 - r rounded to the
    embeddings' dtype as JAX rounds them; where ``position_mask`` [B, T] is
    False the position stays hard."""
    if isinstance(soft_ratio, torch.Tensor):
        r = soft_ratio.to(hard.dtype)
        q = 1.0 - r
    else:
        # rounded on the host (a tensor made on the device would be a copy)
        r = float(torch.tensor(soft_ratio, dtype=hard.dtype))
        q = float(torch.tensor(1.0 - r, dtype=hard.dtype))
    if position_mask is not None:
        soft = torch.where(position_mask[..., None], soft, hard)
    return hard * q + soft * r


def _rng_state(device: torch.device):
    if device.type == 'cuda':
        return torch.cuda.get_rng_state(device)
    return torch.get_rng_state()


def _set_rng_state(state, device: torch.device) -> None:
    if device.type == 'cuda':
        torch.cuda.set_rng_state(state, device)
    else:
        torch.set_rng_state(state)


def soft_token_forward(decoder, z, target_tokens, stoich, heads_vec, soft_ratio,
                       temperature: float = 1.0, position_mask=None):
    """The two-pass soft-token forward; returns the second pass's heads
    (the contract of ``decoder.forward``).

    Pass 1: the teacher-forced forward, without gradient.  Pass 2: the
    forward over mixed embeddings; position 0 (BOS) stays hard, position
    j > 0 mixes in softmax(logits[j-1] / T) @ E, the first pass's
    prediction for position j (softmax in float32, cast to the embedding
    dtype).  The memory is rebuilt from z with the gradient on, so the
    encoder's conditioning still trains.  Dropout follows the decoder's
    mode, with the same masks in both passes."""
    device = z.device
    rng = _rng_state(device)
    with torch.no_grad():
        logits = decoder(z, target_tokens, stoich, heads_vec)['logits']   # [B, T-1, V]

    hard = decoder.embed_hard(target_tokens[:, :-1])                      # [B, T-1, d]
    probs = torch.softmax(logits[:, :-1].float() / max(temperature, 1e-6),
                          dim=-1).to(hard.dtype)                           # [B, T-2, V]
    soft = torch.cat([hard[:, :1], decoder.embed_soft(probs)], dim=1)     # BOS stays hard
    mixed = mix_embeddings(hard, soft, soft_ratio, position_mask=position_mask)

    memory = decoder.build_memory(z, stoich, heads_vec)
    _set_rng_state(rng, device)            # pass 2 draws pass 1's dropout masks
    return decoder.forward_embeds(mixed, memory)
