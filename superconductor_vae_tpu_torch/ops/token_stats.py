"""Token-stream statistics shared by the losses, rewards and constraints
(port of ops/token_stats.py).

Per-element amounts and counts of a batch of token streams as one-hot
contractions over ``[B, T, 119]``, on the device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..tokenizer import (
    ELEMENT_TOKEN_START, EOS_ID, FRACTION_TOKEN_START, INTEGER_TOKEN_START,
)

N_Z = 119  # element accumulator size (Z index, 0 = padding)


def is_element_token(tokens: torch.Tensor) -> torch.Tensor:
    return (tokens >= ELEMENT_TOKEN_START) & (tokens < INTEGER_TOKEN_START)


def is_integer_token(tokens: torch.Tensor) -> torch.Tensor:
    return (tokens >= INTEGER_TOKEN_START) & (tokens < FRACTION_TOKEN_START)


def _shift_left(x: torch.Tensor) -> torch.Tensor:
    """x[:, 1:] with a zero (False) column appended."""
    return torch.cat([x[:, 1:], torch.zeros_like(x[:, :1])], dim=1)


def next_token_quantity(tokens: torch.Tensor, mask: torch.Tensor,
                        token_value_table: torch.Tensor) -> torch.Tensor:
    """For each position: the quantity implied by the FOLLOWING token
    (integer value or fraction value), else 1.0. [B, T]."""
    nxt = _shift_left(tokens)
    nxt_mask = _shift_left(mask)
    qty = token_value_table[nxt.clamp(0, token_value_table.shape[0] - 1)]
    return torch.where((qty > 0) & (nxt_mask > 0), qty, torch.ones_like(qty))


def element_amounts(tokens: torch.Tensor, mask: torch.Tensor,
                    token_to_z: torch.Tensor,
                    token_value_table: torch.Tensor) -> torch.Tensor:
    """Token stream -> per-element amount accumulator [B, 119]: element
    (and isotope) tokens contribute the quantity of their following
    subscript token (default 1)."""
    z = token_to_z[tokens.clamp(0, token_to_z.shape[0] - 1)].long()
    amt = next_token_quantity(tokens, mask, token_value_table)
    contrib = torch.where((z > 0) & (mask > 0), amt, torch.zeros_like(amt))
    onehot = F.one_hot(z, N_Z).to(contrib.dtype)
    return torch.einsum('bt,btz->bz', contrib, onehot)


def element_counts(tokens: torch.Tensor, mask: torch.Tensor,
                   token_to_z: torch.Tensor) -> torch.Tensor:
    """Occurrence count of each element Z in the stream. [B, 119]."""
    z = token_to_z[tokens.clamp(0, token_to_z.shape[0] - 1)].long()
    onehot = F.one_hot(z, N_Z).float()
    return torch.einsum('bt,btz->bz', ((z > 0) & (mask > 0)).float(), onehot)


def integer_subscripts(tokens: torch.Tensor, mask: torch.Tensor):
    """Per element-position integer subscript values (default 1).

    Returns (values [B, T] float, present [B, T] bool), where present marks
    element positions within the masked region."""
    valid = mask > 0
    elem = is_element_token(tokens) & valid
    nxt = _shift_left(tokens)
    nxt_int = is_integer_token(nxt) & _shift_left(valid)
    int_val = torch.where(nxt_int, nxt - INTEGER_TOKEN_START + 1,
                          torch.ones_like(nxt))
    return torch.where(elem, int_val, torch.ones_like(int_val)).float(), elem


def stream_has_fraction(tokens: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """True per sample if any fraction token appears in the masked region."""
    return ((tokens >= FRACTION_TOKEN_START) & (mask > 0)).any(dim=1)


def first_eos_position(tokens: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Position of first EOS within mask, else number of valid tokens. [B]."""
    is_end = (tokens == EOS_ID) & (mask > 0)
    pos = is_end.int().argmax(dim=1)
    has = is_end.any(dim=1)
    return torch.where(has, pos.float(), mask.sum(dim=1).float())
