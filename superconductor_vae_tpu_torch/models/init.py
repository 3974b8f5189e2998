"""Seeded parameter initialisation with the JAX package's initialisers.

Linear weights and the element-attention query: Xavier uniform; biases:
zeros; embeddings and the set decoder's slot queries: normal(0, 0.02);
LayerNorm: ones and zeros.  Values
are drawn on the CPU from an explicit ``torch.Generator`` and copied to
the parameters' device, so a seed gives the same weights on any device.
The parameters are float32 whatever the model's compute dtype
(models/layers.py).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from .encoder import ElementAttention
from .set_decoder import SetFormulaDecoder


def _xavier(shape, generator) -> torch.Tensor:
    fan_out, fan_in = shape            # torch [out, in]; flax [in, out] alike
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return torch.empty(shape).uniform_(-limit, limit, generator=generator)


@torch.no_grad()
def init_params(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Initialises every parameter of ``module`` in place; returns it."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            m.weight.copy_(_xavier(tuple(m.weight.shape), generator))
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.Embedding):
            m.weight.copy_(torch.empty(tuple(m.weight.shape)).normal_(
                0.0, 0.02, generator=generator))
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
        elif isinstance(m, ElementAttention):
            m.query.copy_(_xavier(tuple(m.query.shape), generator))
        elif isinstance(m, SetFormulaDecoder):
            m.slot_queries.copy_(torch.empty(tuple(m.slot_queries.shape)).normal_(
                0.0, 0.02, generator=generator))
    return module
