"""Model architecture configuration (port of models/config.py).

Defaults reproduce the reference V12.43/V14.3 architecture: 108M params,
latent 2048, d_model 576 / 12 layers / ffn 2304, 24 memory tokens.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    # latent + encoder
    latent_dim: int = 2048
    fusion_dim: int = 288
    magpie_dim: int = 145
    encoder_hidden: Tuple[int, ...] = (576, 288)
    decoder_hidden: Tuple[int, ...] = (288, 576)
    element_embed_dim: int = 128
    n_attention_heads: int = 8
    max_elements: int = 12
    n_elements: int = 118
    use_numden_head: bool = False

    # formula decoder
    vocab_size: int = 4752
    d_model: int = 576
    nhead: int = 8
    num_layers: int = 12
    dim_feedforward: int = 2304
    max_len: int = 30
    n_memory_tokens: int = 16
    n_stoich_tokens: int = 4
    n_heads_tokens: int = 4
    heads_input_dim: int = 24       # tc(1)+sc(1)+hp(1)+tc_class(5)+comp(1)+count(1)+family(14)
    stoich_input_dim: int = 13      # fractions(12) + count(1)
    memory_bottleneck_dim: int = 0  # 0 = direct MLP; >0 = bottleneck
    # base width of the sinusoidal table of a width-expanded model
    # (None = plain sinusoids at d_model); see decoder.positional_table
    pos_dim: int | None = None

    dropout: float = 0.1

    # Decode-step self-attention backend.  True: DecoderLayer.step runs
    # the decode-step attention kernel (ops/decode_attention.py) and the
    # KV cache lives in its [B, H, T, Dh] layout; False: the plain
    # masked-softmax path over a [B, T, H, Dh] cache.  Parameter-free: the
    # same weights run under either (the name is the JAX config's).
    pallas_decode: bool = False

    @property
    def head_dim(self) -> int:
        return self.d_model // self.nhead

    @property
    def n_total_memory_tokens(self) -> int:
        return self.n_memory_tokens + self.n_stoich_tokens + self.n_heads_tokens


def config_from_meta(model_config: Dict[str, Any], **overrides) -> ModelConfig:
    """``ModelConfig`` from a checkpoint ``meta.json``'s ``model_config``
    dict (lists become tuples); ``overrides`` replace fields, e.g.
    ``pallas_decode=True``.  run4's dict carries ``magpie_dim`` 78, not the
    default 145."""
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    unknown = set(model_config) - fields
    if unknown:
        raise ValueError(f'unknown model_config keys: {sorted(unknown)}')
    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in model_config.items()}
    kw.update(overrides)
    return ModelConfig(**kw)


def tiny_test_config() -> ModelConfig:
    """Small config for CPU tests: same topology, tiny dims."""
    return ModelConfig(
        latent_dim=64, fusion_dim=32, magpie_dim=16,
        encoder_hidden=(48, 32), decoder_hidden=(32, 48),
        element_embed_dim=16, n_attention_heads=4,
        vocab_size=4752, d_model=32, nhead=4, num_layers=2,
        dim_feedforward=64, max_len=16, n_memory_tokens=4,
        n_stoich_tokens=2, n_heads_tokens=2,
    )
