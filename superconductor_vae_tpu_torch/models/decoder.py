"""Transformer formula decoder with fixed-shape KV-cache decoding (port of
models/decoder.py).

Pre-norm decoder layers cross-attend to 24 memory tokens built from the
latent z (16), the stoichiometry conditioning (4) and the encoder-head
predictions (4); output projection, stop head, site-duplication head and
5-way token-type head.

The KV cache is pre-allocated (``init_cache``) and updated in place, one
row per step.  Its layout is ``[L, B, T, H, Dh]`` for the plain path and
``[L, B, H, T, Dh]`` when ``cfg.pallas_decode`` routes the step's
self-attention through the decode-step kernel (ops/decode_attention.py),
in the compute dtype.  Cross-attention K/V over the static memory are
projected once per generation (``memory_kv``).  ``dtype`` is the compute
dtype, as flax's: the parameters are float32 whatever it is
(models/layers.py).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops.attention import causal_mask, mha_attention
from ..ops.decode_attention import decode_step_attention
from ..utils.device import resolve_device
from .config import ModelConfig
from .layers import Dense, Embed, LayerNorm
from .layers import gelu as _gelu


def sinusoidal_positions(max_len: int, d_model: int) -> np.ndarray:
    """Standard sin/cos positional table [max_len, d_model]."""
    pos = np.arange(max_len)[:, None].astype(np.float32)
    div = np.exp(np.arange(0, d_model, 2).astype(np.float32)
                 * (-math.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model), dtype=np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div[: pe[:, 1::2].shape[1]])
    return pe


def head_dup_map(old_d: int, new_d: int, groups: int) -> np.ndarray:
    """Uniform channel-duplication map [new_d] -> old channel index,
    block-structured per attention head so head splits stay aligned."""
    if new_d % old_d or old_d % groups or new_d % groups:
        raise ValueError(f'cannot map width {old_d} to {new_d} in {groups} groups')
    go, gn = old_d // groups, new_d // groups
    m = np.zeros(new_d, np.int64)
    for h in range(groups):
        m[h * gn:(h + 1) * gn] = h * go + np.sort(np.tile(np.arange(go), gn // go))
    return m


def positional_table(cfg: ModelConfig) -> np.ndarray:
    """Sinusoidal table at ``cfg.pos_dim`` (the pre-expansion width),
    channel-duplicated up to d_model; max_len + 8 rows."""
    n = cfg.max_len + 8
    if cfg.pos_dim is None or cfg.pos_dim == cfg.d_model:
        return sinusoidal_positions(n, cfg.d_model)
    base = sinusoidal_positions(n, cfg.pos_dim)
    return base[:, head_dup_map(cfg.pos_dim, cfg.d_model, cfg.nhead)]


class DecoderLayer(nn.Module):
    """Pre-norm decoder layer: causal self-attn, cross-attn to memory, GELU FFN."""

    def __init__(self, cfg: ModelConfig, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg = cfg
        d = cfg.d_model
        for name in ('norm1', 'norm2', 'norm3'):
            self.add_module(name, LayerNorm(d, **kw))
        for name in ('self_q', 'self_k', 'self_v', 'self_o',
                     'cross_q', 'cross_k', 'cross_v', 'cross_o'):
            self.add_module(name, Dense(d, d, **kw))
        self.ff1 = Dense(d, cfg.dim_feedforward, **kw)
        self.ff2 = Dense(cfg.dim_feedforward, d, **kw)

    def _split(self, x):
        b, t, _ = x.shape
        return x.reshape(b, t, self.cfg.nhead, self.cfg.head_dim)

    def _drop(self, x):
        return F.dropout(x, self.cfg.dropout, self.training)

    def cross_kv(self, memory) -> Tuple[torch.Tensor, torch.Tensor]:
        """Project the static memory to K/V once per generation. [B,M,H,Dh] x2."""
        return self._split(self.cross_k(memory)), self._split(self.cross_v(memory))

    def self_kv(self, x_norm) -> Tuple[torch.Tensor, torch.Tensor]:
        return self._split(self.self_k(x_norm)), self._split(self.self_v(x_norm))

    def forward(self, x, memory, self_mask, memory_kv=None):
        b, t, d = x.shape
        xn = self.norm1(x)
        q = self._split(self.self_q(xn))
        k, v = self.self_kv(xn)
        sa = mha_attention(q, k, v, self_mask).reshape(b, t, d)
        x = x + self._drop(self.self_o(sa))
        xn = self.norm2(x)
        q = self._split(self.cross_q(xn))
        mk, mv = memory_kv if memory_kv is not None else self.cross_kv(memory)
        ca = mha_attention(q, mk, mv).reshape(b, t, d)
        x = x + self._drop(self.cross_o(ca))
        xn = self.norm3(x)
        ff = self.ff2(self._drop(_gelu(self.ff1(xn))))
        return x + self._drop(ff)

    def step(self, x, k_cache, v_cache, memory_kv, position: int, valid_len: int):
        """Single-token forward with the fixed-shape KV cache.

        x: [B, 1, d]; k_cache/v_cache: [B, T, H, Dh], or [B, H, T, Dh] under
        ``cfg.pallas_decode``, updated IN PLACE at ``position``;
        memory_kv: (mk, mv); valid_len: cache capacity (== max_len).
        Returns (x_out [B,1,d], k_cache, v_cache)."""
        b = x.shape[0]
        d = self.cfg.d_model
        xn = self.norm1(x)
        q = self._split(self.self_q(xn))                      # [B,1,H,Dh]
        k_new, v_new = self.self_kv(xn)
        if self.cfg.pallas_decode:
            sa = decode_step_attention(
                q[:, 0].contiguous(), k_new[:, 0].contiguous(),
                v_new[:, 0].contiguous(), k_cache, v_cache, position)
            sa = sa.reshape(b, 1, d)
        else:
            k_cache[:, position] = k_new[:, 0]
            v_cache[:, position] = v_new[:, 0]
            pos_ids = torch.arange(valid_len, device=x.device)[None, None, None, :]
            sa = mha_attention(q, k_cache, v_cache,
                               pos_ids <= position).reshape(b, 1, d)
        x = x + self.self_o(sa)
        xn = self.norm2(x)
        mk, mv = memory_kv
        ca = mha_attention(self._split(self.cross_q(xn)), mk, mv).reshape(b, 1, d)
        x = x + self.cross_o(ca)
        x = x + self.ff2(_gelu(self.ff1(self.norm3(x))))
        return x, k_cache, v_cache


class MemoryBuilder(nn.Module):
    """z + stoich + head predictions -> [B, 24, d_model] memory tokens,
    laid out [latent(16) | stoich(4) | heads(4)]."""

    def __init__(self, cfg: ModelConfig, device=None, dtype=torch.float32):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.cfg, self.dtype = cfg, dtype
        d = cfg.d_model
        ln = 0                       # flax numbers the unnamed LayerNorms
        if cfg.memory_bottleneck_dim > 0:
            self.latent_bottleneck = Dense(cfg.latent_dim, cfg.memory_bottleneck_dim, **kw)
            self.add_module(f'LayerNorm_{ln}', LayerNorm(
                cfg.memory_bottleneck_dim, **kw))
            self._latent_ln = f'LayerNorm_{ln}'
            ln += 1
            self.latent_out = Dense(cfg.memory_bottleneck_dim, d * cfg.n_memory_tokens, **kw)
        else:
            self.latent_mid = Dense(cfg.latent_dim, d * cfg.n_memory_tokens // 2, **kw)
            self.latent_out = Dense(d * cfg.n_memory_tokens // 2, d * cfg.n_memory_tokens,
                                    **kw)
        if cfg.n_stoich_tokens > 0:
            self.stoich_mid = Dense(cfg.stoich_input_dim, d, **kw)
            self.add_module(f'LayerNorm_{ln}', LayerNorm(d, **kw))
            self._stoich_ln = f'LayerNorm_{ln}'
            ln += 1
            self.stoich_out = Dense(d, d * cfg.n_stoich_tokens, **kw)
        if cfg.n_heads_tokens > 0:
            self.heads_mid1 = Dense(cfg.heads_input_dim, d // 2, **kw)
            self.add_module(f'LayerNorm_{ln}', LayerNorm(d // 2, **kw))
            self._heads_ln = f'LayerNorm_{ln}'
            self.heads_mid2 = Dense(d // 2, d, **kw)
            self.heads_out = Dense(d, d * cfg.n_heads_tokens, **kw)

    def forward(self, z, stoich, heads_vec):
        cfg = self.cfg
        d = cfg.d_model
        b = z.shape[0]
        dt = self.dtype
        z = z.to(dt)
        if cfg.memory_bottleneck_dim > 0:
            h = _gelu(getattr(self, self._latent_ln)(self.latent_bottleneck(z)))
        else:
            h = _gelu(self.latent_mid(z))
        parts = [self.latent_out(h).reshape(b, cfg.n_memory_tokens, d)]
        if cfg.n_stoich_tokens > 0:
            s = _gelu(getattr(self, self._stoich_ln)(self.stoich_mid(stoich.to(dt))))
            parts.append(self.stoich_out(s).reshape(b, cfg.n_stoich_tokens, d))
        if cfg.n_heads_tokens > 0:
            hh = _gelu(getattr(self, self._heads_ln)(self.heads_mid1(heads_vec.to(dt))))
            hh = self.heads_out(_gelu(self.heads_mid2(hh)))
            parts.append(hh.reshape(b, cfg.n_heads_tokens, d))
        return torch.cat(parts, dim=1)


class FormulaDecoder(nn.Module):
    """Formula decoder with the teacher-forced forward and the cached
    decode step.  Built on ``device`` (default CUDA; raises if it is
    absent), computing in ``dtype`` with float32 parameters."""

    def __init__(self, cfg: ModelConfig, device='cuda', dtype=torch.float32):
        super().__init__()
        device = resolve_device(device)
        kw = dict(device=device, dtype=dtype)
        self.cfg, self.dtype = cfg, dtype
        d = cfg.d_model
        self.token_embedding = Embed(cfg.vocab_size, d, **kw)
        # +8 slack rows, as in the JAX table (chunked decode reads past the end)
        self.register_buffer('pos_table', torch.tensor(
            positional_table(cfg), device=device), persistent=False)
        self.memory_builder = MemoryBuilder(cfg, **kw)
        for i in range(cfg.num_layers):
            self.add_module(f'layer_{i}', DecoderLayer(cfg, **kw))
        self.out_ln = LayerNorm(d, **kw)
        self.out_d1 = Dense(d, d, **kw)
        self.out_d2 = Dense(d, cfg.vocab_size, **kw)
        self.stop_d1 = Dense(d, d // 4, **kw)
        self.stop_d2 = Dense(d // 4, 1, **kw)
        self.dup_d1 = Dense(d, d // 4, **kw)
        self.dup_d2 = Dense(d // 4, 1, **kw)
        self.type_ln = LayerNorm(d, **kw)
        self.type_d1 = Dense(d, d, **kw)
        self.type_d2 = Dense(d, d // 4, **kw)
        self.type_d3 = Dense(d // 4, 5, **kw)

    @property
    def layers(self) -> List[DecoderLayer]:
        return [getattr(self, f'layer_{i}') for i in range(self.cfg.num_layers)]

    def _drop(self, x, deterministic: bool = False):
        return F.dropout(x, self.cfg.dropout, self.training and not deterministic)

    # -- heads ---------------------------------------------------------------
    def output_heads(self, h, deterministic: bool = False) -> Dict[str, torch.Tensor]:
        """Hidden states -> (vocab logits, stop, type, site-dup) heads.
        Dropout runs in train mode unless ``deterministic``."""
        y = self._drop(_gelu(self.out_d1(self.out_ln(h))), deterministic)
        logits = self.out_d2(y)
        stop = self.stop_d2(_gelu(self.stop_d1(h)))[..., 0]
        dup = self.dup_d2(_gelu(self.dup_d1(h)))[..., 0]
        t = self._drop(_gelu(self.type_d1(self.type_ln(h))), deterministic)
        t = self._drop(_gelu(self.type_d2(t)), deterministic)
        return {'logits': logits, 'stop_logits': stop,
                'type_logits': self.type_d3(t), 'site_dup_logits': dup}

    # -- memory --------------------------------------------------------------
    def build_memory(self, z, stoich, heads_vec) -> torch.Tensor:
        return self.memory_builder(z, stoich, heads_vec)

    def memory_kv(self, memory) -> List[Tuple[torch.Tensor, torch.Tensor]]:
        """Per-layer cross-attention K/V, projected once per generation."""
        return [layer.cross_kv(memory) for layer in self.layers]

    # -- teacher-forced parallel forward --------------------------------------
    def forward(self, z, target_tokens, stoich, heads_vec,
                memory: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """One parallel causal forward over ``target_tokens[:, :-1]``
        ([B, T] ids incl. BOS/EOS/PAD).  Returns logits [B, T-1, V], the
        argmax ``generated``, stop/type/dup logits and the memory."""
        if memory is None:
            memory = self.build_memory(z, stoich, heads_vec)
        return self.forward_embeds(self.token_embedding(target_tokens[:, :-1]),
                                   memory)

    def forward_embeds(self, input_embeds, memory) -> Dict[str, torch.Tensor]:
        """Parallel causal forward over explicit (pre-positional) input
        embeddings."""
        t = input_embeds.shape[1]
        x = self._drop(input_embeds + self.pos_table[None, :t].to(self.dtype))
        mask = causal_mask(t, device=x.device)
        for layer in self.layers:
            x = layer(x, memory, mask)
        heads = self.output_heads(x)
        heads['generated'] = heads['logits'].argmax(dim=-1)
        heads['memory'] = memory
        return heads

    def embed_hard(self, tokens) -> torch.Tensor:
        """Token ids -> embeddings in the compute dtype (the soft-token
        mixer's hard side)."""
        return self.token_embedding(tokens)

    def embed_soft(self, probs) -> torch.Tensor:
        """Probability rows -> expected embedding, ``probs @ E`` in the
        probabilities' dtype."""
        return probs @ self.token_embedding.weight.to(probs.dtype)

    # -- single-token cached step ---------------------------------------------
    def decode_step(self, token, position: int, k_caches, v_caches, memory_kvs):
        """One AR step through all layers with the fixed-shape cache.

        token: [B] current input token; position: int;
        k_caches/v_caches: ``init_cache``'s [L, ...] tensors, updated IN
        PLACE; memory_kvs: per-layer (mk, mv).
        Returns (head outputs for this position, k_caches, v_caches).
        Runs without dropout in either mode, as a rollout inside a train
        step must."""
        x = (self.token_embedding(token)
             + self.pos_table[position].to(self.dtype))[:, None, :]
        for i, layer in enumerate(self.layers):
            x, _, _ = layer.step(x, k_caches[i], v_caches[i], memory_kvs[i],
                                 position, self.cfg.max_len)
        heads = self.output_heads(x, deterministic=True)
        return {k: v[:, 0] for k, v in heads.items()}, k_caches, v_caches

    # -- chunked cached forward (speculative verification) ----------------------
    def _chunk_layers(self, x, mask, write, k_caches, v_caches, memory_kvs):
        """The layers over a chunk of K tokens: ``write(cache, rows)`` puts
        each layer's new K/V rows into its cache in place, then the chunk's
        queries attend the whole cache under ``mask`` (plain attention, no
        dropout).  Returns the output heads over the K positions."""
        b, k = x.shape[:2]
        d = self.cfg.d_model
        for i, layer in enumerate(self.layers):
            xn = layer.norm1(x)
            q = layer._split(layer.self_q(xn))
            kk, vv = layer.self_kv(xn)
            write(k_caches[i], kk)
            write(v_caches[i], vv)
            sa = mha_attention(q, k_caches[i], v_caches[i], mask).reshape(b, k, d)
            x = x + layer.self_o(sa)
            xn = layer.norm2(x)
            mk, mv = memory_kvs[i]
            ca = mha_attention(layer._split(layer.cross_q(xn)), mk, mv).reshape(b, k, d)
            x = x + layer.cross_o(ca)
            x = x + layer.ff2(_gelu(layer.ff1(layer.norm3(x))))
        return self.output_heads(x, deterministic=True)

    def _check_chunk_layout(self):
        if self.cfg.pallas_decode:
            raise ValueError('the chunk forward needs the [L, B, T, H, Dh] cache layout '
                             '(a decoder with pallas_decode=False)')

    def decode_chunk(self, tokens, position: int, k_caches, v_caches, memory_kvs):
        """K-token chunk forward with the fixed-shape cache: ``tokens [B, K]``
        from ``position`` on, causal within the chunk, attending every cached
        slot before it (query i attends slots <= position + i).  The K/V rows
        go into the caches in place; a start past the end clamps, as XLA's
        dynamic slices do.  Returns (heads over the K positions, k_caches,
        v_caches)."""
        self._check_chunk_layout()
        b, k = tokens.shape
        t_cache = k_caches.shape[2]
        dev = tokens.device
        pe_start = min(max(position, 0), self.pos_table.shape[0] - k)
        x = self.token_embedding(tokens) + self.pos_table[pe_start:pe_start + k][None].to(
            self.dtype)
        q_pos = position + torch.arange(k, device=dev)
        mask = torch.arange(t_cache, device=dev)[None, None, None, :] <= q_pos[None, None, :, None]
        start = min(max(position, 0), t_cache - k)

        def write(cache, rows):
            cache[:, start:start + k] = rows
        heads = self._chunk_layers(x, mask, write, k_caches, v_caches, memory_kvs)
        return heads, k_caches, v_caches

    def decode_chunk_perrow(self, tokens, positions, k_caches, v_caches, memory_kvs):
        """``decode_chunk`` with a start position for each row (``positions``
        [B] int64), so that each row of a speculative decode advances by its
        own count.  The positional rows and the mask use the positions
        clipped to the positional table (query i of row b attends slots <=
        its clipped position); the cache write is a dense gather and select
        over the cache axis: slot t of row b takes the chunk's row
        t - positions[b] where that lies in 0..K-1, written in place.
        Returns (heads over the K positions, k_caches, v_caches)."""
        self._check_chunk_layout()
        b, k = tokens.shape
        dev = tokens.device
        pos_idx = (positions[:, None] + torch.arange(k, device=dev)[None, :]).clamp(
            0, self.pos_table.shape[0] - 1)                       # [B, K]
        x = self.token_embedding(tokens) + self.pos_table[pos_idx].to(self.dtype)
        t_cache = k_caches.shape[2]
        cache_pos = torch.arange(t_cache, device=dev)             # [T]
        mask = cache_pos[None, None, None, :] <= pos_idx[:, None, :, None]
        offset = cache_pos[None, :] - positions[:, None]          # [B, T]
        upd_idx = offset.clamp(0, k - 1)
        sel = ((offset >= 0) & (offset < k))[:, :, None, None]

        def write(cache, rows):
            # cache [B, T, H, Dh], rows [B, K, H, Dh]
            g = torch.gather(rows, 1, upd_idx[:, :, None, None].expand(
                b, t_cache, *rows.shape[2:]))
            cache.copy_(torch.where(sel, g, cache))
        heads = self._chunk_layers(x, mask, write, k_caches, v_caches, memory_kvs)
        return heads, k_caches, v_caches

    def init_cache(self, batch_size: int, extra: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
        """Zeroed K and V caches in the compute dtype: [L, B, H, T, Dh] under
        ``cfg.pallas_decode`` (the kernel's layout), else [L, B, T + extra,
        H, Dh]: ``extra`` slack rows take a chunk's writes at the tail
        (speculative decoding), which the kernel's layout refuses."""
        cfg = self.cfg
        if cfg.pallas_decode:
            if extra != 0:
                raise ValueError('init_cache: slack rows (the speculative chunk forward) '
                                 'need the [L, B, T, H, Dh] layout, not pallas_decode')
            shape = (cfg.num_layers, batch_size, cfg.nhead, cfg.max_len, cfg.head_dim)
        else:
            shape = (cfg.num_layers, batch_size, cfg.max_len + extra, cfg.nhead, cfg.head_dim)
        kw = dict(device=self.pos_table.device, dtype=self.dtype)
        return torch.zeros(shape, **kw), torch.zeros(shape, **kw)


def plain_layout(decoder: FormulaDecoder) -> FormulaDecoder:
    """``decoder`` if its caches have the plain [L, B, T, H, Dh] layout;
    else a twin built with ``pallas_decode=False`` that holds the same
    parameter objects (trained and updated as one), in the same mode.  The
    speculative chunk forward needs that layout."""
    if not decoder.cfg.pallas_decode:
        return decoder
    twin = FormulaDecoder(dataclasses.replace(decoder.cfg, pallas_decode=False),
                          device=decoder.pos_table.device, dtype=decoder.dtype)
    twin.load_state_dict(decoder.state_dict(keep_vars=True), assign=True)
    return twin.train(decoder.training)
