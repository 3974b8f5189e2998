"""Function-preserving model surgery on the port's state dicts (port of
models/surgery.py): vocab growth, Net2Net widening of a Dense pair and a
LayerNorm, identity-initialised decoder layers (deepen), the legacy Tc
head upgrade, and the whole-model decoder and encoder widening.

Each function takes and returns ``state_dict``s (a ``Linear`` weight is
``[out, in]``, the transposed flax kernel).  The arithmetic runs on numpy
copies in the flax kernel layout ``[in, out]`` (``_kernel_tree``), in the
JAX package's order: the same ``np.random.default_rng`` draws, in the
same sequence and shapes, and the same float64 steps (a consumer row
divided by a float64 multiplicity), so that a result cast once to
float32 is the JAX surgery's to the bit, noise or none.  The new state
dicts target the configs that ``widened_config`` and
``widened_encoder_config`` return, and ``num_layers + n`` after
``deepen_decoder``; the positional table is derived from the config
(``decoder.positional_table``), so nothing of it is stored.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from .decoder import head_dup_map

# the port's Embed modules: their 2-D weight is a flax 'embedding', not a kernel
_EMBEDS = frozenset({'token_embedding', 'element_embed'})


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x, dtype=np.float32)))


def _kernel_tree(sd: Mapping[str, torch.Tensor]) -> Dict:
    """A state dict as a nested dict of numpy arrays in flax's leaf names
    and layouts (kernel [in, out], scale, bias, embedding)."""
    tree: Dict = {}
    for key, v in sd.items():
        *mods, leaf = key.split('.')
        a = _np(v).copy()
        if leaf == 'weight':
            if a.ndim == 1:
                leaf = 'scale'
            elif mods and mods[-1] in _EMBEDS:
                leaf = 'embedding'
            else:
                leaf, a = 'kernel', a.T.copy()
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = a
    return tree


def _state_dict(tree: Mapping) -> Dict[str, torch.Tensor]:
    """The inverse of ``_kernel_tree``, every leaf cast once to float32."""
    from ..checkpoint.from_jax import state_dict_from_flax
    return state_dict_from_flax(tree)


# ---- the pieces ----------------------------------------------------------------

def _widen_kernels(k1, b1, k2, new_width: int, rng: np.random.Generator,
                   noise: float):
    """Net2WiderNet on kernels [in, w] -> [in, new_width] and [w, out] ->
    [new_width, out] (the JAX function, in its layout)."""
    k1, b1, k2 = _np(k1), _np(b1), _np(k2)
    w = k1.shape[1]
    if new_width < w:
        raise ValueError(f'widen_dense_pair: new width {new_width} < {w}')
    mapping = np.concatenate([np.arange(w), rng.integers(0, w, new_width - w)])
    counts = np.bincount(mapping, minlength=w).astype(k2.dtype)
    k1_new = k1[:, mapping] + noise * rng.standard_normal(
        (k1.shape[0], new_width)).astype(k1.dtype) * (np.arange(new_width) >= w)
    b1_new = b1[mapping]
    k2_new = (k2[mapping, :].T / counts[mapping]).T
    return k1_new, b1_new, k2_new.astype(k2.dtype), mapping


def widen_dense_pair(weight1, bias1, weight2, new_width: int,
                     rng: np.random.Generator, noise: float = 1e-3
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, np.ndarray]:
    """Net2WiderNet on a Linear -> Linear pair (function preserving):
    ``weight1`` [w, in] -> [new_width, in], ``weight2`` [out, w] -> [out,
    new_width].  New units copy random old units; the consumer's columns
    are divided by the copies' multiplicity, so outputs are unchanged up to
    the new units' noise.  Returns (weight1', bias1', weight2', mapping)."""
    k1, b1, k2, mapping = _widen_kernels(_np(weight1).T, bias1, _np(weight2).T,
                                         new_width, rng, noise)
    return _t(k1.T), _t(b1), _t(k2.T), mapping


def widen_layernorm(scale, bias, mapping: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
    return _t(_np(scale)[mapping]), _t(_np(bias)[mapping])


def expand_vocab_rows(
    embedding: np.ndarray,             # [V_old, d]
    new_vocab: int,
    parent_map: Optional[Dict[int, int]] = None,
    rng: Optional[np.random.Generator] = None,
    init_scale: float = 0.02,
) -> np.ndarray:
    """Grow the token embedding to ``new_vocab`` rows.  ``parent_map[new_id]
    = old_id`` starts a new row from a semantic parent (an isotope from its
    element) plus noise; other new rows get small random values."""
    emb = _np(embedding)
    v_old, d = emb.shape
    rng = rng or np.random.default_rng(0)
    out = np.concatenate(
        [emb, init_scale * rng.standard_normal(
            (new_vocab - v_old, d)).astype(emb.dtype)], axis=0)
    if parent_map:
        for new_id, old_id in parent_map.items():
            if v_old <= new_id < new_vocab and old_id < v_old:
                out[new_id] = emb[old_id] + init_scale * \
                    rng.standard_normal(d).astype(emb.dtype)
    return out


def expand_output_head_rows(
    kernel: np.ndarray,                # [d, V_old]
    bias: np.ndarray,                  # [V_old]
    new_vocab: int,
    parent_map: Optional[Dict[int, int]] = None,
    new_bias_value: float = -4.0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Grow a vocab projection; new logits start suppressed (bias -4) or
    copy their parent's column."""
    k, b = _np(kernel), _np(bias)
    d, v_old = k.shape
    k_new = np.concatenate(
        [k, np.zeros((d, new_vocab - v_old), k.dtype)], axis=1)
    b_new = np.concatenate(
        [b, np.full(new_vocab - v_old, new_bias_value, b.dtype)])
    if parent_map:
        for new_id, old_id in parent_map.items():
            if v_old <= new_id < new_vocab and old_id < v_old:
                k_new[:, new_id] = k[:, old_id]
                b_new[new_id] = b[old_id]
    return k_new, b_new


def isotope_parent_map(tokenizer) -> Dict[int, int]:
    """ISO token id -> parent element token id (for vocab migration init)."""
    out = {}
    if not tokenizer.isotopes:
        return out
    from ..chem.isotopes import parse_isotope
    for i, iso in enumerate(tokenizer.isotopes):
        _, sym = parse_isotope(iso)
        out[tokenizer.isotope_token_start + i] = tokenizer.token_id(sym)
    return out


def expand_decoder_vocab(dec_state: Mapping[str, torch.Tensor], new_vocab: int,
                         parent_map: Optional[Dict[int, int]] = None
                         ) -> Dict[str, torch.Tensor]:
    """Vocab migration of a ``FormulaDecoder`` state dict: grows the
    ``token_embedding`` rows and the output projection ``out_d2``.
    Returns a new state dict of CPU tensors."""
    sd = {k: v.detach().cpu() for k, v in dec_state.items()}
    emb = expand_vocab_rows(sd['token_embedding.weight'].numpy(), new_vocab, parent_map)
    k, b = expand_output_head_rows(sd['out_d2.weight'].numpy().T, sd['out_d2.bias'].numpy(),
                                   new_vocab, parent_map)
    sd['token_embedding.weight'] = torch.from_numpy(emb)
    sd['out_d2.weight'] = torch.from_numpy(np.ascontiguousarray(k.T))
    sd['out_d2.bias'] = torch.from_numpy(b)
    return sd


_RESIDUAL_WRITERS = ('self_o', 'cross_o', 'ff2')


def identity_decoder_layer(layer_state: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A decoder layer's state dict (keys relative to the layer) with its
    residual-writing projections ``self_o``, ``cross_o`` and ``ff2``
    zeroed: a pre-norm layer so made is the identity, and inserting it is
    a function-preserving deepen."""
    return {k: (torch.zeros_like(v) if k.split('.')[0] in _RESIDUAL_WRITERS
                else v.detach().cpu().clone())
            for k, v in layer_state.items()}


def deepen_decoder(dec_state: Mapping[str, torch.Tensor], n_new_layers: int
                   ) -> Dict[str, torch.Tensor]:
    """Appends ``n_new_layers`` identity layers (clones of the last layer,
    residual projections zeroed) after the stack.  Returns a state dict
    for ``num_layers + n_new_layers``."""
    sd = {k: v.detach().cpu().clone() for k, v in dec_state.items()}
    last = max(int(k.split('.')[0].split('_')[1]) for k in sd if k.startswith('layer_'))
    prefix = f'layer_{last}.'
    layer = {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}
    for i in range(n_new_layers):
        for k, v in identity_decoder_layer(layer).items():
            sd[f'layer_{last + 1 + i}.{k}'] = v
    return sd


def upgrade_tc_head(enc_state: Mapping[str, torch.Tensor],
                    old_tc_head: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Transfers a legacy two-layer Tc head, ``{'weight0' [256, in],
    'bias0', 'weight1' [1, 256], 'bias1'}`` in ``Linear`` layout (either
    layer may be absent), into the residual Tc stack: ``tc_proj`` takes
    layer 0; ``tc_out_2`` (128 -> 1) takes the old output's first 128
    input connections; ``tc_out_1`` (256 -> 128) becomes a slice
    identity."""
    sd = {k: v.detach().cpu().clone() for k, v in enc_state.items()}
    if 'weight0' in old_tc_head:
        sd['tc_proj.weight'] = _t(_np(old_tc_head['weight0']))
        sd['tc_proj.bias'] = _t(_np(old_tc_head['bias0']))
    if 'weight1' in old_tc_head:
        old_w = _np(old_tc_head['weight1'])              # [1, 256]
        eye = torch.zeros_like(sd['tc_out_1.weight'])
        n = min(eye.shape)
        eye[torch.arange(n), torch.arange(n)] = 1.0
        sd['tc_out_1.weight'] = eye
        sd['tc_out_1.bias'] = torch.zeros_like(sd['tc_out_1.bias'])
        sd['tc_out_2.weight'] = _t(old_w[:, :sd['tc_out_2.weight'].shape[1]])
        sd['tc_out_2.bias'] = _t(_np(old_tc_head['bias1']))
    return sd


# ---- whole-model decoder widening ------------------------------------------------

def widened_config(cfg, new_d_model: int, new_dim_feedforward: int):
    """The config an ``expand_decoder_width`` result targets: the new
    widths, with ``pos_dim`` pinned to the original model's positional
    base so that the widened decoder keeps a channel duplication of the
    same sinusoidal table."""
    return dataclasses.replace(cfg, d_model=new_d_model,
                               dim_feedforward=new_dim_feedforward,
                               pos_dim=cfg.pos_dim or cfg.d_model)


def _uniform_map(old_d: int, new_d: int, groups: int):
    m = head_dup_map(old_d, new_d, groups)
    counts = np.bincount(m, minlength=old_d)
    return m, counts[m].astype(np.float64)


def expand_decoder_width(dec_state: Mapping[str, torch.Tensor], cfg, new_d_model: int,
                         new_dim_feedforward: int, noise: float = 0.0,
                         seed: int = 0) -> Dict[str, torch.Tensor]:
    """Widens the whole ``FormulaDecoder`` (d_model and dim_feedforward in
    every layer, the embedding, the memory builder and the output heads),
    exactly function preserving: every channel is duplicated uniformly
    within its head (``head_dup_map``), so LayerNorm statistics, every
    consumer's sum and the attention scores (q scaled by sqrt(dh'/dh), k
    and v divided by the multiplicity) are unchanged.  The widths must be
    integer multiples of the old ones: uneven duplication changes the
    LayerNorm statistics, so it raises.  ``noise > 0`` adds normal noise of
    that scale to every produced column (symmetry breaking), drawn from
    ``np.random.default_rng(seed)`` in the JAX function's order.  Returns
    a state dict for ``widened_config(cfg, new_d_model,
    new_dim_feedforward)``."""
    d, ff, nhead = cfg.d_model, cfg.dim_feedforward, cfg.nhead
    if new_d_model % nhead:
        raise ValueError(f'expand_decoder_width: d_model {new_d_model} is not a '
                         f'multiple of {nhead} heads')
    if new_d_model % d or new_dim_feedforward % ff:
        raise ValueError(
            f'expand_decoder_width requires integer widening factors: '
            f'{d}->{new_d_model}, {ff}->{new_dim_feedforward}')
    dh, dh2 = d // nhead, new_d_model // nhead
    rng = np.random.default_rng(seed)
    m, mult = _uniform_map(d, new_d_model, nhead)       # the residual stream's map
    mf, multf = _uniform_map(ff, new_dim_feedforward, 1)

    def nz(shape):
        return rng.normal(0, noise, shape) if noise > 0 else 0.0

    def cols(k, mm):                                     # produces into the stream
        out = k[..., mm]
        return out + nz(out.shape)

    def rows(k, mm, mm_mult):                            # consumes from the stream
        return k[mm] / mm_mult[:, None]

    def flat_cols(k, n_tokens):                          # [in, n*d] -> [in, n*d'] a token
        k3 = k.reshape(k.shape[0], n_tokens, d)
        return k3[..., m].reshape(k.shape[0], n_tokens * new_d_model)

    def flat_bias(b, n_tokens):
        return b.reshape(n_tokens, d)[:, m].reshape(-1)

    def map_ln(ln, mm):
        ln['scale'], ln['bias'] = ln['scale'][mm], ln['bias'][mm]

    root = _kernel_tree(dec_state)
    scale = float(np.sqrt(dh2 / dh))
    root['token_embedding']['embedding'] = cols(root['token_embedding']['embedding'], m)

    mb = root['memory_builder']
    n_mem, n_st, n_hd = cfg.n_memory_tokens, cfg.n_stoich_tokens, cfg.n_heads_tokens
    if 'latent_mid' in mb:      # the direct path: its mid width d*M//2 scales with d
        k1, b1, k2, _ = _widen_kernels(mb['latent_mid']['kernel'], mb['latent_mid']['bias'],
                                       mb['latent_out']['kernel'],
                                       new_d_model * n_mem // 2, rng, noise)
        mb['latent_mid']['kernel'], mb['latent_mid']['bias'] = k1, b1
        mb['latent_out']['kernel'] = flat_cols(k2, n_mem)
    else:
        mb['latent_out']['kernel'] = flat_cols(mb['latent_out']['kernel'], n_mem)
    mb['latent_out']['bias'] = flat_bias(mb['latent_out']['bias'], n_mem)
    # the LayerNorms in creation order: [bottleneck?] [stoich?] [heads?]
    ln_names = sorted((k for k in mb if k.startswith('LayerNorm')),
                      key=lambda s: int(s.split('_')[1]))
    ln_i = 1 if getattr(cfg, 'memory_bottleneck_dim', 0) > 0 else 0
    if n_st > 0:
        mb['stoich_mid']['kernel'] = cols(mb['stoich_mid']['kernel'], m)
        mb['stoich_mid']['bias'] = mb['stoich_mid']['bias'][m]
        map_ln(mb[ln_names[ln_i]], m)
        ln_i += 1
        mb['stoich_out']['kernel'] = flat_cols(rows(mb['stoich_out']['kernel'], m, mult), n_st)
        mb['stoich_out']['bias'] = flat_bias(mb['stoich_out']['bias'], n_st)
    if n_hd > 0:
        # heads_mid1 -> LN -> gelu -> heads_mid2: a uniform map keeps the
        # LN between the pair exact (random replication would not)
        mh, multh = _uniform_map(d // 2, new_d_model // 2, 1)
        mb['heads_mid1']['kernel'] = cols(mb['heads_mid1']['kernel'], mh)
        mb['heads_mid1']['bias'] = mb['heads_mid1']['bias'][mh]
        map_ln(mb[ln_names[ln_i]], mh)
        mb['heads_mid2']['kernel'] = cols(rows(mb['heads_mid2']['kernel'], mh, multh), m)
        mb['heads_mid2']['bias'] = mb['heads_mid2']['bias'][m]
        mb['heads_out']['kernel'] = flat_cols(rows(mb['heads_out']['kernel'], m, mult), n_hd)
        mb['heads_out']['bias'] = flat_bias(mb['heads_out']['bias'], n_hd)

    # the layers in the JAX tree's key order (sorted as strings: layer_10
    # before layer_2), which is the order of their noise draws
    for name in sorted(k for k in root if k.startswith('layer_')):
        layer = root[name]
        for lnk in ('norm1', 'norm2', 'norm3'):
            map_ln(layer[lnk], m)
        for att in ('self', 'cross'):
            q = layer[f'{att}_q']
            q['kernel'] = cols(rows(q['kernel'], m, mult), m) * scale
            q['bias'] = q['bias'][m] * scale
            for kv in ('k', 'v'):
                p = layer[f'{att}_{kv}']
                p['kernel'] = cols(rows(p['kernel'], m, mult), m) / mult
                p['bias'] = p['bias'][m] / mult
            o = layer[f'{att}_o']
            o['kernel'] = cols(o['kernel'][m], m)          # rows NOT divided
            o['bias'] = o['bias'][m]
        layer['ff1']['kernel'] = cols(rows(layer['ff1']['kernel'], m, mult), mf)
        layer['ff1']['bias'] = layer['ff1']['bias'][mf]
        layer['ff2']['kernel'] = cols(rows(layer['ff2']['kernel'], mf, multf), m)
        layer['ff2']['bias'] = layer['ff2']['bias'][m]

    map_ln(root['out_ln'], m)
    mo, multo = _uniform_map(d, new_d_model, 1)
    root['out_d1']['kernel'] = cols(rows(root['out_d1']['kernel'], m, mult), mo)
    root['out_d1']['bias'] = root['out_d1']['bias'][mo]
    root['out_d2']['kernel'] = rows(root['out_d2']['kernel'], mo, multo)
    map_ln(root['type_ln'], m)
    mt, multt = _uniform_map(d, new_d_model, 1)
    root['type_d1']['kernel'] = cols(rows(root['type_d1']['kernel'], m, mult), mt)
    root['type_d1']['bias'] = root['type_d1']['bias'][mt]
    mq, multq = _uniform_map(d // 4, new_d_model // 4, 1)
    root['type_d2']['kernel'] = cols(rows(root['type_d2']['kernel'], mt, multt), mq)
    root['type_d2']['bias'] = root['type_d2']['bias'][mq]
    root['type_d3']['kernel'] = rows(root['type_d3']['kernel'], mq, multq)
    for hd in ('stop', 'dup'):
        mh, multh = _uniform_map(d // 4, new_d_model // 4, 1)
        root[f'{hd}_d1']['kernel'] = cols(rows(root[f'{hd}_d1']['kernel'], m, mult), mh)
        root[f'{hd}_d1']['bias'] = root[f'{hd}_d1']['bias'][mh]
        root[f'{hd}_d2']['kernel'] = rows(root[f'{hd}_d2']['kernel'], mh, multh)
    return _state_dict(root)


# ---- whole-model encoder widening ------------------------------------------------

def widened_encoder_config(cfg, new_fusion_dim: int, new_encoder_hidden,
                           new_decoder_hidden):
    """The config an ``expand_encoder_widths`` result targets."""
    return dataclasses.replace(cfg, fusion_dim=new_fusion_dim,
                               encoder_hidden=tuple(new_encoder_hidden),
                               decoder_hidden=tuple(new_decoder_hidden))


def expand_encoder_widths(enc_state: Mapping[str, torch.Tensor], cfg, new_fusion_dim: int,
                          new_encoder_hidden, new_decoder_hidden,
                          noise: float = 0.0, seed: int = 0) -> Dict[str, torch.Tensor]:
    """Widens the whole ``MaterialsEncoder`` (fusion_dim and both hidden
    stacks: the three branches, the fusion MLP, the latent stack, the
    decoder backbone and every head reading from it) by uniform channel
    duplication, exactly function preserving for every fixed-width output
    (z and the head predictions); ``attended_input`` becomes its own
    channel duplication.  Integer factors and equal stack depths only, or
    it raises.  ``noise`` and ``seed`` as in ``expand_decoder_width``.
    Returns a state dict for ``widened_encoder_config``."""
    f = cfg.fusion_dim
    eh, dh = tuple(cfg.encoder_hidden), tuple(cfg.decoder_hidden)
    neh, ndh = tuple(new_encoder_hidden), tuple(new_decoder_hidden)
    if (new_fusion_dim % f or len(neh) != len(eh) or len(ndh) != len(dh)
            or any(n % o for n, o in zip(neh, eh))
            or any(n % o for n, o in zip(ndh, dh))):
        raise ValueError(
            f'expand_encoder_widths requires integer widening factors and '
            f'equal stack depths: fusion {f}->{new_fusion_dim}, '
            f'encoder_hidden {eh}->{neh}, decoder_hidden {dh}->{ndh}')
    rng = np.random.default_rng(seed)

    def umap(old, new):
        m = np.sort(np.tile(np.arange(old), new // old))
        counts = np.bincount(m, minlength=old)
        return m, counts[m].astype(np.float64)

    def nz(shape):
        return rng.normal(0, noise, shape) if noise > 0 else 0.0

    def cols(k, m):
        out = k[..., m]
        return out + nz(out.shape)

    def rows(k, m, mult):
        return k[m] / mult[:, None]

    def map_ln(ln, m):
        ln['scale'], ln['bias'] = ln['scale'][m], ln['bias'][m]

    def map_out(mod, m):
        mod['kernel'] = cols(mod['kernel'], m)
        mod['bias'] = mod['bias'][m]

    def map_through(mod, m_in, mult_in, m_out):         # consumes and produces widened
        mod['kernel'] = cols(rows(mod['kernel'], m_in, mult_in), m_out)
        mod['bias'] = mod['bias'][m_out]

    mf, multf = umap(f, new_fusion_dim)
    root = _kernel_tree(enc_state)

    op = root['element_encoder']['output_projection']
    map_out(op['Dense_0'], mf)
    map_ln(op['LayerNorm_0'], mf)

    m2f, mult2f = umap(2 * f, 2 * new_fusion_dim)
    me = root['magpie_encoder']
    map_out(me['Dense_0'], m2f)
    map_ln(me['LayerNorm_0'], m2f)
    map_through(me['Dense_1'], m2f, mult2f, mf)
    map_ln(me['LayerNorm_1'], mf)

    mfh, multfh = umap(f // 2, new_fusion_dim // 2)
    te = root['tc_encoder_pre']
    map_out(te['Dense_0'], mfh)
    map_through(te['Dense_1'], mfh, multfh, mf)
    map_ln(root['tc_encoder_ln'], mf)

    # the fusion input is [elem f | magpie f | tc f]: a segment-blocked
    # consume map; its 3f output is internal, so a plain uniform map
    m3f_in = np.concatenate([mf + i * f for i in range(3)])
    mult3f_in = np.concatenate([multf] * 3)
    m3f, mult3f = umap(3 * f, 3 * new_fusion_dim)
    map_through(root['fusion']['Dense_0'], m3f_in, mult3f_in, m3f)
    map_ln(root['fusion']['LayerNorm_0'], m3f)

    prev_m, prev_mult = m3f, mult3f
    lm = root['latent_mlp']
    for i, (old_w, new_w) in enumerate(zip(eh, neh)):
        mh, multh = umap(old_w, new_w)
        map_through(lm[f'Dense_{i}'], prev_m, prev_mult, mh)
        map_ln(lm[f'LayerNorm_{i}'], mh)
        prev_m, prev_mult = mh, multh
    root['fc_mean']['kernel'] = rows(root['fc_mean']['kernel'], prev_m, prev_mult)

    bb = root['decoder_backbone']
    prev = None
    for i, (old_w, new_w) in enumerate(zip(dh, ndh)):
        mh, multh = umap(old_w, new_w)
        k = bb[f'Dense_{i}']['kernel']
        bb[f'Dense_{i}']['kernel'] = cols(k if prev is None else rows(k, *prev), mh)
        bb[f'Dense_{i}']['bias'] = bb[f'Dense_{i}']['bias'][mh]
        map_ln(bb[f'LayerNorm_{i}'], mh)
        prev = (mh, multh)
    mb, multb = prev                                     # the backbone output's map

    root['tc_proj']['kernel'] = rows(root['tc_proj']['kernel'], mb, multb)
    mg = root['magpie_head']
    mgh, multgh = umap(dh[-1], ndh[-1])
    map_through(mg['Dense_0'], mb, multb, mgh)
    mg['Dense_1']['kernel'] = rows(mg['Dense_1']['kernel'], mgh, multgh)
    map_through(root['attended_head'], mb, multb, mf)
    map_ln(root['attended_head_ln'], mf)
    tch = root['tc_class_head']
    tch['Dense_0']['kernel'] = rows(tch['Dense_0']['kernel'], mb, multb)
    # the family head's input is [backbone | sc_logit(1)]
    mb_sc = np.concatenate([mb, [dh[-1]]])
    multb_sc = np.concatenate([multb, [1.0]])
    fh = root['family_head']
    for head in ('coarse', 'cuprate_sub', 'iron_sub'):
        fh[f'{head}_d0']['kernel'] = rows(fh[f'{head}_d0']['kernel'], mb_sc, multb_sc)
    return _state_dict(root)
