"""Checkpoint auto-migration chain, applied on resume (port of
checkpoint/migrate.py), on the port's state dicts.

It compares the restored payload's shapes with the current
``ModelConfig`` and chains the upgrades:

  1. decoder vocab expansion (embedding rows + output-head columns,
     isotope rows seeded from their parent elements: models/surgery.py);
  2. the Magpie feature dim (the encoder's input branch zero-padded or
     truncated, the prediction head's last layer grown with fresh
     columns or truncated);
  3. the physics-Z Magpie projection re-initialised when its input dim
     drifted.

Each step drops the optimizer state of what it changed.  The numpy draws
are the JAX package's, in its kernel layout ([in, out], the transpose of
a ``Linear`` weight), so steps 1 and 2 give the same arrays; step 3 draws
from the port's ``init_magpie_proj``.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ..models.surgery import expand_decoder_vocab, isotope_parent_map
from ..ops.physics_z_loss import init_magpie_proj

_XAVIER_SCALE = 1.0  # xavier-uniform bound factor for fresh head columns


def _resize_rows(kernel: np.ndarray, new_in: int) -> np.ndarray:
    """Grow (zero-pad: new inputs initially ignored, function preserving)
    or shrink (truncate) the input dimension of a Dense kernel [in, out]."""
    old = kernel.shape[0]
    if new_in == old:
        return kernel
    if new_in < old:
        return kernel[:new_in]
    pad = np.zeros((new_in - old,) + kernel.shape[1:], kernel.dtype)
    return np.concatenate([kernel, pad], axis=0)


def _resize_out(kernel: np.ndarray, bias: np.ndarray, new_out: int,
                rng: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
    """Grow (fresh xavier columns) or shrink (truncate) a Dense output."""
    old = kernel.shape[1]
    if new_out == old:
        return kernel, bias
    if new_out < old:
        return kernel[:, :new_out], bias[:new_out]
    bound = _XAVIER_SCALE * np.sqrt(6.0 / (kernel.shape[0] + new_out))
    fresh = rng.uniform(-bound, bound,
                        (kernel.shape[0], new_out - old)).astype(kernel.dtype)
    k = np.concatenate([kernel, fresh], axis=1)
    b = np.concatenate([bias, np.zeros(new_out - old, bias.dtype)])
    return k, b


def _weight(kernel: np.ndarray) -> torch.Tensor:
    """A Dense kernel [in, out] as a ``Linear`` weight [out, in]."""
    return torch.from_numpy(np.ascontiguousarray(kernel.T))


def auto_migrate(restored: Dict, meta: Dict, mcfg, tokenizer=None,
                 seed: int = 0) -> Tuple[Dict, List[str]]:
    """Detects drift between a restored payload (``load_checkpoint``) and
    the current ``ModelConfig`` and chains the upgrades.  Returns
    (migrated payload, the actions taken); no action means the checkpoint
    loads as it is."""
    actions: List[str] = []
    rng = np.random.default_rng(seed)

    # ---- 1. decoder vocab ---------------------------------------------------
    dec = restored.get('dec_params')
    if dec is not None:
        old_v = dec['token_embedding.weight'].shape[0]
        if old_v < mcfg.vocab_size:
            parent = isotope_parent_map(tokenizer) if tokenizer else None
            restored['dec_params'] = expand_decoder_vocab(dec, mcfg.vocab_size, parent)
            restored.pop('dec_opt', None)
            actions.append(
                f'decoder vocab {old_v}->{mcfg.vocab_size} '
                f'(embedding rows + out_d2 columns'
                f'{", isotope rows from parents" if parent else ""}; '
                f'dec_opt reset)')
        elif old_v > mcfg.vocab_size:
            raise ValueError(
                f'checkpoint vocab {old_v} > model vocab {mcfg.vocab_size}: '
                f'shrinking is not a supported migration')

    # ---- 2. Magpie feature dim (encoder input branch + prediction head) ----
    enc = restored.get('enc_params')
    w0 = enc.get('magpie_encoder.Dense_0.weight') if enc is not None else None
    if w0 is not None and w0.shape[1] != mcfg.magpie_dim:
        old_m = w0.shape[1]
        enc = {k: v.detach().cpu().clone() for k, v in enc.items()}
        enc['magpie_encoder.Dense_0.weight'] = _weight(
            _resize_rows(w0.detach().cpu().numpy().T, mcfg.magpie_dim))
        # the prediction head's last Dense
        n = len({k.split('.')[1] for k in enc if k.startswith('magpie_head.Dense_')})
        last = f'magpie_head.Dense_{n - 1}'
        k, b = _resize_out(enc[f'{last}.weight'].numpy().T, enc[f'{last}.bias'].numpy(),
                           mcfg.magpie_dim, rng)
        enc[f'{last}.weight'], enc[f'{last}.bias'] = _weight(k), torch.from_numpy(b)
        restored['enc_params'] = enc
        restored.pop('enc_opt', None)
        actions.append(
            f'magpie dim {old_m}->{mcfg.magpie_dim} (encoder branch '
            f'zero-padded/truncated, head columns fresh; enc_opt reset)')

    # ---- 3. physics-Z Magpie projection -------------------------------------
    pz = restored.get('pz_params')
    if pz is not None and 'weight' in pz:
        out_dim, old_in = pz['weight'].shape
        if old_in != mcfg.magpie_dim:
            fresh = init_magpie_proj(torch.Generator().manual_seed(seed), mcfg.magpie_dim,
                                     out_dim=out_dim, device='cpu')
            restored['pz_params'] = {k: v.detach() for k, v in fresh.state_dict().items()}
            restored.pop('pz_opt', None)
            actions.append(
                f'physics-Z magpie projection {old_in}->{mcfg.magpie_dim} '
                f're-initialized (pz_opt reset)')

    return restored, actions
