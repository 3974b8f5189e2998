"""True-autoregressive evaluation (port of training/evaluate.py).

``eval_batch`` is the body of the JAX package's jitted ``eval_batch``:
encoder, decoder memory, greedy KV-cache generation with the decode gates
and early exit (or, given n-gram draft tables, speculative decoding:
generation/speculative.py, pure greedy), then the teacher-forced forward
for TF-exact.
``evaluate_autoregressive`` runs it over a dataset and scores true-AR and
TF exact match, Tc error, the SC head and the family head as the JAX
function does.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional

import numpy as np
import torch

from ..data.pipeline import DatasetArrays
from ..generation import GenerationConfig, generate_with_kv_cache
from ..generation.speculative import _as_draft_tables, speculative_generate
from ..tokenizer import EOS_ID, PAD_ID, FractionAwareTokenizer
from .config import TrainConfig
from .train_step import stoich_conditioning

TC_BINS = ((0, 10), (10, 50), (50, 100), (100, 120), (120, 200), (200, 1000))


def _exact_match(generated: np.ndarray, targets: np.ndarray) -> np.ndarray:
    """Per-sample: generated token stream equals target up to/incl. EOS; a
    target with no EOS is never exact."""
    b, t = targets.shape
    g = generated[:, :t]
    if g.shape[1] < t:
        g = np.pad(g, ((0, 0), (0, t - g.shape[1])), constant_values=-1)
    has_eos = (targets == EOS_ID).any(axis=1)
    eos_pos = np.where(has_eos, (targets == EOS_ID).argmax(axis=1), t - 1)
    needed = np.arange(t)[None, :] <= eos_pos[:, None]
    return ((g == targets) | ~needed).all(axis=1) & has_eos


def eval_train_config(max_len: int, eval_gating: Optional[Mapping] = None) -> TrainConfig:
    """``TrainConfig(max_formula_len=max_len)`` with a checkpoint's
    ``eval_gating`` (``meta.json``) copied onto it key by key, as the JAX
    eval CLI does: a key the meta lacks keeps TrainConfig's default."""
    tcfg = TrainConfig(max_formula_len=max_len)
    for k, v in (eval_gating or {}).items():
        setattr(tcfg, k, v)
    return tcfg


def eval_generation_config(tcfg: TrainConfig, max_len: int) -> GenerationConfig:
    """Greedy early-exit generation with ``tcfg``'s decode gates."""
    return GenerationConfig(
        max_len=max_len, temperature=0.0,
        stop_boost=tcfg.stop_boost,
        hard_stop_threshold=tcfg.hard_stop_threshold,
        site_dup_threshold=tcfg.site_dup_threshold,
        use_type_masking=tcfg.use_type_masking_ar,
        early_exit=True)


SPECULATIVE_K = 4                   # drafted tokens a chunk, as the JAX eval


@torch.inference_mode()
def eval_batch(encoder, decoder, batch: Dict[str, torch.Tensor],
               gcfg: GenerationConfig,
               type_masks: Optional[torch.Tensor] = None,
               speculative_tables: Optional[Dict[str, torch.Tensor]] = None
               ) -> Dict[str, torch.Tensor]:
    """One eval batch: returns the generated tokens [B, max_len-1], the
    TF argmax ``tf_pred`` [B, max_len-1], ``tc_pred``, ``sc_pred``,
    ``z_norm``, ``family_composed_14`` and the generation's ``margin``.
    With ``speculative_tables`` the tokens come from speculative decoding
    (k = 4, pure greedy: ``gcfg``'s gates do not apply), which needs a
    decoder with ``pallas_decode=False``.

    ``batch`` holds element_indices / element_fractions / element_mask
    [B, 12], magpie [B, magpie_dim], tc [B] and tokens [B, max_len]."""
    enc_out = encoder(batch['element_indices'], batch['element_fractions'],
                      batch['element_mask'], batch['magpie'], batch['tc'])
    heads_vec = encoder.heads_pred_for_decoder(enc_out)
    stoich = stoich_conditioning(batch)
    if speculative_tables is not None:
        gen = speculative_generate(decoder, enc_out['z'], stoich, heads_vec,
                                   speculative_tables, k=SPECULATIVE_K)
    else:
        gen = generate_with_kv_cache(decoder, enc_out['z'], stoich, heads_vec,
                                     None, gcfg, type_masks=type_masks)
    dec_out = decoder(enc_out['z'], batch['tokens'], stoich, heads_vec)
    return {
        'generated': gen['tokens'],
        'tf_pred': dec_out['generated'],
        'tc_pred': enc_out['tc_pred'],
        'sc_pred': enc_out['sc_pred'],
        'z_norm': torch.linalg.norm(enc_out['z'], dim=1),
        'family_composed_14': enc_out['family_composed_14'],
        'margin': gen['margin'],
    }


def _to_device(batch: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """A numpy batch on ``device``; int32 ids widen to int64 for indexing."""
    return {k: torch.as_tensor(v.astype(np.int64) if v.dtype == np.int32 else v).to(device)
            for k, v in batch.items()}


def evaluate_autoregressive(
    encoder, decoder,
    ds: DatasetArrays,
    tcfg: TrainConfig,
    luts: Dict[str, torch.Tensor],
    tokenizer: Optional[FractionAwareTokenizer] = None,
    batch_size: int = 256,
    max_batches: Optional[int] = None,
    collect_errors: bool = False,
    sample_indices: Optional[np.ndarray] = None,
    speculative_tables: Optional[Dict[str, torch.Tensor]] = None,
) -> Dict[str, object]:
    """True-AR and TF exact match of ``ds`` (or of its rows
    ``sample_indices``) in batches of ``batch_size``, on the modules'
    device; the last batch is padded with row 0 so that every batch has one
    shape.  ``sample_indices`` in the result holds the true dataset
    indices of the evaluated rows, and ``per_sample_margin`` each row's
    smallest gap between the two largest gated logits over its decode
    steps (how near its stream came to a tie; the JAX function has no such
    key).

    ``speculative_tables``: n-gram draft tables (models/draft.py
    ``build_ngram_draft``, or a bare bigram table) switch the decode to
    speculative chunk verification (``eval_batch``).  That path is pure
    greedy, with no stop boost, hard stop or type mask, so its exact match
    can differ from the gated scan's at the margin, as in JAX."""
    gcfg = eval_generation_config(tcfg, decoder.cfg.max_len)
    type_masks = luts['type_masks'] if tcfg.use_type_masking_ar else None
    device = next(encoder.parameters()).device
    if speculative_tables is not None:
        speculative_tables = _as_draft_tables(speculative_tables, device)

    if sample_indices is None:
        sample_indices = np.arange(len(ds))
    sample_indices = np.asarray(sample_indices, np.int64)
    n = len(sample_indices)
    nb = -(-n // batch_size)
    if max_batches:
        nb = min(nb, max_batches)

    ar_exact, tf_exact = [], []
    tc_preds, tc_trues, z_norms = [], [], []
    fam_correct = []
    sc_probs, sc_trues = [], []
    pos_errors, pos_masks = [], []
    margins = []
    errors: List[dict] = []
    for b in range(nb):
        idx = sample_indices[b * batch_size: min((b + 1) * batch_size, n)]
        pad_n = batch_size - len(idx)
        full_idx = np.concatenate([idx, np.zeros(pad_n, np.int64)]) if pad_n else idx
        out = eval_batch(encoder, decoder, _to_device(ds.batch(full_idx), device), gcfg,
                         type_masks=type_masks, speculative_tables=speculative_tables)
        out = {k: (v.float() if v.is_floating_point() else v).cpu().numpy()
               for k, v in out.items()}
        m = len(idx)

        targets = ds.tokens[idx][:, 1:]
        ar = _exact_match(out['generated'][:m], targets)
        mask = targets != PAD_ID
        tf = ((out['tf_pred'][:m] == targets) | ~mask).all(axis=1)
        pos_errors.append((out['tf_pred'][:m] != targets) & mask)
        pos_masks.append(mask)
        ar_exact.append(ar)
        tf_exact.append(tf)
        # each row's smallest top-two logit gap over its steps up to EOS
        gen = out['generated'][:m]
        is_eos = gen == EOS_ID
        last = np.where(is_eos.any(axis=1), is_eos.argmax(axis=1), gen.shape[1] - 1)
        run = np.arange(gen.shape[1])[None, :] <= last[:, None]
        margins.append(np.where(run, out['margin'][:m], np.inf).min(axis=1))
        tc_preds.append(out['tc_pred'][:m])
        tc_trues.append(ds.tc[idx])
        z_norms.append(out['z_norm'][:m])
        coarse_pred = out['family_composed_14'][:m].argmax(axis=1)
        fam_correct.append(coarse_pred == ds.family[idx])
        sc_probs.append(1.0 / (1.0 + np.exp(-out['sc_pred'][:m])))
        sc_trues.append(ds.is_sc[idx])

        if collect_errors and tokenizer is not None:
            for i in np.where(~ar)[0]:
                errors.append({
                    'index': int(idx[i]),
                    'formula': ds.formulas[idx[i]],
                    'generated': tokenizer.decode(out['generated'][i]),
                    'tc_kelvin': float(ds.norm_stats.tc_to_kelvin(
                        np.array([ds.tc[idx[i]]]))[0]),
                    'z_norm': float(out['z_norm'][i]),
                    'family': int(ds.family[idx[i]]),
                })

    ar_exact = np.concatenate(ar_exact)
    tf_exact = np.concatenate(tf_exact)
    tc_pred = np.concatenate(tc_preds)
    tc_true = np.concatenate(tc_trues)
    z_norm = np.concatenate(z_norms)

    k_pred = ds.norm_stats.tc_to_kelvin(tc_pred)
    k_true = ds.norm_stats.tc_to_kelvin(tc_true)
    r2_per_bin = {}
    for lo, hi in TC_BINS:
        sel = (k_true >= lo) & (k_true < hi)
        if sel.sum() >= 5:
            ss_res = ((k_pred[sel] - k_true[sel]) ** 2).sum()
            ss_tot = ((k_true[sel] - k_true[sel].mean()) ** 2).sum()
            r2_per_bin[f'{lo}-{hi}K'] = float(1 - ss_res / max(ss_tot, 1e-8))
    tc_mae = float(np.abs(k_pred - k_true).mean())

    # the SC head's classifier metrics, where both classes are present
    sc_p = np.concatenate(sc_probs)
    sc_t = np.concatenate(sc_trues).astype(np.int32)
    sc_metrics = {}
    if len(np.unique(sc_t)) == 2:
        pred = (sc_p >= 0.5).astype(np.int32)
        tp = int(((pred == 1) & (sc_t == 1)).sum())
        fp = int(((pred == 1) & (sc_t == 0)).sum())
        fn = int(((pred == 0) & (sc_t == 1)).sum())
        # rank-based AUC (Mann-Whitney)
        order = np.argsort(sc_p, kind='stable')
        ranks = np.empty(len(sc_p))
        ranks[order] = np.arange(1, len(sc_p) + 1)
        n1, n0 = int(sc_t.sum()), int((1 - sc_t).sum())
        auc = (ranks[sc_t == 1].sum() - n1 * (n1 + 1) / 2) / (n1 * n0)
        sc_metrics = {
            'sc_accuracy': float((pred == sc_t).mean()),
            'sc_precision': tp / max(tp + fp, 1),
            'sc_recall': tp / max(tp + fn, 1),
            'sc_auc': float(auc),
            'sc_balance': float(sc_t.mean()),
        }

    return {
        'ar_exact': float(ar_exact.mean()),
        'tf_exact': float(tf_exact.mean()),
        'tc_mae_kelvin': tc_mae,
        'tc_r2_per_bin': r2_per_bin,
        'sc_metrics': sc_metrics,
        'z_norm_mean': float(z_norm.mean()),
        'family_coarse_acc': float(np.concatenate(fam_correct).mean()),
        'n_evaluated': int(len(ar_exact)),
        'error_records': errors,
        'per_sample_ar_exact': ar_exact,
        'per_sample_margin': np.concatenate(margins),
        'sample_indices': sample_indices[:len(ar_exact)],
        'position_errors': np.concatenate(pos_errors),
        'position_mask': np.concatenate(pos_masks),
    }
