"""The 17-term multi-task loss in one pass (port of ops/losses.py).

Formula focal CE (with length and element-count per-sample weights),
policy gradient (from the caller), Tc Huber + asymmetric + Kelvin-weighted
+ relative-blend + binned, Tc-bucket CE, Magpie MSE, masked stoichiometry
MSE + count MSE, z-L2 ("kl_loss"), z-norm penalty, stop BCE, token-type
CE, site-dup BCE, HP BCE, SC BCE, hierarchical family CE, constraint zoo
A3/A6, and the physics-Z term (from the caller).

Mixed SC/non-SC batches take one pass with per-sample weights: 1 for SC
rows and ``non_sc_formula_weight`` for non-SC rows on the formula term,
SC-indicator masks on the Tc, Magpie and stoichiometry terms.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..models.family_classifier import (
    FINE_TO_COARSE, FINE_TO_CUPRATE_SUB, FINE_TO_IRON_SUB,
)
from ..tokenizer import (
    EOS_ID, FRACTION_TOKEN_START, PAD_ID, TOKEN_TYPE_ELEMENT,
    TOKEN_TYPE_FRACTION, TOKEN_TYPE_INTEGER,
)
from ..parallel.global_batch import (gather_rows, gather_rows_grad, global_count,
                                     global_mean, global_rows, share)
from .aux_losses import supcon_loss
from .constraints import charge_balance_loss, site_occupancy_loss
from .token_stats import is_element_token


@dataclasses.dataclass(frozen=True)
class LossConfig:
    """Loss weights and shapes (the JAX package's defaults)."""
    ce_weight: float = 1.0
    rl_weight: float = 0.0
    tc_weight: float = 20.0
    magpie_weight: float = 2.0
    kl_weight: float = 1e-4
    stoich_weight: float = 2.0
    element_count_weight: float = 0.5
    tc_class_weight: float = 1.0
    hp_loss_weight: float = 1.0
    sc_loss_weight: float = 1.0
    stop_loss_weight: float = 5.0
    stop_end_position_weight: float = 10.0
    token_type_loss_weight: float = 1.0
    site_dup_loss_weight: float = 1.0
    site_dup_pos_weight: float = 800.0
    family_loss_weight: float = 0.5
    family_coarse_weight: float = 0.6
    family_cuprate_weight: float = 0.3
    family_iron_weight: float = 0.1
    constraint_zoo_weight: float = 0.5
    a3_weight: float = 1.0
    a6_weight: float = 1.0
    a6_tolerance: float = 0.5
    non_sc_formula_weight: float = 0.5

    focal_gamma: float = 2.0
    label_smoothing: float = 0.1
    fraction_token_weight: float = 2.0

    # SupCon contrastive over latents (weight 0 on the active path)
    supcon_weight: float = 0.0
    supcon_temperature: float = 0.07

    # semantic-unit penalties (weight 0 on the active path)
    semantic_unit_weight: float = 0.0
    semantic_element_penalty: float = 5.0
    semantic_fraction_penalty: float = 3.0
    semantic_exact_penalty: float = 1.0

    use_length_weighting: bool = True
    length_weight_base: float = 8.0
    length_weight_alpha: float = 1.0
    use_element_count_weighting: bool = True
    element_count_base: float = 3.0
    element_count_beta: float = 0.5

    tc_huber_delta: float = 1.0
    tc_underpred_penalty: float = 1.5
    tc_relative_weight: float = 0.5
    tc_kelvin_weighting: bool = True
    tc_kelvin_weight_scale: float = 20.0
    tc_bin_weights: Tuple[Tuple[float, float], ...] = (
        (0.0, 1.0), (10.0, 1.5), (50.0, 2.0), (100.0, 2.5), (150.0, 3.0))
    tc_class_bins: Tuple[float, ...] = (0.0, 10.0, 50.0, 100.0)
    tc_mean: float = 0.0
    tc_std: float = 1.0
    tc_log_transform: bool = True

    use_z_norm_penalty: bool = True
    z_norm_target: float = 22.0
    z_norm_penalty_weight: float = 0.001


@functools.cache
def _family_tables(device: torch.device):
    """The FINE_TO_* maps on ``device``, made once (a copy from the host
    would wait for the device on every call)."""
    return tuple(torch.as_tensor(t, dtype=torch.long, device=device)
                 for t in (FINE_TO_COARSE, FINE_TO_CUPRATE_SUB, FINE_TO_IRON_SUB))


# ---------------------------------------------------------------------------
# primitive losses
# ---------------------------------------------------------------------------

def focal_ce_per_sample(logits: torch.Tensor, targets: torch.Tensor,
                        gamma: float, smoothing: float,
                        fraction_token_weight: float = 1.0) -> torch.Tensor:
    """Focal CE with label smoothing and fraction-token upweighting, the
    per-sample mean over non-PAD positions."""
    mask = (targets != PAD_ID).float()
    logp = F.log_softmax(logits.float(), dim=-1)
    tgt_logp = logp.gather(-1, targets[..., None].long())[..., 0]
    focal_w = (1.0 - torch.exp(tgt_logp)) ** gamma
    if smoothing > 0:
        smooth = -logp.mean(dim=-1)
        per_tok = focal_w * ((1.0 - smoothing) * (-tgt_logp) + smoothing * smooth)
    else:
        per_tok = focal_w * (-tgt_logp)
    if fraction_token_weight != 1.0:
        w = torch.where(targets >= FRACTION_TOKEN_START,
                        fraction_token_weight, 1.0).to(per_tok.dtype)
        per_tok = per_tok * w
    return (per_tok * mask).sum(dim=1) / mask.sum(dim=1).clamp_min(1.0)


def tc_kelvin(tc_norm: torch.Tensor, cfg: LossConfig) -> torch.Tensor:
    x = tc_norm * cfg.tc_std + cfg.tc_mean
    if cfg.tc_log_transform:
        x = torch.expm1(x)
    return x.clamp_min(0.0)


def tc_loss_per_sample(tc_pred: torch.Tensor, tc_true: torch.Tensor,
                       cfg: LossConfig) -> torch.Tensor:
    """Huber + asymmetric underprediction + relative blend + bin/Kelvin
    weighting."""
    err = tc_pred - tc_true
    if cfg.tc_huber_delta > 0:
        d = cfg.tc_huber_delta
        a = err.abs()
        loss = torch.where(a <= d, 0.5 * err ** 2, d * (a - 0.5 * d))
    else:
        loss = err ** 2
    if cfg.tc_underpred_penalty != 1.0:
        under = (tc_pred < tc_true).to(loss.dtype)
        loss = loss * (1.0 + under * (cfg.tc_underpred_penalty - 1.0))
    k_true = tc_kelvin(tc_true, cfg)
    if cfg.tc_relative_weight > 0:
        k_pred = tc_kelvin(tc_pred, cfg)
        rel = (k_pred - k_true).abs() / k_true.clamp_min(1.0)
        loss = (1.0 - cfg.tc_relative_weight) * loss + cfg.tc_relative_weight * rel
    # highest matching threshold wins: ascending, each overwrites
    bin_w = torch.ones_like(k_true)
    for thr, w in sorted(cfg.tc_bin_weights):
        bin_w = torch.where(k_true >= thr, torch.full_like(bin_w, w), bin_w)
    loss = loss * bin_w
    if cfg.tc_kelvin_weighting:
        loss = loss * (1.0 + k_true / cfg.tc_kelvin_weight_scale)
    return loss


def tc_class_targets(k_true: torch.Tensor, bins) -> torch.Tensor:
    """Kelvin -> bucket id: 0 for Tc <= 0, then one per bin edge exceeded."""
    t = torch.zeros_like(k_true, dtype=torch.long)
    for i, edge in enumerate(bins):
        t = torch.where(k_true > edge, torch.full_like(t, i + 1), t)
    return t


def masked_ce(logits: torch.Tensor, targets: torch.Tensor,
              valid: torch.Tensor) -> torch.Tensor:
    """Mean CE over the valid rows (0 for an empty selection), over the
    global batch's valid rows under data parallelism."""
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, targets.clamp_min(0)[..., None].long())[..., 0]
    v = valid.float()
    return (nll * v).sum() / global_count(v.sum()).clamp_min(1.0)


def bce_logits(logits: torch.Tensor, targets: torch.Tensor,
               pos_weight: Optional[torch.Tensor | float] = None) -> torch.Tensor:
    """Elementwise BCE-with-logits, optionally positive-class weighted."""
    logits = logits.float()
    log_p = F.logsigmoid(logits)
    log_np = F.logsigmoid(-logits)
    if pos_weight is not None:
        return -(pos_weight * targets * log_p + (1.0 - targets) * log_np)
    return -(targets * log_p + (1.0 - targets) * log_np)


def site_dup_targets(targets: torch.Tensor) -> torch.Tensor:
    """1.0 where the target token is an element token already emitted
    earlier in the sequence."""
    t = targets.shape[1]
    elem = is_element_token(targets) & (targets != PAD_ID)
    same = targets[:, :, None] == targets[:, None, :]          # [B, T, T]
    earlier = torch.ones(t, t, dtype=torch.bool, device=targets.device).tril(-1)[None]
    dup = (same & earlier & elem[:, None, :] & elem[:, :, None]).any(dim=2)
    return dup.float()


def semantic_unit_loss(
    pred: torch.Tensor,           # [B, T] argmax token ids
    targets: torch.Tensor,        # [B, T]
    mask: torch.Tensor,           # [B, T] target validity (non-PAD)
    type_table: torch.Tensor,     # [V] token -> type LUT
    element_penalty: float = 5.0,
    fraction_penalty: float = 3.0,
    exact_match_penalty: float = 1.0,
) -> Dict[str, torch.Tensor]:
    """Penalties on the decoded stream's semantic units: the ordered
    element stream and the ordered amount stream (INTEGER | FRACTION
    tokens) of prediction and target, errors = positional mismatches +
    |count difference| over the longer stream, plus a 0/1 non-exact
    penalty.  Argmax-based: a penalty signal, not a gradient path.  The
    unit streams are compacted with a stable sort over the type LUT."""
    t = pred.shape[1]
    idx = torch.arange(t, device=pred.device)[None, :]
    # the prediction stream is live strictly before its first EOS
    pred_live = torch.cumsum((pred == EOS_ID).int(), dim=1) == 0
    tgt_live = mask & (targets != EOS_ID)
    tp = type_table[pred]
    tt = type_table[targets]

    def compact(tokens, is_unit):
        order = torch.sort((~is_unit).int(), dim=1, stable=True).indices
        return tokens.gather(1, order)

    def stream_err(unit_types):
        is_p = functools.reduce(torch.logical_or, [tp == u for u in unit_types]) & pred_live
        is_t = functools.reduce(torch.logical_or, [tt == u for u in unit_types]) & tgt_live
        comp_p, comp_t = compact(pred, is_p), compact(targets, is_t)
        n_p, n_t = is_p.sum(dim=1), is_t.sum(dim=1)
        both = idx < torch.minimum(n_p, n_t)[:, None]
        mism = ((comp_p != comp_t) & both).sum(dim=1)
        err = mism + (n_p - n_t).abs()
        n = torch.maximum(n_p, n_t)
        return torch.where(n > 0, err / n.clamp_min(1), 0.0)

    elem_err = stream_err([TOKEN_TYPE_ELEMENT])
    frac_err = stream_err([TOKEN_TYPE_INTEGER, TOKEN_TYPE_FRACTION])
    exact_err = 1.0 - ((pred == targets) | ~mask).all(dim=1).float()

    element_loss = global_mean(elem_err) * element_penalty
    fraction_loss = global_mean(frac_err) * fraction_penalty
    exact_loss = global_mean(exact_err) * exact_match_penalty
    return {
        'element_loss': element_loss,
        'fraction_loss': fraction_loss,
        'exact_match_loss': exact_loss,
        'total': element_loss + fraction_loss + exact_loss,
    }


# ---------------------------------------------------------------------------
# full assembly
# ---------------------------------------------------------------------------

def multitask_loss(
    cfg: LossConfig,
    enc_out: Dict[str, torch.Tensor],
    dec_out: Dict[str, torch.Tensor],
    batch: Dict[str, torch.Tensor],
    type_table: torch.Tensor,                 # [V] token->type LUT
    rl_loss: Optional[torch.Tensor] = None,   # scalar policy-gradient loss
    rl_reward_mean: Optional[torch.Tensor] = None,
    tc_weight_override: Optional[float] = None,
    magpie_weight_override: Optional[float] = None,
    dyn: Optional[Dict[str, float | torch.Tensor]] = None,
    physz_loss: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One pass over a (possibly mixed SC/non-SC) batch; returns
    (total_loss, metrics).

    Static term weights live in ``cfg``; the host scheduler's per-epoch
    decisions arrive in ``dyn`` (all optional): 'tc_w', 'magpie_w', 'rl_w',
    'physz_w' (absolute weights; physz_w defaults to 0) and 'm_<term>'
    (0/1 skip multipliers for magpie, tc_class, hp, sc, stop, site_dup,
    family, physics_z).

    Under data parallelism (an active ``parallel.global_batch``) every
    term and metric is this rank's share: its rows' numerator over the
    global batch's denominator (``global_mean``, ``global_count``), so
    that the sums over the ranks are the global batch's values."""
    tokens = batch['tokens']
    targets = tokens[:, 1:]
    logits = dec_out['logits']
    b = tokens.shape[0]
    dev = logits.device
    mask = targets != PAD_ID
    maskf = mask.float()
    is_sc = (batch['is_sc'] == 1).float()
    n_sc = global_count(is_sc.sum())
    sc_any = n_sc.clamp_min(1.0)
    n_tok = global_count(maskf.sum())

    dyn = dyn or {}

    def mult(name):
        return dyn.get(f'm_{name}', 1.0)

    tc_w = dyn.get(
        'tc_w', cfg.tc_weight if tc_weight_override is None else tc_weight_override)
    mg_w = dyn.get(
        'magpie_w',
        cfg.magpie_weight if magpie_weight_override is None else magpie_weight_override)
    rl_w = dyn.get('rl_w', cfg.rl_weight)

    # ---- formula CE with per-sample weights and SC/non-SC weighting ---------
    per_sample_ce = focal_ce_per_sample(
        logits, targets, cfg.focal_gamma, cfg.label_smoothing,
        cfg.fraction_token_weight)
    sample_w = torch.ones(b, device=dev)
    if cfg.use_length_weighting:
        seq_len = maskf.sum(dim=1)
        sample_w = sample_w * (1.0 + cfg.length_weight_alpha * (
            (seq_len - cfg.length_weight_base) / cfg.length_weight_base).clamp_min(0.0))
    if cfg.use_element_count_weighting:
        n_elem = batch['element_mask'].sum(dim=1).float()
        sample_w = sample_w * (1.0 + cfg.element_count_beta * (
            n_elem - cfg.element_count_base).clamp_min(0.0))
    sc_row_w = torch.where(is_sc > 0, 1.0, cfg.non_sc_formula_weight)
    formula_ce = global_mean(per_sample_ce * sample_w * sc_row_w)

    # ---- Tc stack (SC rows only, scaled by the SC fraction) -----------------
    tc_ps = tc_loss_per_sample(enc_out['tc_pred'], batch['tc'], cfg)
    tc_loss = global_mean(tc_ps * is_sc)
    k_true = tc_kelvin(batch['tc'], cfg)
    tcc = masked_ce(enc_out['tc_class_logits'],
                    tc_class_targets(k_true, cfg.tc_class_bins), is_sc > 0)
    tc_class_loss = tcc * (n_sc / global_rows(b))

    # ---- Magpie / stoichiometry (SC rows) -----------------------------------
    mg_err = (enc_out['magpie_pred'] - batch['magpie']) ** 2
    magpie_loss = global_mean(mg_err.mean(dim=1) * is_sc)

    em = batch['element_mask'].float()
    st_err = (enc_out['fraction_pred'] - batch['element_fractions']) ** 2 * em
    st_ps = st_err.sum(dim=1) / em.sum(dim=1).clamp_min(1.0)
    stoich_loss = global_mean(st_ps * is_sc)
    cnt_err = (enc_out['element_count_pred'] - em.sum(dim=1)) ** 2
    count_loss = global_mean(cnt_err * is_sc)

    # ---- z regularization ---------------------------------------------------
    kl_loss = enc_out['kl_loss']
    z = enc_out['z']
    z_norm_penalty = torch.zeros((), device=dev)
    if cfg.use_z_norm_penalty:
        excess = (torch.linalg.norm(z, dim=1) - cfg.z_norm_target).clamp_min(0.0)
        z_norm_penalty = global_mean(excess ** 2)

    # ---- decoder auxiliary heads --------------------------------------------
    stop_t = (targets == EOS_ID).float()
    stop_bce = bce_logits(dec_out['stop_logits'], stop_t)
    if cfg.stop_end_position_weight > 1.0:
        stop_bce = stop_bce * torch.where(stop_t > 0, cfg.stop_end_position_weight, 1.0)
    stop_loss = (stop_bce * maskf).sum() / n_tok.clamp_min(1.0)

    type_t = type_table[targets.clamp(0, type_table.shape[0] - 1)]
    type_loss = masked_ce(dec_out['type_logits'], type_t, mask)
    type_pred = dec_out['type_logits'].argmax(dim=-1)
    type_acc = ((type_pred == type_t) & mask).sum() / n_tok.clamp_min(1)

    sd_t = site_dup_targets(targets)
    sd_bce = bce_logits(dec_out['site_dup_logits'], sd_t,
                        pos_weight=cfg.site_dup_pos_weight)
    site_dup_loss = (sd_bce * maskf).sum() / n_tok.clamp_min(1.0)

    # ---- encoder auxiliary heads --------------------------------------------
    # HP: SC rows only, dynamic pos_weight capped at 50
    hp_t = batch['hp'].float()
    n_pos = global_count((hp_t * is_sc).sum()).clamp_min(1.0)
    n_neg = global_count(((1 - hp_t) * is_sc).sum()).clamp_min(1.0)
    hp_pw = (n_neg / n_pos).clamp(1.0, 50.0)
    hp_bce = bce_logits(enc_out['hp_pred'], hp_t, pos_weight=hp_pw)
    hp_loss = (hp_bce * is_sc).sum() / sc_any

    sc_loss = global_mean(bce_logits(enc_out['sc_pred'], is_sc))

    fam = batch['family'].clamp(0, 13).long()
    to_coarse, to_cup, to_iron = _family_tables(dev)
    coarse_t, cup_t, iron_t = to_coarse[fam], to_cup[fam], to_iron[fam]
    sc_rows = is_sc > 0
    coarse_loss = masked_ce(enc_out['family_coarse_logits'], coarse_t,
                            sc_rows & (coarse_t >= 0))
    cup_loss = masked_ce(enc_out['family_cuprate_sub_logits'], cup_t,
                         sc_rows & (coarse_t == 1) & (cup_t >= 0))
    iron_loss = masked_ce(enc_out['family_iron_sub_logits'], iron_t,
                          sc_rows & (coarse_t == 2) & (iron_t >= 0))
    family_loss = (cfg.family_coarse_weight * coarse_loss
                   + cfg.family_cuprate_weight * cup_loss
                   + cfg.family_iron_weight * iron_loss)

    # ---- constraint zoo (A3/A6) ---------------------------------------------
    zoo = torch.zeros((), device=dev)
    if cfg.constraint_zoo_weight > 0:
        a3 = site_occupancy_loss(
            batch['element_indices'], batch['element_fractions'],
            batch['element_mask'], enc_out.get('family_composed_14'))
        a6 = charge_balance_loss(
            batch['element_indices'], batch['element_fractions'],
            batch['element_mask'], tolerance=cfg.a6_tolerance)
        zoo = cfg.a3_weight * a3 + cfg.a6_weight * a6

    # ---- policy gradient and physics-Z (computed by the caller) -------------
    rl = rl_loss if rl_loss is not None else torch.zeros((), device=dev)
    pz = physz_loss if physz_loss is not None else torch.zeros((), device=dev)
    total = (
        cfg.ce_weight * formula_ce
        + rl_w * rl
        + tc_w * tc_loss
        + mg_w * mult('magpie') * magpie_loss
        + cfg.kl_weight * kl_loss
        + cfg.stoich_weight * stoich_loss
        + cfg.element_count_weight * count_loss
        + cfg.tc_class_weight * mult('tc_class') * tc_class_loss
        + cfg.constraint_zoo_weight * zoo
        + cfg.z_norm_penalty_weight * z_norm_penalty
        + cfg.stop_loss_weight * mult('stop') * stop_loss
        + cfg.token_type_loss_weight * type_loss
        + cfg.site_dup_loss_weight * mult('site_dup') * site_dup_loss
        + cfg.hp_loss_weight * mult('hp') * hp_loss
        + cfg.sc_loss_weight * mult('sc') * sc_loss
        + cfg.family_loss_weight * mult('family') * family_loss
        + dyn.get('physz_w', 0.0) * mult('physics_z') * pz
    )

    # SupCon contrastive (static gate: nothing computed when off)
    # (over the whole batch: every rank computes it on the gathered z)
    if cfg.supcon_weight > 0 and 'label' in batch:
        total = total + cfg.supcon_weight * share(supcon_loss(
            gather_rows_grad(enc_out['z']), gather_rows(batch['label']),
            cfg.supcon_temperature))

    # ---- metrics ------------------------------------------------------------
    pred = logits.argmax(dim=-1)
    sem = torch.zeros((), device=dev)
    if cfg.semantic_unit_weight > 0:
        sem = semantic_unit_loss(
            pred, targets, mask, type_table,
            cfg.semantic_element_penalty, cfg.semantic_fraction_penalty,
            cfg.semantic_exact_penalty)['total']
        total = total + cfg.semantic_unit_weight * sem
    correct = (pred == targets) & mask
    token_acc = correct.sum() / n_tok.clamp_min(1)
    exact = global_mean((correct | ~mask).all(dim=1).float())
    probs = torch.softmax(logits.float(), dim=-1).clamp_min(1e-8)
    ent = (-(probs * torch.log(probs)).sum(dim=-1) * maskf).sum(dim=1)
    entropy = global_mean(ent)

    metrics = {
        'total': total, 'formula_loss': formula_ce, 'reinforce_loss': rl,
        'tc_loss': tc_loss, 'magpie_loss': magpie_loss,
        'stoich_loss': stoich_loss, 'count_loss': count_loss,
        'kl_loss': kl_loss, 'tc_class_loss': tc_class_loss,
        'z_norm_penalty': z_norm_penalty, 'stop_loss': stop_loss,
        'type_loss': type_loss, 'type_accuracy': type_acc,
        'site_dup_loss': site_dup_loss, 'hp_loss': hp_loss,
        'sc_loss': sc_loss, 'family_loss': family_loss,
        'constraint_zoo_loss': zoo, 'physics_z_loss': pz,
        'semantic_unit_loss': sem,
        'token_accuracy': token_acc,
        'exact_match': exact, 'entropy': entropy,
        'mean_reward': (rl_reward_mean if rl_reward_mean is not None
                        else torch.zeros((), device=dev)),
    }
    return total, metrics
