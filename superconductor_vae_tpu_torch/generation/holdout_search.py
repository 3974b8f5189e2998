"""Generative holdout search: recover held-out superconductors by navigating
the latent space (port of generation/holdout_search.py).

For each holdout target: element-similar corpus anchors (Jaccard over
element sets), candidate latents from perturbation, SLERP / linear
interpolation, centroid and PCA walks and dopant blends, decoded in one
pooled batch (``SuperconductorDiscoveryPipeline.decode_latents``, chunked),
and scored by exact composition and element similarity on the host.  The
guided tier descends z (Adam) so that the encoder's own heads predict the
target's properties; the inversion tier descends z on the teacher-forced
cross-entropy of the target's canonical token sequence through the full
chain z -> heads -> memory -> TF logits.  Both take gradients with respect
to z alone (``torch.autograd.grad``), with the modules in eval mode, and
give the modules their modes back.

Random streams: a target's draws come from ``torch.Generator``s named
``(seed, target_index, fold, ...)`` (utils/rng.py), where the JAX search
folds ``jax.random`` keys; ``target_index`` counts from ``target_offset``,
so a target's streams do not depend on how the targets are split into
runs.  The streams differ from JAX's by design.  Errors propagate: no
strategy is skipped on an exception.
"""

from __future__ import annotations

import dataclasses
import json
import time
from fractions import Fraction
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..data.pipeline import (
    MAX_ELEMENTS, canonical_composition_key, parse_formula_composition,
)
from ..chem.elements import SYMBOL_TO_Z
from ..chem.featurize import formula_features
from ..models.layers import eval_mode
from ..tokenizer import EOS_ID, PAD_ID
from ..tokenizer.fraction_tokenizer import ELEMENT_TOKEN_START, TOKEN_TYPE_ELEMENT
from ..utils.rng import Key, key_generator
from .discovery import SuperconductorDiscoveryPipeline
from .latent import (
    element_anchored_blend, element_jaccard_neighbors, lerp, pca_components,
    perturb, slerp,
)

HOLDOUT_PATH = Path(__file__).resolve().parents[2] / 'data' / 'GENERATIVE_HOLDOUT_DO_NOT_TRAIN.json'


@dataclasses.dataclass
class HoldoutResult:
    target: str
    best_match: str
    exact: bool
    best_similarity: float
    n_candidates: int
    # re-encode self-consistency of the best match's latent centroid
    consistent: bool = True
    consistency: Optional[Dict[str, float]] = None
    # DIAGNOSTIC, outside the headline: what the decoder produces from
    # directly ENCODING the target's composition (holdout reconstruction).
    # The headline `exact` counts only navigation-found candidates.
    oracle_formula: Optional[str] = None
    oracle_match: Optional[bool] = None
    # type-mask convention the oracle decode ran under
    # ('element-constrained' | 'generic')
    oracle_masks: Optional[str] = None
    # which strategy family first produced the best match ('inversion' /
    # 'pool' / 'guided' / 'inverse_regression' / 'refine')
    found_by: Optional[str] = None
    # information-budget tier at which the exact match landed (tiered
    # order only): 'navigation' (element-set anchors + pool + refine),
    # 'guided' (the target's exact fractions, Magpie and Tc), 'inversion'
    # (the exact target token sequence). None when no exact match.
    exact_tier: Optional[str] = None
    # best similarity at the END of each tier that ran
    tier_sim: Optional[Dict[str, float]] = None
    # decoder-inversion endpoint diagnostics (best across starts/rounds):
    # 'tf_ce_min', 'tf_argmax_max', 'tf_argmax_full'
    inversion_diag: Optional[Dict[str, float]] = None
    # wall-clock seconds of this target's search; excluded from equality so
    # split runs compare equal to a single run on search outcomes
    wall_s: Optional[float] = dataclasses.field(default=None, compare=False)


def element_presence(formulas: List[str]) -> np.ndarray:
    out = np.zeros((len(formulas), 119), bool)
    for i, f in enumerate(formulas):
        for el in parse_formula_composition(f):
            out[i, SYMBOL_TO_Z[el]] = True
    return out


def composition_feature(formula: str, dim: int = 119) -> Optional[np.ndarray]:
    """Order-free composition vector: x[Z] = normalized fraction of element
    Z, plus a trailing bias term (the inverse regression's feature space)."""
    comp = parse_formula_composition(formula)
    if not comp:
        return None
    x = np.zeros(dim + 1, np.float32)
    total = sum(comp.values()) or 1.0
    for el, amt in comp.items():
        z = SYMBOL_TO_Z.get(el)
        if z is None:
            return None
        x[z] = amt / total
    x[-1] = 1.0
    return x


def element_similarity(a: str, b: str) -> float:
    """Jaccard over element sets, weighted by fraction closeness."""
    ca, cb = parse_formula_composition(a), parse_formula_composition(b)
    if not ca or not cb:
        return 0.0
    sa, sb = set(ca), set(cb)
    jac = len(sa & sb) / len(sa | sb)
    if jac == 0:
        return 0.0
    ta = sum(ca.values()) or 1.0
    tb = sum(cb.values()) or 1.0
    diffs = [abs(ca[e] / ta - cb[e] / tb) for e in sa & sb]
    frac_score = 1.0 - min(sum(diffs) / max(len(diffs), 1), 1.0)
    return 0.5 * jac + 0.5 * jac * frac_score


def _snapshot_steps(steps: int, n_snapshots: int) -> List[int]:
    """The steps whose states a descent returns: every ``steps //
    n_snapshots``-th, the first ``n_snapshots`` of them, padded with the
    last step (JAX's ``flatnonzero(..., size=n_snapshots,
    fill_value=steps - 1)``)."""
    every = max(steps // n_snapshots, 1)
    idx = [i for i in range(steps) if (i + 1) % every == 0][:n_snapshots]
    return idx + [steps - 1] * (n_snapshots - len(idx))


class HoldoutSearch:
    def __init__(self, pipeline: SuperconductorDiscoveryPipeline,
                 holdout_path: Optional[str | Path] = None):
        self.pipe = pipeline
        self.device = pipeline.device
        blob = json.loads(Path(holdout_path or HOLDOUT_PATH).read_text())
        self.targets = [s['formula'] for s in blob['holdout_samples']]
        self.target_tc = {s['formula']: float(s['Tc'])
                          for s in blob['holdout_samples'] if 'Tc' in s}
        self.presence = element_presence(pipeline.ds.formulas)
        self.last_inversion_diag: Optional[Dict[str, float]] = None

    def _gen(self, key: Key) -> torch.Generator:
        return key_generator(key, self.device)

    def _t(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    # ---- head-guided latent optimization -----------------------------------
    def _target_head_arrays(self, target: str):
        """Supervision-convention arrays for the guided objective: normalized
        fractions padded to 12 slots + mask, element count, the target Tc in
        normalized units and its weight, and the Magpie target and mask.

        Slot order is ALPHABETICAL by element symbol, the corpus's spelling
        convention; holdout targets keep their source spelling, so their own
        appearance order would mis-assign the slots of reordered targets.
        The Magpie target is the target's ``formula_features`` through
        ``NormStats.normalize_fresh_magpie`` (columns it cannot reproduce
        are masked out)."""
        comp = parse_formula_composition(target)
        f_star = np.zeros(MAX_ELEMENTS, np.float32)
        m_star = np.zeros(MAX_ELEMENTS, np.float32)
        total = sum(comp.values()) or 1.0
        for j, (_, amt) in enumerate(sorted(comp.items())[:MAX_ELEMENTS]):
            f_star[j] = amt / total
            m_star[j] = 1.0
        tc_k = self.target_tc.get(target)
        tc_star = float(self.pipe.ds.norm_stats.kelvin_to_norm(
            np.asarray(tc_k or 0.0, np.float64)))
        tc_w = np.float32(0.5 if tc_k is not None else 0.0)

        ns = self.pipe.ds.norm_stats
        mdim = self.pipe.ds.magpie_dim
        mg_star = np.zeros(mdim, np.float32)
        mg_mask = np.zeros(mdim, np.float32)
        raw = formula_features(target)
        if len(raw) == mdim and np.asarray(ns.magpie_mean).shape[0] == mdim:
            mg_star, mg_mask = ns.normalize_fresh_magpie(raw)
            mg_star = mg_star * mg_mask
        return (f_star, m_star, np.float32(len(comp)), np.float32(tc_star),
                tc_w, mg_star, mg_mask)

    def _guided_objective(self, z, z0, arrays, trust: float, order_free: bool):
        """The guided descent's summed loss at z (encoder in eval mode)."""
        fs, ms, ns, ts, tw, mgs, mgm = arrays
        h = self.pipe.encoder.heads_from_z(z)
        pred = h['fraction_pred'].float()
        if order_free:
            pred = torch.sort(pred, dim=-1, descending=True).values
        lf = ((pred - fs) ** 2 * ms).sum(-1)
        lc = 0.05 * (h['element_count_pred'].float() - ns) ** 2
        lt = tw * (h['tc_pred'].float() - ts) ** 2
        lsc = 0.05 * F.softplus(-h['sc_pred'].float())
        # element identity lives in the Magpie head (the fraction head has
        # amounts only)
        lm = 0.25 * ((h['magpie_pred'].float() * mgm - mgs) ** 2).sum(-1) \
            / mgm.sum().clamp_min(1.0)
        reg = trust * ((z - z0) ** 2).sum(-1)
        return (lf + lc + lt + lsc + lm + reg).sum()

    def _guided_arrays(self, target: str, order_free: bool):
        (f_star, m_star, n_star, tc_star, tc_w,
         mg_star, mg_mask) = self._target_head_arrays(target)
        if order_free:
            f_star = np.sort(f_star)[::-1].copy()
            m_star = np.sort(m_star)[::-1].copy()
        return tuple(self._t(a) for a in (f_star, m_star, n_star, tc_star, tc_w,
                                          mg_star, mg_mask))

    def _descend(self, objective, z_init, steps: int, lr: float,
                 n_snapshots: int, modules) -> Tuple[torch.Tensor, torch.Tensor]:
        """``steps`` Adam steps (torch's defaults: betas (0.9, 0.999), eps
        1e-8, optax's ``adam`` arithmetic) on z alone, the modules in eval
        mode.  Returns (the snapshots, the final z)."""
        z0 = self._t(z_init).detach()
        z = z0.clone().requires_grad_(True)
        opt = torch.optim.Adam([z], lr=lr)
        keep = set(_snapshot_steps(steps, n_snapshots)) | {steps - 1}
        snaps = {}
        with eval_mode(*modules):
            for i in range(steps):
                z.grad = torch.autograd.grad(objective(z, z0), z)[0]
                opt.step()
                if i in keep:
                    snaps[i] = z.detach().clone()
        return (torch.cat([snaps[i] for i in _snapshot_steps(steps, n_snapshots)], dim=0),
                snaps[steps - 1])

    def head_guided_latents(self, target: str, z_init, steps: int = 240,
                            lr: float = 0.08, trust: float = 2e-3,
                            n_snapshots: int = 4,
                            order_free: bool = False) -> torch.Tensor:
        """Navigate latents by gradient: descend z so that the encoder's OWN
        heads predict the target's known properties (fractions, element
        count, Tc, SC, Magpie), starting from corpus anchors, with a
        trust-region tether to each anchor.

        ``order_free=True`` matches sorted-descending predicted fractions to
        sorted-descending targets (any slot permutation that realises the
        target's fraction multiset).  Where predicted fractions tie exactly,
        the gradient through the sort may take another route than JAX's.

        Returns ``[n_snapshots * len(z_init), latent]``: trajectory
        snapshots, the final state last."""
        arrays = self._guided_arrays(target, order_free)
        snaps, _ = self._descend(
            lambda z, z0: self._guided_objective(z, z0, arrays, trust, order_free),
            z_init, steps, lr, n_snapshots, (self.pipe.encoder,))
        return snaps

    # ---- decoder inversion --------------------------------------------------
    def _target_token_ids(self, target: str) -> Optional[np.ndarray]:
        """Canonical-spelling token sequence for decoder inversion:
        alphabetical element order with merged, GCD-reduced amounts (the
        corpus convention).  None when the spelling does not round-trip
        (a fraction outside the vocab, a sequence longer than max_len)."""
        tok = self.pipe.tokenizer
        comp = parse_formula_composition(target)
        if not comp:
            return None
        parts = []
        for el in sorted(comp):
            amt = Fraction(comp[el]).limit_denominator(100000)
            parts.append(el)
            if amt == 1:
                continue
            if amt.denominator == 1:
                parts.append(str(int(amt)))
            else:
                parts.append(f'({amt.numerator}/{amt.denominator})')
        spelled = ''.join(parts)
        ids = tok.encode(spelled)
        tkey = canonical_composition_key(target)
        if tkey is None or canonical_composition_key(tok.decode(ids)) != tkey:
            return None
        return np.asarray(ids, np.int32)

    def _tf_heads(self, z, toks):
        full = self.pipe.encoder.heads_from_z(z)
        heads = self.pipe.decoder(z, toks, full['stoich'], full['heads_vec'])
        logits = heads['logits'].float()                       # [B, T-1, V]
        tgt = toks[:, 1:]
        mask = (tgt != PAD_ID).float()
        denom = mask.sum(-1).clamp_min(1.0)
        ce = -torch.log_softmax(logits, dim=-1).gather(-1, tgt[..., None])[..., 0]
        ce = (ce * mask).sum(-1) / denom
        return heads, logits, tgt, mask, denom, ce

    def _inversion_objective(self, z, z0, toks, trust: float, stop_w: float):
        """TF cross-entropy of ``toks`` + ``stop_w`` x the stop-head BCE +
        the trust term, summed over the starts (modules in eval mode)."""
        heads, _, tgt, mask, denom, ce = self._tf_heads(z, toks)
        sbce = F.binary_cross_entropy_with_logits(
            heads['stop_logits'].float(), (tgt == EOS_ID).float(), reduction='none')
        sbce = (sbce * mask).sum(-1) / denom
        reg = trust * ((z - z0) ** 2).sum(-1)
        return (ce + stop_w * sbce + reg).sum()

    def _inversion_tokens(self, ids: np.ndarray, n: int) -> torch.Tensor:
        return torch.as_tensor(np.tile(ids[None], (n, 1)), dtype=torch.long,
                               device=self.device)

    def decoder_inversion_latents(self, target: str, z_init,
                                  steps: int = 384, lr: float = 0.05,
                                  trust: float = 1e-3,
                                  n_snapshots: int = 6,
                                  stop_w: float = 0.25) -> Optional[torch.Tensor]:
        """Direct decoder inversion: descend z on the teacher-forced
        cross-entropy of the exact canonical target token sequence, plus a
        stop-head alignment BCE (so that greedy decode's hard stop fires at
        EOS, not before), through z -> encoder heads -> memory -> TF logits
        (the decoder's plain attention, ``mha_attention``).

        Greedy decode reproduces the target iff the target token is the
        argmax at every position, which a low enough TF cross-entropy
        guarantees.  Sets ``last_inversion_diag`` (the final z's least TF
        CE, best argmax-match share, and count of starts matching at every
        position).  Returns trajectory snapshots ``[n_snapshots *
        len(z_init), latent]`` (final states last), or None when the target
        has no in-vocab canonical spelling."""
        ids = self._target_token_ids(target)
        if ids is None:
            return None
        toks = self._inversion_tokens(ids, len(z_init))
        modules = (self.pipe.encoder, self.pipe.decoder)
        snaps, zf = self._descend(
            lambda z, z0: self._inversion_objective(z, z0, toks, trust, stop_w),
            z_init, steps, lr, n_snapshots, modules)
        with torch.no_grad(), eval_mode(*modules):
            _, logits, tgt, mask, denom, ce = self._tf_heads(zf, toks)
            am = ((logits.argmax(-1) == tgt).float() * mask).sum(-1) / denom
        self.last_inversion_diag = {
            'tf_ce_min': float(ce.min()),
            'tf_argmax_max': float(am.max()),
            'tf_argmax_full': int((am >= 1.0).sum())}
        return snaps

    def _anchor_latents(self, target: str, cache, n: int = 16) -> torch.Tensor:
        """Fixed-count anchor set for guided navigation: same-element-set
        rows first, then Jaccard neighbours; each neighbour missing target
        elements is pre-blended 30% toward the centroid of the 16 corpus
        rows carrying the missing element with the most set overlap with
        the target.  Padded by repetition."""
        tgt_presence = element_presence([target])[0]
        same = np.flatnonzero((self.presence == tgt_presence).all(axis=1))
        nbrs = element_jaccard_neighbors(tgt_presence, self.presence, k=n)
        idx = np.concatenate([same[:n], nbrs])[:n]
        if len(idx) == 0:
            idx = np.argsort(-cache.tc_kelvin)[:n]
        idx = np.resize(idx, n)
        z = np.array(np.asarray(cache.z[idx], np.float32))
        for i, row in enumerate(idx):
            missing = np.flatnonzero(tgt_presence & ~self.presence[row])
            for ez in missing:
                rows = np.flatnonzero(self.presence[:, ez])
                if len(rows):
                    ov = (self.presence[rows] & tgt_presence).sum(1) \
                        / np.maximum((self.presence[rows]
                                      | tgt_presence).sum(1), 1)
                    best = rows[np.argsort(-ov)[:16]]
                    cen = np.asarray(cache.z[best], np.float32).mean(0)
                    z[i] = 0.7 * z[i] + 0.3 * cen
        return self._t(z)

    def _candidate_latents(self, target: str, cache, budget: int,
                           generator: torch.Generator) -> torch.Tensor:
        """Candidate latent pool of ``budget`` rows: same-element-set
        sweeps (pairwise lerp with extrapolation, tight perturbation) first,
        then pairwise slerp / lerp between the top-100 Jaccard neighbours,
        centroid random walks and the anchor -> centroid line, PCA walks
        and random component mixes, dopant-anchored blends for target
        elements the anchor lacks, and multi-scale Gaussian perturbation of
        the top 30 seeds, sized last to fill ``budget``.  Draws come from
        ``generator`` in JAX's order of the blocks."""
        tgt_presence = element_presence([target])[0]
        nbrs = element_jaccard_neighbors(tgt_presence, self.presence, k=100)
        if len(nbrs) == 0:
            nbrs = np.argsort(-cache.tc_kelvin)[:8]
        z_n = self._t(cache.z[nbrs])
        anchor = z_n[0]
        latent_dim = z_n.shape[-1]
        kw = dict(generator=generator, device=self.device)

        def randint(n, high):
            return torch.randint(0, high, (n,), **kw)

        def uniform(n, lo, hi):
            return lo + (hi - lo) * torch.rand(n, **kw)

        # same-element-set manifold sweep: rows with the IDENTICAL element
        # set differ from the target only in fractions
        same_set = np.flatnonzero((self.presence == tgt_presence).all(axis=1))
        same_parts = []
        if len(same_set) >= 1:
            z_s = self._t(cache.z[same_set[:24]])
            n_pair = max(budget // 8, 8)
            if len(z_s) >= 2:
                ii, jj = randint(n_pair, len(z_s)), randint(n_pair, len(z_s))
                ts = uniform(n_pair, -0.25, 1.25)   # extrapolate past endpoints
                same_parts.append(lerp(z_s[ii], z_s[jj], ts))
            same_parts.append(perturb(z_s[randint(n_pair, len(z_s))], generator, 0.03))

        # dopant anchoring: blend the anchor with corpus rows that carry the
        # target elements the anchor's own formula lacks
        anchor_presence = self.presence[nbrs[0]]
        missing = np.flatnonzero(tgt_presence & ~anchor_presence)
        per = max(budget // (6 if len(missing) else 5), 4)
        dope_parts = []
        if len(missing):
            per_el = max(per // len(missing), 2)
            for ez in missing:
                rows = np.flatnonzero(self.presence[:, ez])
                if len(rows) == 0:
                    continue
                dope_parts.append(element_anchored_blend(
                    anchor, self._t(cache.z[rows[:64]]), generator, per_el, sigma=0.02))

        parts: List[torch.Tensor] = []

        # pairwise interpolation between seed pairs, slerp then lerp, with
        # extrapolation past the endpoints
        if len(z_n) >= 2:
            n_int = max(budget // 8, 16)
            ii, jj = randint(n_int, len(z_n)), randint(n_int, len(z_n))
            ts = uniform(n_int, -0.25, 1.25)
            half = n_int // 2
            parts.append(slerp(z_n[ii[:half]], z_n[jj[:half]], ts[:half]))
            parts.append(lerp(z_n[ii[half:]], z_n[jj[half:]], ts[half:]))

        # centroid + scaled random walks, directions scaled by the
        # neighbours' per-dim std, scales {0.3, 0.5, 1.0, 1.5, 2.0}
        centroid = z_n.mean(dim=0)
        cw_scales = self._t((0.3, 0.5, 1.0, 1.5, 2.0))
        n_cw = max(budget // 32, 10)
        dirs = torch.randn(n_cw, latent_dim, **kw) \
            * z_n.std(dim=0, correction=0).clamp_min(1e-4)[None]
        parts.append(centroid[None]
                     + cw_scales[torch.arange(n_cw, device=self.device) % 5][:, None] * dirs)
        # plus the anchor -> centroid line
        steps = torch.linspace(-0.5, 1.5, max(budget // 64, 8), device=self.device)
        parts.append(anchor[None] + steps[:, None] * (centroid - anchor)[None])

        # PCA walks: top-20 principal directions of the seed cloud, stepped
        # -3 sigma..+3 sigma from the centroid, plus random combinations
        if len(nbrs) >= 4:
            n_comp = min(20, len(nbrs) - 1)
            comps, std = pca_components(z_n.cpu().numpy(), k=n_comp)
            sweep = np.linspace(-3.0, 3.0, 20)
            mags = np.zeros((n_comp * 20, n_comp), np.float32)
            for c in range(n_comp):
                mags[c * 20:(c + 1) * 20, c] = sweep * std[c]
            n_mix = max(budget // 32, 10)
            mix = torch.randn(n_mix, n_comp, **kw).cpu().numpy() * std[None] * 0.5
            parts.append(self._t(centroid.cpu().numpy()[None] + mags @ comps))
            parts.append(self._t(anchor.cpu().numpy()[None] + mix @ comps))
        parts += dope_parts

        # multi-scale Gaussian perturbation of the top element-overlap seeds
        # (30 seeds x 8 noise scales), sized to fill the budget
        n_so_far = sum(len(p) for p in same_parts + parts)
        n_pert = max(budget - n_so_far, 64)
        seeds = z_n[:30]
        sidx = randint(n_pert, len(seeds))
        scales = self._t((0.02, 0.05, 0.08, 0.1, 0.15, 0.2, 0.3, 0.5))
        sig = scales[torch.arange(n_pert, device=self.device) % 8]
        parts.append(seeds[sidx] + sig[:, None] * torch.randn(n_pert, latent_dim, **kw))

        # same-set sweeps go FIRST so the [:budget] clip never drops them
        # (the leading rows are also the sampled-temperature slice)
        return torch.cat(same_parts + parts, dim=0)[:budget]

    def _inverse_regression_latents(self, target: str,
                                    pool_z: List[np.ndarray],
                                    by_formula: Dict[str, list],
                                    generator: torch.Generator,
                                    best: str = '',
                                    n_out: int = 384,
                                    k_local: int = 1024,
                                    l2: float = 1e-2,
                                    tau: float = 0.3) -> Optional[torch.Tensor]:
        """Local inverse regression: every distinct decoded formula maps to
        the centroid of the latents that produced it; a weighted ridge
        (weights ``exp(-L1/tau)`` in composition space, on the active
        columns) over the ``k_local`` pool formulas nearest the target fits
        a local linear inverse of the decoder, queried at the exact target
        composition and along the best-match -> target path (with mild
        extrapolation).  Returns the queries tiled with small Gaussian
        perturbations, or None when the pool is too thin to fit."""
        x_t = composition_feature(target)
        if x_t is None:
            return None
        all_z = np.concatenate(pool_z)
        feats, zs = [], []
        for f, rows in by_formula.items():
            x = composition_feature(f)
            if x is None:
                continue
            feats.append(x)
            zs.append(all_z[np.asarray(rows)].mean(axis=0))
        if len(feats) < 24:
            return None
        X = np.stack(feats)                        # [N, 120]
        Z = np.stack(zs).astype(np.float64)        # [N, latent]
        d = np.abs(X - x_t[None]).sum(axis=1)      # L1 in composition space
        idx = np.argsort(d)[:k_local]
        Xl, Zl, dl = X[idx].astype(np.float64), Z[idx], d[idx]
        w = np.exp(-dl / tau)
        if w.sum() < 1e-6:
            return None
        Xw = Xl * w[:, None]
        active = np.flatnonzero((Xl != 0).any(axis=0))
        A = Xw[:, active].T @ Xl[:, active] + l2 * np.eye(len(active))
        B = Xw[:, active].T @ Zl
        try:
            beta = np.linalg.solve(A, B)           # [act, latent]
        except np.linalg.LinAlgError:
            return None

        queries = [x_t]
        x_b = composition_feature(best) if best else None
        if x_b is not None:
            for t in (0.5, 0.75, 1.1, 1.25):       # path + extrapolation
                queries.append((1 - t) * x_b + t * x_t)
        Q = np.stack(queries)[:, active]
        z_q = (Q @ beta).astype(np.float32)        # [q, latent]

        reps = max(n_out // len(z_q), 1)
        base = self._t(np.repeat(z_q, reps, axis=0))
        sig = self._t(np.tile(np.asarray([0.0, 0.005, 0.01, 0.02], np.float32),
                              (len(base) + 3) // 4)[:len(base)])[:, None]
        noise = torch.randn(base.shape, generator=generator, device=self.device)
        return base + sig * noise

    def _oracle_inputs(self, target: str):
        """The target's encoder inputs in the corpus convention
        (alphabetical slots, normalized fractions, fresh Magpie, known Tc),
        or None if it has no known element."""
        comp = parse_formula_composition(target)
        if not comp:
            return None
        idx = np.zeros((1, MAX_ELEMENTS), np.int64)
        frac = np.zeros((1, MAX_ELEMENTS), np.float32)
        mask = np.zeros((1, MAX_ELEMENTS), bool)
        total = sum(comp.values()) or 1.0
        for j, (el, amt) in enumerate(sorted(comp.items())[:MAX_ELEMENTS]):
            z = SYMBOL_TO_Z.get(el)
            if z is None:
                return None
            idx[0, j] = z
            frac[0, j] = amt / total
            mask[0, j] = True
        (_, _, _, tc_star, _, mg_star, _) = self._target_head_arrays(target)
        dev = self.device
        return (torch.as_tensor(idx, device=dev), self._t(frac),
                torch.as_tensor(mask, device=dev), self._t(mg_star[None]),
                self._t(np.asarray([tc_star], np.float32)))

    def oracle_encode_latent(self, target: str) -> Optional[torch.Tensor]:
        """Encode the target composition directly (holdout RECONSTRUCTION,
        reported as a diagnostic beside, never inside, the search pool)."""
        inputs = self._oracle_inputs(target)
        if inputs is None:
            return None
        with torch.no_grad(), eval_mode(self.pipe.encoder):
            return self.pipe.encoder.encode(*inputs)['z']

    def oracle_reconstruct(self, target: str, type_masks=None
                           ) -> Optional[Tuple[str, torch.Tensor]]:
        """Full-supervision holdout RECONSTRUCTION: encode the target's
        composition and greedy-decode with GROUND-TRUTH stoich conditioning
        and the encoder's head vector, the AR eval's conditioning
        convention (``decode_conditioned``).  Returns (decoded formula, z)
        or None if the target cannot be encoded."""
        inputs = self._oracle_inputs(target)
        if inputs is None:
            return None
        _, frac, mask, _, _ = inputs
        enc = self.pipe.encoder
        with torch.no_grad(), eval_mode(enc):
            enc_out = enc(*inputs)
            heads_vec = enc.heads_pred_for_decoder(enc_out)
        stoich = torch.cat([frac * mask, mask.sum(dim=1, keepdim=True).float()], dim=1)
        fs = self.pipe.decode_conditioned(enc_out['z'], stoich, heads_vec,
                                          type_masks=type_masks)
        return (fs[0] if fs else ''), enc_out['z']

    def _element_type_masks(self, target: str) -> Optional[np.ndarray]:
        """Type masks with the ELEMENT row restricted to the target's element
        set: the decode-time constraint of the element-constrained mode."""
        tok = self.pipe.tokenizer
        if tok.type_masks is None:
            return None
        masks = np.array(tok.type_masks)
        allowed = np.zeros(masks.shape[1], bool)
        for el in parse_formula_composition(target):
            allowed[ELEMENT_TOKEN_START + SYMBOL_TO_Z[el] - 1] = True
        masks[TOKEN_TYPE_ELEMENT] &= allowed
        return masks

    def consistency_check(self, z) -> Dict[str, np.ndarray]:
        """All-head self-consistency over candidate latents: SC prob vs
        predicted Tc, SC prob vs the family head, Tc value vs Tc bucket."""
        heads = self.pipe._full_heads(z)
        tc_k = np.asarray(self.pipe.ds.norm_stats.tc_to_kelvin(
            heads['tc_pred'].cpu().numpy().astype(np.float64)))
        sc_p = torch.sigmoid(heads['sc_pred'].float()).cpu().numpy()
        fam = heads['family_composed_14'].argmax(-1).cpu().numpy()
        bucket = heads['tc_class_logits'].argmax(-1).cpu().numpy()
        exp_bucket = np.digitize(tc_k, [0.0, 10.0, 50.0, 100.0])
        sc_tc = (((sc_p < 0.5) & (tc_k > 5.0))
                 | ((sc_p > 0.8) & (tc_k <= 0.0)))
        # family index 0 = NOT_SUPERCONDUCTOR in the composed-14 layout
        sc_family = (((sc_p < 0.5) & (fam != 0))
                     | ((sc_p > 0.8) & (fam == 0)))
        tc_bucket = np.abs(exp_bucket - bucket) > 1
        return {'sc_tc_mismatch': sc_tc, 'sc_family_mismatch': sc_family,
                'tc_bucket_mismatch': tc_bucket,
                'tc_pred_kelvin': tc_k, 'sc_prob': sc_p}

    def search(self, budget_per_target: int = 200, seed: int = 0,
               targets: Optional[List[str]] = None,
               temperature_sweep: tuple = (0.0, 0.3, 0.7),
               check_consistency: bool = True,
               refine_rounds: int = 2,
               guided: bool = True,
               guided_starts: int = 16,
               inversion: bool = True,
               inversion_starts: int = 24,
               inversion_steps: int = 384,
               inverse_regression: bool = True,
               oracle_diagnostic: bool = True,
               constrain_elements: bool = False,
               sample_slice: int = 4096,
               sample_draws: int = 2,
               decode_chunk: int = 2048,
               target_offset: int = 0,
               strategy_order: str = 'tiered',
               snap_stoich: bool = True,
               log_fn=print,
               stream_fn=None) -> List[HoldoutResult]:
        """``refine_rounds``: zoom-in passes re-seeding a fine perturbation
        sweep around the best candidate's latent centroid.

        ``strategy_order``: ``'tiered'`` (the reporting protocol) runs the
        information tiers in order, each only if the previous one found no
        exact match: *navigation* (pool + perturbation-only refine), then
        *guided* (head-guided descent + inverse regression), then
        *inversion* (TF-CE descent on the exact target tokens), so that
        ``exact_tier`` names the weakest information budget that found the
        target.  ``'inversion_first'`` is the legacy speed order;
        ``exact_tier`` then comes from ``found_by``.

        Temperatures: the whole pool decodes at ``temperature_sweep[0]``
        (greedy); the other temperatures decode only the leading
        ``sample_slice`` rows, ``sample_draws`` times each with fresh
        streams.

        ``target_offset``: the absolute index of ``targets[0]`` in the full
        holdout list; each target's streams are named by its absolute
        index, so they are the same whether the targets run in one call or
        split across several."""
        cache = self.pipe.analyzer.build_cache(self.pipe.ds)
        results = []
        # exact match is COMPOSITION-level: generated formulas are in the
        # tokenizer's canonical order while holdout targets keep their
        # source notation
        for t_i, target in enumerate(targets or self.targets):
            t_start = time.perf_counter()
            t_key = (seed, target_offset + t_i)
            tkey = canonical_composition_key(target)

            pool_z: List[np.ndarray] = []      # latent pool, concatenated
            by_formula: Dict[str, list] = {}   # formula -> latent pool rows
            scores: Dict[str, tuple] = {}      # formula -> (sim, is_exact)
            first_label: Dict[str, str] = {}   # formula -> producing strategy

            tmask = (self._element_type_masks(target)
                     if constrain_elements else None)

            def decode_into_pool(zc, temps, key, label='pool', pure_greedy=False):
                offset = sum(len(p) for p in pool_z)
                pool_z.append(zc.cpu().numpy())
                for s, temp in enumerate(temps):
                    greedy = temp < 0.01
                    z_use = zc if greedy else zc[:sample_slice]
                    for d in range(1 if greedy else sample_draws):
                        fs = self.pipe.decode_latents(
                            z_use, temperature=temp,
                            generator=self._gen(key + (s * 131 + d,)),
                            type_masks=tmask, chunk=decode_chunk,
                            pure_greedy=pure_greedy, snap_stoich=snap_stoich)
                        for j, f in enumerate(fs):
                            if f:
                                by_formula.setdefault(f, []).append(offset + j)
                                first_label.setdefault(f, label)
                                if f not in scores:
                                    is_exact = (tkey is not None
                                                and canonical_composition_key(f) == tkey)
                                    sim = (1.0 if is_exact
                                           else element_similarity(f, target))
                                    scores[f] = (sim, is_exact)

            def score():
                best, best_sim, best_exact = '', 0.0, False
                for f, (sim, is_exact) in scores.items():
                    if sim > best_sim or (is_exact and not best_exact):
                        best, best_sim, best_exact = f, sim, is_exact
                return best, best_sim, best_exact

            best, best_sim, best_exact = '', 0.0, False
            inv_diag = None
            tier_sim: Dict[str, float] = {}
            exact_tier: Optional[str] = None

            def merge_inv_diag():
                nonlocal inv_diag
                d = self.last_inversion_diag
                if d is None:
                    return
                if inv_diag is None:
                    inv_diag = dict(d)
                else:
                    inv_diag['tf_ce_min'] = min(inv_diag['tf_ce_min'], d['tf_ce_min'])
                    inv_diag['tf_argmax_max'] = max(inv_diag['tf_argmax_max'],
                                                    d['tf_argmax_max'])
                    inv_diag['tf_argmax_full'] += d['tf_argmax_full']

            def best_centroid():
                all_z = np.concatenate(pool_z)
                return self._t(all_z[np.asarray(by_formula[best])].mean(axis=0))

            def around_best(n, fold, sigma):
                return perturb(best_centroid()[None].repeat(n, 1),
                               self._gen(t_key + (fold,)), sigma)

            fine_n = min(max(budget_per_target // 2, 8), 8192)

            def run_pool():
                z = self._candidate_latents(target, cache, budget_per_target,
                                            self._gen(t_key))
                decode_into_pool(z, temperature_sweep, t_key)
                return score()

            def run_navigation_refine(r):
                # perturbation-only zoom-in around the best candidate: stays
                # inside the navigation information budget
                fine = around_best(fine_n, 100 + r, 0.01 * (r + 1))
                decode_into_pool(fine, (0.0, 0.3), t_key + (200 + r,), label='refine')
                return score()

            def run_guided(anchors, suffix=0):
                # both slot conventions: corpus-alphabetical and sorted
                zg = self.head_guided_latents(target, anchors)
                decode_into_pool(zg, (0.0,), t_key + (999 - suffix,), label='guided')
                zg = self.head_guided_latents(target, anchors, order_free=True)
                decode_into_pool(zg, (0.0,), t_key + (979 - suffix,), label='guided')
                return score()

            def run_inverse_regression(r=0):
                zi = self._inverse_regression_latents(
                    target, pool_z, by_formula, self._gen(t_key + (500 + r,)), best=best)
                if zi is not None:
                    decode_into_pool(zi, (0.0, 0.3), t_key + (530 + r,),
                                     label='inverse_regression')
                return score()

            def run_inversion(z_seed, fold):
                self.last_inversion_diag = None
                zi = self.decoder_inversion_latents(target, z_seed, steps=inversion_steps)
                merge_inv_diag()
                if zi is None:
                    return score()
                decode_into_pool(zi, (0.0,), t_key + (fold,), label='inversion')
                b, s, e = score()
                if not e:
                    # ungated argmax rollout: equals the TF-argmax
                    # diagnostic by induction
                    decode_into_pool(zi, (0.0,), t_key + (fold + 3,),
                                     label='inversion_pure', pure_greedy=True)
                    b, s, e = score()
                if not e:
                    # small greedy fan around the final states: argmax ties
                    # at the CE optimum sit on basin boundaries
                    fin = zi[-inversion_starts:]
                    reps = max(256 // max(len(fin), 1), 1)
                    fan = perturb(fin.repeat(reps, 1), self._gen(t_key + (fold + 1,)), 0.004)
                    decode_into_pool(fan, (0.0,), t_key + (fold + 2,), label='inversion')
                    b, s, e = score()
                    if not e:
                        decode_into_pool(fan, (0.0,), t_key + (fold + 4,),
                                         label='inversion_pure', pure_greedy=True)
                        b, s, e = score()
                return b, s, e

            if strategy_order == 'tiered':
                # ---- tier 1: NAVIGATION ----
                best, best_sim, best_exact = run_pool()
                for r in range(refine_rounds):
                    if best_exact or not best:
                        break
                    best, best_sim, best_exact = run_navigation_refine(r)
                tier_sim['navigation'] = best_sim
                if best_exact:
                    exact_tier = 'navigation'

                # ---- tier 2: GUIDED (target-property supervision) ----
                if not best_exact and (guided or inverse_regression):
                    if guided:
                        best, best_sim, best_exact = run_guided(
                            self._anchor_latents(target, cache, n=guided_starts))
                    if inverse_regression and not best_exact:
                        best, best_sim, best_exact = run_inverse_regression()
                    for r in range(refine_rounds):
                        if best_exact or not best:
                            break
                        if guided:
                            best, best_sim, best_exact = run_guided(
                                around_best(guided_starts, 300 + r, 0.01),
                                suffix=2 * r + 2)
                        if inverse_regression and not best_exact:
                            best, best_sim, best_exact = run_inverse_regression(r + 1)
                    tier_sim['guided'] = best_sim
                    if best_exact and exact_tier is None:
                        exact_tier = 'guided'

                # ---- tier 3: INVERSION (decoder invertibility) ----
                if not best_exact and inversion:
                    best, best_sim, best_exact = run_inversion(
                        self._anchor_latents(target, cache, n=inversion_starts), 600)
                    for r in range(refine_rounds):
                        if best_exact or not best:
                            break
                        best, best_sim, best_exact = run_inversion(
                            around_best(inversion_starts, 700 + r, 0.02), 710 + 10 * r)
                    tier_sim['inversion'] = best_sim
                    if best_exact and exact_tier is None:
                        exact_tier = 'inversion'
            else:
                # legacy speed order: inversion first
                if inversion:
                    best, best_sim, best_exact = run_inversion(
                        self._anchor_latents(target, cache, n=inversion_starts), 600)
                if not best_exact:
                    best, best_sim, best_exact = run_pool()
                if guided and not best_exact:
                    best, best_sim, best_exact = run_guided(
                        self._anchor_latents(target, cache, n=guided_starts))
                if inverse_regression and not best_exact:
                    best, best_sim, best_exact = run_inverse_regression()
                for r in range(refine_rounds):
                    if best_exact or not best:
                        break
                    best, best_sim, best_exact = run_navigation_refine(r)
                    if inversion and not best_exact:
                        # inversion re-seeded from the best-match basin
                        best, best_sim, best_exact = run_inversion(
                            around_best(inversion_starts, 700 + r, 0.02), 710 + 10 * r)
                    if guided and not best_exact:
                        best, best_sim, best_exact = run_guided(
                            around_best(guided_starts, 300 + r, 0.01), suffix=2 * r + 2)
                    if inverse_regression and not best_exact:
                        best, best_sim, best_exact = run_inverse_regression(r + 1)
                if best_exact:
                    exact_tier = {
                        'pool': 'navigation', 'refine': 'mixed',
                        'guided': 'guided', 'inverse_regression': 'guided',
                        'inversion': 'inversion',
                        'inversion_pure': 'inversion',
                    }.get(first_label.get(best) or '', 'mixed')

            oracle_f = oracle_m = None
            oracle_masks = None
            if oracle_diagnostic:
                rec = self.oracle_reconstruct(target, type_masks=tmask)
                if rec is not None:
                    oracle_f = rec[0]
                    oracle_m = bool(tkey is not None and oracle_f
                                    and canonical_composition_key(oracle_f) == tkey)
                    oracle_masks = ('element-constrained' if tmask is not None
                                    else 'generic')

            consistent = True
            cons_info = None
            if check_consistency and best:
                c = self.consistency_check(best_centroid()[None])
                consistent = not (c['sc_tc_mismatch'][0]
                                  or c['sc_family_mismatch'][0]
                                  or c['tc_bucket_mismatch'][0])
                cons_info = {'tc_pred_kelvin': float(c['tc_pred_kelvin'][0]),
                             'sc_prob': float(c['sc_prob'][0])}
            results.append(HoldoutResult(
                target=target, best_match=best, exact=best_exact,
                best_similarity=best_sim, n_candidates=len(by_formula),
                consistent=consistent, consistency=cons_info,
                oracle_formula=oracle_f, oracle_match=oracle_m,
                oracle_masks=oracle_masks,
                found_by=first_label.get(best),
                exact_tier=exact_tier, tier_sim=tier_sim or None,
                inversion_diag=inv_diag,
                wall_s=round(time.perf_counter() - t_start, 2)))
            log_fn(f'[{target_offset + t_i + 1}] {target}: '
                   f'best={best!r} sim={best_sim:.3f} '
                   f'{"EXACT[" + str(exact_tier) + "/" + str(first_label.get(best)) + "]" if best_exact else ""}'
                   f'{"" if consistent else " INCONSISTENT"}'
                   f'{" oracle=Y" if oracle_m else ""}')
            if stream_fn is not None:
                # durably record each finished target
                stream_fn(target_offset + t_i, results[-1])
        return results

    @staticmethod
    def summarize(results: List[HoldoutResult]) -> Dict[str, float]:
        n = len(results)
        nav = sum(r.exact_tier == 'navigation' for r in results)
        gui = sum(r.exact_tier == 'guided' for r in results)
        inv = sum(r.exact_tier == 'inversion' for r in results)
        return {
            'n_targets': n,
            'exact': sum(r.exact for r in results),
            # information-budget stratification (HoldoutResult.exact_tier);
            # the *_cum rows are cumulative
            'exact_navigation': nav,
            'exact_guided_cum': nav + gui,
            'exact_inversion_cum': nav + gui + inv,
            'exact_tier_unattributed': sum(
                r.exact and r.exact_tier in (None, 'mixed') for r in results),
            'sim_ge_99': sum(r.best_similarity >= 0.99 for r in results),
            'sim_ge_95': sum(r.best_similarity >= 0.95 for r in results),
            'mean_similarity': float(np.mean([r.best_similarity
                                              for r in results])) if n else 0.0,
            'consistent': sum(r.consistent for r in results),
            # diagnostic only: direct-encode reconstruction, NOT in 'exact'
            'oracle_match': sum(bool(r.oracle_match) for r in results),
        }
