"""Phase-2 self-supervised training: learn from the model's own generations
(port of training/self_supervised.py).

One sub-epoch (``SelfSupervisedEpoch.run``): sample latents around the data
manifold (coverage-weighted anchors, then Gaussian perturbation, SLERP
between anchors and element-anchored blends), decode them in two batched
KV-cache rollouts (greedy, and sampled at an exploration temperature),
filter the formulas through the chemical and physics validators, track the
novel ones, and run one gated low-LR update of the encoder AND the decoder
on four self-supervised losses over the accepted candidates (round-trip
re-encoding, multi-head consistency, the differentiable physics
constraints, and REINFORCE with a round-trip reward and a diversity bonus).

The rollouts are ``generate_with_kv_cache`` without gates or early exit:
29 steps each, through K1 when the decoder has ``pallas_decode``.  Every
forward of the sub-epoch is deterministic, as JAX's (flax's
``deterministic=True`` default): ``run`` and ``update`` put the encoder and
the decoder in eval mode and give back the mode they found.  The modules
are updated in place; each has its own clip-and-AdamW (``optax.chain(
clip_by_global_norm, adamw)``, weight decay optax's 1e-4), made at the
first update that runs and kept across sub-epochs, in no checkpoint.

Differences from the JAX sub-epoch: its random draws come from one
``torch.Generator`` (JAX splits a key), so latents and sampled tokens
cannot equal JAX's; the seams ``sample_latents``, ``rollouts``,
``filter_candidates`` and ``update`` let a caller feed fixed draws.
"""

from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..data.pipeline import DatasetArrays, load_holdout_formulas
from ..generation import GenerationConfig, generate_with_kv_cache
from ..generation.latent import element_anchored_blend, perturb, slerp
from ..models.layers import eval_mode
from ..ops.constraints import charge_balance_loss, site_occupancy_loss
from ..ops.round_trip import tokens_to_composition
from ..tokenizer import BOS_ID, PAD_ID, FractionAwareTokenizer
from ..validation import CandidateValidator, PhysicsValidator
from .coverage_tracker import CoverageTracker
from .train_step import ADAM_BETAS, ADAM_EPS, clip_by_global_norm_

ADAMW_WEIGHT_DECAY = 1e-4         # optax.adamw's default, which JAX's Phase 2 keeps


@dataclasses.dataclass
class Phase2Config:
    n_samples: int = 64
    noise_schedule: tuple = (0.02, 0.05, 0.08, 0.1)
    noise_warmup_epochs: int = 200
    element_anchored_fraction: float = 0.20
    slerp_fraction: float = 0.3
    lr_factor: float = 0.1
    grad_clip: float = 0.5
    # generation split (reference: self_supervised.py:86-88)
    greedy_fraction: float = 0.5
    explore_temp_min: float = 0.1
    explore_temp_max: float = 0.3
    # loss weights, relative within Phase 2 (reference: :96-99)
    round_trip_weight: float = 1.0
    consistency_weight: float = 0.5
    physics_weight: float = 0.3
    reinforce_weight: float = 0.5
    tc_consistency_weight: float = 5.0   # Tc weighted 5x inside loss 1
    # mode collapse intervention (reference: :101-104)
    diversity_bonus: float = 5.0
    collapse_threshold: float = 0.3
    collapse_temp_boost: float = 0.5
    collapse_rt_weight_mult: float = 2.0
    collapse_duration: int = 2
    # safety guards (reference: :117-119)
    exact_drop_threshold: float = 0.02
    exact_drop_window: int = 4
    coverage_k: int = 64
    max_weight: float = 0.1
    warmup: int = 50


def phase2_seed(seed: int, epoch: int) -> int:
    """The seed of the training loop's Phase-2 generator at ``epoch``: a
    stream of its own, apart from the train step's dropout and rollout
    seeds."""
    return int(np.random.SeedSequence([seed, epoch]).spawn(2)[1].generate_state(1)[0])


def _host_rng(generator: torch.Generator) -> np.random.Generator:
    """A numpy generator seeded from one draw of ``generator`` (JAX seeds
    its host generator from a key the same way)."""
    seed = torch.randint(0, 2 ** 30, (), generator=generator, device=generator.device)
    return np.random.default_rng(int(seed))


class NovelDiscoveryTracker:
    """Tracks validated formulas not present in training or holdout sets
    (reference: self_supervised.py:856)."""

    def __init__(self, known: set, holdout: Optional[set] = None,
                 log_path: Optional[Path] = None):
        self.known = set(known)
        self.holdout = set(holdout or load_holdout_formulas())
        self.discoveries: List[dict] = []
        self.holdout_hits: List[str] = []
        self.log_path = Path(log_path) if log_path else None

    def record(self, formula: str, meta: Optional[dict] = None) -> bool:
        if formula in self.known:
            return False
        entry = {'formula': formula, 'time': time.time(), **(meta or {})}
        if formula in self.holdout:
            self.holdout_hits.append(formula)
            entry['holdout_hit'] = True
        self.discoveries.append(entry)
        self.known.add(formula)
        if self.log_path:
            self.log_path.parent.mkdir(parents=True, exist_ok=True)
            with open(self.log_path, 'a') as f:
                f.write(json.dumps(entry) + '\n')
        return True


class SelfSupervisedEpoch:
    def __init__(self, encoder, decoder, tokenizer: FractionAwareTokenizer,
                 ds: DatasetArrays, luts: Dict[str, torch.Tensor],
                 cfg: Phase2Config = Phase2Config(),
                 base_lr: float = 3e-5,
                 output_dir: Optional[str] = None):
        self.encoder, self.decoder = encoder, decoder
        self.tokenizer = tokenizer
        self.ds = ds
        self.luts = luts
        self.cfg = cfg
        self.lr = base_lr * cfg.lr_factor
        self.validator = CandidateValidator()
        self.physics = PhysicsValidator()
        self.coverage = CoverageTracker(k=cfg.coverage_k)
        self.tracker = NovelDiscoveryTracker(
            set(ds.formulas),
            log_path=(Path(output_dir) / 'phase2_discoveries.jsonl'
                      if output_dir else None))
        self._enc_opt: Optional[torch.optim.AdamW] = None
        self._dec_opt: Optional[torch.optim.AdamW] = None
        self._epoch = 0
        # mode-collapse intervention + exact-drop safety state
        self._collapse_remaining = 0
        self._exact_hist: List[float] = []
        self._rewarded: set = set(ds.formulas)

    # ---- latent sampling ---------------------------------------------------
    def _sigma(self) -> float:
        sched = self.cfg.noise_schedule
        frac = min(self._epoch / max(self.cfg.noise_warmup_epochs, 1), 1.0)
        idx = min(int(frac * (len(sched) - 1) + 1e-9), len(sched) - 1)
        return sched[idx]

    def sample_latents(self, z_cache: np.ndarray, generator: torch.Generator) -> torch.Tensor:
        """``cfg.n_samples`` latents [n, latent] on the generator's device:
        coverage-weighted anchors from ``z_cache``, then perturbed, SLERPed
        toward a shuffled partner, or blended around the last anchor with
        16 random cache rows."""
        n = self.cfg.n_samples
        dev = generator.device
        if self.coverage.centers is None:
            self.coverage.fit(z_cache, method='hdbscan')
        weights = self.coverage.sampling_weights()
        host_rng = _host_rng(generator)
        # coverage-weighted anchor choice: sample clusters, then members
        assign = self.coverage.assign(z_cache, self.coverage.centers)
        anchors = []
        for _ in range(n):
            c = host_rng.choice(len(weights), p=weights)
            members = np.where(assign == c)[0]
            anchors.append(z_cache[host_rng.choice(members)]
                           if len(members) else z_cache[host_rng.integers(len(z_cache))])
        anchors = torch.as_tensor(np.stack(anchors), device=dev)

        sigma = self._sigma()
        n_anchor = int(n * self.cfg.element_anchored_fraction)
        n_slerp = int(n * self.cfg.slerp_fraction)
        n_pert = n - n_anchor - n_slerp

        parts = [perturb(anchors[:n_pert], generator, sigma)]
        if n_slerp:
            partners = anchors[torch.randperm(n, generator=generator, device=dev)][:n_slerp]
            ts = 0.2 + 0.6 * torch.rand(n_slerp, generator=generator, device=dev,
                                        dtype=anchors.dtype)
            parts.append(slerp(anchors[n_pert:n_pert + n_slerp], partners, ts))
        if n_anchor:
            nbrs = torch.as_tensor(z_cache[host_rng.choice(
                len(z_cache), size=min(16, len(z_cache)), replace=False)], device=dev)
            parts.append(element_anchored_blend(
                anchors[-1], nbrs, generator, n_anchor, sigma=sigma, slerp_fraction=0.3))
        return torch.cat(parts, dim=0)

    # ---- generation and filtering -------------------------------------------
    def rollouts(self, z: torch.Tensor, stoich: torch.Tensor, heads_vec: torch.Tensor,
                 temperature: float, generator: torch.Generator) -> torch.Tensor:
        """Tokens [n, max_len - 1]: the first ``greedy_fraction`` of the rows
        decoded greedily, the rest sampled at ``temperature``; two rollouts
        without gates or early exit."""
        n_greedy = int(z.shape[0] * self.cfg.greedy_fraction)
        max_len = self.decoder.cfg.max_len
        halves = []
        with eval_mode(self.decoder):
            for rows, gcfg, gen in (
                    (slice(None, n_greedy), GenerationConfig(max_len=max_len, temperature=0.0),
                     None),
                    (slice(n_greedy, None),
                     GenerationConfig(max_len=max_len, temperature=float(temperature)),
                     generator)):
                if z[rows].shape[0]:
                    halves.append(generate_with_kv_cache(
                        self.decoder, z[rows], stoich[rows], heads_vec[rows], gen,
                        gcfg)['tokens'])
        return torch.cat(halves)

    def filter_candidates(self, formulas: Sequence[str]
                          ) -> Tuple[List[int], List[str], np.ndarray]:
        """Parse + chemical + physics validation: (accepted indices, accepted
        formulas, per-candidate quality).  The quality is the validator's
        score, a quarter of it for a physically implausible candidate, and
        0 for a rejected or empty one; it feeds the coverage tracker."""
        accepted_idx, accepted = [], []
        cand_quality = np.zeros(len(formulas), np.float32)
        for i, f in enumerate(formulas):
            if not f:
                continue
            v = self.validator.validate(f)
            if not v.is_valid or v.score < 0.3:
                continue
            if not self.physics.validate(f).is_plausible:
                cand_quality[i] = 0.25 * v.score
                continue
            cand_quality[i] = v.score
            accepted_idx.append(i)
            accepted.append(f)
        return accepted_idx, accepted, cand_quality

    # ---- one phase-2 sub-epoch --------------------------------------------
    def _safety_weight(self, phase2_weight: float,
                       current_exact: Optional[float]) -> float:
        """Exact-drop guard: halve the Phase-2 weight when training exact
        fell vs the recent window (reference: self_supervised.py:1486-1492)."""
        if current_exact is None:
            return phase2_weight
        self._exact_hist.append(current_exact)
        w = self.cfg.exact_drop_window
        if len(self._exact_hist) > w:
            recent_max = max(self._exact_hist[-w:])
            if current_exact < recent_max - self.cfg.exact_drop_threshold:
                return phase2_weight * 0.5
        return phase2_weight

    def run(self, z_cache: np.ndarray, generator: torch.Generator,
            phase2_weight: float = 0.1,
            current_exact: Optional[float] = None) -> Dict[str, object]:
        """One Phase-2 sub-epoch from the latent cache ``z_cache`` [N,
        latent], drawing from ``generator`` (on the models' device).
        Updates the encoder and the decoder in place when a candidate is
        accepted and the weight is above 1e-8; returns {'metrics',
        'accepted'} with the JAX package's metric names."""
        cfg = self.cfg
        self._epoch += 1
        weight = self._safety_weight(phase2_weight, current_exact)
        rt_mult = (cfg.collapse_rt_weight_mult
                   if self._collapse_remaining > 0 else 1.0)
        with eval_mode(self.encoder, self.decoder):
            z = self.sample_latents(z_cache, generator)
            with torch.no_grad():
                heads = self.encoder.heads_from_z(z)
            stoich, heads_vec = heads['stoich'], heads['heads_vec']

            # exploration temperature; boosted while collapse intervention active
            temp = cfg.explore_temp_min + (
                cfg.explore_temp_max - cfg.explore_temp_min) * _host_rng(generator).random()
            if self._collapse_remaining > 0:
                temp = cfg.collapse_temp_boost
            tokens_all = self.rollouts(z, stoich, heads_vec, temp, generator).cpu().numpy()
            b = z.shape[0]
            is_explore = np.arange(b) >= int(b * cfg.greedy_fraction)
            formulas = [self.tokenizer.decode(t) for t in tokens_all]
            accepted_idx, accepted, cand_quality = self.filter_candidates(formulas)

            # degeneracy diagnostics + collapse detection (intervene, don't
            # skip: the reference boosts round-trip weight + temperature for
            # 2 sub-epochs, self_supervised.py:1609-1616)
            unique_rate = len(set(accepted)) / max(len(accepted), 1)
            collapsed = bool(accepted) and unique_rate < cfg.collapse_threshold
            if collapsed and self._collapse_remaining == 0:
                self._collapse_remaining = cfg.collapse_duration
            elif self._collapse_remaining > 0:
                self._collapse_remaining -= 1

            novel = [f for f in set(accepted) if self.tracker.record(
                f, {'epoch': self._epoch})]

            # coverage sees EVERY sampled latent with its quality (before the
            # no-accepts return, so barren regions are down-weighted too)
            self.coverage.record_visits(z.float().cpu().numpy(), quality=cand_quality)

            metrics = {
                'n_sampled': len(formulas),
                'n_accepted': len(accepted),
                'n_novel': len(novel),
                'unique_rate': unique_rate,
                'mode_collapsed': collapsed,
                'collapse_active': self._collapse_remaining > 0,
                'explore_temp': float(temp),
                'sigma': self._sigma(),
                'phase2_weight': weight,
                'holdout_hits': len(self.tracker.holdout_hits),
            }
            if not accepted_idx or weight <= 1e-8:
                return {'metrics': metrics, 'accepted': accepted}

            # the accepted set padded cyclically to cfg.n_samples rows (as
            # JAX pads it to one static shape); repeated rows reweight the
            # means.  First-seen formulas earn the diversity bonus.
            div_np = np.zeros(len(accepted), np.float32)
            for i, f in enumerate(accepted):
                if f not in self._rewarded:
                    div_np[i] = cfg.diversity_bonus
                    self._rewarded.add(f)
            pad_pos = np.resize(np.arange(len(accepted_idx)), cfg.n_samples)
            sel = np.asarray(accepted_idx)[pad_pos]
            acc = torch.as_tensor(sel, device=z.device)
            batch = {'tokens': torch.as_tensor(tokens_all[sel], device=z.device),
                     'z_acc': z[acc], 'stoich': stoich[acc], 'heads': heads_vec[acc],
                     'div_bonus': torch.as_tensor(div_np[pad_pos], device=z.device),
                     'explore_w': torch.as_tensor(is_explore[sel], dtype=torch.float32,
                                                  device=z.device),
                     'weight': weight, 'rt_mult': rt_mult}
            metrics.update(self.update(batch))
        return {'metrics': metrics, 'accepted': accepted}

    # ---- the update -----------------------------------------------------------
    def loss(self, batch: Dict[str, object]) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The weighted sum of the four self-supervised losses over
        ``batch`` (the models' outputs in float32), and its terms."""
        cfg = self.cfg
        enc, dec = self.encoder, self.decoder
        tokens, z_acc = batch['tokens'], batch['z_acc']
        tok_mask = (tokens != PAD_ID).float()
        e_idx, e_frac, e_mask = tokens_to_composition(
            tokens, tok_mask, self.luts['token_to_z'], self.luts['token_value_table'],
            max_elements=enc.cfg.max_elements)

        # proxies from the ORIGINAL z (no grad, as in the reference)
        with torch.no_grad():
            proxies = enc.decode(z_acc)
        magpie_proxy, tc_proxy = proxies['magpie_pred'], proxies['tc_pred'].float()

        # loss 1: extended round-trip consistency (encoder grads)
        z_recon = enc.encode(e_idx, e_frac, e_mask, magpie_proxy, tc_proxy)['z'].float()
        z_mse = ((z_recon - z_acc) ** 2).mean()
        tc_mse = ((enc.decode(z_recon)['tc_pred'].float() - tc_proxy) ** 2).mean()
        loss1 = z_mse + cfg.tc_consistency_weight * tc_mse

        # loss 2: multi-head self-consistency on the sampled z
        hz = {k: v.float() for k, v in enc.heads_from_z(z_acc).items()}
        should_be_sc = torch.sigmoid(hz['tc_pred'] * 2.0).detach()
        sc_bce = F.binary_cross_entropy_with_logits(hz['sc_pred'], should_be_sc)
        bucket_p = torch.softmax(hz['tc_class_logits'], dim=-1)
        bucket_ent = (-(bucket_p * torch.log(bucket_p + 1e-8)).sum(-1)).mean()
        loss2 = 0.5 * (sc_bce + 0.1 * bucket_ent)

        # loss 3: differentiable physics constraints (A3+A6) on the
        # encoder's fraction head for the re-encoded candidates' elements
        frac_pred = hz['fraction_pred']
        a3 = site_occupancy_loss(e_idx, frac_pred, e_mask, hz['family_composed_14'])
        a6 = charge_balance_loss(e_idx, frac_pred, e_mask)
        loss3 = 0.5 * (a3 + a6)

        # loss 4: REINFORCE with round-trip cosine reward + diversity bonus,
        # the only signal reaching the decoder; the exploratory rows only
        cos = (z_acc * z_recon).sum(-1) / (
            torch.linalg.vector_norm(z_acc, dim=-1)
            * torch.linalg.vector_norm(z_recon, dim=-1) + 1e-8)
        reward = (cos.clamp(0.0, 1.0) + batch['div_bonus']).detach()
        adv = reward - reward.mean()
        # [BOS] + sampled tokens -> logits [B, T, V] aligned with tokens
        tf_input = torch.cat([torch.full_like(tokens[:, :1], BOS_ID), tokens], dim=1)
        logits = dec(z_acc, tf_input, batch['stoich'], batch['heads'])['logits'].float()
        logp = torch.log_softmax(logits, dim=-1).gather(2, tokens[:, :, None])[:, :, 0]
        seq_logp = (logp * tok_mask).sum(1)
        loss4 = -(adv * seq_logp * batch['explore_w']).mean()

        total = batch['weight'] * (
            cfg.round_trip_weight * batch['rt_mult'] * loss1
            + cfg.consistency_weight * loss2
            + cfg.physics_weight * loss3
            + cfg.reinforce_weight * loss4)
        return total, {'loss1_round_trip': loss1, 'loss2_consistency': loss2,
                       'loss3_physics': loss3, 'loss4_reinforce': loss4,
                       'z_mse': z_mse, 'tc_mse': tc_mse}

    def update(self, batch: Dict[str, object]) -> Dict[str, float]:
        """One clip-and-AdamW step of the encoder and of the decoder, each
        clipped on its own, on ``loss(batch)``; both models in eval mode.
        ``batch``: tokens [n, T] int64, z_acc [n, latent], stoich, heads
        (the decoder's conditioning), div_bonus and explore_w [n] float32,
        and the plain numbers weight and rt_mult.  Returns the loss and its
        terms as floats."""
        groups = [(list(m.parameters()), m) for m in (self.encoder, self.decoder)]
        if self._enc_opt is None:
            self._enc_opt, self._dec_opt = (
                torch.optim.AdamW(params, lr=self.lr, betas=ADAM_BETAS, eps=ADAM_EPS,
                                  weight_decay=ADAMW_WEIGHT_DECAY) for params, _ in groups)
        opts = (self._enc_opt, self._dec_opt)
        with eval_mode(self.encoder, self.decoder):
            for opt in opts:
                opt.zero_grad(set_to_none=True)
            total, aux = self.loss(batch)
            total.backward()
            for (params, _), opt in zip(groups, opts):
                # a parameter the loss does not reach has a zero gradient, and
                # AdamW still decays it (as optax does)
                for p in params:
                    if p.grad is None:
                        p.grad = torch.zeros_like(p)
                clip_by_global_norm_([p.grad for p in params], self.cfg.grad_clip)
                opt.step()
                opt.zero_grad(set_to_none=True)
        vals = torch.stack([total.detach()] + [v.detach() for v in aux.values()]).tolist()
        metrics = {'phase2_loss': vals[0], **dict(zip(aux, vals[1:]))}
        metrics['round_trip_z_mse'] = metrics.pop('z_mse')
        return metrics
