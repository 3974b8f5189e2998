"""Host-side training controllers (port of training/schedulers.py).

Plain Python on per-epoch metric floats, feeding the train step's ``dyn``
scalars or acting on the models between epochs: the curriculum ramp of
the Tc and Magpie weights, the adaptive teacher-forcing ratio (logged),
the cosine learning rate, the RL temperature schedule, the plateau
detector, ``RLController`` (``dyn['rl_w']``, ``dyn['rl_temperature']``),
``PhysZController`` (``dyn['physz_w']``), ``LossSkipScheduler`` (the
``m_*`` multipliers), ``DropDetector`` (rollback and learning-rate
halving), ``EntropyManager`` (``dyn['entropy_weight']``),
``PerPositionEntropyWeighter`` (``dyn['entropy_pos_w']``) and
``TcBinTracker``, which snapshots and restores the encoder's Tc head.
Each stateful controller has ``state_dict`` / ``load_state_dict``, which
the host loop's checkpoints carry.
"""

from __future__ import annotations

import math
from collections import deque
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from .config import TrainConfig


# ---------------------------------------------------------------------------
# simple functional schedules
# ---------------------------------------------------------------------------

def curriculum_weights(epoch: int, cfg: TrainConfig):
    """Phase-1 ramp of the Tc and Magpie weights (reference: :1317-1339)."""
    end = cfg.curriculum_phase1_end
    if epoch < end:
        p = epoch / end
        return 5.0 + (cfg.tc_weight - 5.0) * p, 1.0 + (cfg.magpie_weight - 1.0) * p
    return cfg.tc_weight, cfg.magpie_weight


def teacher_forcing_ratio(exact_match: float, cfg: TrainConfig) -> float:
    """Adaptive TF (reference: :1342-1376); locked at 1.0 by default."""
    if cfg.tf_locked or exact_match < cfg.tf_onset:
        return 1.0
    p = (exact_match - cfg.tf_onset) / (1.0 - cfg.tf_onset)
    return max(cfg.tf_floor, 1.0 - (1.0 - cfg.tf_floor) * p)


def cosine_lr(epoch: int, cfg: TrainConfig) -> float:
    """Warmup + plain cosine over num_epochs, floored at lr*min_factor."""
    lr = cfg.learning_rate
    if cfg.lr_warmup_epochs > 0 and epoch < cfg.lr_warmup_epochs:
        return lr * (epoch + 1) / cfg.lr_warmup_epochs
    t = min(max(epoch - cfg.lr_warmup_epochs, 0),
            cfg.num_epochs) / max(cfg.num_epochs, 1)
    floor = lr * cfg.lr_min_factor
    return floor + 0.5 * (lr - floor) * (1 + math.cos(math.pi * t))


def rl_temperature(epochs_since_rl_start: int, cfg: TrainConfig) -> float:
    """Exploration -> exploitation decay (reference: :599-602)."""
    if epochs_since_rl_start < 0:
        return cfg.rl_temperature_start
    p = min(epochs_since_rl_start / max(cfg.rl_temperature_decay_epochs, 1), 1.0)
    return (cfg.rl_temperature_start
            + (cfg.rl_temperature_end - cfg.rl_temperature_start) * p)


class PlateauDetector:
    """Shared plateau logic: < threshold improvement over a window."""

    def __init__(self, window: int, threshold: float):
        self.window = window
        self.threshold = threshold
        self.history: deque = deque(maxlen=window)

    def update(self, value: float) -> bool:
        self.history.append(value)
        if len(self.history) < self.window:
            return False
        return (self.history[-1] - self.history[0]) < self.threshold


class RLController:
    """RL auto-reactivation, warmup ramp, auto-scale calibration, and safety
    guard (reference: :535-602, :569-594)."""

    def __init__(self, cfg: TrainConfig):
        self.cfg = cfg
        self.active = cfg.rl_weight > 0
        self.weight = cfg.rl_weight
        self.activation_epoch: Optional[int] = None
        self.auto_scale_factor: Optional[float] = None
        self._plateau = PlateauDetector(cfg.rl_reactivation_window,
                                        cfg.rl_reactivation_plateau_threshold)
        self._last_safety_exact: Optional[float] = None

    def epoch_update(self, epoch: int, tf_exact: float, ar_exact: float,
                     raw_rl_loss: Optional[float] = None) -> float:
        cfg = self.cfg
        plateaued = self._plateau.update(tf_exact)

        if not self.active and cfg.rl_auto_reactivate:
            ready = (tf_exact >= cfg.rl_reactivation_min_exact and plateaued)
            forced = tf_exact >= cfg.rl_reactivation_force_exact
            gated = ar_exact >= cfg.rl_min_ar_exact if cfg.rl_min_ar_exact > 0 else True
            if (ready or forced) and gated:
                self.active = True
                self.activation_epoch = epoch
                self.weight = cfg.rl_reactivation_weight

        if not self.active:
            return 0.0

        # duty cycle: RL rollouts every k-th epoch once active.  The rollout
        # epoch costs ~6x a TF-only epoch (two AR decodes per step), so
        # interleaving TF-only epochs buys most of RL's AR-gap benefit at a
        # fraction of the wall cost — the throughput analogue of the
        # reference's smart loss skipping (train_v12_clean.py:614-636).
        if (cfg.rl_epoch_interval > 1 and self.activation_epoch is not None
                and (epoch - self.activation_epoch)
                % cfg.rl_epoch_interval != 0):
            return 0.0

        w = self.weight
        # warmup ramp after activation
        if self.activation_epoch is not None:
            since = epoch - self.activation_epoch
            if since < cfg.rl_warmup_epochs:
                ramp = (cfg.rl_warmup_start
                        + (1.0 - cfg.rl_warmup_start) * since / cfg.rl_warmup_epochs)
                w = w * ramp
        # auto-scale: |w * raw_rl| ~= target.  One-shot calibration on the
        # first observed RL loss after activation (the reference calibrates
        # once after a probe epoch), then a slow EMA so a single noisy RL
        # loss cannot yank the weight around.
        if cfg.rl_auto_scale and raw_rl_loss is not None and abs(raw_rl_loss) > 1e-8:
            target = cfg.rl_auto_scale_target / abs(raw_rl_loss)
            if self.auto_scale_factor is None:
                self.auto_scale_factor = target
            else:
                ema = cfg.rl_auto_scale_ema
                self.auto_scale_factor = (ema * self.auto_scale_factor
                                          + (1.0 - ema) * target)
            w = min(w, self.auto_scale_factor)
        # safety guard: halve on TF exact drop
        if epoch % cfg.rl_safety_check_interval == 0:
            if (self._last_safety_exact is not None
                    and tf_exact < self._last_safety_exact - cfg.rl_safety_exact_drop):
                self.weight *= 0.5
                w = min(w, self.weight)
            self._last_safety_exact = tf_exact
        return w

    def temperature(self, epoch: int) -> float:
        since = (epoch - self.activation_epoch
                 if self.activation_epoch is not None else -1)
        return rl_temperature(since, self.cfg)

    def state_dict(self) -> Dict:
        return {'active': self.active, 'weight': self.weight,
                'activation_epoch': self.activation_epoch,
                'auto_scale_factor': self.auto_scale_factor,
                'plateau_history': list(self._plateau.history),
                'last_safety_exact': self._last_safety_exact}

    def load_state_dict(self, s: Dict) -> None:
        self.active = s['active']
        self.weight = s['weight']
        self.activation_epoch = s['activation_epoch']
        self.auto_scale_factor = s['auto_scale_factor']
        self._plateau.history = deque(s['plateau_history'],
                                      maxlen=self._plateau.window)
        self._last_safety_exact = s['last_safety_exact']


class PhysZController:
    """Physics-Z auto-reactivation + regression guard
    (reference: :860-883)."""

    def __init__(self, cfg: TrainConfig):
        self.cfg = cfg
        self.active = False
        self.weight = 0.0
        self.activation_epoch: Optional[int] = None
        self.activation_exact: Optional[float] = None
        self.paused = False
        self._plateau = PlateauDetector(
            cfg.physics_z_reactivation_window,
            cfg.physics_z_reactivation_plateau_threshold)

    def epoch_update(self, epoch: int, tf_exact: float) -> float:
        cfg = self.cfg
        if not cfg.use_physics_z:
            return 0.0
        plateaued = self._plateau.update(tf_exact)

        if not self.active and cfg.physics_z_auto_reactivate:
            ready = (tf_exact >= cfg.physics_z_reactivation_min_exact and plateaued)
            forced = tf_exact >= cfg.physics_z_reactivation_force_exact
            if ready or forced:
                self.active = True
                self.paused = False
                self.activation_epoch = epoch
                self.activation_exact = tf_exact
                self.weight = cfg.physics_z_weight

        if not self.active or self.paused:
            return 0.0

        w = self.weight
        # warmup ramp
        since = epoch - (self.activation_epoch or epoch)
        if since < cfg.physics_z_warmup_epochs:
            w = w * (since + 1) / cfg.physics_z_warmup_epochs
        # regression guard
        if (epoch % cfg.physics_z_regression_check_interval == 0
                and self.activation_exact is not None
                and tf_exact < self.activation_exact - cfg.physics_z_regression_threshold):
            self.weight *= 0.5
            if self.weight < cfg.physics_z_weight_floor:
                self.paused = True
                return 0.0
            w = min(w, self.weight)
        elif (self.activation_exact is not None
              and tf_exact >= self.activation_exact):
            self.weight = cfg.physics_z_weight  # full recovery
        return w

    def state_dict(self) -> Dict:
        return {'active': self.active, 'weight': self.weight,
                'activation_epoch': self.activation_epoch,
                'activation_exact': self.activation_exact,
                'paused': self.paused,
                'plateau_history': list(self._plateau.history)}

    def load_state_dict(self, s: Dict) -> None:
        self.active = s['active']
        self.weight = s['weight']
        self.activation_epoch = s['activation_epoch']
        self.activation_exact = s['activation_exact']
        self.paused = s['paused']
        self._plateau.history = deque(s['plateau_history'],
                                      maxlen=self._plateau.window)


class LossSkipScheduler:
    """Smart loss skipping: converged losses computed only every N epochs,
    resumed on spikes (reference: :607-636).  Returns 0/1 multipliers for
    ``dyn``: skipping zeroes a term's gradient."""

    def __init__(self, cfg: TrainConfig):
        self.cfg = cfg
        self.schedule = {name: (thr, spike)
                         for name, thr, spike in cfg.loss_skip_schedule}
        self.converged: Dict[str, float] = {}   # name -> baseline at convergence

    def multipliers(self, epoch: int,
                    last_metrics: Optional[Dict[str, float]]) -> Dict[str, float]:
        out = {}
        for name, (thr, spike) in self.schedule.items():
            key = f'm_{name.replace("_loss", "")}'
            if not self.cfg.loss_skip_enabled or last_metrics is None:
                out[key] = 1.0
                continue
            val = last_metrics.get(name)
            if val is None:
                out[key] = 1.0
                continue
            check_epoch = epoch % self.cfg.loss_skip_frequency == 0
            if name in self.converged:
                if check_epoch:
                    out[key] = 1.0
                    if val > self.converged[name] + spike:
                        del self.converged[name]  # spiked: resume
                else:
                    out[key] = 0.0
            else:
                out[key] = 1.0
                if val < thr:
                    self.converged[name] = val
        return out

    def state_dict(self) -> Dict:
        return {'converged': dict(self.converged)}

    def load_state_dict(self, s: Dict) -> None:
        self.converged = dict(s['converged'])


class DropDetector:
    """Catastrophic-drop rollback: restore best params + halve LR, capped
    (reference: epoch loop + :6790)."""

    def __init__(self, cfg: TrainConfig):
        self.cfg = cfg
        self.prev_exact: Optional[float] = None
        self.rollbacks = 0
        self.grace_until = 0
        self.lr_scale = 1.0

    def check(self, epoch: int, exact: float) -> bool:
        """True -> caller must roll back to the best checkpoint."""
        if self.cfg.disable_drop_detection or epoch < self.grace_until:
            self.prev_exact = max(self.prev_exact or 0.0, exact)
            return False
        triggered = (self.prev_exact is not None
                     and exact < self.prev_exact - self.cfg.drop_threshold
                     and self.rollbacks < self.cfg.max_rollbacks)
        if triggered:
            self.rollbacks += 1
            self.lr_scale *= 0.5
            self.grace_until = epoch + self.cfg.rollback_grace_epochs
        else:
            self.prev_exact = max(self.prev_exact or 0.0, exact)
        return triggered

    def state_dict(self) -> Dict:
        return {'prev_exact': self.prev_exact, 'rollbacks': self.rollbacks,
                'grace_until': self.grace_until, 'lr_scale': self.lr_scale}

    def load_state_dict(self, s: Dict) -> None:
        self.prev_exact = s['prev_exact']
        self.rollbacks = s['rollbacks']
        self.grace_until = s['grace_until']
        self.lr_scale = s['lr_scale']


class EntropyManager:
    """Entropy maintenance for RL (reference:
    training/entropy_maintenance.py:967 — compact reimplementation of the
    constant / adaptive / causal / cyclical strategies).

    Tracks reward plateaus and policy entropy; the causal strategy only
    boosts the entropy weight when the plateau is *attributable* to entropy
    collapse (entropy fell before the plateau or sits below the floor).
    """

    def __init__(self, cfg: TrainConfig):
        self.cfg = cfg
        self.weight = cfg.entropy_weight_min
        self.reward_hist: deque = deque(maxlen=cfg.entropy_plateau_window)
        self.entropy_hist: deque = deque(maxlen=cfg.entropy_plateau_window)
        self.variance_hist: deque = deque(maxlen=cfg.entropy_plateau_window)
        self.temperature_scale = 1.0
        self._cycle = 0

    def _uncertainty_boost(self) -> float:
        """Uncertainty-guided exploration: high reward variance means the
        policy is unsure — boost entropy (reference:
        entropy_maintenance.py:881-952 UncertaintyGuidedExploration)."""
        cfg = self.cfg
        if not cfg.entropy_uncertainty_guided or len(self.variance_hist) < 3:
            return 1.0
        avg_var = sum(self.variance_hist) / len(self.variance_hist)
        if avg_var <= cfg.entropy_variance_threshold:
            return 1.0
        ratio = avg_var / cfg.entropy_variance_threshold
        return 1.0 + min(0.5 * ratio, cfg.entropy_uncertainty_max_boost)

    def update(self, mean_reward: float, mean_entropy: float,
               reward_var: Optional[float] = None) -> float:
        cfg = self.cfg
        self.reward_hist.append(mean_reward)
        self.entropy_hist.append(mean_entropy)
        if reward_var is not None:
            self.variance_hist.append(reward_var)
        strategy = cfg.entropy_strategy

        if strategy == 'constant':
            return self.weight

        plateaued = (len(self.reward_hist) == self.reward_hist.maxlen
                     and (self.reward_hist[-1] - self.reward_hist[0])
                     < cfg.entropy_plateau_threshold * max(abs(self.reward_hist[0]), 1.0))
        entropy_low = mean_entropy < cfg.entropy_min
        entropy_fell = (len(self.entropy_hist) == self.entropy_hist.maxlen
                        and self.entropy_hist[-1] < 0.8 * self.entropy_hist[0])

        if strategy == 'cyclical':
            self._cycle += 1
            period = 2 * cfg.entropy_plateau_window
            phase = (self._cycle % period) / period
            self.temperature_scale = 1.0 + 0.5 * math.sin(2 * math.pi * phase)
            return self.weight

        boost = False
        if strategy == 'adaptive':
            boost = mean_entropy < cfg.entropy_target
        else:  # 'causal' (default) and 'composite'
            boost = plateaued and (entropy_low or entropy_fell)
            if strategy == 'composite':
                boost = boost or entropy_low

        if boost:
            self.weight = min(self.weight * 1.5, cfg.entropy_weight_max)
        elif mean_entropy > cfg.entropy_target:
            self.weight = max(self.weight * 0.9, cfg.entropy_weight_min)
        return min(self.weight * self._uncertainty_boost(),
                   cfg.entropy_weight_max)

    def state_dict(self) -> Dict:
        return {'weight': self.weight,
                'reward_hist': list(self.reward_hist),
                'entropy_hist': list(self.entropy_hist),
                'variance_hist': list(self.variance_hist),
                'temperature_scale': self.temperature_scale,
                'cycle': self._cycle}

    def load_state_dict(self, s: Dict) -> None:
        self.weight = s['weight']
        self.reward_hist = deque(s['reward_hist'],
                                 maxlen=self.cfg.entropy_plateau_window)
        self.entropy_hist = deque(s['entropy_hist'],
                                  maxlen=self.cfg.entropy_plateau_window)
        self.variance_hist = deque(s.get('variance_hist', []),
                                   maxlen=self.cfg.entropy_plateau_window)
        self.temperature_scale = s['temperature_scale']
        self._cycle = s['cycle']


class PerPositionEntropyWeighter:
    """Per-position entropy weighting: positions with high error rates get
    more exploration (reference: entropy_maintenance.py:650-733).

    Error rates come from the TF-eval per-position mismatches; the resulting
    [T] weight vector enters the RL loss as ``dyn['entropy_pos_w']`` (a
    tensor on the models' device).
    """

    def __init__(self, max_len: int, base_weight: float = 1.0,
                 error_boost: float = 2.0, decay: float = 0.99):
        self.max_len = max_len
        self.base_weight = base_weight
        self.error_boost = error_boost
        self.decay = decay
        self.error_rates = np.full(max_len, 0.5)

    def update(self, position_errors, position_mask) -> None:
        """EMA-update per-position error rates from a [B, T] batch
        (vectorized — the reference loops positions in Python)."""
        errors = np.asarray(position_errors, np.float64)
        mask = np.asarray(position_mask, np.float64)
        t = min(errors.shape[1], self.max_len)
        counts = mask[:, :t].sum(axis=0)
        rates = errors[:, :t].sum(axis=0) / np.clip(counts, 1, None)
        seen = counts > 0
        self.error_rates[:t] = np.where(
            seen, self.decay * self.error_rates[:t] + (1 - self.decay) * rates,
            self.error_rates[:t])

    def weights(self):
        w = self.base_weight + self.error_boost * self.error_rates
        return np.convolve(w, np.ones(3) / 3, mode='same')

    def state_dict(self) -> Dict:
        return {'error_rates': self.error_rates.tolist()}

    def load_state_dict(self, s: Dict) -> None:
        self.error_rates = np.asarray(s['error_rates'])


class TcBinTracker:
    """Snapshot/restore of the Tc head on high-Tc-bin R² regression
    (reference: :3365-3497 TcBinTracker).  Acts on the encoder's
    ``tc_proj``, ``tc_res_block``, ``tc_out_ln``, ``tc_out_1`` and
    ``tc_out_2`` submodules: the snapshot is a host copy of their
    ``state_dict``s, restored in place with ``load_state_dict``.  Its
    ``state_dict`` holds tensors, so a checkpoint keeps it in the payload,
    not in ``meta.json``."""

    TC_KEYS = ('tc_proj', 'tc_res_block', 'tc_out_ln', 'tc_out_1', 'tc_out_2')

    def __init__(self, cfg: TrainConfig):
        self.cfg = cfg
        self.best_r2: Optional[float] = None
        self.snapshot: Optional[Dict[str, Dict[str, torch.Tensor]]] = None

    def _tc_subtree(self, encoder: nn.Module) -> Dict[str, Dict[str, torch.Tensor]]:
        return {k: {n: t.detach().cpu().clone() for n, t in getattr(encoder, k).state_dict().items()}
                for k in self.TC_KEYS if hasattr(encoder, k)}

    def update(self, encoder: nn.Module, combined_r2: float) -> bool:
        """Snapshots the Tc head on a new best R², restores it in place on a
        regression past the threshold; returns whether it restored."""
        if not self.cfg.tc_bin_tracker_enabled:
            return False
        if self.best_r2 is None or combined_r2 > self.best_r2:
            self.best_r2 = combined_r2
            self.snapshot = self._tc_subtree(encoder)
            return False
        if (self.snapshot is not None
                and combined_r2 < self.best_r2 - self.cfg.tc_bin_regression_threshold):
            for k, sd in self.snapshot.items():
                getattr(encoder, k).load_state_dict(sd)
            return True
        return False

    def state_dict(self) -> Dict:
        return {'best_r2': self.best_r2, 'snapshot': self.snapshot}

    def load_state_dict(self, s: Dict) -> None:
        self.best_r2 = s['best_r2']
        self.snapshot = s['snapshot']
