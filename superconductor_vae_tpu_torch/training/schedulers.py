"""Host-side controllers that feed the RL branch of the train step (port
of the RL parts of training/schedulers.py).

Plain Python on per-epoch metric floats: the RL temperature schedule, the
plateau detector, ``RLController`` (auto-reactivation, warmup ramp,
auto-scale, safety guard: ``dyn['rl_w']`` and ``dyn['rl_temperature']``),
``EntropyManager`` (``dyn['entropy_weight']``) and
``PerPositionEntropyWeighter`` (``dyn['entropy_pos_w']``).  The other
controllers of that file come with the host loop.
"""

from __future__ import annotations

import math
from collections import deque
from typing import Dict, Optional

import numpy as np

from .config import TrainConfig


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
