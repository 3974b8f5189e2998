"""Training configuration (port of training/config.py, field for field).

Every field of the JAX ``TrainConfig`` with its default, so that a config
means the same on both sides.  The port's train step reads the loss,
optimizer and physics-Z fields and refuses the options whose paths are not
ported yet (training/train_step.py says which); the host loop's fields
(curriculum, RL gating, rollback, ...) wait for the host loop.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from ..ops.losses import LossConfig
from ..ops.rl import RLConfig


@dataclasses.dataclass
class TrainConfig:
    # core loop
    num_epochs: int = 5000
    learning_rate: float = 3e-5
    lr_warmup_epochs: int = 0
    lr_min_factor: float = 0.01
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    batch_size: int = 256               # global batch (split over DP axis)
    accumulation_steps: int = 1         # gradient accumulation (reference: :430)
    max_formula_len: int = 30
    checkpoint_interval: int = 50
    eval_interval: int = 4              # true-AR eval cadence
    eval_max_batches: int = 4           # eval subset = batch_size * this
    eval_random_subset: bool = True     # rotate a random eval subsample so
                                        # mastery/curriculum see the corpus
    error_report_interval: int = 16     # epochs between error-record JSONL
                                        # dumps (reference: :4431+)
    seed: int = 0
    # NaN/Inf sanitizer (jax_debug_nans) on the train step (SURVEY 5.2);
    # disables the whole-epoch scan path — debugging only
    debug_numerics: bool = False
    # data pipeline options forwarded to load_dataset:
    # order_augment=K appends up to K random element-order respellings per
    # multi-element row (reference: data/canonical_ordering.py:228-295);
    # skew_transform 'quantile' (persisted grids, fresh-formula-invertible)
    # or 'rank_gauss' (legacy round-2 normalization)
    order_augment: int = 0
    # redraw every augmented row's respelling each N epochs (fresh random
    # permutations) so ordering supervision generalizes beyond K static
    # spellings; requires order_augment > 0
    order_augment_resample: bool = False
    order_augment_resample_interval: int = 1
    # soft-token scheduled sampling (training/soft_token.py; reference:
    # training/soft_token_sampling.py): differentiable exposure-bias
    # training — second decoder pass over probability-weighted embedding
    # mixtures. Ratio ramps start->end over soft_token_epochs after warmup.
    soft_token_enabled: bool = False
    soft_token_start_ratio: float = 0.0
    soft_token_end_ratio: float = 0.3
    soft_token_warmup_epochs: int = 0
    soft_token_epochs: int = 300
    soft_token_schedule: str = 'linear'
    soft_token_temperature: float = 1.0
    skew_transform: str = 'quantile'
    # grace window after a resume before the catastrophic-drop detector may
    # fire (reference grants grace after fresh optimizers / new data,
    # train_v12_clean.py:6630-6668): fine-tuning a checkpoint on a shifted
    # corpus/normalization legitimately dips exact-match at first, and the
    # detector would otherwise halve LR against its old prev_exact
    resume_grace_epochs: int = 0
    # model compute dtype ('float32' | 'bfloat16'). bf16 keeps params fp32
    # (flax param_dtype) and runs matmuls on the MXU at 2x; losses are
    # computed in fp32 regardless (outputs cast at the loss boundary)
    compute_dtype: str = 'float32'

    # curriculum (reference: train_v12_clean.py:1317-1339)
    curriculum_phase1_end: int = 30
    tc_weight: float = 20.0
    magpie_weight: float = 2.0

    # adaptive teacher forcing (reference: :1342-1376; locked at 1.0 by
    # default per the V15.2 lesson — scheduled sampling is a false signal)
    tf_locked: bool = True
    tf_onset: float = 0.80
    tf_floor: float = 0.10

    # RL gating and scheduling (reference: :523-602)
    rl_weight: float = 0.0
    rl_min_ar_exact: float = 0.40
    rl_auto_reactivate: bool = True
    rl_reactivation_weight: float = 1.0
    rl_reactivation_min_exact: float = 0.80
    rl_reactivation_window: int = 20
    rl_reactivation_plateau_threshold: float = 0.01
    rl_reactivation_force_exact: float = 0.92
    rl_warmup_epochs: int = 20
    rl_warmup_start: float = 0.1
    rl_auto_scale: bool = True
    rl_auto_scale_target: float = 0.1
    rl_auto_scale_ema: float = 0.9      # smoothing after one-shot calibration
    rl_safety_exact_drop: float = 0.02
    rl_safety_check_interval: int = 5
    rl_epoch_interval: int = 1          # run RL rollouts every k-th epoch
                                        # once active (duty cycle; 1 = every
                                        # epoch as the reference)
    # RL epochs scan k-step BLOCKS per dispatch (middle ground between the
    # whole-epoch scan — whose RL program crashed the remote TPU worker at
    # compile time in round 2 — and per-step dispatch at ~357 samples/s
    # where host RTT dominates). 0 = per-step dispatch. On the first chunk
    # failing to compile, the loop falls back to per-step for the session.
    rl_chunk_steps: int = 8
    rl_temperature_start: float = 1.2
    rl_temperature_end: float = 0.5
    rl_temperature_decay_epochs: int = 50

    # physics-Z scheduling (reference: :842-883)
    use_physics_z: bool = True
    physics_z_auto_reactivate: bool = True
    physics_z_reactivation_min_exact: float = 0.85
    physics_z_reactivation_window: int = 20
    physics_z_reactivation_plateau_threshold: float = 0.005
    physics_z_reactivation_force_exact: float = 0.95
    physics_z_warmup_epochs: int = 20
    physics_z_regression_threshold: float = 0.02
    physics_z_regression_check_interval: int = 5
    physics_z_weight_floor: float = 0.1
    physics_z_weight: float = 1.0
    # learnable Magpie->Block-11 projection trained jointly with the encoder
    # (reference: z_supervision_loss.py:52-76 MagpieEncodingLoss nn.Linear)
    magpie_proj_learnable: bool = True

    # keep the full dataset in HBM and lax.scan the train step over the
    # whole epoch (one dispatch per epoch). Single-host only; multi-host
    # uses the per-batch sharded input path.
    device_resident_data: bool = True

    # smart loss skipping (reference: :614-636)
    loss_skip_enabled: bool = True
    loss_skip_frequency: int = 4
    loss_skip_schedule: Tuple[Tuple[str, float, float], ...] = (
        ('magpie_loss', 0.1, 0.1),
        ('tc_class_loss', 0.5, 0.2),
        ('physics_z_loss', 0.5, 0.2),
        ('hp_loss', 0.3, 0.1),
        ('sc_loss', 0.3, 0.1),
        ('stop_loss', 0.1, 0.1),
        ('site_dup_loss', 0.01, 0.05),
        ('family_loss', 0.5, 0.2),
    )

    # catastrophic drop detection (reference: :6790+ and epoch loop)
    disable_drop_detection: bool = False
    drop_threshold: float = 0.10        # exact-match drop triggering rollback
    max_rollbacks: int = 3
    rollback_grace_epochs: int = 5

    # entropy maintenance (reference: :714-721)
    entropy_strategy: str = 'causal'
    entropy_target: float = 0.5
    entropy_min: float = 0.1
    entropy_weight_min: float = 0.05
    entropy_weight_max: float = 1.0
    entropy_plateau_window: int = 10
    entropy_plateau_threshold: float = 0.01
    # per-position entropy weighting + uncertainty-guided exploration
    # (reference: entropy_maintenance.py:650-952)
    entropy_per_position: bool = True
    entropy_position_boost: float = 2.0
    entropy_uncertainty_guided: bool = True
    entropy_variance_threshold: float = 100.0  # reward units are ~[0, 100]
    entropy_uncertainty_max_boost: float = 2.0

    # Tc-bin head snapshot/restore (reference: :829-832)
    tc_bin_tracker_enabled: bool = True
    tc_bin_regression_threshold: float = 0.10

    # data / sampling
    contrastive_mode: bool = True
    balanced_sampling: bool = True
    oversample_hard_sequences: bool = True
    oversample_high_tc: bool = True

    # A5 round-trip cycle consistency (reference: :968-972; zoo default ON)
    use_round_trip: bool = True
    round_trip_subset_fraction: float = 0.1
    a5_z_weight: float = 1.0
    a5_tc_weight: float = 5.0
    a5_weight: float = 1.0

    # theory regularization (reference: :771-774 — computed, weight 0)
    use_theory_loss: bool = True
    theory_weight: float = 0.0

    # curriculum AR warmup (reference: :1059-1066)
    curriculum_ar_enabled: bool = False

    # resume: 'auto' loads the best/latest checkpoint in output_dir
    resume: Optional[str] = None

    # phase 2 (reference: :1024-1049)
    phase2_enabled: bool = False
    phase2_auto_min_exact: float = 0.80
    phase2_interval: int = 2
    phase2_max_weight: float = 0.1
    phase2_warmup: int = 50
    phase2_n_samples: int = 64
    phase2_lr_factor: float = 0.1

    # V16 Hungarian set decoder (reference: :1068-1086)
    hungarian_enabled: bool = True
    hungarian_loss_weight: float = 1.0
    hungarian_element_weight: float = 1.0
    hungarian_fraction_weight: float = 5.0
    hungarian_no_object_weight: float = 0.1
    hungarian_presence_weight: float = 1.0
    hungarian_mode: str = 'parallel'    # 'parallel' | 'set_only' (detach z)
    hungarian_d_model: int = 512
    hungarian_num_layers: int = 3
    hungarian_dim_feedforward: int = 1024
    hungarian_n_z_tokens: int = 4

    # sub-configs
    loss: LossConfig = dataclasses.field(default_factory=LossConfig)
    rl: RLConfig = dataclasses.field(default_factory=RLConfig)

    # generation defaults for eval (reference: :789-791)
    stop_boost: float = 10.0
    hard_stop_threshold: float = 0.8
    site_dup_threshold: float = 0.0
    use_type_masking_ar: bool = True
