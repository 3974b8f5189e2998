"""The training entry point: the host loop around the train step (port of
training/train_loop.py).

``train()`` loads and weights the data, builds the train state, and runs
the epochs: the per-epoch controller decisions (curriculum, RL, physics-Z,
loss skipping, entropy, the learning rate), the epoch itself (the
device-resident dataset through ``make_epoch_runner``, or per batch from
the host), the true-AR eval on its cadence feeding mastery sampling, the
curriculum and the Tc-bin tracker, the gated Phase-2 self-supervised
sub-epoch (training/self_supervised.py), the latent cache and topology on
the checkpoint cadence, drop detection with rollback to the 'best'
checkpoint, the metrics CSV, and full-state checkpoints with resume,
manifest drift and auto-migration; SIGINT and SIGTERM save an 'interrupt'
checkpoint.

Data parallelism: in a process of a ``torch.distributed`` group of more
than one rank (``torchrun``; ``parallel.init_distributed``) the loop runs
data-parallel, as JAX's does over a mesh (``make_mesh()`` whenever it sees
more than one device) and across hosts (each keeping its shard of the
global batch).  Every rank draws the same global batches from the sampler
and keeps its contiguous block (``batch_size`` must divide by the world
size); the step sums the global batch's shares of every loss over the
ranks (training/train_step.py), so every rank holds the same parameters
and the same global metrics, and the controllers take the same decisions.
The eval, the Tc-bin tracker, Phase 2, the latent cache, topology, the
metrics CSV, the checkpoints and the log run on rank 0, which broadcasts
what they decide (the AR exact match, the sampling weights, the
per-position entropy weights, and the parameters when it changed them).
A SIGINT or SIGTERM on any rank makes rank 0 save one 'interrupt'
checkpoint and every rank stop; a resume reads it on every rank, at the
same world size.

``TrainConfig.debug_numerics`` turns on the NaN/Inf sanitizer
(utils/debug.py) and, as in JAX, one dispatch a step: the epoch runner is
off.

Differences from the JAX loop:
- it runs on ``device`` ('cuda' unless the caller asks for the CPU); a
  data-parallel run uses the process group it finds, so there is no
  ``use_mesh``;
- RL epochs run the same per-step runner as teacher-forced ones (the JAX
  loop scans RL steps in chunks only to keep an XLA program small);
- every step gets the seed ``tcfg.seed + 1``, and its dropout masks and
  rollouts follow the state's step count, which a checkpoint restores; the
  checkpoint also carries the last epoch's metrics, the Tc-bin tracker and
  the epoch of the last 'best' save, and a resume re-applies the mastery
  weights to the sampler, so a resumed run repeats an uninterrupted one
  exactly (JAX's per-step key stream and those states are not saved);
- Phase 2 draws from a generator seeded from ``tcfg.seed`` and the epoch
  (``phase2_seed``), not from the step seeds; its optimizers, as JAX's,
  are in no checkpoint, so a resume starts them afresh;
- under data parallelism the dataset stays on every rank's device and the
  epoch runner runs (JAX's multi-host loop feeds batches from the host).
"""

from __future__ import annotations

import csv
import dataclasses
import json
import signal
import time
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ..analysis import TopologyAnalyzer
from ..checkpoint import (auto_migrate, check_manifest_drift, is_checkpoint,
                          latest_checkpoint, load_train_checkpoint, save_checkpoint)
from ..data import (DatasetArrays, WeightedEpochSampler, compute_sample_weights,
                    load_dataset, resample_order_augmentation, synthetic_dataset)
from ..data.sampler import shard_batch_indices
from ..generation.latent_analyzer import LatentSpaceAnalyzer
from ..models.config import ModelConfig
from ..parallel import all_reduce_sum_, broadcast_object, replicate, world
from ..tokenizer import default_tokenizer
from ..utils.debug import enable_nan_debugging
from ..utils.device import resolve_device
from .config import TrainConfig
from .evaluate import _to_device, evaluate_autoregressive
from .mastery_sampler import CurriculumScheduler, MasteryTracker
from .self_supervised import Phase2Config, SelfSupervisedEpoch, phase2_seed
from .schedulers import (DropDetector, EntropyManager, LossSkipScheduler,
                         PerPositionEntropyWeighter, PhysZController, RLController,
                         TcBinTracker, cosine_lr, curriculum_weights, teacher_forcing_ratio)
from .soft_token import SoftTokenSchedule, soft_token_ratio
from .train_step import (build_luts, compute_dtype, create_train_state, default_dyn,
                         make_epoch_runner, make_train_step, set_learning_rate)

CSV_FIELDS = ['epoch', 'total', 'formula_loss', 'tc_loss', 'exact_match',
              'token_accuracy', 'true_ar_exact', 'rl_weight',
              'physz_weight', 'lr', 'entropy', 'mean_reward',
              'epoch_time_s', 'samples_per_s']
# the keys of the dataset that order augmentation respells
_AUG_KEYS = ('tokens', 'element_indices', 'element_fractions', 'element_mask')


def check_loop_supported(tcfg: TrainConfig) -> None:
    """Raises ``ValueError`` for a compute dtype other than float32 or
    bfloat16."""
    compute_dtype(tcfg)


def _read_sums(sums: Dict[str, torch.Tensor], n_batches: int) -> Dict[str, float]:
    """The epoch's metric sums as per-step means on the host: one copy."""
    keys = list(sums)
    if not keys:
        return {}
    vals = torch.stack([sums[k].float() for k in keys]).cpu().tolist()
    return {k: v / max(n_batches, 1) for k, v in zip(keys, vals)}


def train(
    csv_path: Optional[str] = None,
    model_config: Optional[ModelConfig] = None,
    train_config: Optional[TrainConfig] = None,
    output_dir: str = 'outputs',
    limit: Optional[int] = None,
    dataset: Optional[DatasetArrays] = None,
    log_fn=None,
    device='cuda',
) -> Dict[str, object]:
    """Trains for ``train_config.num_epochs`` epochs (from the checkpoint
    ``resume`` names, if any) on ``dataset``, the CSV at ``csv_path``, or
    the synthetic dataset; writes the metrics CSV and checkpoints under
    ``output_dir``.  Returns the state, the models, the dataset, the
    history (one row an epoch, the CSV's), the LUTs, the model config,
    the tokenizer and the controllers' state as a checkpoint's meta holds
    it.  In a ``torch.distributed`` group of more than one rank the run is
    data-parallel (see the module's docstring); ``device`` is this rank's."""
    rank, n_ranks = world()
    group = torch.distributed.group.WORLD if n_ranks > 1 else None
    main = rank == 0
    if log_fn is None:
        log_fn = lambda *a, **k: print(*a, flush=True, **k)  # noqa: E731
    if not main:
        log_fn = lambda *a, **k: None  # noqa: E731
    tcfg = train_config or TrainConfig()
    check_loop_supported(tcfg)
    device = resolve_device(device)
    out_dir = Path(output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    # ---- data --------------------------------------------------------------
    tokenizer = default_tokenizer(max_len=tcfg.max_formula_len)
    if dataset is not None:
        ds = dataset
    elif csv_path:
        ds = load_dataset(csv_path, max_len=tcfg.max_formula_len,
                          tokenizer=tokenizer, limit=limit,
                          skew_transform=tcfg.skew_transform,
                          order_augment=tcfg.order_augment,
                          order_augment_seed=tcfg.seed)
    else:
        ds = synthetic_dataset(n=limit or 512, max_len=tcfg.max_formula_len)

    mcfg = model_config or ModelConfig(magpie_dim=ds.magpie_dim,
                                       max_len=tcfg.max_formula_len)
    if mcfg.magpie_dim != ds.magpie_dim:
        mcfg = dataclasses.replace(mcfg, magpie_dim=ds.magpie_dim)
    # the loss needs the dataset's Tc normalisation for Kelvin weighting
    tcfg.loss = dataclasses.replace(
        tcfg.loss, tc_mean=float(ds.norm_stats.tc_mean),
        tc_std=float(ds.norm_stats.tc_std),
        tc_log_transform=bool(ds.norm_stats.tc_log_transform))

    weights = compute_sample_weights(
        ds, balanced=tcfg.balanced_sampling,
        oversample_hard=tcfg.oversample_hard_sequences,
        oversample_high_tc=tcfg.oversample_high_tc)
    batch_size = min(tcfg.batch_size, len(ds))
    if batch_size % n_ranks:
        raise ValueError(f'train: batch size {batch_size} does not divide over '
                         f'{n_ranks} ranks')
    sampler = WeightedEpochSampler(weights, batch_size=batch_size, seed=tcfg.seed)

    # ---- models / state ----------------------------------------------------
    state = create_train_state(mcfg, tcfg, seed=tcfg.seed, device=device)
    modules = (state.encoder, state.decoder, state.pz_proj, state.set_decoder)
    luts = build_luts(tokenizer, device=device)
    step_seed = tcfg.seed + 1
    steps, runners = {}, {}

    def get_step(rl_enabled: bool):
        if rl_enabled not in steps:
            steps[rl_enabled] = make_train_step(tcfg, luts, rl_enabled=rl_enabled,
                                                group=group)
        return steps[rl_enabled]

    def get_epoch_runner(rl_enabled: bool):
        if rl_enabled not in runners:
            runners[rl_enabled] = make_epoch_runner(tcfg, luts, rl_enabled=rl_enabled,
                                                    group=group)
        return runners[rl_enabled]

    # the whole dataset on the device, each epoch's batches gathered there
    # (the sanitizer runs one dispatch a step instead)
    data_dev = (_to_device(ds.batch(np.arange(len(ds))), device)
                if tcfg.device_resident_data and not tcfg.debug_numerics else None)

    # ---- controllers -------------------------------------------------------
    rl_ctl = RLController(tcfg)
    pz_ctl = PhysZController(tcfg)
    skip_ctl = LossSkipScheduler(tcfg)
    drop_ctl = DropDetector(tcfg)
    ent_mgr = EntropyManager(tcfg)
    tc_tracker = TcBinTracker(tcfg)
    pos_weighter = (PerPositionEntropyWeighter(
        tcfg.max_formula_len - 1, error_boost=tcfg.entropy_position_boost)
        if tcfg.entropy_per_position else None)
    # mastery-aware sampling and the optional length-bucket AR curriculum
    mastery = MasteryTracker(len(ds))
    curriculum = None
    if tcfg.curriculum_ar_enabled:
        curriculum = CurriculumScheduler((ds.tokens != 0).sum(axis=1))
    topo = TopologyAnalyzer(output_dir=out_dir) if main else None

    # Phase-2 self-supervised machinery (gated; rank 0's)
    phase2 = None
    if tcfg.phase2_enabled and main:
        phase2 = SelfSupervisedEpoch(
            state.encoder, state.decoder, tokenizer, ds, luts,
            cfg=Phase2Config(n_samples=tcfg.phase2_n_samples,
                             lr_factor=tcfg.phase2_lr_factor,
                             max_weight=tcfg.phase2_max_weight,
                             warmup=tcfg.phase2_warmup),
            base_lr=tcfg.learning_rate, output_dir=str(out_dir))

    # graceful shutdown: SIGINT/SIGTERM saves a full-state 'interrupt'
    # checkpoint at the end of the epoch
    interrupt = {'flag': False}

    def _on_signal(signum, frame):
        interrupt['flag'] = True

    old_handlers = {}
    for sig in (signal.SIGINT, signal.SIGTERM):
        try:
            old_handlers[sig] = signal.signal(sig, _on_signal)
        except ValueError:
            pass  # not the main thread

    best_exact = 0.0
    last_best_saved = 0.0
    last_best_save_epoch = -10 ** 9
    last_metrics: Optional[Dict[str, float]] = None
    last_ar_exact = 0.0
    history = []
    start_epoch = 0

    def _ctl_state():
        return {
            'rl': rl_ctl.state_dict(), 'physz': pz_ctl.state_dict(),
            'skip': skip_ctl.state_dict(), 'drop': drop_ctl.state_dict(),
            'entropy': ent_mgr.state_dict(),
            'pos_weighter': pos_weighter.state_dict() if pos_weighter else None,
            'curriculum': curriculum.state_dict() if curriculum else None,
            'best_exact': best_exact, 'last_best_saved': last_best_saved,
            'last_ar_exact': last_ar_exact,
            'last_best_save_epoch': last_best_save_epoch,
            'last_metrics': last_metrics,
        }

    def _extra_arrays():
        return {'mastery': {'mastery': torch.from_numpy(mastery.mastery),
                            'seen': torch.from_numpy(mastery.seen),
                            'peak': torch.from_numpy(mastery.peak)},
                'tc_bin': tc_tracker.state_dict()}

    def _combined_weights():
        w = weights * mastery.weights()
        if curriculum is not None:
            w = w * curriculum.get_sample_weights()
        return w

    # resume: params, optimizer states, step, controllers, mastery; a JAX
    # checkpoint converted on the way in (load_train_checkpoint)
    if tcfg.resume:
        path = (latest_checkpoint(out_dir / 'checkpoints')
                if tcfg.resume == 'auto' else Path(tcfg.resume))
        if path is not None and (Path(path) / 'meta.json').exists():
            restored, meta, fmt = load_train_checkpoint(path, tcfg.accumulation_steps)
            drift = check_manifest_drift(meta.get('manifest', {}), mcfg, tcfg)
            if drift:
                whose = ' (of the JAX package\'s configs)' if fmt == 'orbax' else ''
                log_fn(f'[resume] manifest drift{whose}: {drift}')
            restored, migrations = auto_migrate(restored, meta, mcfg,
                                                tokenizer=tokenizer, seed=tcfg.seed)
            for act in migrations:
                log_fn(f'[resume][migrate] {act}')
            # load_state_dict copies into the float32 parameters, so the
            # bf16 params of a params-only snapshot become float32 masters
            state.encoder.load_state_dict(restored['enc_params'])
            state.decoder.load_state_dict(restored['dec_params'])
            # a checkpoint without a group keeps that group's fresh init
            if state.pz_proj is not None and 'pz_params' in restored:
                state.pz_proj.load_state_dict(restored['pz_params'])
            if state.set_decoder is not None and 'set_params' in restored:
                state.set_decoder.load_state_dict(restored['set_params'])
            if 'step' in restored:
                state.step = int(restored['step'])
            for name in ('enc_opt', 'dec_opt', 'set_opt', 'pz_opt'):
                if name in restored and getattr(state, name) is not None:
                    getattr(state, name).load_state_dict(restored[name])
            ctl = meta.get('controllers') or {}
            for obj, key in ((rl_ctl, 'rl'), (pz_ctl, 'physz'), (skip_ctl, 'skip'),
                             (drop_ctl, 'drop'), (ent_mgr, 'entropy')):
                if ctl.get(key):
                    obj.load_state_dict(ctl[key])
            if curriculum is not None and ctl.get('curriculum'):
                curriculum.load_state_dict(ctl['curriculum'])
            if pos_weighter is not None and ctl.get('pos_weighter'):
                pos_weighter.load_state_dict(ctl['pos_weighter'])
            best_exact = float(ctl.get('best_exact', 0.0))
            last_best_saved = float(ctl.get('last_best_saved', 0.0))
            last_ar_exact = float(ctl.get('last_ar_exact', 0.0))
            last_best_save_epoch = int(ctl.get('last_best_save_epoch', last_best_save_epoch))
            last_metrics = ctl.get('last_metrics')
            if restored.get('tc_bin') is not None:
                tc_tracker.load_state_dict(restored['tc_bin'])
            m = restored.get('mastery')
            if m is not None and len(m['mastery']) == len(ds):
                mastery.mastery = m['mastery'].numpy().copy()
                mastery.seen = m['seen'].numpy().astype(bool)
                mastery.peak = m['peak'].numpy().copy()
                if mastery.seen.any():
                    sampler.set_weights(_combined_weights())
            elif m is not None:
                log_fn(f'[resume] mastery arrays of {len(m["mastery"])} rows skipped: the '
                       f'dataset has {len(ds)} (another corpus or normalisation)')
            start_epoch = int(meta.get('epoch', -1)) + 1
            if tcfg.resume_grace_epochs > 0:
                drop_ctl.grace_until = max(drop_ctl.grace_until,
                                           start_epoch + tcfg.resume_grace_epochs)
                drop_ctl.prev_exact = None
                log_fn(f'[resume] drop-detector grace until epoch '
                       f'{drop_ctl.grace_until} (corpus/normalization shift expected)')
            opts = [k for k in ('enc_opt', 'dec_opt', 'set_opt', 'pz_opt') if k in restored]
            log_fn(f'[resume] {path} -> epoch {start_epoch} (opt={bool(opts)} '
                   f'ctl={bool(ctl)}; format {fmt}; optimizer moments: '
                   f'{", ".join(opts) if opts else "none, params only"}; step {state.step})')

    if group is not None:
        replicate(modules, group)
    csv_path_out = out_dir / 'training_metrics.csv'
    # append across resumes, so that a crash-restart loop keeps one history
    if main and not (start_epoch > 0 and csv_path_out.exists()):
        with open(csv_path_out, 'w', newline='') as f:
            csv.DictWriter(f, fieldnames=CSV_FIELDS).writeheader()

    nan_debug = enable_nan_debugging(*modules) if tcfg.debug_numerics else None
    try:
        for epoch in range(start_epoch, tcfg.num_epochs):
            t0 = time.time()
            tf_exact = last_metrics.get('exact_match', 0.0) if last_metrics else 0.0

            # per-epoch order-augmentation resampling: fresh respellings
            if (tcfg.order_augment_resample and ds.aug_group is not None
                    and epoch % max(tcfg.order_augment_resample_interval, 1) == 0):
                ds = resample_order_augmentation(ds, tokenizer,
                                                 seed=tcfg.seed * 100003 + epoch)
                if data_dev is not None:
                    data_dev.update(_to_device({k: getattr(ds, k) for k in _AUG_KEYS},
                                               device))

            # controller decisions for this epoch
            tc_w, mg_w = curriculum_weights(epoch, tcfg)
            rl_w = rl_ctl.epoch_update(
                epoch, tf_exact, last_ar_exact,
                raw_rl_loss=last_metrics.get('reinforce_loss') if last_metrics else None)
            pz_w = pz_ctl.epoch_update(epoch, tf_exact)
            skip_m = skip_ctl.multipliers(epoch, last_metrics)
            ent_w = (ent_mgr.update(last_metrics.get('mean_reward', 0.0),
                                    last_metrics.get('entropy', 1.0),
                                    reward_var=last_metrics.get('reward_var'))
                     if last_metrics else tcfg.rl.entropy_weight)
            tf_ratio = teacher_forcing_ratio(tf_exact, tcfg)  # logged; TF path fixed
            lr = cosine_lr(epoch, tcfg) * drop_ctl.lr_scale
            set_learning_rate(state.enc_opt, lr)
            set_learning_rate(state.dec_opt, lr)

            dyn = default_dyn(tcfg)
            dyn.update({
                'tc_w': tc_w, 'magpie_w': mg_w, 'rl_w': rl_w, 'physz_w': pz_w,
                'rl_temperature': max(rl_ctl.temperature(epoch) * ent_mgr.temperature_scale,
                                      0.011),
                'entropy_weight': ent_w,
            })
            if tcfg.soft_token_enabled:
                dyn['soft_ratio'] = soft_token_ratio(epoch, SoftTokenSchedule(
                    n_epochs=tcfg.soft_token_epochs,
                    start_ratio=tcfg.soft_token_start_ratio,
                    end_ratio=tcfg.soft_token_end_ratio,
                    warmup_epochs=tcfg.soft_token_warmup_epochs,
                    schedule=tcfg.soft_token_schedule))
            if pos_weighter is not None:
                dyn['entropy_pos_w'] = torch.as_tensor(pos_weighter.weights(),
                                                       dtype=torch.float32, device=device)
            dyn.update(skip_m)

            # the epoch; its metric sums stay on the device and are read once
            rl_on = rl_w > 0
            if data_dev is not None:
                idx_mat = np.stack(list(sampler.epoch(epoch)))
                state, sums = get_epoch_runner(rl_on)(state, data_dev, idx_mat,
                                                      step_seed, dyn)
                n_batches, n_samples = idx_mat.shape[0], int(idx_mat.size)
            else:
                step_fn = get_step(rl_on)
                sums: Dict[str, torch.Tensor] = {}
                n_batches = n_samples = 0
                for batch_idx in sampler.epoch(epoch):
                    n_samples += len(batch_idx)
                    if group is not None:
                        # every rank draws the same global batch; keep our shard
                        batch_idx = shard_batch_indices(batch_idx, rank, n_ranks)
                    batch = _to_device(ds.batch(batch_idx), device)
                    state, metrics = step_fn(state, batch, step_seed, dyn)
                    n_batches += 1
                    for k, v in metrics.items():
                        sums[k] = sums[k] + v if k in sums else v
            last_metrics = _read_sums(sums, n_batches)
            epoch_time = time.time() - t0

            # cadence: true-AR eval on a rotating random subsample, with the
            # error records on their own cadence (rank 0's)
            eval_epoch = (epoch + 1) % tcfg.eval_interval == 0 or epoch == tcfg.num_epochs - 1
            params_changed = False
            if eval_epoch and main:
                n_eval = min(len(ds), batch_size * tcfg.eval_max_batches)
                if tcfg.eval_random_subset and n_eval < len(ds):
                    eval_idx = np.random.default_rng(tcfg.seed * 100003 + epoch).choice(
                        len(ds), size=n_eval, replace=False)
                else:
                    eval_idx = np.arange(n_eval)
                collect = ((epoch + 1) % tcfg.error_report_interval == 0
                           or epoch == tcfg.num_epochs - 1)
                state.encoder.eval()
                state.decoder.eval()
                eval_out = evaluate_autoregressive(
                    state.encoder, state.decoder, ds, tcfg, luts, tokenizer=tokenizer,
                    batch_size=batch_size, max_batches=tcfg.eval_max_batches,
                    sample_indices=eval_idx, collect_errors=collect)
                last_ar_exact = eval_out['ar_exact']
                if collect and eval_out['error_records']:
                    err_dir = out_dir / 'error_reports'
                    err_dir.mkdir(exist_ok=True)
                    with open(err_dir / f'epoch_{epoch:05d}.jsonl', 'w') as f:
                        for rec in eval_out['error_records']:
                            f.write(json.dumps({'epoch': epoch, **rec}) + '\n')
                # the Tc-bin tracker acts on the high-Tc bins
                bins = eval_out['tc_r2_per_bin']
                high = [v for k, v in bins.items() if k in ('120-200K', '200-1000K')]
                if high and tc_tracker.update(state.encoder, float(np.mean(high))):
                    params_changed = True
                    log_fn(f'[tc-bin] epoch {epoch}: high-Tc R2 regressed; '
                           'restored the Tc head snapshot')
                # mastery and curriculum consume the per-row AR exact; both
                # fold multiplicatively into the base sampling weights
                idx = eval_out['sample_indices']
                per = eval_out['per_sample_ar_exact'].astype(np.float64)
                mastery.update(idx, per)
                if pos_weighter is not None:
                    pos_weighter.update(eval_out['position_errors'],
                                        eval_out['position_mask'])
                if curriculum is not None:
                    curriculum.report_ar_exact(per, idx)
                sampler.set_weights(_combined_weights())

                # the Phase-2 sub-epoch, gated on the TF exact match
                if (phase2 is not None
                        and tf_exact >= tcfg.phase2_auto_min_exact
                        and (epoch + 1) % tcfg.phase2_interval == 0):
                    cache = LatentSpaceAnalyzer(state.encoder).build_cache(ds)
                    p2_w = tcfg.phase2_max_weight * min(
                        1.0, (epoch + 1) / max(tcfg.phase2_warmup, 1))
                    gen = torch.Generator(device=device).manual_seed(
                        phase2_seed(tcfg.seed, epoch))
                    p2 = phase2.run(cache.z, gen, phase2_weight=p2_w,
                                    current_exact=tf_exact)
                    params_changed = True
                    log_fn(f"[phase2] {p2['metrics']}")
                    # one record a sub-epoch (read by scripts/phase2_dashboard.py)
                    with open(out_dir / 'phase2_log.jsonl', 'a') as f:
                        f.write(json.dumps({'epoch': epoch, **p2['metrics']}) + '\n')

                # latent cache and topology telemetry on the checkpoint cadence
                if (epoch + 1) % tcfg.checkpoint_interval == 0:
                    cache = LatentSpaceAnalyzer(state.encoder).build_cache(ds)
                    np.savez_compressed(out_dir / 'latent_cache.npz',
                                        z=cache.z, tc_pred=cache.tc_pred,
                                        tc_kelvin=cache.tc_kelvin,
                                        is_sc=cache.is_sc, family=cache.family)
                    topo.analyze(cache.z, is_sc=cache.is_sc,
                                 tc_kelvin=cache.tc_kelvin, epoch=epoch)
            if eval_epoch and group is not None:
                # what rank 0's eval decided, for every rank
                decided = broadcast_object(
                    {'ar': last_ar_exact, 'weights': sampler.weights,
                     'pos': pos_weighter.state_dict() if pos_weighter else None,
                     'params': params_changed} if main else None, group)
                last_ar_exact = decided['ar']
                sampler.weights = decided['weights']
                if pos_weighter is not None:
                    pos_weighter.load_state_dict(decided['pos'])
                if decided['params']:
                    replicate(modules, group)

            # drop detection / rollback to the on-disk 'best' checkpoint
            exact = last_metrics.get('exact_match', 0.0)
            if drop_ctl.check(epoch, exact):
                best_dir = out_dir / 'checkpoints' / 'best'
                if is_checkpoint(best_dir):
                    # every rank reads it (rank 0 wrote it an epoch or more ago)
                    restored_best, _, _ = load_train_checkpoint(best_dir)
                    state.encoder.load_state_dict(restored_best['enc_params'])
                    state.decoder.load_state_dict(restored_best['dec_params'])
                    log_fn(f'[rollback] epoch {epoch}: exact {exact:.3f} collapsed; '
                           f'restored best checkpoint, lr_scale={drop_ctl.lr_scale}')
                else:
                    log_fn(f'[rollback] epoch {epoch}: exact {exact:.3f} collapsed but '
                           f'no best checkpoint exists yet; continuing '
                           f'(lr_scale={drop_ctl.lr_scale})')
            elif exact > best_exact:
                best_exact = exact

            row = {
                'epoch': epoch, 'total': last_metrics.get('total', 0.0),
                'formula_loss': last_metrics.get('formula_loss', 0.0),
                'tc_loss': last_metrics.get('tc_loss', 0.0),
                'exact_match': exact,
                'token_accuracy': last_metrics.get('token_accuracy', 0.0),
                'true_ar_exact': last_ar_exact, 'rl_weight': rl_w,
                'physz_weight': pz_w, 'lr': lr,
                'entropy': last_metrics.get('entropy', 0.0),
                'mean_reward': last_metrics.get('mean_reward', 0.0),
                'epoch_time_s': round(epoch_time, 3),
                'samples_per_s': round(n_samples / max(epoch_time, 1e-6), 1),
            }
            history.append(row)
            if main:
                with open(csv_path_out, 'a', newline='') as f:
                    csv.DictWriter(f, fieldnames=CSV_FIELDS).writerow(row)
            log_fn(f"epoch {epoch}: loss={row['total']:.4f} "
                   f"exact={exact:.3f} tok_acc={row['token_accuracy']:.3f} "
                   f"ar={last_ar_exact:.3f} {row['samples_per_s']}/s tf={tf_ratio}")

            ckpt_root = out_dir / 'checkpoints'
            periodic = (epoch + 1) % tcfg.checkpoint_interval == 0
            # 'best' on a clear improvement, at most every 10 epochs; decided
            # first, so that every checkpoint of this epoch carries the
            # bookkeeping the run goes on with
            save_best = exact > 0 and exact >= best_exact and (
                (exact - last_best_saved >= 0.005 and epoch - last_best_save_epoch >= 10)
                or periodic)
            if save_best:
                last_best_saved = exact
                last_best_save_epoch = epoch
            if group is not None:
                # a signal on any rank stops every rank, after one save
                flag = torch.tensor([float(interrupt['flag'])], device=device)
                interrupt['flag'] = all_reduce_sum_(flag, group).item() > 0
            if not main:
                periodic = save_best = False
            if periodic:
                save_checkpoint(ckpt_root, state, mcfg, tcfg, epoch=epoch, metrics=row,
                                controllers=_ctl_state(), extra_arrays=_extra_arrays())
            if save_best:
                save_checkpoint(ckpt_root, state, mcfg, tcfg, epoch=epoch, metrics=row,
                                tag='best', controllers=_ctl_state(),
                                extra_arrays=_extra_arrays())
            if interrupt['flag'] and main:
                save_checkpoint(ckpt_root, state, mcfg, tcfg, epoch=epoch, metrics=row,
                                tag='interrupt', controllers=_ctl_state(),
                                extra_arrays=_extra_arrays())
                log_fn(f'[interrupt] saved checkpoint at epoch {epoch}; stopping')
            if group is not None:
                torch.distributed.barrier(group)    # rank 0's files are written
            if interrupt['flag']:
                break
    finally:
        if nan_debug is not None:
            nan_debug.remove()
        for sig, h in old_handlers.items():
            signal.signal(sig, h)

    return {
        'state': state, 'encoder': state.encoder, 'decoder': state.decoder,
        'dataset': ds, 'history': history, 'luts': luts,
        'model_config': mcfg, 'tokenizer': tokenizer, 'controllers': _ctl_state(),
    }
