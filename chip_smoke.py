#!/usr/bin/env python3
"""Runs the PyTorch port (superconductor_vae_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

1. Prints the card's name and power limit (nvidia-smi).
2. Builds every CUDA kernel of the port with nvcc (ops/_build.py), prints
   each kernel's registers and spills (ptxas) and its tensor-core, ldmatrix
   and cp.async instructions (cuobjdump -sass), and checks that K2's
   bfloat16 instances run on mma.sync (HMMA) fed by ldmatrix and cp.async,
   its float32 instances on mma.sync fed by cp.async, and that none of
   K1's twenty instances spills.
3. Kernel phase: K1, the decode-step attention, against its plain PyTorch
   version in float32 and bfloat16, output and both caches: at the main
   path's shape (B=256, H=8, T=30, Dh=72) at positions 0, 14 and 29, and
   over T in {33, 38, 257} and Dh in {64, 128, 256, ragged} at positions
   on both sides of a 32-slot tile edge; in float32 at the RL rollouts'
   shapes (B=1024 and 2048) at positions 0, 7, 8, 14 and 29, which run
   each split of the warps over a row.  Times the kernel, the plain
   version and, as a yardstick the port never calls, torch's
   scaled_dot_product_attention over the same masked cache, at B=256
   (positions 14 and 29, both dtypes), B=512 and 1024 (float32) and
   bench.py's probe (B=512, T=38, position 19, bfloat16); and the kernel
   alone at every position 0..28 at B=256 and at B=1024, whose means are
   what the eval path and the SCST rollout (RL batch 512) pay a launch.
   Then K1 at H=4 (a rank's heads under 2-way tensor parallelism), float32,
   B=25 (the round trip) and B=256 (the eval batch): against its plain
   version at every position, and timed at every position 0..28 beside
   the plain version, SDPA and the bytes bound (means in the kernels line,
   ``h4_b25`` and ``h4_b256``).
4. Data phase: data/processed/jarvis_merged.csv.gz through the port's
   data/pipeline.py load_dataset with run4's normalisation
   (ckpt_skew_transform of its meta.json: rank-gauss), timed on the host,
   with numpy's and scipy's versions; its arrays are held to constants that
   the CPU tests hold bit-equal to the JAX package's load_dataset (a sha256
   of the integer arrays and the formulas; float sums and three rows).
5. End-to-end phase: the main path of true-AR evaluation at run4's widths
   (results/run4/ckpt_snapshot/meta.json: 12 layers, d_model 576,
   magpie_dim 78) with weights from a seed, float32: the first 1,024 rows
   of the loaded corpus in 4 batches of 256 through training/evaluate.py
   eval_batch (encoder, memory, greedy KV-cache generation with run4's
   eval gates and early exit, TF forward), once through K1 and once through
   the plain attention path.  The two token streams must agree except where
   the top two logits were within 1e-4; 8 rows also run on the CPU and
   must agree with the card.
6. Real-weights phase: run4's trained weights (epoch 899), read in place
   from the committed Orbax snapshot (results/run4/ckpt_snapshot/state) by
   the port's own reader (checkpoint/ocdbt.py: OCDBT, zarr v2, libzstd
   through ctypes), float32 from their bf16 values ('real' lines).  (a) The
   read's seconds and GB/s, every array's SHA-256 against the table that
   the CPU tests hold against Orbax (tests/torch_port_run4_sha256.json);
   (b) the data phase's 1,024 rows through eval_batch with the meta's
   gates, once through K1 and once through the plain attention path:
   streams equal but at near-ties (each excused row's gap printed), K1 = 12
   x decode steps; 8 rows' encoder outputs and TF logits card against CPU
   within 1e-4 of the largest value; (c) evaluate_autoregressive over all
   26,917 rows through K1 (the host scoring batch b while the card decodes
   b+1): true-AR and TF exact match within 5 rows of the CPU's (0.9841364,
   0.9846194), K1 = 12 x decode steps, formulas/s and peak memory; the rows
   whose exact match differs from the JAX package's committed eval of these
   weights, and then the lowest margins, 32 rows, also run on the CPU, and
   a row that differs there must be a near-tie (gap printed); the serial
   eval loop and the overlapped one timed in turns on 1,024 rows, each
   one's busy share from the device time of one profiled run.
6b. Speculative phase: speculative decoding (generation/speculative.py,
   k=4, pure greedy) with the e2e phase's weights on its 1,024 rows, on a
   twin of its decoder with the plain cache layout that holds the same
   weights (the chunk forward's attention is plain PyTorch).  Two drafts
   (models/draft.py): the corpus draft from all 26,917 kept rows (BOS
   first, grammar-constrained), as the eval CLI's --speculative builds
   it, and a self-consistent draft from the plain scan's streams without
   the grammar constraint, as bench.py --spec builds it.  The plain greedy
   scan (no gates, all 29 steps) runs through K1, 12 x 29 launches a batch;
   the corpus draft goes through evaluate_autoregressive, the self draft
   through speculative_generate, and neither launches a kernel.  Checks:
   both give the plain scan's tokens up to each row's EOS, except where
   the top two logits were within 1e-4; 8 rows of each on the CPU give the
   card's tokens; at most one host read an iteration.  Prints the
   acceptance rates, the iterations beside the 29 plain steps, formulas/s
   of the plain scan and of each draft in turns, and the kernel launches
   and host reads an iteration.
7. K2 phase: the flash-attention forward against its plain version at the
   JAX tests' shapes ((T, Dh) in (128, 64), (256, 72), (128, 128), T=100
   at Dh=72) and at B=64, H=8, Dh=72, T=256, in float32 and bfloat16, and
   in both over Dh in {64, 72, 80, 96, 128, 200, 256} and a ragged Dh (66
   in float32, 70 in bfloat16, padded by the wrapper) x T in {1, 17, 64,
   65, 100, 129, 256} at B*H = 1 and 6; its times at B=64, H=8, Dh=72,
   T in {128, 256} beside the plain version's, the bound's and
   scaled_dot_product_attention's (a yardstick the port never calls, whose
   float32 device kernel is named from one profiled call), with the
   achieved GB/s and TFLOP/s; then the dispatch of fused_attention,
   K2's entry point, in each dtype: K2 at T >= 128 (its launches are the
   ones reported), the plain attention at T=29, a refusal for inputs that
   require grad.
8. Train phase: the teacher-forced train step (training/train_step.py) at
   run4's widths with weights from a seed, float32, dropout 0.1, on the
   same 1,024 rows: a warm-up step, then 8 timed steps (train samples/s,
   peak memory, first and last loss), every metric finite, every group of
   parameters changed, no K1 or K2 launch; one step under the profiler;
   one step of 8 rows with dropout off on the card and on the CPU from the
   same weights, whose metrics, AdamW moments and updates must agree.
   This step runs without the set decoder and the round-trip loss.
8b. Defaults phase: the train step at TrainConfig()'s defaults (the set
   decoder with its on-device Hungarian matching; the A5 round trip, whose
   greedy rollout of a tenth of the batch, 25 rows, runs 29 steps through
   K1) at run4's widths, float32, batch 256, dropout 0.1.  (c) K1 against
   its plain version at the round trip's shapes (B=25 and 51, T=30, every
   position, both dtypes, caches equal) and timed there beside the plain
   version, SDPA and the bound; K1 launched 12 x 29 = 348 times a step,
   counted over the timed default steps; the default step and the step
   without the two options timed in turns (samples/s), each one's launches
   and busy share under the profiler, the parts of a default step (the
   rollout's share, the round trip, the set decoder's forward, the
   Hungarian loss), the set decoder's forward and backward and the DP
   alone; (d) an epoch of make_epoch_runner at the defaults makes the host
   wait for the card at no operation, and its read does; (b) one default
   step of 32 rows (a round trip of 3) on the card and on the CPU from the
   same weights, dropout off in every model: metrics 1e-4, the four groups'
   AdamW moments and updates as the train phase holds them, the round
   trip's tokens equal except at near-ties, the Hungarian permutations equal
   except between assignments whose costs lie within 1e-5.
8c. Soft-token phase: the train step at TrainConfig()'s defaults with
   soft_token_enabled (training/soft_token.py: a teacher-forced pass
   without gradient, then a pass over mixed embeddings) at ratio 0.3, run4
   widths, float32, batch 256, dropout 0.1: the default step and the
   soft-token step timed in turns (samples/s), K1 launched 348 times a
   step (the round trip), every metric finite; one soft-token step of 32
   rows on the card and on the CPU as in the defaults phase's (b).
8d. Dist phase: data parallelism (superconductor_vae_tpu_torch/parallel)
   ('dist' lines).  (a) scripts/dryrun_multichip.py's harness in
   torch.cuda.device_count() NCCL ranks, one a card, then in 2 gloo ranks
   on this card, each spawned: at run4 width (dropout 0, the set decoder's
   too) the data-parallel step at TrainConfig(batch_size=256)'s defaults on
   its shard of 1 global batch, and the data-parallel SCST step
   (rl_w 1) on it, each against the one-process step that rank 0
   runs from the same state on the whole batch (metrics within 1e-5
   relative, the gradient norm 1e-4, as the CPU tests hold them; AdamW
   moments within 1e-4 of each group's largest, where the CPU tests ask
   1e-5: the card's float32 GEMMs sum a shard in another order); K1
   launched 348 times a default step on rank 0, which holds the round
   trip's 25 rows, and never on the others, and 348 times more a SCST step
   on every rank, each of which rolls out the whole global batch; every
   rank's parameters and moments rank 0's; DP and one-process samples/s
   and SCST seconds.  (b) One step of 32 rows under debug_numerics'
   checks (utils/debug.py), and a NaN put into a decoder weight raising
   with that module's name.  (c) A reference-layout decoder state dict at
   run4 widths through checkpoint/torch_convert.py: TF logits card vs CPU.
   (d) The native tokenizer and parser (native/, g++) on the corpus's
   formulas against the Python path, bit-equal, with each one's seconds.
8e. TP phase: tensor parallelism (parallel/mesh.py, parallel/tensor.py)
   ('tp' lines), through scripts/dryrun_multichip.py's run_tp in 2 gloo
   ranks on this card, a 1 x 2 grid: the decoder Megatron-sharded over the
   two ranks (each holds 4 of the 8 heads, and its caches and K1 see 4),
   at run4 width, dropout 0 (the set decoder's too),
   TrainConfig(batch_size=256)'s defaults: N_TP_STEPS steps, each against
   the one-process step that rank 0 runs from the gathered state (metrics
   within DIST_TOL, the gradient norm within METRIC_TOL, AdamW moments
   within DIST_MOMENT_REL of each group's largest); the replicated
   parameters and their gradients equal on both ranks bit for bit; K1
   launched 348 times a step on each rank (both hold the round trip's 25
   rows); then eval_batch of the corpus's first 256 rows with run4's
   gates and the e2e phase's fixed heads through the TP decoder and the
   whole one: the streams equal up to EOS but at near-ties (TIE), K1 = 12
   x 29 on each rank; TP and one-process samples/s.
9. RL phase: the RL train step (training/train_step.py, rl_enabled) at
   run4's widths with weights from a seed, float32, dropout 0.1, K1 in
   the rollouts, bench.py's RL TrainConfig (rl.max_len = max_len, rl_w 1)
   on 512 of the rows, the stop and type heads fixed as in the e2e phase:
   SCST (a [2 x 512] rollout) with a warm-up step and 4 timed steps (RL
   samples/s, peak memory), then RLOO (K=4, a [4 x 512] rollout) with 2.
   Checks: (a) every metric finite and every group of parameters changed;
   (b) K1 launched once a layer at every decode step the rollouts took, K2
   never; (c) a rollout's sampled half's log-probs equal the TF re-score
   of its tokens within 2e-4; (d) its greedy half equals a greedy rollout
   through the plain attention path except at near-ties; (e) one SCST step
   of 8 rows with dropout off on the card and on the CPU from the same
   weights, the CPU step fed the card's rollout: metrics, AdamW moments
   and updates agree.  One SCST step and one fused rollout under the
   profiler; the rollout and the TF re-score with its backward timed alone;
   each method's peak memory with the TF re-score rematerialised
   (torch.utils.checkpoint, as the step runs it) and, for one step, without.
10. K1 bf16 at the bench paths' shapes (B=512, the gen probe; B=1024, the
   SCST rollout of 512; T=30, Dh=72) and run5's recipe's at batch 128
   (B=12, its round trip; B=256, its SCST rollout; at positions 0, 14, 29)
   against its plain version, caches equal, and timed beside the plain
   version, SDPA and the bytes bound, averaged over positions 0..28.
11. Bench phase: the port's bench (superconductor_vae_tpu_torch/bench.py)
   at ModelConfig() (magpie_dim 145, run4's other widths) in bf16 compute
   with float32 parameters, batch 512, bench.py's TrainConfig (the set
   decoder and the round trip on: a 51-row rollout through K1 in every
   train and RL step), K1 in the rollouts, on its
   synthetic data: its train probe (5 steps here, 20 standalone), RL probe
   (SCST, rl_w 1; 1 warm + 1 timed chunk of 8 steps here, 1 + 3
   standalone) and gen probe (greedy with bench.py's gates and early exit,
   1 + 3 calls) with random heads, as the bench runs them; then gen again
   with the stop and type heads fixed (every rollout 29 steps; no warm-up
   call, the first pass warmed it); one SCST step under the profiler.
   Checks (a) the
   pre-boundary logits and the KV caches bf16, parameters and AdamW
   moments float32, losses finite, and K1's bf16 instance launched 12
   times a decode step of every probe rollout (the round trips' included)
   and nothing else; (c) a
   29-step greedy rollout of 512 rows through K1 against the plain decode
   path and the float32 decode of the same weights: over K1's stream, K1
   bf16's logits at most min(3 x the plain bf16 path's distance from
   float32, 2**-4) from float32's, K1 at each call within one bf16
   rounding of the float64 attention of its inputs, the streams equal
   except where the top two logits were within twice the two bf16 paths'
   largest difference;
   (d) one bf16 train step of 8 rows at ModelConfig() on the card against
   the CPU: the loss terms and the AdamW first moments within half of the
   CPU's own bf16-vs-float32 difference; the updates printed beside them.
12. Loop phase: training/train_loop.py train(), the system's training
   entry point, at run4's architecture (ModelConfig() at the corpus's
   magpie_dim 78) in float32 with K1 in the rollouts, on the first 1,024
   rows of the loaded corpus, batch 256, at TrainConfig()'s defaults (the
   set decoder and the round trip on), an eval of 2 batches every epoch and
   a checkpoint every 2: 4 epochs (epoch 1 an SCST epoch, activated by the RL controller's
   plateau rule; the others teacher-forced through make_epoch_runner),
   then a second call with resume='auto' for one more.  Checks (a) the
   epochs' rows, finite losses, one metrics-CSV row an epoch across both
   calls, each epoch's samples/s printed beside the train phase's
   step-alone rate; (b) K1 launched 12 times a decode step of every eval,
   RL and round-trip rollout; (c) load_checkpoint gives back the saved
   parameters (the set decoder's included), AdamW moments, step counts and
   controllers bit for bit, each save's
   seconds and size printed, and the resume starts at the saved epoch + 1;
   (d) one accumulated update (k=2) of 8 rows on the card against the CPU
   (metrics 1e-4 relative, moments 1e-3; 2 of the 12 layers), and its
   accumulators through a save and a load; (e) one epoch of
   make_epoch_runner under the profiler (the device's busy share) and
   under torch.cuda.set_sync_debug_mode: no operation of the epoch makes
   the host wait for the card, and the one read of its sums does; then
   a runner and a per-batch epoch timed (4 steps each).
12a. Resume phase: run5's recipe (superconductor_vae_tpu_torch/scripts/
   launch_run5.sh) seeded as the recipe says, from run4's snapshot:
   outputs/chip_smoke_resume/checkpoints/epoch_00899 a symlink to
   results/run4/ckpt_snapshot, the port's training CLI with the recipe's
   flags but --output, --epochs 902, --limit 256 and --pallas-decode (K1
   in every rollout), on jarvis_merged_v2.csv.gz ('resume' lines).  (a)
   The resume through --resume auto, read at epoch 900's start before any
   update: the resume line says epoch 900, format orbax, params only,
   run4's step; run4's mastery arrays skipped (another corpus); the four
   modules' parameters bit-equal to params_from_jax of the same snapshot,
   fresh optimizers.  (b) One float32 step at
   TrainConfig()'s defaults from those weights on the corpus's first 32
   rows, card against CPU, as the defaults phase's (b).  (c) The recipe in
   bf16 for epochs 900 (teacher-forced) and 901 (RL, run4's controller
   active since epoch 193 at rl_epoch_interval 3): finite losses, samples/s,
   exact match and true-AR an epoch; K1 bf16 launched layers x decode steps
   on each path (round trip, SCST rollout, Phase 2, eval) and nowhere else.
12b. Phase-2 phase: training/self_supervised.py at run4's widths with the
   e2e phase's weights and the K1 decoder, float32 unless a step says
   otherwise ('phase2' lines).  (a) K1 against its plain version at Phase
   2's rollout shapes, B=32 and B=128 (T=30, H=8, Dh=72), at every
   position 0-28 in both dtypes, caches compared exactly, and timed (mean
   over positions) beside the plain version, SDPA and the bound; (b) the
   z-cache of the e2e phase's 1,024 rows and the coverage fit (which
   clustering ran: k-means where sklearn is absent); (c) one sub-epoch of
   64 samples with the real validators: K1 launched exactly 696 times (12
   layers x 29 steps x 2 rollouts), K2 never, the seconds of sampling,
   rollouts, filter and update; (d) one of 256 samples with permissive
   validators: 696 launches, the four losses finite, both models changed;
   (e) that update on 16 of its rows card against CPU from the same
   weights in train mode (losses 1e-4 relative, AdamW moments and updates
   1e-3) and a greedy rollout of 8 rows card against CPU; (f) one
   sub-epoch in bf16 compute: K1's bf16 instance 696 times, finite losses;
   (g) train() with Phase 2 at every epoch, 2 epochs of 512 rows: one
   phase2_log.jsonl line an epoch, K1 = 12 x eval decode steps + 696 a
   sub-epoch; (h) the port's phase2_standalone CLI on the loop phase's
   checkpoint (2 sub-epochs of 64, --pallas-decode, --save-checkpoint),
   whose saved checkpoint loads back bit for bit.
12c. Holdout phase: generation/discovery.py and generation/holdout_search.py
   at run4's widths with the e2e phase's weights and the K1 decoder,
   float32, on the loaded corpus ('holdout' lines).  (a) K1 against its
   plain version at the discovery decode's chunk, B=2048 (T=30, H=8,
   Dh=72), at every position 0-28, caches compared exactly, and timed (mean
   over positions) beside the plain version, SDPA and the bound; (b) the
   analyzer's cache over the corpus and SuperconductorDiscoveryPipeline.run
   with 256 candidates over the corpus's first 4,096 rows; (c) a greedy decode of a 4,196-row candidate pool
   in chunks of 2048 (the third padded) through K1 against the plain
   attention path (tokens equal up to EOS but at near-ties), 8 of its rows
   against the CPU, formulas/s; (d) HoldoutSearch.search of 1 target at
   budget 1024 with every tier, the inversion descent at 128 steps (its
   default 384), without zoom-in
   rounds (random weights find nothing, so every tier runs): each tier's
   seconds, the inversion's steps/s, the host scoring's seconds; (e) card against CPU from the same
   weights: the first guided (both slot conventions) and inversion
   gradients with respect to z on 4 starts (1e-4 of the largest
   component), z after 8 Adam steps (1e-3), predict_tc_mc at dropout 0
   (mean = tc_pred, std 0); (f) the port's holdout CLI on the loop phase's
   checkpoint with --pallas-decode, one target at budget 1024 with a
   stream (no zoom-in rounds, an inversion of 48 steps), then
   --oracle-only, the stream summarised by the port's
   holdout_summarize.  In (b), (c), (d) and (f) K1 runs exactly 12 x the
   decode steps of every rollout and K2 never.
12d. Surgery phase: models/surgery.py, the migrate CLI, the diagnostics
   and the legacy models ('surgery' lines).  (a) The e2e phase's seeded
   run4 models, float32: the decoder deepened by one layer (13) and
   widened x2 (d_model 1152, ffn 4608, Dh 144), the encoder widened x2;
   eval_batch on the corpus's first 256 rows through K1 with each decoder:
   K1 launches = layers x decode steps, the streams equal the original's
   up to EOS but at near-ties (TIE); TF logits, stop and type logits and
   the widened encoder's outputs within 1e-4 of the original's; K1 float32
   at Dh 144, B=256, against its plain version at positions 0, 14, 29 and
   timed (mean over positions 0-28) beside the plain version, SDPA and the
   bound.  (b) The seeded models saved as a checkpoint, deepened by
   scripts/migrate_checkpoint.py, and the eval CLI with --pallas-decode
   --limit 128 on both (on the corpus's first 4,096 rows): the same exact
   match.  (c) On that checkpoint with --pallas-decode: order_robust_eval
   (--limit 128 --k 2), generation_quality (--limit 128), oracle_bisect
   (--n 8), holdout_inversion_control (2 scrambled, 1 non-SC, budget 64,
   16 inversion steps, no zoom-in), each with K1 = layers x decode steps and
   its formulas/s; holdout_campaign over 1 target in windows of 1 (budget
   64, no zoom-in) in a subprocess, twice: the first starts its search,
   which prints its K1 launches, the second none (its shard is cached).
   (d) BidirectionalVAE.loss, PointerGeneratorDecoder and
   GroupedFeatureEncoder forward and backward, card against CPU (1e-5).
13. Prints the kernels' JSON line, then as its last line
   {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Any failed check raises, and the script exits non-zero without the last
line.  It refuses to run without CUDA.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gzip
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CSV = ROOT / 'data' / 'processed' / 'jarvis_merged.csv.gz'
META = ROOT / 'results' / 'run4' / 'ckpt_snapshot' / 'meta.json'
SEED = 0
BATCH, N_BATCHES = 256, 4
N_CPU_ROWS = 8
TIE = 1e-4                        # top-two logit gap under which argmax may flip

# H100 SXM (NVIDIA data sheet): HBM rate, float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12          # tensor cores, dense
TF32_FLOP_PER_S = 495e12          # tensor cores, dense; 3xTF32 takes three a float32 FLOP


def check(cond, msg):
    if not cond:
        raise RuntimeError(f'chip_smoke: {msg}')


# -- timing -------------------------------------------------------------------

def device_ms(torch, fn, arg_sets, iters=60):
    """(device ms, host ms) per call of ``fn`` over ``arg_sets`` in turn.

    The stream is held by a sleep kernel while the host enqueues all the
    calls, so they run back to back and the events time the device, not
    the Python launch path.  Rotating over several argument sets larger
    than the 50 MB L2 cache makes each call find its data cold, as each
    layer's cache is on the main path."""
    for args in arg_sets:
        fn(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    # calibrate the sleep kernel, then hold the stream for a multiple of
    # the enqueue time; a host stall (shared cores) can outlast the hold,
    # so a measurement whose enqueue did not finish first is taken again
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    torch.cuda._sleep(1_000_000)
    e1.record()
    torch.cuda.synchronize()
    cycles_per_ms = 1_000_000 / max(e0.elapsed_time(e1), 1e-3)
    for factor in (4, 8, 16):
        held, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        held.record()
        torch.cuda._sleep(int(cycles_per_ms * factor * host_ms))
        start.record()
        t0 = time.perf_counter()
        for i in range(iters):
            fn(*arg_sets[i % len(arg_sets)])
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        end.record()
        torch.cuda.synchronize()
        if enqueue_ms < held.elapsed_time(start):
            break
    check(enqueue_ms < held.elapsed_time(start),
          'the host did not enqueue ahead of the device; timing invalid')
    return start.elapsed_time(end) / iters, enqueue_ms / iters


# -- build --------------------------------------------------------------------

def kernel_label(mangled):
    """'flash_attention_bf16_kernel<80>', 'decode_attention_kernel<float, 4,
    18>' and the like from a mangled (Itanium ABI) kernel name: the last of
    its length-prefixed names, and its template arguments (int literals,
    float, named types)."""
    i, names = (3 if mangled.startswith('_ZN') else 2), []
    while m := re.match(r'\d+', mangled[i:]):
        n, i = int(m.group()), i + len(m.group())
        names.append(mangled[i:i + n])
        i += n
    label = names[-1] if names else mangled
    if not mangled[i:].startswith('I'):
        return label
    i, args = i + 1, []
    while i < len(mangled) and mangled[i] != 'E':
        if m := re.match(r'L[ib](\d+)E|(f)|(\d+)', mangled[i:]):
            if m.group(3):        # a length-prefixed type name
                n = int(m.group(3))
                start = i + len(m.group(3))
                args.append(mangled[start:start + n].removeprefix('__nv_'))
                i = start + n
            else:
                args.append(m.group(1) or 'float')
                i += m.end()
        else:
            return label
    return f"{label}<{', '.join(args)}>"


SASS_OPS = ('HMMA', 'LDSM', 'LDGSTS', 'MUFU', 'LDS', 'LDS.128')


def build_report(libs, nvcc):
    """Each kernel's registers and spills (ptxas -v, kept beside the
    library) and, in its SASS, its instructions and among them HMMA
    (mma.sync), LDSM (ldmatrix), LDGSTS (cp.async), MUFU (exp2 and the
    like) and shared-memory loads (LDS, of which LDS.128 16-byte); K2's bfloat16 instances must have the first three, its float32
    instances HMMA and LDGSTS; K1's twenty instances must not spill, and all
    but the bfloat16 one with 2-byte chunks (which cp.async cannot move)
    must fetch with LDGSTS."""
    for name, path in libs.items():
        log = path.with_name(path.name + '.log')
        entry, spills = None, {}
        for line in (log.read_text().splitlines() if log.exists() else []):
            if 'Compiling entry function' in line:
                entry = kernel_label(line.split("'")[1])
            elif 'registers' in line or 'spill' in line:
                print(f'build {name}: {entry}: {line.split(":", 1)[-1].strip()}')
                if m := re.search(r'(\d+) bytes spill stores, (\d+) bytes spill loads', line):
                    spills[entry] = int(m.group(1)) + int(m.group(2))
        sass = subprocess.run([str(Path(nvcc).parent / 'cuobjdump'), '-sass', str(path)],
                              capture_output=True, text=True, check=True).stdout
        counts, fn = {}, None
        for line in sass.splitlines():
            if 'Function :' in line:
                fn = kernel_label(line.split('Function :')[1].strip())
                counts[fn] = dict.fromkeys(('instructions',) + SASS_OPS, 0)
            elif fn and re.match(r'\s*/\*[0-9a-f]{4,}\*/', line):
                counts[fn]['instructions'] += 1
                for op in SASS_OPS:
                    counts[fn][op] += f' {op}.' in line or f' {op} ' in line
        for fn, c in counts.items():
            print(f'sass {name}: {fn}: ' + ', '.join(f'{op} {n}' for op, n in c.items()))
        bf16 = {fn: c for fn, c in counts.items() if 'bf16_kernel' in fn}
        f32 = {fn: c for fn, c in counts.items() if 'f32_kernel' in fn}
        if name == 'flash_attention':
            check(len(bf16) == 4, f'expected four bfloat16 instances of K2 (DHP 64, 80, '
                  f'128, 256), found {sorted(bf16)}')
            check(len(f32) == 4, f'expected four float32 instances of K2 (DHP 64, 72, '
                  f'128, 256), found {sorted(f32)}')
        for fn, c in bf16.items():
            check(c['HMMA'] and c['LDSM'] and c['LDGSTS'],
                  f'{fn} lacks mma.sync, ldmatrix or cp.async: {c}')
        for fn, c in f32.items():
            check(c['HMMA'] and c['LDGSTS'], f'{fn} lacks mma.sync or cp.async: {c}')
        if name == 'decode_attention':
            k1 = {fn: c for fn, c in counts.items() if fn.startswith('decode_attention_kernel')}
            check(len(k1) == 20, f'expected twenty instances of K1 (four 16-byte widths and '
                  f'one of element chunks, in each dtype, each with the warps split over rows '
                  f'or not), found {sorted(k1)}')
            check(sorted(spills) == sorted(k1) and not any(spills.values()),
                  f'a K1 instance spills, or ptxas reported no spills for it: {spills}')
            for fn, c in k1.items():
                check(c['LDGSTS'] or fn.startswith('decode_attention_kernel<bfloat16, 1, 256,'),
                      f'{fn} fetches without cp.async: {c}')


# -- kernel phase -------------------------------------------------------------

# K1 against its plain version: the main path's shape (B=256, H=8, T=30,
# Dh=72) at positions 0, 14 and 29; then (B=4, H=8) over T past one 32-slot
# tile (33, 38, 257) at Dh=72 and over Dh (64, 128, 256 and a Dh that is
# not a whole number of 16-byte vectors) at T=38, at the first slot, the
# middle, the last, and on both sides of a tile edge
K1_MAIN = (BATCH, 8, 30, 72)
K1_MAIN_POSITIONS = (0, 14, 29)
K1_GRID = [(33, 72, (0, 16, 31, 32)), (38, 72, (0, 19, 31, 32, 37)),
           (257, 72, (0, 31, 32, 63, 64, 128, 200, 256))] + [
          (38, dh, (0, 19, 31, 32, 37)) for dh in (64, 128, 256, 'ragged')]
K1_RAGGED_DH = {'float32': 66, 'bfloat16': 70}
# the RL path's shapes, float32: the fused [2 x 512] SCST rollout and the
# [4 x 512] RLOO rollout, at positions that run each split of the warps
# (one warp a row below 8, two below 16, all four, kFull, from 16)
K1_RL = [(2 * 512, 8, 30, 72), (4 * 512, 8, 30, 72)]
K1_RL_POSITIONS = (0, 7, 8, 14, 29)
# float32: other summation order only; bfloat16: one rounding of a float32
# result to bf16 (one ulp, 2**-7 relative) plus 1e-3 absolute
K1_TOL = {'float32': dict(rtol=1e-5, atol=1e-5), 'bfloat16': dict(rtol=2 ** -7, atol=1e-3)}
# timed: (dtype, B, T, position); the first is the kernels line's row
K1_TIMED = [('float32', BATCH, 30, 29), ('float32', BATCH, 30, 14),
            ('bfloat16', BATCH, 30, 29), ('bfloat16', BATCH, 30, 14),
            ('float32', 512, 30, 29), ('float32', 1024, 30, 29),
            ('bfloat16', 512, 38, 19)]                # bench.py --pallas-decode's probe
L2_COLD_BYTES = 150e6             # each timed rotation spans three L2 caches
K1_PER_POSITION_B = (BATCH, 1024)   # the eval batch; the SCST rollout of 512 rows
# tensor parallelism on 2 model ranks: a rank's 4 of the 8 heads, at the
# round trip's 25 rows and the eval batch's 256
K1_TP_HEADS = 4
K1_TP_B = (25, BATCH)


def k1_bytes_ops(b, h, dh, position, itemsize):
    """K1's least traffic and work: q, k_new, v_new read, the output and
    the two cache rows written, K and V slots 0..position-1 read once; a
    q.k and a p.v product over position+1 slots."""
    rows = b * h * dh * itemsize
    nbytes = 6 * rows + 2 * position * rows
    ops = 4 * b * h * (position + 1) * dh
    return nbytes, ops


def k1_inputs(torch, gen, b, h, t, dh, dtype):
    """q, k_new, v_new [B, H, Dh] and the caches [B, H, T, Dh], random."""
    dev = gen.device
    rows = [torch.randn(b, h, dh, generator=gen, device=dev).to(dtype) for _ in range(3)]
    caches = [torch.randn(b, h, t, dh, generator=gen, device=dev).to(dtype) for _ in range(2)]
    return rows + caches


def k1_held(torch, gen, b, h, t, dh, dtype, position):
    """K1 against its plain version: max abs error; fails on a disagreement
    beyond K1_TOL or on caches that differ at all."""
    from superconductor_vae_tpu_torch.ops.decode_attention import (
        decode_step_attention, decode_step_attention_ref)
    q, kn, vn, kc, vc = k1_inputs(torch, gen, b, h, t, dh, dtype)
    kc_ref, vc_ref = kc.clone(), vc.clone()
    out = decode_step_attention(q, kn, vn, kc, vc, position)
    ref = decode_step_attention_ref(q, kn, vn, kc_ref, vc_ref, position)
    torch.cuda.synchronize()
    name = str(dtype).split('.')[1]
    err = (out.float() - ref.float()).abs().max().item()
    where = f'{name}, B={b} H={h} T={t} Dh={dh} pos={position}'
    check(out.shape == q.shape and torch.allclose(out.float(), ref.float(), **K1_TOL[name]),
          f'K1 output disagrees with the plain version ({where}): max_abs_err {err:.3e}')
    check(torch.equal(kc, kc_ref) and torch.equal(vc, vc_ref),
          f'K1 cache rows disagree ({where})')
    return err


def k1_sets(torch, gen, b, h, t, dh, dtype):
    """Enough input sets that a rotation over them finds each cold."""
    per_set = 2 * b * h * t * dh * torch.empty((), dtype=dtype).element_size()
    return [k1_inputs(torch, gen, b, h, t, dh, dtype)
            for _ in range(max(2, -(-int(L2_COLD_BYTES) // per_set)))]


def k1_position_means(torch, gen, b, h, t, dh, dtype, phase):
    """K1's device time at every position 0..t-2 (a rollout's decode
    steps) beside its plain version's, SDPA's over the same masked cache
    and the bound's; prints and returns the means (kernels-line keys)."""
    import torch.nn.functional as F
    from superconductor_vae_tpu_torch.ops.decode_attention import (
        decode_step_attention, decode_step_attention_ref)
    sets = k1_sets(torch, gen, b, h, t, dh, dtype)
    itemsize = sets[0][0].element_size()
    kern, plain, lib, bound, by = [], [], [], [], set()
    for p in range(t - 1):
        keep = (torch.arange(t, device=gen.device) <= p)[None, :]
        kern.append(device_ms(torch, lambda *a: decode_step_attention(*a, p), sets)[0])
        plain.append(device_ms(torch, lambda *a: decode_step_attention_ref(*a, p), sets)[0])
        lib.append(device_ms(torch, lambda q, kn, vn, kc, vc: F.scaled_dot_product_attention(
            q[:, :, None], kc, vc, attn_mask=keep), sets)[0])
        nbytes, ops = k1_bytes_ops(b, h, dh, p, itemsize)
        bound.append(max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOP_PER_S) * 1e3)
        by.add('bytes' if nbytes / HBM_BYTES_PER_S >= ops / F32_FLOP_PER_S else 'operations')
    mean = {k: sum(v) / len(v) for k, v in
            (('ms', kern), ('plain_ms', plain), ('library_ms', lib), ('bound_ms', bound))}
    name = str(dtype).split('.')[1]
    check(len(by) == 1, f'{phase}: K1 {name} B={b} bound by {by} over the positions')
    bound_by = by.pop()
    print(f'{phase}: K1 time {name} B={b} T={t} pos 0..{t - 2} mean: kernel '
          f'{mean["ms"] * 1e3:.2f} us, plain {mean["plain_ms"] * 1e3:.2f} us, sdpa '
          f'{mean["library_ms"] * 1e3:.2f} us, {bound_by} bound {mean["bound_ms"] * 1e3:.2f} us '
          f'(kernel / bound {mean["ms"] / mean["bound_ms"]:.2f}); kernel by position '
          + ' '.join(f'{x * 1e3:.1f}' for x in kern))
    return dict(mean, bound_by=bound_by)


def kernel_phase(torch, dev):
    import torch.nn.functional as F
    from superconductor_vae_tpu_torch.ops.decode_attention import (
        decode_step_attention, decode_step_attention_ref)

    gen = torch.Generator(device=dev).manual_seed(SEED)
    dtypes = {'float32': torch.float32, 'bfloat16': torch.bfloat16}

    def held(b, h, t, dh, dtype, position):
        return k1_held(torch, gen, b, h, t, dh, dtype, position)

    max_err = dict.fromkeys(dtypes, 0.0)
    for name, dtype in dtypes.items():
        for position in K1_MAIN_POSITIONS:
            err = held(*K1_MAIN, dtype, position)
            print(f'K1 check {name:8s} B={K1_MAIN[0]} T={K1_MAIN[2]} Dh={K1_MAIN[3]} '
                  f'pos={position:2d}: max_abs_err={err:.3e} (tol {K1_TOL[name]}) caches_equal=True')
            max_err[name] = max(max_err[name], err)
        for t, dh, positions in K1_GRID:
            dh = K1_RAGGED_DH[name] if dh == 'ragged' else dh
            worst = max(held(4, 8, t, dh, dtype, p) for p in positions)
            print(f'K1 check {name:8s} B=4 T={t:3d} Dh={dh:3d} pos in {positions}: '
                  f'max_abs_err={worst:.3e} (tol {K1_TOL[name]}) caches_equal=True')
            max_err[name] = max(max_err[name], worst)
    for shape in K1_RL:
        worst = max(held(*shape, torch.float32, p) for p in K1_RL_POSITIONS)
        print(f'K1 check float32  B={shape[0]} T={shape[2]} Dh={shape[3]} (RL rollout) pos in '
              f'{K1_RL_POSITIONS}: max_abs_err={worst:.3e} (tol {K1_TOL["float32"]}) '
              'caches_equal=True')
        max_err['float32'] = max(max_err['float32'], worst)

    def sets_for(b, h, t, dh, dtype):
        return k1_sets(torch, gen, b, h, t, dh, dtype)

    h, dh = K1_MAIN[1], K1_MAIN[3]
    rows = {}
    for name, b, t, position in K1_TIMED:
        dtype = dtypes[name]
        sets = sets_for(b, h, t, dh, dtype)
        kern, kern_host = device_ms(torch, lambda *a: decode_step_attention(*a, position), sets)
        plain, plain_host = device_ms(torch, lambda *a: decode_step_attention_ref(*a, position),
                                      sets)
        keep = (torch.arange(t, device=dev) <= position)[None, :]   # [Lq=1, T]

        def sdpa(q, kn, vn, kc, vc):
            return F.scaled_dot_product_attention(q[:, :, None], kc, vc, attn_mask=keep)
        lib, lib_host = device_ms(torch, sdpa, sets)
        nbytes, ops = k1_bytes_ops(b, h, dh, position, sets[0][0].element_size())
        bound = max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOP_PER_S) * 1e3
        by = 'bytes' if nbytes / HBM_BYTES_PER_S >= ops / F32_FLOP_PER_S else 'operations'
        print(f'K1 time {name:8s} B={b:4d} T={t} pos={position:2d}: kernel {kern * 1e3:.2f} us, '
              f'plain {plain * 1e3:.2f} us, sdpa {lib * 1e3:.2f} us, bound {bound * 1e3:.2f} us '
              f'({by}: {nbytes / 1e6:.1f} MB, {ops / 1e6:.1f} MFLOP); kernel / bound '
              f'{kern / bound:.2f}, {nbytes / kern / 1e6:.1f} GB/s; {len(sets)} input sets; '
              f'host per call: kernel {kern_host * 1e3:.1f} us, plain {plain_host * 1e3:.1f} us, '
              f'sdpa {lib_host * 1e3:.1f} us')
        rows[(name, b, t, position)] = dict(ms=kern, plain_ms=plain, bound_ms=bound,
                                            bound_by=by, library_ms=lib)
        del sets

    # what a launch costs on the main path, f32 over positions 0..28: at
    # the eval path's B=256 and the SCST rollout's B=1024 (RL batch 512)
    t = K1_MAIN[2]
    for b in K1_PER_POSITION_B:
        sets = sets_for(b, h, t, dh, torch.float32)
        per_pos = [device_ms(torch, lambda *a: decode_step_attention(*a, p), sets)[0]
                   for p in range(t - 1)]
        bound_mean = sum(k1_bytes_ops(b, h, dh, p, 4)[0] for p in range(t - 1)) / (t - 1) \
            / HBM_BYTES_PER_S * 1e3
        mean = sum(per_pos) / len(per_pos)
        print(f'K1 time float32  B={b} T={t} pos 0..{t - 2}: mean {mean * 1e3:.2f} us (bound '
              f'mean {bound_mean * 1e3:.2f} us, kernel / bound {mean / bound_mean:.2f}); by '
              'position ' + ' '.join(f'{x * 1e3:.1f}' for x in per_pos))
        del sets

    # tensor parallelism's head-sharded caches: H=4, float32
    h4 = {}
    for b in K1_TP_B:
        err = max(held(b, K1_TP_HEADS, t, dh, torch.float32, p) for p in range(t))
        print(f'K1 check float32  B={b} H={K1_TP_HEADS} T={t} Dh={dh} (tensor parallelism, '
              f'pos 0..{t - 1}): max_abs_err={err:.3e} (tol {K1_TOL["float32"]}) '
              'caches_equal=True')
        max_err['float32'] = max(max_err['float32'], err)
        h4[f'h4_b{b}'] = k1_position_means(torch, gen, b, K1_TP_HEADS, t, dh, torch.float32,
                                           f'K1 H={K1_TP_HEADS}')
    torch.cuda.empty_cache()
    return dict(rows[('float32', *K1_TIMED[0][1:])], **h4), max_err['float32']


# -- K2 phase -----------------------------------------------------------------

K2_CHECKS = [(2, 128, 2, 64), (2, 256, 2, 72), (2, 128, 2, 128), (2, 100, 2, 72),
             (64, 256, 8, 72)]                   # (B, T, H, Dh): JAX tests' shapes + timed
K2_TIMED = [(64, 128, 8, 72), (64, 256, 8, 72)]
# both dtypes: every padded width of the kernel (float32 64, 72, 128, 256;
# bfloat16 64, 80, 128, 256) and widths between them, plus a Dh that is not
# a whole number of 16-byte vectors (the wrapper pads it); T below, at and
# past the 64-row tiles; one and several (b, h) slices
K2_SWEEP_DH = (64, 72, 80, 96, 128, 200, 256)
K2_RAGGED_DH = {'float32': 66, 'bfloat16': 70}
K2_SWEEP_T = (1, 17, 64, 65, 100, 129, 256)
K2_SWEEP_BH = ((1, 1), (2, 3))
# float32: other summation order only (the JAX tests' tolerance); bfloat16:
# output rounded once to bf16 and the probabilities rounded to bf16 against
# the running max (kernel) or the final max (plain): two bf16 ulp (2**-6
# relative) plus 2e-3 absolute
K2_TOL = {'float32': dict(rtol=2e-5, atol=2e-5), 'bfloat16': dict(rtol=2 ** -6, atol=2e-3)}


def k2_bytes_ops(b, t, h, dh, itemsize):
    """K2's least traffic and work: q, k, v read once, out written once;
    a q.k and a p.v product for each of the T(T+1)/2 causal pairs."""
    return 4 * b * t * h * dh * itemsize, 4 * dh * b * h * t * (t + 1) // 2


def k2_bound(nbytes, ops, dtype_name):
    """(bound in ms, 'bytes' or 'operations') on the tensor cores: bfloat16
    at its rate; float32 as 3xTF32, three TF32 FLOPs a float32 FLOP."""
    op_s = 3 * ops / TF32_FLOP_PER_S if dtype_name == 'float32' else ops / BF16_FLOP_PER_S
    by_s = nbytes / HBM_BYTES_PER_S
    return max(by_s, op_s) * 1e3, 'bytes' if by_s >= op_s else 'operations'


def device_kernel_names(torch, fn, args):
    """The device kernels of one call of ``fn`` under torch.profiler.  A
    session can come back without device activity (seen on the card in the
    K2 phase, not in a fresh process), so up to three are tried."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn(*args)
            torch.cuda.synchronize()
        names = sorted({e.key for e in prof.key_averages()
                        if e.device_type == torch.autograd.DeviceType.CUDA})
        if names:
            return names
    return ['not recorded by the profiler']


def k2_phase(torch, dev):
    """K2, the flash-attention forward, against its plain version; its
    times; and the dispatch of fused_attention, K2's entry point, whose
    kernel launches are the ones reported (no model path calls K2)."""
    import torch.nn.functional as F
    from superconductor_vae_tpu_torch.ops.attention import causal_mask, mha_attention
    from superconductor_vae_tpu_torch.ops.fused_attention import (
        flash_attention, flash_attention_ref, fused_attention)

    gen = torch.Generator(device=dev).manual_seed(SEED)

    def inputs(b, t, h, dh, dtype):
        return [torch.randn(b, t, h, dh, generator=gen, device=dev).to(dtype)
                for _ in range(3)]

    max_err = {torch.float32: 0.0, torch.bfloat16: 0.0}
    with torch.no_grad():
        for dtype in (torch.float32, torch.bfloat16):
            tol = K2_TOL[str(dtype).split('.')[1]]
            for b, t, h, dh in K2_CHECKS:
                q, k, v = inputs(b, t, h, dh, dtype)
                out = flash_attention(q, k, v)
                ref = flash_attention_ref(q, k, v)
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item()
                print(f'K2 check {str(dtype):15s} B={b} T={t:3d} H={h} Dh={dh:3d}: '
                      f'max_abs_err={err:.3e} (tol {tol})')
                check(torch.allclose(out.float(), ref.float(), **tol),
                      f'K2 disagrees with the plain version ({dtype}, T={t}, Dh={dh})')
                max_err[dtype] = max(max_err[dtype], err)
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split('.')[1]
            tol = K2_TOL[name]
            for dh in K2_SWEEP_DH + (K2_RAGGED_DH[name],):
                worst = 0.0
                for t in K2_SWEEP_T:
                    for b, h in K2_SWEEP_BH:
                        q, k, v = inputs(b, t, h, dh, dtype)
                        out = flash_attention(q, k, v)
                        ref = flash_attention_ref(q, k, v)
                        torch.cuda.synchronize()
                        err = (out.float() - ref.float()).abs().max().item()
                        check(out.shape == q.shape and torch.allclose(
                                  out.float(), ref.float(), **tol),
                              f'K2 disagrees with the plain version ({name}, B={b}, T={t}, '
                              f'H={h}, Dh={dh}): max_abs_err {err:.3e}')
                        worst = max(worst, err)
                print(f'K2 check {str(dtype):15s} Dh={dh:3d}, T in {K2_SWEEP_T}, (B, H) in '
                      f'{K2_SWEEP_BH}: max_abs_err={worst:.3e} (tol {tol})')
                max_err[dtype] = max(max_err[dtype], worst)

        rows = {}
        for dtype in (torch.float32, torch.bfloat16):
            for b, t, h, dh in K2_TIMED:
                sets = [inputs(b, t, h, dh, dtype) for _ in range(4)]   # > 50 MB L2
                kern, kern_host = device_ms(torch, flash_attention, sets)
                # ~20 kernels a call: few enough calls to stay in the launch queue
                plain, _ = device_ms(torch, flash_attention_ref, sets, iters=20)

                def sdpa(q, k, v):
                    return F.scaled_dot_product_attention(
                        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                        is_causal=True)
                lib, _ = device_ms(torch, sdpa, sets, iters=20)
                if dtype == torch.float32 and t == K2_TIMED[0][1]:
                    print(f'K2 sdpa float32 runs: {device_kernel_names(torch, sdpa, sets[0])}')
                nbytes, ops = k2_bytes_ops(b, t, h, dh, sets[0][0].element_size())
                bound, by = k2_bound(nbytes, ops, str(dtype).split('.')[1])
                fma = ''
                if dtype == torch.float32:   # beside it, the bound on the CUDA cores' FMA rate
                    fma_bound = max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOP_PER_S) * 1e3
                    fma = (f'; bound on the float32 FMA rate {fma_bound * 1e3:.2f} us, '
                           f'kernel / that {kern / fma_bound:.2f}')
                print(f'K2 time {str(dtype):15s} B={b} T={t} H={h} Dh={dh}: kernel '
                      f'{kern * 1e3:.2f} us, plain {plain * 1e3:.2f} us, sdpa '
                      f'{lib * 1e3:.2f} us, bound {bound * 1e3:.2f} us ({by}: '
                      f'{nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} GFLOP, tensor cores); '
                      f'kernel / bound {kern / bound:.2f}, kernel / sdpa {kern / lib:.2f}; '
                      f'kernel {nbytes / kern / 1e6:.1f} GB/s and {ops / kern / 1e9:.2f} TFLOP/s, '
                      f'sdpa {nbytes / lib / 1e6:.1f} GB/s and {ops / lib / 1e9:.2f} '
                      f'TFLOP/s; host per call {kern_host * 1e3:.1f} us{fma}')
                rows[(dtype, t)] = dict(ms=kern, plain_ms=plain, bound_ms=bound,
                                        bound_by=by, library_ms=lib)
                del sets
        torch.cuda.empty_cache()

        # the entry point, in each dtype: fused_attention dispatches to K2
        # for causal self-attention at T >= 128 on the card, and to the
        # plain attention below that (the model's T = 29); the counts are
        # set to 0 just before and read just after
        launches = {}
        for dtype in (torch.float32, torch.bfloat16):
            flash_attention.launches = 0
            for b, t, h, dh in K2_TIMED:
                q, k, v = inputs(b, t, h, dh, dtype)
                out = fused_attention(q, k, v, causal=True)
                want = flash_attention_ref(q, k, v)
                check(out.dtype == dtype and torch.allclose(
                          out.float(), want.float(), **K2_TOL[str(dtype).split('.')[1]]),
                      f'fused_attention at T={t} disagrees with the plain version ({dtype})')
            n = flash_attention.launches
            check(n == len(K2_TIMED), f'fused_attention launched K2 {n} times for '
                  f'{len(K2_TIMED)} calls at T >= 128 ({dtype})')
            q, k, v = inputs(256, 29, 8, 72, dtype)
            out = fused_attention(q, k, v, causal=True)
            check(flash_attention.launches == n, f'fused_attention launched K2 at T=29 ({dtype})')
            check(torch.equal(out, mha_attention(q, k, v, causal_mask(29, device=dev))),
                  'fused_attention at T=29 is not mha_attention with the causal mask')
            launches[dtype] = n
    n = flash_attention.launches
    q, k, v = (x.requires_grad_() for x in inputs(2, 128, 2, 72, torch.float32))
    try:
        fused_attention(q, k, v, causal=True)
        raised = False
    except RuntimeError:
        raised = True
    check(raised, 'K2 did not refuse inputs that require grad')
    check(flash_attention.launches == n, 'K2 launched on inputs that require grad')
    print(f'K2 dispatch: {launches[torch.float32]} float32 and {launches[torch.bfloat16]} '
          f'bfloat16 launches through fused_attention at T >= 128, none at T=29, '
          f'refused under grad')
    return rows, max_err, launches


# -- end-to-end phase ---------------------------------------------------------

# The port's arrays of the whole corpus as run4's checkpoint loads it
# (rank-gauss), which tests/test_torch_port_dataset.py holds bit-equal to
# the JAX package's load_dataset on the CPU and to these constants: a sha256
# of the integer and boolean arrays and the formulas, exact; for each float
# array the float64 sum and sum of magnitudes, to 1e-6 of the sum of
# magnitudes, and three rows (CORPUS_ROWS), to 1e-6 relative plus 1e-6
# absolute: another numpy or scipy may round the column statistics an ulp
# apart, which moves every z-scored value by about 1e-7
CORPUS_ROWS_KEPT = 26917
CORPUS_SHA256 = '13f0c858fe638d155776af3582ca8f346e9d56805982910dc64575d41fff120b'
CORPUS_ROWS = (0, 13458, 26916)
CORPUS_FLOATS = {
    'tc': (-8240.930919843318, 28571.448894020927, [
        [-2.19841671],
        [1.32253766],
        [-0.890461087],
    ]),
    'element_fractions': (26917.00036749116, 26917.00036749116, [
        [0.444444448, 0.0666666701, 0.111111112, 0.377777785, 0, 0, 0, 0, 0, 0, 0, 0],
        [0.154559508, 0.231839254, 0.077279754, 0.536321461, 0, 0, 0, 0, 0, 0, 0, 0],
        [0.166666672, 0.483333319, 0.183333337, 0.166666672, 0, 0, 0, 0, 0, 0, 0, 0],
    ]),
    'comp_targets': (2798.0128301659934, 314709.92718416674, [
        [0.0208282936, 1.16424489, -0.0868321359, 1.00861943, 1.66717672, -1.16699553,
         -0.73480773, 0.906643331, -0.395188242, -0.975531757, -0.283436686, -0.054716412,
         -1.18707776, 1.32524228, 0.0424972251],
        [0.0208282936, -0.521149218, -0.0868321359, -0.540695846, 0.108663633, 0.942156374,
         0.975056767, -0.700276434, 1.12316513, 0.797903538, -0.977172196, -0.222352445,
         0.914791346, -0.803835511, 1.14073133],
        [0.0208282936, -0.267065823, -0.0868321359, -0.246617973, 0.628167987, -0.481807679,
         -0.320955366, -0.133842349, -0.583020926, -0.907515407, -0.645994663, 0.220564097,
         0.132665947, -0.320593417, -0.0616949089],
    ]),
    'magpie': (3498.317985982171, 1659685.8659185432, [
        [-1.15410542, -0.536123514, 0.168230951, -0.91697371, -0.75065124, -0.674970269,
         0.881101489, 0.949757338, 0.029026255, 0.502057016, 0.224006563, -0.310120881,
         -1.17311931, -0.719220579, 0.043170061, -1.12419868, -0.978858232, -0.70831883,
         -1.720204, -0.572180331, -0.769259274, -0.511782169, -0.156622335, -1.51177132,
         1.31667876, -1.06862462, 1.48897529, 0.762574852, -0.700607061, 1.30283475, 0.436264694,
         1.11791408, -0.166177452, 0.393497825, 0.530791819, -0.573126793, -0.827875912,
         -1.02629244, 0.37546286, -0.890710771, -0.825340986, -0.291592032, -0.995690882,
         0.0910718888, 0.173980355, 0.588581681, 0.409865499, -1.4547888, -1.01737475,
         -1.01651216, -0.384934276, -0.681735754, -0.261282086, -0.798931658, -0.157313094,
         0.133392662, 0.0448341183, 0.491640002, 0.522493541, 0.320752144, 1.1510216, 3.34457636,
         -0.687817514, 1.74195433, 1.95258796, -0.840114057, -0.0161986761, -0.419452846,
         -0.490871489, -0.5834319, -0.629241288, -0.658665061, 0.317110926, -0.982204914,
         0.383050591, 0.995008647, 1.64544058, -0.761874497],
        [0.948109984, 1.11665606, -0.760114968, 0.893214047, 0.96293056, 1.13007593,
         -0.705582082, 1.11249459, -0.817949712, 1.00125241, 1.05899239, -0.997539639,
         0.921140313, 1.11778617, -0.702276111, 0.790225267, 0.8702088, 1.10882628, 0.478405714,
         0.210667834, -0.346165806, -0.0104515972, 0.136903226, 0.560725868, -0.795792222,
         0.289053351, -0.686242521, -0.880972922, -0.242217973, -0.890181422, -0.647366226,
         -0.0358344801, -0.505391479, -0.422905415, -0.107744075, -0.77594012, 0.332395524,
         1.18027842, -0.495416462, 0.990483344, 1.01214635, -0.55397141, 0.851893425,
         0.515587449, -0.568830013, 0.588581681, 0.712379158, 0.0434924923, -0.56331259,
         0.57207787, -0.384934276, 0.480945587, 0.6261127, -0.798931658, -0.330818564,
         -0.238379017, -0.114476338, 0.179987371, 0.209157079, -0.788930953, -0.530828953,
         0.43384856, -0.543098927, 0.0287479647, 0.383185118, -0.744837999, -0.0161986761,
         -0.314909577, -0.253495187, -0.173360288, -0.136773765, -0.112925187, 0.336084247,
         -0.542248011, -0.280190885, -0.551027417, 0.0896056816, -0.55848664],
        [-0.471170932, -0.339388162, 0.168230951, -0.362238944, -0.335899144, -0.48157233,
         -0.146281213, 0.179384097, 0.0507435873, -0.277935743, -0.170714036, -0.116233535,
         0.141845778, -0.212513834, 0.445474327, -0.336784512, -0.41065532, 0.0390838981,
         -0.393389165, 0.312206119, -0.769259274, 1.00949681, 1.27839148, -0.693680346,
         -0.316319495, 1.23581529, -0.32301566, 0.629669845, 1.00218189, -0.638868451,
         -0.515711129, 0.301051527, -0.360013992, 0.607091844, 0.889179885, -0.689020038,
         -1.56188738, -1.22754157, 0.037489675, -1.54241014, -1.36995018, -0.551928401,
         -0.924830377, -0.984880388, 0.173980355, -1.26337028, -1.10270286, -0.455934584,
         -1.31653786, -1.5148778, -0.384934276, -2.61953807, -1.74027336, -0.798931658,
         0.346651137, 1.14029455, 0.364718288, 1.27077162, 1.30583453, -0.151054025,
         -0.277279764, 0.560494959, -0.125453562, 0.596279502, 0.595799804, -0.469879538,
         -0.0161986761, -0.680329025, -0.633762658, -0.537876666, -0.489440173, -0.457928836,
         0.622439742, -1.78743958, 1.5848732, -0.257572025, 0.608217299, -0.0839149058],
    ]),
}


def corpus_digest(ds):
    """sha256 of the dataset's tokens, element slots, labels and formulas."""
    import hashlib
    import numpy as np
    h = hashlib.sha256()
    for name in ('tokens', 'element_indices', 'element_mask', 'is_sc', 'label', 'family'):
        a = np.ascontiguousarray(getattr(ds, name))
        h.update(f'{name} {a.dtype} {a.shape}\n'.encode())
        h.update(a.tobytes())
    h.update('\n'.join(ds.formulas).encode())
    return h.hexdigest()


def check_corpus(ds):
    """The dataset against CORPUS_*; returns the worst float error over its
    tolerance."""
    import numpy as np
    check(len(ds) == CORPUS_ROWS_KEPT, f'{len(ds)} rows kept, expected {CORPUS_ROWS_KEPT}')
    digest = corpus_digest(ds)
    check(digest == CORPUS_SHA256, f'corpus sha256 {digest} != {CORPUS_SHA256}')
    worst = 0.0
    for name, (total, magnitude, rows) in CORPUS_FLOATS.items():
        a = getattr(ds, name).astype(np.float64)
        for got, want in ((a.sum(), total), (np.abs(a).sum(), magnitude)):
            worst = max(worst, abs(got - want) / (1e-6 * magnitude))
        for r, want in zip(CORPUS_ROWS, rows):
            err = np.abs(np.atleast_1d(a[r]) - want) / (1e-6 + 1e-6 * np.abs(want))
            worst = max(worst, float(err.max()))
        check(worst <= 1.0, f'corpus {name} differs from CORPUS_FLOATS: error / tolerance '
              f'{worst:.3f}')
    return worst


def data_phase(torch, dev):
    """The corpus through the port's load_dataset with run4's normalisation
    (ckpt_skew_transform of its meta.json), checked against CORPUS_*; and
    its first N_BATCHES batches of BATCH rows on the card, with the eval
    path's keys and the train step's."""
    import numpy as np
    import scipy
    from superconductor_vae_tpu_torch.checkpoint import ckpt_skew_transform
    from superconductor_vae_tpu_torch.data import load_dataset
    from superconductor_vae_tpu_torch.models import config_from_meta
    from superconductor_vae_tpu_torch.training.evaluate import _to_device

    meta = json.loads(META.read_text())
    cfg = config_from_meta(meta['model_config'])
    transform = ckpt_skew_transform(meta)
    t0 = time.perf_counter()
    ds = load_dataset(CSV, max_len=cfg.max_len, skew_transform=transform)
    secs = time.perf_counter() - t0
    print(f'data: numpy {np.__version__}, scipy {scipy.__version__}; load_dataset '
          f'({transform}) {secs:.2f} s on the host: {len(ds)} rows, magpie_dim {ds.magpie_dim}')
    check(ds.magpie_dim == cfg.magpie_dim,
          f'{ds.magpie_dim} feature columns, model wants {cfg.magpie_dim}')
    worst = check_corpus(ds)
    print(f'data: sha256 {CORPUS_SHA256[:16]}... equal; float sums and rows {CORPUS_ROWS}: '
          f'worst error / tolerance {worst:.3f}')
    batches = [_to_device(ds.batch(np.arange(i * BATCH, (i + 1) * BATCH)), dev)
               for i in range(N_BATCHES)]
    return ds, batches


def steps_run(generated, eos_id):
    """Decode steps an early-exit rollout took: up to the last row's EOS."""
    is_eos = generated == eos_id
    if not bool(is_eos.any(dim=1).all()):
        return generated.shape[1]
    return int(is_eos.int().argmax(dim=1).max()) + 1


def compare_streams(got, want, eos_id, what, tie=TIE):
    """Token streams up to each row's EOS must agree; a row may diverge
    only where the two largest logits were within ``tie`` in either run."""
    from superconductor_vae_tpu_torch.generation import sequence_mask
    mask = sequence_mask(want['generated']).bool()
    diff = (got['generated'] != want['generated']) & mask
    ties = 0
    for r in diff.any(dim=1).nonzero()[:, 0].tolist():
        s = int(diff[r].int().argmax())
        gap = min(float(got['margin'][r, s]), float(want['margin'][r, s]))
        print(f'{what}: row {r} diverges at step {s}, top-two gap {gap:.3e}')
        check(gap < tie, f'{what}: row {r} diverges at step {s} with top-two gap {gap:.3e}')
        ties += 1
    return ties


def trace_batch(torch, fn, what, own=None):
    """``fn`` (one batch, or one step) under torch.profiler recording the
    device alone (recording the host's operators as well slowed the host's
    launches, lowering the busy share, and its events took about 1 ms each
    to sum, a minute of the smoke): the device's busy
    share of the wall time (kernel time summed over the call), the top
    kernels and, if ``own`` is given, the kernels whose names hold it.
    Returns the device time in seconds (None where none was recorded)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # device events, without user annotations (AdamW's step is one): their
    # span would count the kernels inside them twice
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels = [e for e in device if not getattr(e, 'is_user_annotation', False)]
    for e in device:
        if e not in kernels:
            print(f'trace: annotation {e.key[:60]!r} ({e.self_device_time_total / 1e3:.2f} ms) '
                  'left out of the busy time')
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us == 0:
        print('trace: the profiler recorded no device time; busy share not measured')
        return None
    print(f'trace: {what} under the profiler: wall {wall_us / 1e3:.1f} ms, '
          f'device busy {busy_us / 1e3:.1f} ms ({100 * busy_us / wall_us:.1f}%), '
          f'{sum(e.count for e in kernels)} kernel launches')
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        print(f'trace:   {e.self_device_time_total / 1e3:8.2f} ms {e.count:6d}x  {e.key[:90]}')
    mine = [e for e in kernels if own and own in e.key]
    for e in mine + ([None] if len(mine) > 1 else []):
        us, n = ((e.self_device_time_total, e.count) if e else
                 (sum(x.self_device_time_total for x in mine), sum(x.count for x in mine)))
        print(f'trace:   {own}: {us / 1e3:.2f} ms over {n} launches, {us / max(n, 1):.2f} us '
              f'a launch ({100 * us / busy_us:.1f}% of busy): {e.key[:90] if e else "all"}')
    # cuBLAS's GEMMs: *gemm* kernels, and on Hopper its nvjet kernels
    gemm = [e for e in kernels if 'gemm' in e.key.lower() or e.key.startswith('nvjet')]
    gemm_us = sum(e.self_device_time_total for e in gemm)
    print(f'trace:   GEMM kernels {gemm_us / 1e3:.1f} ms ({100 * gemm_us / busy_us:.1f}% of '
          f'busy) over {sum(e.count for e in gemm)} launches; the rest '
          f'{(busy_us - gemm_us) / 1e3:.1f} ms over '
          f'{sum(e.count for e in kernels) - sum(e.count for e in gemm)} launches')
    return busy_us / 1e6


def fix_rollout_heads(torch, decoder):
    """Random heads end every rollout at its first step (hard stop or a
    predicted EOS type).  A constant stop probability of 0.018 and a type
    head that never predicts EOS make every rollout run all max_len - 1
    steps instead: the decode's worst case, and K1 at every position (a
    trained model stops after 15-22 steps).  Returns the decoder."""
    with torch.no_grad():
        decoder.stop_d2.weight.zero_()
        decoder.stop_d2.bias.fill_(-4.0)
        decoder.type_d3.bias[4] = -30.0
    return decoder


def seeded_models(torch, dev, cfg, dtype=None):
    """The encoder and the decoder at ``cfg`` with random weights from SEED
    (the encoder drawn first) and the decoder's heads fixed
    (``fix_rollout_heads``), in eval mode: the e2e phase's models, which
    the Phase-2 phase builds again."""
    from superconductor_vae_tpu_torch.models import FormulaDecoder, MaterialsEncoder, init_params
    kw = dict(device=dev, dtype=dtype or torch.float32)
    gen = torch.Generator().manual_seed(SEED)
    encoder = init_params(MaterialsEncoder(cfg, **kw), gen).eval()
    decoder = fix_rollout_heads(torch, init_params(FormulaDecoder(cfg, **kw), gen).eval())
    return encoder, decoder


def e2e_phase(torch, dev, ds, batches):
    """The eval path on the data phase's batches, through K1 and through the
    plain attention path, then 8 rows on the CPU, and one batch under the
    profiler.  Returns K1's launches, and the encoder and the K1 decoder."""
    import numpy as np
    from superconductor_vae_tpu_torch.models import (
        FormulaDecoder, MaterialsEncoder, config_from_meta)
    from superconductor_vae_tpu_torch.ops.decode_attention import decode_step_attention
    from superconductor_vae_tpu_torch.tokenizer import EOS_ID, default_tokenizer
    from superconductor_vae_tpu_torch.training import (
        build_luts, eval_batch, eval_generation_config, eval_train_config)
    from superconductor_vae_tpu_torch.training.evaluate import _exact_match

    meta = json.loads(META.read_text())
    cfg = config_from_meta(meta['model_config'], pallas_decode=True)
    gcfg = eval_generation_config(eval_train_config(cfg.max_len, meta['eval_gating']),
                                  cfg.max_len)
    print(f'e2e: run4 widths {dataclasses.asdict(cfg)}')
    print(f'e2e: {gcfg}')

    encoder, decoder = seeded_models(torch, dev, cfg)
    plain_cfg = dataclasses.replace(cfg, pallas_decode=False)
    decoder_plain = FormulaDecoder(plain_cfg, device=dev).eval()
    decoder_plain.load_state_dict(decoder.state_dict())
    n_params = sum(p.numel() for m in (encoder, decoder) for p in m.parameters())
    print(f'e2e: {n_params / 1e6:.1f}M parameters from seed {SEED}, float32')

    tok = default_tokenizer(max_len=cfg.max_len)
    type_masks = build_luts(tok, device=dev)['type_masks']

    def run(dec):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = [eval_batch(encoder, dec, bt, gcfg, type_masks=type_masks) for bt in batches]
        torch.cuda.synchronize()
        return outs, time.perf_counter() - t0

    run(decoder)                                    # warm-up (cuBLAS, allocator)
    run(decoder_plain)
    plain_outs, plain_wall = run(decoder_plain)
    # the main path, through K1
    decode_step_attention.launches = 0
    outs, wall = run(decoder)
    launches = decode_step_attention.launches
    # once more each, in turns (plain, K1, K1, plain), to see the spread
    walls = [wall, run(decoder)[1]]
    plain_walls = [plain_wall, run(decoder_plain)[1]]

    steps = [steps_run(o['generated'], EOS_ID) for o in outs]
    print(f'e2e: decode steps per batch {steps}; K1 launches {launches}')
    check(launches > 0, 'K1 was not launched on the main path')
    check(launches == cfg.num_layers * sum(steps),
          f'K1 launches {launches} != layers x steps {cfg.num_layers * sum(steps)}')

    ties = 0
    for i, (o, p) in enumerate(zip(outs, plain_outs)):
        check(o['generated'].shape == (BATCH, cfg.max_len - 1), 'generated shape')
        check(o['tf_pred'].shape == (BATCH, cfg.max_len - 1), 'tf_pred shape')
        check(bool(((o['generated'] >= 0) & (o['generated'] < cfg.vocab_size)).all()),
              'token ids out of range')
        for key in ('tc_pred', 'sc_pred', 'z_norm'):
            check(o[key].shape == (BATCH,) and bool(torch.isfinite(o[key]).all()),
                  f'{key} not finite or misshapen')
        ties += compare_streams(o, p, EOS_ID, f'batch {i} K1 vs plain')

    # the same weights on the CPU, plain path, for a few rows
    enc_cpu = MaterialsEncoder(cfg, device='cpu').eval()
    enc_cpu.load_state_dict(encoder.state_dict())
    dec_cpu = FormulaDecoder(plain_cfg, device='cpu').eval()
    dec_cpu.load_state_dict(decoder.state_dict())
    small = {k: v[:N_CPU_ROWS].cpu() for k, v in batches[0].items()}
    cpu_out = eval_batch(enc_cpu, dec_cpu, small, gcfg, type_masks=type_masks.cpu())
    card = {k: v[:N_CPU_ROWS].cpu() for k, v in outs[0].items()}
    ties += compare_streams(card, cpu_out, EOS_ID, 'card vs CPU')
    for key in ('tc_pred', 'sc_pred', 'z_norm'):
        err = (card[key] - cpu_out[key]).abs().max().item()
        print(f'e2e: card vs CPU {key} max_abs_err {err:.3e}')
        check(torch.allclose(card[key], cpu_out[key], rtol=1e-4, atol=1e-4),
              f'card and CPU disagree on {key}')

    trace_batch(torch, lambda: eval_batch(encoder, decoder, batches[0], gcfg,
                                          type_masks=type_masks),
                f'one eval batch of {BATCH}', own='decode_attention_kernel')

    gen_all = torch.cat([o['generated'] for o in outs]).cpu().numpy()
    tgt = np.concatenate([bt['tokens'][:, 1:].cpu().numpy() for bt in batches])
    exact = float(_exact_match(gen_all, tgt).mean())
    n = BATCH * N_BATCHES
    print(f'e2e: {n} formulas in {wall:.3f} s through K1 = {n / wall:.1f} formulas/s '
          f'(runs in turn: plain {plain_walls[0]:.3f} s, K1 {walls[0]:.3f} s, '
          f'K1 {walls[1]:.3f} s, plain {plain_walls[1]:.3f} s); '
          f'near-tie divergences {ties}; true-AR exact (random weights) {exact:.4f}')
    for r in range(3):
        print(f'e2e: {ds.formulas[r]!r} -> {tok.decode(gen_all[r])!r}')
    return launches, (encoder, decoder)


RUN4 = ROOT / 'results' / 'run4' / 'ckpt_snapshot'
RUN4_SHA256 = ROOT / 'tests' / 'torch_port_run4_sha256.json'   # held against Orbax on the CPU
# run4's exact match over all 26,917 rows on the CPU: the port's eval CLI
# and the JAX package's, row for row (tests/test_torch_port_dataset.py)
RUN4_CPU = {'ar': 0.9841364193632277, 'tf': 0.9846193855184456}
RUN4_ROW_SLACK = 5                # rows the card may differ from the CPU by, near-ties
# the JAX package's own eval of these weights (epoch 899), committed with them
RUN4_ERRORS = ROOT / 'results' / 'run4' / 'final_eval_e899_errors.jsonl'
REAL_CPU_ROWS = 32                # the full eval's rows that also run on the CPU
REAL_TURN_BATCHES = 4             # the serial loop and the overlapped one, timed in turns
REAL_REL = 1e-4                   # card vs CPU, of the largest magnitude


def serial_eval(encoder, decoder, ds, tcfg, luts, n_batches):
    """The eval loop without the overlap: each batch decoded, copied to
    the host and scored before the next is launched (the loop the port
    ran before, held bit-equal to the overlapped one on the CPU)."""
    import numpy as np
    from superconductor_vae_tpu_torch.training import evaluate as ev
    gcfg = ev.eval_generation_config(tcfg, decoder.cfg.max_len)
    dev = next(encoder.parameters()).device
    parts = []
    for b in range(n_batches):
        idx = np.arange(b * BATCH, (b + 1) * BATCH)
        out = ev.eval_batch(encoder, decoder, ev._to_device(ds.batch(idx), dev), gcfg,
                            type_masks=luts['type_masks'])
        host = {k: (v.float() if v.is_floating_point() else v).cpu() for k, v in out.items()}
        parts.append(ev._score_batch(host, None, idx, ds, None))
    return ev.summarize_scores(parts, ds, np.arange(n_batches * BATCH))


def tf_flip_gap(torch, ds, row, card, cpu):
    """The smallest top-two gap of the TF logits, card's or CPU's, at the
    positions of ``row`` where their argmax differ (inf where none does)."""
    from superconductor_vae_tpu_torch.training import stoich_conditioning
    from superconductor_vae_tpu_torch.training.evaluate import _to_device
    import numpy as np
    logits, dev = [], next(card[0].parameters()).device
    with torch.no_grad():
        for (enc, dec), d in ((card, dev), (cpu, 'cpu')):
            bt = _to_device(ds.batch(np.array([row])), d)
            e = enc(bt['element_indices'], bt['element_fractions'], bt['element_mask'],
                    bt['magpie'], bt['tc'])
            logits.append(dec(e['z'], bt['tokens'], stoich_conditioning(bt),
                              enc.heads_pred_for_decoder(e))['logits'][0].float().cpu())
    flips = logits[0].argmax(-1) != logits[1].argmax(-1)
    gaps = [(x.topk(2, dim=-1).values[:, 0] - x.topk(2, dim=-1).values[:, 1])[flips]
            for x in logits]
    return min((float(g.min()) for g in gaps if g.numel()), default=float('inf'))


def real_weights_phase(torch, dev, ds, batches):
    """run4's trained weights, read in place from the committed Orbax
    snapshot by the port's own reader, on the main path of true-AR
    evaluation: (a) the read, timed, every array's SHA-256 against the
    table the CPU tests hold against Orbax; (b) the data phase's 1,024 rows
    through eval_batch with K1 and with the plain path (streams equal but
    at near-ties, each excused row's gap printed), 8 rows' encoder outputs
    and TF logits card vs CPU; (c) evaluate_autoregressive over all rows
    through K1 with the meta's gates: true-AR and TF within RUN4_ROW_SLACK
    rows of the CPU's, K1 = layers x decode steps, the rows whose exact
    match differs from the JAX package's committed eval and the lowest
    margins run on the CPU too (a row that differs must be a near-tie),
    formulas/s, peak memory, and the serial loop against the overlapped one
    in turns, each one's busy share.  Returns K1's launches."""
    import numpy as np
    from superconductor_vae_tpu_torch.checkpoint import params_from_jax, read_snapshot
    from superconductor_vae_tpu_torch.checkpoint.ocdbt import Zstd, array_digests
    from superconductor_vae_tpu_torch.models import FormulaDecoder, config_from_meta
    from superconductor_vae_tpu_torch.ops.decode_attention import decode_step_attention
    from superconductor_vae_tpu_torch.tokenizer import EOS_ID, default_tokenizer
    from superconductor_vae_tpu_torch.training import (
        build_luts, eval_batch, eval_generation_config, eval_train_config, evaluate,
        evaluate_autoregressive, stoich_conditioning)

    t_phase = time.perf_counter()
    t_parts = {}

    def part(name):
        t_parts[name] = time.perf_counter() - t_phase - sum(t_parts.values())

    # (a) the read
    state = RUN4 / 'state'
    on_disk = sum(f.stat().st_size for f in state.rglob('*') if f.is_file())
    zstd = Zstd()
    t0 = time.perf_counter()
    tree = read_snapshot(state, zstd)
    secs = time.perf_counter() - t0
    digests = array_digests(tree)
    n_bytes = sum(int(np.prod(shape)) * (2 if dt == 'bfloat16' else np.dtype(dt).itemsize)
                  for dt, shape, _ in digests.values())
    table = json.loads(RUN4_SHA256.read_text())
    bad = [k for k in table if digests.get(k) != table[k]]
    print(f'real: {zstd.lib._name} loaded; {state.relative_to(ROOT)} read in {secs:.2f} s: '
          f'{on_disk / 1e9:.3f} GB on disk at {on_disk / secs / 1e9:.2f} GB/s, {len(digests)} '
          f'arrays of {n_bytes / 1e9:.3f} GB at {n_bytes / secs / 1e9:.2f} GB/s')
    check(len(digests) == len(table) == 570 and not bad,
          f'real: {len(bad)} of {len(table)} arrays differ from the SHA-256 table: {bad[:5]}')
    print(f'real: all {len(table)} arrays\' SHA-256 equal the table')
    part('(a) read')

    meta = json.loads((RUN4 / 'meta.json').read_text())
    cfg = config_from_meta(meta['model_config'], pallas_decode=True)
    plain_cfg = dataclasses.replace(cfg, pallas_decode=False)
    encoder, decoder = params_from_jax(tree['enc_params'], tree['dec_params'], cfg, device=dev)
    decoder_plain = FormulaDecoder(plain_cfg, device=dev).eval()
    decoder_plain.load_state_dict(decoder.state_dict())
    enc_cpu, dec_cpu = params_from_jax(tree['enc_params'], tree['dec_params'], plain_cfg,
                                       device='cpu')
    del tree
    tcfg = eval_train_config(cfg.max_len, meta['eval_gating'])
    gcfg = eval_generation_config(tcfg, cfg.max_len)
    luts = build_luts(default_tokenizer(max_len=cfg.max_len), device=dev)
    type_masks = luts['type_masks']
    part('models')
    print(f'real: run4 epoch {meta["epoch"]}, '
          f'{sum(p.numel() for m in (encoder, decoder) for p in m.parameters()) / 1e6:.1f}M '
          f'parameters (bf16 values) in float32; gates {meta["eval_gating"]}')

    # (b) the first 1,024 rows through K1 and through the plain path
    def run(dec):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = [eval_batch(encoder, dec, bt, gcfg, type_masks=type_masks) for bt in batches]
        torch.cuda.synchronize()
        return outs, time.perf_counter() - t0

    plain_outs, plain_wall = run(decoder_plain)          # (the e2e phase warmed K1's shapes)
    decode_step_attention.launches = 0
    outs, wall = run(decoder)
    launches = decode_step_attention.launches
    steps = [steps_run(o['generated'], EOS_ID) for o in outs]
    check(launches == cfg.num_layers * sum(steps) > 0,
          f'real (b): K1 launches {launches} != layers x steps {cfg.num_layers * sum(steps)}')
    ties = sum(compare_streams(o, p, EOS_ID, f'real (b) batch {i} K1 vs plain')
               for i, (o, p) in enumerate(zip(outs, plain_outs)))
    n = BATCH * len(batches)
    print(f'real (b): {n} rows, decode steps per batch {steps}; K1 launches {launches}; '
          f'K1 {n / wall:.1f} formulas/s, plain {n / plain_wall:.1f}; streams equal but '
          f'{ties} near-tie rows')
    small = {k: v[:N_CPU_ROWS] for k, v in batches[0].items()}
    with torch.no_grad():
        for where, (enc, dec, bt) in (('card', (encoder, decoder, small)),
                                      ('cpu', (enc_cpu, dec_cpu,
                                               {k: v.cpu() for k, v in small.items()}))):
            e = enc(bt['element_indices'], bt['element_fractions'], bt['element_mask'],
                    bt['magpie'], bt['tc'])
            tf = dec(e['z'], bt['tokens'], stoich_conditioning(bt),
                     enc.heads_pred_for_decoder(e))['logits']
            res = {k: e[k].float().cpu() for k in ('z', 'tc_pred', 'sc_pred',
                                                   'family_composed_14')}
            res['tf_logits'] = tf.float().cpu()
            if where == 'card':
                card = res
    for k, want in res.items():
        rel = ((card[k] - want).abs().max() / want.abs().max()).item()
        print(f'real (b): card vs CPU {k} {tuple(want.shape)}: largest error over the largest '
              f'value {rel:.3e}')
        check(rel <= REAL_REL, f'real (b): card and CPU differ on {k} by {rel:.3e}')
    part('(b)')

    # (c) every row through K1, the scoring overlapped with the next batch
    with CallLog(evaluate, 'generate_with_kv_cache') as log:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        decode_step_attention.launches = 0
        t0 = time.perf_counter()
        out = evaluate_autoregressive(encoder, decoder, ds, tcfg, luts, batch_size=BATCH)
        wall = time.perf_counter() - t0          # its results are on the host: synchronised
        launches_c = decode_step_attention.launches
    peak = torch.cuda.max_memory_allocated()
    steps = [steps_run(o['tokens'], EOS_ID) for o in log.outputs]
    n = out['n_evaluated']
    print(f'real (c): {n} rows in {len(steps)} batches of {BATCH} through K1 in {wall:.3f} s = '
          f'{n / wall:.1f} formulas/s; decode steps summed {sum(steps)} (a batch '
          f'{min(steps)}-{max(steps)}); K1 launches {launches_c}; peak {peak / 2 ** 30:.2f} GiB')
    check(n == len(ds), f'real (c): evaluated {n} of {len(ds)} rows')
    check(launches_c == cfg.num_layers * sum(steps),
          f'real (c): K1 launches {launches_c} != layers x steps {cfg.num_layers * sum(steps)}')
    for key, name in (('ar', 'true-AR'), ('tf', 'TF')):
        got = int(round(out[f'{key}_exact'] * n))
        want = int(round(RUN4_CPU[key] * n))
        print(f'real (c): {name} exact {out[f"{key}_exact"]:.7f} ({got} rows) against the CPU\'s '
              f'{RUN4_CPU[key]:.7f} ({want} rows): {got - want:+d} rows')
        check(abs(got - want) <= RUN4_ROW_SLACK,
              f'real (c): {name} {got} rows exact, the CPU {want}')
    part('(c) eval')
    idx = out['sample_indices']
    margin = out['per_sample_margin']
    inexact = set(idx[~out['per_sample_ar_exact']].tolist())
    record = {json.loads(line)['index'] for line in RUN4_ERRORS.read_text().splitlines()}
    record &= set(idx.tolist())
    other = sorted(inexact ^ record)
    print(f'real (c): {len(inexact)} rows not exact; the JAX package\'s committed eval of these '
          f'weights ({RUN4_ERRORS.name}) has {len(record)}; {len(other)} rows differ')
    for r in other:
        print(f'real (c): row {r} {"exact" if r not in inexact else "not exact"} on the card, '
              f'{"not exact" if r in record else "exact"} in the record; smallest top-two gap '
              f'{margin[r]:.3e}')
    # the rows nearest a tie, and those, on the CPU
    pick = list(other) + [int(r) for r in np.argsort(margin, kind='stable')
                          if int(r) not in other]
    pick = np.array(sorted(pick[:REAL_CPU_ROWS]), np.int64)
    cpu_luts = {k: v.cpu() for k, v in luts.items()}
    t0 = time.perf_counter()
    cpu = evaluate_autoregressive(enc_cpu, dec_cpu, ds, tcfg, cpu_luts, sample_indices=pick,
                                  batch_size=len(pick))
    cpu_s = time.perf_counter() - t0
    tf_card = ~out['position_errors'].any(axis=1)
    tf_cpu = ~cpu['position_errors'].any(axis=1)
    differ = 0
    for j, r in enumerate(pick):
        for name, a, b in (('true-AR', out['per_sample_ar_exact'][r],
                            cpu['per_sample_ar_exact'][j]), ('TF', tf_card[r], tf_cpu[j])):
            if a != b:
                gap = (min(margin[r], cpu['per_sample_margin'][j]) if name == 'true-AR' else
                       tf_flip_gap(torch, ds, r, (encoder, decoder), (enc_cpu, dec_cpu)))
                differ += 1
                print(f'real (c): row {r} {name} exact on the card {bool(a)}, on the CPU '
                      f'{bool(b)}; smallest top-two gap {gap:.3e}')
                check(gap < TIE, f'real (c): row {r} differs from the CPU ({name}) with gap '
                                 f'{gap:.3e}')
    print(f'real (c): {len(pick)} rows on the CPU in {cpu_s:.1f} s (the {len(other)} that '
          f'differ from the record, then the lowest margins, up to {margin[pick].max():.3e}): '
          f'{differ} differ from the card, each a near-tie')

    part('(c) CPU rows')
    # the serial loop and the overlapped one, in turns, on the same rows;
    # both launch the same kernels, so one profiled run gives the device
    # time of a row, and each loop's busy share is that over its own wall
    walls = {'serial': [], 'overlapped': []}
    sub = ds.subset(np.arange(REAL_TURN_BATCHES * BATCH))

    def loop(how):
        if how == 'serial':
            return serial_eval(encoder, decoder, sub, tcfg, luts, REAL_TURN_BATCHES)
        return evaluate_autoregressive(encoder, decoder, sub, tcfg, luts, batch_size=BATCH)
    for how in ('serial', 'overlapped', 'overlapped', 'serial'):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = loop(how)
        walls[how].append(time.perf_counter() - t0)
        check(np.array_equal(res['per_sample_ar_exact'],
                             out['per_sample_ar_exact'][:len(sub)]),
              f'real (c): the {how} loop disagrees with the full eval')
    part('(c) turns')
    busy_s = trace_batch(torch, lambda: loop('overlapped'),
                         f'the overlapped eval loop over {REAL_TURN_BATCHES} batches of {BATCH}',
                         own='decode_attention_kernel')
    rows = len(sub)
    for how, v in walls.items():
        print(f'real (c): the {how} loop over {rows} rows: '
              + ', '.join(f'{rows / w:.1f} formulas/s'
                          + (f' (device busy {100 * busy_s / w:.1f}%)' if busy_s else '')
                          for w in v))
    part('(c) trace')
    print('real: by part ' + ', '.join(f'{k} {v:.1f} s' for k, v in t_parts.items()))
    return launches + launches_c


# -- speculative phase ----------------------------------------------------------

SPEC_K = 4                        # drafted tokens a chunk, as the eval's
N_SPEC_CPU_ROWS = 8


def spec_phase(torch, dev, ds, batches, encoder, decoder):
    """Speculative decoding (generation/speculative.py) at run4's widths on
    the data phase's batches, with the e2e phase's weights and fixed heads.
    Two drafts: the corpus draft, built from every kept row's token stream
    as the eval CLI builds it, and a self-consistent one, built from the
    plain scan's streams without the grammar constraint as bench.py builds
    it.  The plain greedy scan (no gates, all 29 steps) runs through K1,
    its counts at 0 just before and read just after; the speculative side
    runs on a twin decoder with the plain cache layout that holds the same
    weights.  Checks: the corpus draft through evaluate_autoregressive (the
    eval CLI's --speculative) and the self draft through
    speculative_generate each give the plain scan's tokens up to each row's
    EOS, except at near-ties, and launch neither kernel; 8 rows on the CPU
    give the card's tokens.  Prints the acceptance rates, the iterations
    beside the plain scan's steps, formulas/s of both in turns, and the
    kernel launches and host reads an iteration.  Returns K1's launches."""
    import numpy as np
    from superconductor_vae_tpu_torch.generation import GenerationConfig, generate_with_kv_cache
    from superconductor_vae_tpu_torch.generation.speculative import (
        _as_draft_tables, speculative_generate)
    from superconductor_vae_tpu_torch.models import FormulaDecoder
    from superconductor_vae_tpu_torch.models.decoder import plain_layout
    from superconductor_vae_tpu_torch.models.draft import build_ngram_draft
    from superconductor_vae_tpu_torch.ops.decode_attention import decode_step_attention
    from superconductor_vae_tpu_torch.ops.fused_attention import flash_attention
    from superconductor_vae_tpu_torch.tokenizer import BOS_ID, EOS_ID, default_tokenizer
    from superconductor_vae_tpu_torch.training import (
        build_luts, eval_train_config, evaluate, evaluate_autoregressive, stoich_conditioning)

    cfg = decoder.cfg
    steps = cfg.max_len - 1
    tok = default_tokenizer(max_len=cfg.max_len)
    twin = plain_layout(decoder)
    check(all(a is b for a, b in zip(decoder.parameters(), twin.parameters()))
          and not twin.cfg.pallas_decode, 'spec: the twin decoder does not share the weights')

    def bos_stream(tokens):
        return np.concatenate([np.full((len(tokens), 1), BOS_ID, np.int64),
                               np.asarray(tokens, np.int64)], axis=1)
    t0 = time.perf_counter()
    corpus_np = build_ngram_draft(bos_stream(ds.tokens[:, 1:]), tok)
    corpus_s = time.perf_counter() - t0
    with torch.inference_mode():
        inputs = []
        for bt in batches:
            enc_out = encoder(bt['element_indices'], bt['element_fractions'],
                              bt['element_mask'], bt['magpie'], bt['tc'])
            inputs.append((enc_out['z'], stoich_conditioning(bt),
                           encoder.heads_pred_for_decoder(enc_out)))
    gcfg = GenerationConfig(max_len=cfg.max_len, temperature=0.0)   # no gates, every step

    # the plain greedy scan through K1
    torch.cuda.synchronize()
    decode_step_attention.launches = 0
    flash_attention.launches = 0
    plain = [generate_with_kv_cache(decoder, *x, None, gcfg) for x in inputs]
    torch.cuda.synchronize()
    launches = decode_step_attention.launches
    check(launches == cfg.num_layers * steps * len(batches),
          f'spec: K1 launches {launches} in the plain scans != {cfg.num_layers} x {steps} x '
          f'{len(batches)}')
    t0 = time.perf_counter()
    self_np = build_ngram_draft(bos_stream(torch.cat([o['tokens'] for o in plain]).cpu()),
                                tok, grammar_constrained=False)
    self_s = time.perf_counter() - t0
    drafts = {'corpus': _as_draft_tables(corpus_np, dev), 'self': _as_draft_tables(self_np, dev)}
    print(f'spec: drafts built on the host: corpus ({len(ds)} rows, grammar-constrained) '
          f'{corpus_s:.2f} s, {int((corpus_np["trigram"] >= 0).sum())} trigram contexts; '
          f'self ({len(batches) * BATCH} plain streams, unconstrained) {self_s:.2f} s, '
          f'{int((self_np["trigram"] >= 0).sum())} contexts')

    # the corpus draft through the entry point: the eval's speculative branch
    luts = build_luts(tok, device=dev)
    sub = ds.subset(np.arange(len(batches) * BATCH))
    k1_before = decode_step_attention.launches
    with CallLog(evaluate, 'speculative_generate') as log:
        out = evaluate_autoregressive(encoder, twin, sub, eval_train_config(cfg.max_len), luts,
                                      batch_size=BATCH, speculative_tables=corpus_np)
    check(decode_step_attention.launches == k1_before and flash_attention.launches == 0,
          'spec: the speculative path launched a kernel')
    results = {'corpus': log.outputs}
    results['self'] = [speculative_generate(twin, *x, drafts['self'], k=SPEC_K) for x in inputs]
    check(decode_step_attention.launches == k1_before and flash_attention.launches == 0,
          'spec: the speculative path launched a kernel')
    for name, outs in results.items():
        ties = 0
        for i, (o, p) in enumerate(zip(outs, plain)):
            check(o['tokens'].shape == (BATCH, steps), f'spec {name}: tokens shape')
            ties += compare_streams({'generated': o['tokens'], 'margin': o['margin']},
                                    {'generated': p['tokens'], 'margin': p['margin']}, EOS_ID,
                                    f'spec {name} batch {i} vs the plain scan through K1')
        acc = [float(o['acceptance_rate']) for o in outs]
        iters = [o['n_iterations'] for o in outs]
        print(f'spec: {name} draft: acceptance {", ".join(f"{a:.4f}" for a in acc)}; '
              f'iterations {iters} against {steps} plain steps a batch '
              f'(steps / (1 + a k) = {[round(steps / (1 + a * SPEC_K), 1) for a in acc]}); '
              f'tokens equal to the plain scan\'s up to EOS (near-tie divergences {ties})')
    print(f'spec: eval of {out["n_evaluated"]} rows with the corpus draft: true_ar_exact '
          f'{out["ar_exact"]:.4f}, tf_exact {out["tf_exact"]:.4f} (random weights)')

    # formulas/s in turns, each turn the four batches, then a synchronise
    def run(name):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for x in inputs:
            if name == 'plain':
                generate_with_kv_cache(decoder, *x, None, gcfg)
            else:
                speculative_generate(twin, *x, drafts[name], k=SPEC_K)
        torch.cuda.synchronize()
        return len(inputs) * BATCH / (time.perf_counter() - t0)
    rates = {'plain': [], 'corpus': [], 'self': []}
    for name in ('plain', 'corpus', 'self', 'self', 'corpus', 'plain'):
        rates[name].append(run(name))
    print('spec: formulas/s in turns (batches of ' + f'{BATCH}, {len(inputs)} a turn): '
          + '; '.join(f'{k} ' + ', '.join(f'{x:.1f}' for x in v) for k, v in rates.items())
          + '; the plain greedy scan through K1 (no gates, all steps), speculative k='
          f'{SPEC_K} through the plain attention')

    # kernel launches and host reads an iteration (one batch)
    x = inputs[0]
    _, _, plain_kernels = profile_counts(torch, lambda: generate_with_kv_cache(
        decoder, *x, None, gcfg))
    for name in ('corpus', 'self'):
        o, syncs = host_syncs(torch, lambda: speculative_generate(
            twin, *x, drafts[name], k=SPEC_K))
        _, busy, kernels = profile_counts(torch, lambda: speculative_generate(
            twin, *x, drafts[name], k=SPEC_K))
        n = o['n_iterations']
        print(f'spec: {name} draft, one batch of {BATCH}: {n} iterations, {kernels} kernel '
              f'launches ({kernels / n:.1f} an iteration; the plain scan {plain_kernels} = '
              f'{plain_kernels / steps:.1f} a step), device busy {busy:.2f} ms, host reads '
              f'{sum(syncs.values())} ({sum(syncs.values()) / n:.2f} an iteration) {dict(syncs)}')
        check(sum(syncs.values()) <= n + 1, f'spec: {dict(syncs)} host reads in {n} iterations')

    # the card against the CPU, a few rows, the same weights
    dec_cpu = FormulaDecoder(twin.cfg, device='cpu').eval()
    dec_cpu.load_state_dict(twin.state_dict())
    for name, outs in results.items():
        small = [v[:N_SPEC_CPU_ROWS].float().cpu() for v in inputs[0]]
        cpu = speculative_generate(dec_cpu, *small, {k: None if v is None else v.cpu()
                                                     for k, v in drafts[name].items()}, k=SPEC_K)
        card = {k: outs[0][k][:N_SPEC_CPU_ROWS].cpu() for k in ('tokens', 'margin')}
        ties = compare_streams({'generated': card['tokens'], 'margin': card['margin']},
                               {'generated': cpu['tokens'], 'margin': cpu['margin']}, EOS_ID,
                               f'spec {name} card vs CPU')
        print(f'spec: {name} draft: {N_SPEC_CPU_ROWS} rows on the CPU give the card\'s tokens '
              f'(near-tie divergences {ties})')
    del twin, dec_cpu, drafts
    torch.cuda.empty_cache()
    return launches


# -- train phase --------------------------------------------------------------

N_TRAIN_STEPS = 8
METRIC_TOL = dict(rtol=1e-4, atol=1e-6)   # card vs CPU: float32, other summation orders


def _tree_check(phase, got, want, what):
    """Card against CPU, tensor by tensor: 1e-3 relative plus 1e-4 of the
    largest magnitude in the tree (elements near zero carry the summation
    noise of the whole tree)."""
    scale = max(w.abs().max().item() for w in want.values())
    worst = 0.0
    for k, w in want.items():
        g = got[k].cpu()
        bound = 1e-3 * w.abs() + 1e-4 * scale
        worst = max(worst, ((g - w).abs() / bound).max().item())
    print(f'{phase}: card vs CPU {what}: worst error / tolerance {worst:.3f}')
    check(worst <= 1.0, f'card and CPU disagree on {what}')


def _group_tensors(state):
    """{group: {name: (param, exp_avg)}} of the update groups (the set
    decoder's where the state has one)."""
    out = {}
    for name, module, opt in (('encoder', state.encoder, state.enc_opt),
                              ('decoder', state.decoder, state.dec_opt),
                              ('projection', state.pz_proj, state.pz_opt),
                              ('set decoder', state.set_decoder, state.set_opt)):
        if module is None:
            continue
        out[name] = {n: (p.detach().clone(), opt.state[p]['exp_avg'].clone()
                         if p in opt.state else None)
                     for n, p in module.named_parameters()}
    return out


def no_set_dropout(state):
    """The set decoder's own dropout (0.1, whatever the model config says)
    off, for a card-against-CPU step; returns the state."""
    from superconductor_vae_tpu_torch.models import SetDecoderLayer
    if state.set_decoder is not None:
        for m in state.set_decoder.modules():
            if isinstance(m, SetDecoderLayer):
                m.dropout = 0.0
    return state


def check_metrics(phase, got, want, what):
    """Card against CPU, metric by metric, within METRIC_TOL."""
    for k in want:
        g, w = got[k].item(), want[k].item()
        ok = abs(g - w) <= METRIC_TOL['atol'] + METRIC_TOL['rtol'] * abs(w)
        check(ok, f'{phase}: card {g!r} and CPU {w!r} disagree on {what} {k}')
    print(f'{phase}: card vs CPU: {len(want)} {what} agree within {METRIC_TOL}')


def check_updates(torch, phase, before_c, after_c, before_h, after_h, lr):
    """Card against CPU after one step from the same weights: each group's
    AdamW first moment (``_tree_check``), and each parameter update."""
    for name in after_h:
        _tree_check(phase, {k: v[1] for k, v in after_c[name].items()},
                    {k: v[1] for k, v in after_h[name].items()}, f'{name} AdamW mu')
        mu_scale = max(v[1].abs().max().item() for v in after_h[name].values())
        worst = 0.0
        for k, (p_h, mu_h) in after_h[name].items():
            d_c = (after_c[name][k][0] - before_c[name][k][0]).cpu()
            d_h = p_h - before_h[name][k][0]
            # an update is at most lr (1 + wd |p|) at step 1; where the
            # gradient is far above its tree's float32 noise the sign is
            # sure and the two updates agree to 1e-3
            check(bool(((d_c - d_h).abs() <= 2 * lr * (1 + 1e-2 * p_h.abs()) + 1e-7).all()),
                  f'{phase}: {name} {k} update out of bounds')
            sure = mu_h.abs() > 1e-2 * mu_scale
            ulp = 4 * torch.finfo(torch.float32).eps * before_h[name][k][0].abs()
            err = ((d_c - d_h).abs() / (1e-3 * d_h.abs() + ulp + 1e-9))[sure].max().item() \
                if bool(sure.any()) else 0.0
            worst = max(worst, err)
        print(f'{phase}: card vs CPU {name} parameter updates: worst error / tolerance '
              f'{worst:.3f}')
        check(worst <= 1.0, f'card and CPU disagree on the {name} updates')


def train_phase(torch, dev, batches):
    """The teacher-forced train step at run4's widths with weights from a
    seed, float32, bench.py's TrainConfig (batch 256, physics-Z with the
    learnable projection, lr 3e-5, weight decay 0.01, clip 1) without the
    set decoder and the round-trip loss, run4's physics-Z weight 1 and
    dropout 0.1: 1 warm-up step and N_TRAIN_STEPS timed steps over the 4
    batches, one step under the profiler, and one step of 8 rows with
    dropout off on the card and on the CPU from the same weights."""
    import math
    from superconductor_vae_tpu_torch.models import config_from_meta
    from superconductor_vae_tpu_torch.ops.decode_attention import decode_step_attention
    from superconductor_vae_tpu_torch.ops.fused_attention import flash_attention
    from superconductor_vae_tpu_torch.ops.physics_z_loss import physics_z_loss
    from superconductor_vae_tpu_torch.tokenizer import default_tokenizer
    from superconductor_vae_tpu_torch.training import (
        TrainConfig, build_luts, create_train_state, default_dyn, make_train_step)

    meta = json.loads(META.read_text())
    cfg = config_from_meta(meta['model_config'])
    tcfg = TrainConfig(batch_size=BATCH, use_physics_z=True, magpie_proj_learnable=True,
                       hungarian_enabled=False, use_round_trip=False)
    dyn = dict(default_dyn(tcfg), physz_w=float(meta['controllers']['physz']['weight']))
    print(f'train: run4 widths, float32, dropout {cfg.dropout}, batch {BATCH}, lr '
          f'{tcfg.learning_rate}, wd {tcfg.weight_decay}, clip {tcfg.grad_clip}, '
          f'physz_w {dyn["physz_w"]}, theory_w {tcfg.theory_weight}')
    tok = default_tokenizer(max_len=cfg.max_len)
    luts = build_luts(tok, device=dev)
    step = make_train_step(tcfg, luts)

    state = create_train_state(cfg, tcfg, seed=SEED, device=dev)
    n_params = {name: sum(p.numel() for p, _ in g.values())
                for name, g in _group_tensors(state).items()}
    print(f'train: parameters {n_params} from seed {SEED}')
    start = _group_tensors(state)
    state, _ = step(state, batches[0], SEED, dyn)              # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # the main path: counts at 0 just before, read just after
    decode_step_attention.launches = 0
    flash_attention.launches = 0
    t0 = time.perf_counter()
    steps = []
    for i in range(N_TRAIN_STEPS):
        state, m = step(state, batches[(i + 1) % len(batches)], SEED, dyn)
        steps.append(m)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k_launches = (decode_step_attention.launches, flash_attention.launches)
    peak = torch.cuda.max_memory_allocated()
    vals = [{k: v.item() for k, v in m.items()} for m in steps]
    check(k_launches == (0, 0), f'the train step launched K1/K2 {k_launches} times; '
          'the JAX step runs no Pallas kernel')
    for i, v in enumerate(vals):
        bad = [k for k, x in v.items() if not math.isfinite(x)]
        check(not bad, f'train step {i + 1}: metrics not finite: {bad}')
    end = _group_tensors(state)
    for name in start:
        changed = sum(not torch.equal(start[name][k][0], end[name][k][0]) for k in start[name])
        print(f'train: {name}: {changed} of {len(start[name])} parameter tensors changed')
        check(changed > 0, f'train: no parameter of the {name} changed')
    del start, end
    print(f'train: {N_TRAIN_STEPS} steps of {BATCH} in {wall:.3f} s = '
          f'{N_TRAIN_STEPS * BATCH / wall:.1f} train samples/s; peak memory '
          f'{peak / 2 ** 30:.2f} GiB; K1/K2 launches {k_launches}')
    for i in (0, N_TRAIN_STEPS - 1):
        print(f'train: step {i + 2}: total {vals[i]["total"]:.4f}, grad_norm '
              f'{vals[i]["grad_norm"]:.3f}, formula {vals[i]["formula_loss"]:.4f}, '
              f'physics_z {vals[i]["physics_z_loss"]:.4f}, token_accuracy '
              f'{vals[i]["token_accuracy"]:.4f}')
    trace_batch(torch, lambda: step(state, batches[1], SEED, dyn),
                f'one train step of {BATCH}')
    samples_per_s = N_TRAIN_STEPS * BATCH / wall
    del state, steps
    torch.cuda.empty_cache()

    # card against CPU: one step of 8 rows from the same weights, dropout off
    cfg0 = dataclasses.replace(cfg, dropout=0.0)
    small = {k: v[:N_CPU_ROWS] for k, v in batches[0].items()}
    runs = []
    for where in (dev, torch.device('cpu')):
        st = create_train_state(cfg0, tcfg, seed=SEED + 1, device=where)
        bt = {k: v.to(where) for k, v in small.items()}
        with torch.no_grad():
            enc_out = st.encoder.train()(bt['element_indices'], bt['element_fractions'],
                                         bt['element_mask'], bt['magpie'], bt['tc'])
            pz = physics_z_loss(enc_out['z'], bt['comp_targets'], bt['magpie'], bt['tc'],
                                proj=st.pz_proj)
        before = _group_tensors(st)
        st, m = make_train_step(tcfg, build_luts(tok, device=where))(st, bt, SEED, dyn)
        runs.append((pz, m, before, _group_tensors(st)))
        del st
    (pz_c, m_c, before_c, after_c), (pz_h, m_h, before_h, after_h) = runs
    check_metrics('train', pz_c, pz_h, 'physics_z_loss')
    check_metrics('train', m_c, m_h, 'step metrics')
    check_updates(torch, 'train', before_c, after_c, before_h, after_h, tcfg.learning_rate)
    return samples_per_s, peak


# -- defaults phase -------------------------------------------------------------

N_DEFAULT_STEPS = 4               # timed steps of each configuration, in turns
N_DEFAULT_CPU_ROWS = 32           # card against CPU: a round trip of 3 rows
RT_B = (25, 51)                   # the round trip's rows at batch 256 (this phase), 512 (bench)
HUNGARIAN_TIE = 1e-5              # assignments whose costs lie this close may swap


def defaults_phase(torch, dev, batches):
    """The train step at TrainConfig()'s defaults (the set decoder with its
    Hungarian matching, the A5 round trip whose greedy rollout of 25 rows
    runs through K1) at run4's widths, float32, batch 256, dropout 0.1:
    (c) K1 against its plain version at the round trip's shapes (B=25 and
    51, T=30, every position, both dtypes; caches equal) and timed there;
    then one step with K1 counted (12 layers x 29 steps), steps of the
    defaults and of the step without the two options timed in turns, each
    step's launches and busy share under the profiler, the parts of a
    default step (host clock), and the set decoder's forward and backward
    and the Hungarian DP alone; (d) an epoch of make_epoch_runner at the
    defaults under the sync debug mode; (b) one step of 32 rows on the card
    and on the CPU from the same weights, dropout off in every model.
    Returns (K1 launches of the timed default steps, step samples/s)."""
    import math
    import numpy as np
    import superconductor_vae_tpu_torch.training.train_step as ts_mod
    from superconductor_vae_tpu_torch.models import SetFormulaDecoder, config_from_meta
    from superconductor_vae_tpu_torch.ops import hungarian, round_trip
    from superconductor_vae_tpu_torch.ops.decode_attention import decode_step_attention
    from superconductor_vae_tpu_torch.ops.fused_attention import flash_attention
    from superconductor_vae_tpu_torch.tokenizer import default_tokenizer
    from superconductor_vae_tpu_torch.training import (
        TrainConfig, build_luts, create_train_state, default_dyn, make_epoch_runner,
        make_train_step)
    from superconductor_vae_tpu_torch.training.train_loop import _read_sums

    # (c) K1 at the round trip's shapes
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    h, t, dh = 8, 30, 72
    for name, dtype in (('float32', torch.float32), ('bfloat16', torch.bfloat16)):
        for b in RT_B:
            err = max(k1_held(torch, gen, b, h, t, dh, dtype, p) for p in range(t))
            print(f'defaults (c): K1 check {name} B={b} T={t} Dh={dh} pos 0..{t - 1}: '
                  f'max_abs_err {err:.3e} (tol {K1_TOL[name]}) caches_equal=True')
    k1_rows = {b: k1_position_means(torch, gen, b, h, t, dh, dtype, 'defaults (c)')
               for b, dtype in ((RT_B[0], torch.float32), (RT_B[1], torch.bfloat16))}
    torch.cuda.empty_cache()

    meta = json.loads(META.read_text())
    cfg = config_from_meta(meta['model_config'], pallas_decode=True)
    tcfg = TrainConfig(batch_size=BATCH)
    check(tcfg.hungarian_enabled and tcfg.use_round_trip and tcfg.a5_weight > 0,
          "defaults: TrainConfig()'s defaults lost the set decoder or the round trip")
    off = dataclasses.replace(tcfg, hungarian_enabled=False, use_round_trip=False)
    subset = max(int(BATCH * tcfg.round_trip_subset_fraction), 1)
    check(subset == RT_B[0], f'defaults: a round trip of {subset} rows')
    dyn = dict(default_dyn(tcfg), physz_w=float(meta['controllers']['physz']['weight']))
    tok = default_tokenizer(max_len=cfg.max_len)
    luts = build_luts(tok, device=dev)
    configs = {'defaults': tcfg, 'without': off}
    steps = {k: make_train_step(c, luts) for k, c in configs.items()}
    states = {k: create_train_state(cfg, c, seed=SEED, device=dev) for k, c in configs.items()}
    n_params = {name: sum(p.numel() for p, _ in g.values())
                for name, g in _group_tensors(states['defaults']).items()}
    print(f'defaults: run4 widths, float32, dropout {cfg.dropout}, batch {BATCH}, K1 in the '
          f'round trip ({subset} rows, {cfg.max_len - 1} steps); set decoder d_model '
          f'{tcfg.hungarian_d_model}, {tcfg.hungarian_num_layers} layers, FFN '
          f'{tcfg.hungarian_dim_feedforward}, {tcfg.hungarian_n_z_tokens} z tokens; parameters '
          f'{n_params}')
    for k in configs:                                                   # warm-up
        states[k], _ = steps[k](states[k], batches[0], SEED, dyn)
    # the main path: counts at 0 just before the timed steps, read just after
    rates = {k: [] for k in configs}
    torch.cuda.synchronize()
    decode_step_attention.launches = 0
    flash_attention.launches = 0
    k1 = {k: 0 for k in configs}
    vals = {}
    for i, how in enumerate(('without', 'defaults', 'defaults', 'without')):
        before = decode_step_attention.launches
        t0 = time.perf_counter()
        for j in range(N_DEFAULT_STEPS):
            states[how], m = steps[how](states[how], batches[(i + j + 1) % len(batches)],
                                        SEED, dyn)
        torch.cuda.synchronize()
        rates[how].append(N_DEFAULT_STEPS * BATCH / (time.perf_counter() - t0))
        k1[how] += decode_step_attention.launches - before
        vals[how] = {key: v.item() for key, v in m.items()}
        bad = [key for key, x in vals[how].items() if not math.isfinite(x)]
        check(not bad, f'defaults ({how}): metrics not finite: {bad}')
    launches = decode_step_attention.launches
    n_default = 2 * N_DEFAULT_STEPS
    per_step = cfg.num_layers * (cfg.max_len - 1)
    check(flash_attention.launches == 0, 'defaults: K2 was launched')
    check(k1['without'] == 0, f'defaults: the step without the round trip launched K1 '
          f'{k1["without"]} times')
    check(launches == n_default * per_step,
          f'defaults: K1 launches {launches} over {n_default} default steps != '
          f'{n_default} x {per_step}')
    print(f'defaults: K1 launches {launches} over {n_default} default steps = {per_step} a step '
          f'(12 layers x {cfg.max_len - 1} decode steps); without the two options 0')
    v = vals['defaults']
    print(f'defaults: last default step: total {v["total"]:.4f}, a5_z_mse '
          f'{v["a5_z_mse"]:.4f}, a5_tc_mse {v["a5_tc_mse"]:.4f}, hungarian_loss '
          f'{v["hungarian_loss"]:.4f}, set_element_accuracy '
          f'{v["set_element_accuracy"]:.4f}, grad_norm {v["grad_norm"]:.3f}')
    print('defaults: train samples/s in turns (steps of ' + f'{BATCH}, {N_DEFAULT_STEPS} a '
          'turn): ' + '; '.join(f'{how} ' + ', '.join(f'{x:.1f}' for x in v)
                                for how, v in rates.items()))
    st = states['defaults']

    # the set decoder's forward and backward alone, and the DP alone
    z = torch.randn(BATCH, cfg.latent_dim, device=dev, requires_grad=True)
    b0 = batches[0]
    fwd, bwd = [], []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = st.set_decoder(z)
        loss = hungarian.hungarian_matching_loss(
            out['element_logits'], out['fraction_pred'], out['presence_logits'],
            b0['element_indices'], b0['element_fractions'], b0['element_mask'])['total']
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        loss.backward()
        torch.cuda.synchronize()
        fwd.append((t1 - t0) * 1e3)
        bwd.append((time.perf_counter() - t1) * 1e3)
    st.set_decoder.zero_grad(set_to_none=True)
    cost = torch.rand(BATCH, 12, 12, device=dev)
    dp_wall, dp_busy, dp_kernels = profile_counts(
        torch, lambda: hungarian.hungarian_assignment(cost))
    print(f'defaults: set decoder alone at B={BATCH} (host clock, after a warm-up): forward '
          f'with the matching loss {min(fwd[1:]):.2f}-{max(fwd[1:]):.2f} ms, backward '
          f'{min(bwd[1:]):.2f}-{max(bwd[1:]):.2f} ms; the Hungarian DP alone on [{BATCH}, 12, '
          f'12] under the profiler: {dp_busy:.3f} ms on the device in {dp_kernels} launches, '
          f'wall {dp_wall:.3f} ms')

    # the parts of a default step, each timed with a synchronise after it;
    # the second of two steps is printed
    for i in range(2):
        with Timings(torch, (round_trip, 'generate_with_kv_cache'),
                     (ts_mod, 'round_trip_loss'), (ts_mod, 'hungarian_matching_loss'),
                     (SetFormulaDecoder, 'forward')) as tm:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, _ = steps['defaults'](st, batches[2 + i], SEED, dyn)
            torch.cuda.synchronize()
            step_s = time.perf_counter() - t0
    part = {name: sum(x for x, _ in v) for name, v in tm.calls.items()}
    print(f'defaults: parts of one default step of {BATCH} (host clock, a synchronise after '
          f'each part; the step {step_s * 1e3:.1f} ms): the round trip\'s rollout '
          f'{part["generate_with_kv_cache"] * 1e3:.1f} ms '
          f'({100 * part["generate_with_kv_cache"] / step_s:.1f}% of the step), the round trip '
          f'with its re-encoding {part["round_trip_loss"] * 1e3:.1f} ms, the set decoder\'s '
          f'forward {part["forward"] * 1e3:.1f} ms, the Hungarian loss with its DP '
          f'{part["hungarian_matching_loss"] * 1e3:.1f} ms')
    states['defaults'] = st
    for how in configs:
        wall, busy, n_kernels = profile_counts(
            torch, lambda: steps[how](states[how], batches[1], SEED, dyn))
        print(f'defaults: one step ({how}) under the profiler: wall {wall:.1f} ms, device busy '
              f'{busy:.1f} ms ({100 * busy / wall:.1f}%), {n_kernels} kernel launches')
    del states['without']
    torch.cuda.empty_cache()

    # (d) an epoch of make_epoch_runner at the defaults makes the host wait
    # nowhere; its one read does
    run = make_epoch_runner(tcfg, luts)
    data = {k: torch.cat([bt[k] for bt in batches]) for k in batches[0]}
    idx = np.arange(2 * BATCH).reshape(2, BATCH)
    st, _ = run(st, data, idx[:1], SEED, dyn)                           # first use
    (st, sums), epoch_syncs = host_syncs(torch, lambda: run(st, data, idx, SEED, dyn))
    _, read_syncs = host_syncs(torch, lambda: _read_sums(sums, len(idx)))
    print(f'defaults (d): operations that made the host wait for the card: in an epoch of '
          f'{len(idx)} default steps {dict(epoch_syncs)}, in the read of its sums '
          f'{dict(read_syncs)}')
    check(not epoch_syncs, f'defaults (d): the epoch made the host wait at {dict(epoch_syncs)}')
    check(sum(read_syncs.values()) >= 1, 'defaults (d): the sync debug mode missed the read')
    del st, states, steps, data, sums, z, out, loss
    torch.cuda.empty_cache()

    # (b) card against CPU: one default step of 32 rows, dropout off
    card_vs_cpu_step(torch, dev, batches[0], cfg, tcfg, dyn, 'defaults (b)')
    torch.cuda.empty_cache()
    return launches, rates, k1_rows


def card_vs_cpu_step(torch, dev, batch, cfg, tcfg, dyn, phase, weights=None):
    """One step of ``tcfg`` on the first 32 rows of ``batch`` (a round trip
    of 3), on the card and on the CPU from the same weights (seeded, or the
    state dicts ``weights`` of the state's modules by attribute name),
    dropout off in every model: the metrics within METRIC_TOL, the four groups' AdamW
    moments and updates (``check_updates``), the round trip's tokens equal
    except at near-ties, the Hungarian permutations equal except between
    assignments whose costs lie within HUNGARIAN_TIE."""
    from superconductor_vae_tpu_torch.ops import hungarian, round_trip
    from superconductor_vae_tpu_torch.tokenizer import EOS_ID, default_tokenizer
    from superconductor_vae_tpu_torch.training import (
        build_luts, create_train_state, make_train_step)

    tok = default_tokenizer(max_len=cfg.max_len)
    cfg0 = dataclasses.replace(cfg, dropout=0.0)
    tcfg0 = dataclasses.replace(tcfg, batch_size=N_DEFAULT_CPU_ROWS)
    small = {k: v[:N_DEFAULT_CPU_ROWS] for k, v in batch.items()}
    rec = {'tokens': [], 'margin': [], 'perm': [], 'cost': []}

    def recorded(fn, keys):
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            got = (out['tokens'], out['margin']) if keys[0] == 'tokens' else (out[0], args[0])
            for key, v in zip(keys, got):
                rec[key].append(v.detach().cpu())
            return out
        return call
    runs = []
    with _patched(round_trip, 'generate_with_kv_cache', recorded(
            round_trip.generate_with_kv_cache, ('tokens', 'margin'))), \
            _patched(hungarian, 'hungarian_assignment', recorded(
                hungarian.hungarian_assignment, ('perm', 'cost'))):
        for where in (dev, torch.device('cpu')):
            st = no_set_dropout(create_train_state(cfg0, tcfg0, seed=SEED + 1, device=where))
            for name, sd in (weights or {}).items():
                getattr(st, name).load_state_dict(sd)
            before = _group_tensors(st)
            st, m = make_train_step(tcfg0, build_luts(tok, device=where))(
                st, {k: v.to(where) for k, v in small.items()}, SEED, dyn)
            runs.append((m, before, _group_tensors(st)))
            del st
    (m_c, before_c, after_c), (m_h, before_h, after_h) = runs
    check(len(after_h) == 4, f'{phase}: update groups {list(after_h)}')
    check_metrics(phase, m_c, m_h, 'default step metrics')
    check_updates(torch, phase, before_c, after_c, before_h, after_h,
                  tcfg.learning_rate)
    (tok_c, tok_h), (mar_c, mar_h) = rec['tokens'], rec['margin']
    check(tok_c.shape[0] == 3, f'{phase}: a round trip of {tok_c.shape[0]} rows')
    ties = compare_streams({'generated': tok_c, 'margin': mar_c},
                           {'generated': tok_h, 'margin': mar_h}, EOS_ID,
                           f'{phase} round trip')
    (perm_c, perm_h), cost = rec['perm'], rec['cost'][1]
    rows = torch.arange(cost.shape[1])
    swapped = 0
    for r in torch.nonzero((perm_c != perm_h).any(dim=1))[:, 0].tolist():
        a, b = cost[r, rows, perm_c[r]].sum().item(), cost[r, rows, perm_h[r]].sum().item()
        check(abs(a - b) <= HUNGARIAN_TIE, f'{phase}: row {r}: the card\'s assignment '
              f'costs {a!r}, the CPU\'s {b!r}')
        swapped += 1
    print(f'{phase}: the round trip\'s {tok_c.shape[0]} rollouts equal card vs CPU '
          f'(near-tie divergences {ties}); the Hungarian permutations of {perm_c.shape[0]} rows '
          f'equal ({swapped} swapped between assignments within {HUNGARIAN_TIE} of cost)')


# -- soft-token phase -----------------------------------------------------------

N_SOFT_STEPS = 2                  # timed steps of each configuration, in turns


def soft_token_phase(torch, dev, batches):
    """The soft-token train step (training/soft_token.py: a teacher-forced
    pass without gradient, then the pass over mixed embeddings) at
    TrainConfig()'s defaults (the set decoder and the round trip, its
    rollout through K1) at run4's widths, float32, batch 256, dropout 0.1,
    at ratio soft_token_end_ratio (0.3): warm-up, then the default step and
    the soft-token step timed in turns (samples/s), K1 counted over the
    timed steps (348 a step, the round trip's), every metric finite; then
    one soft-token step of 32 rows on the card and on the CPU from the same
    weights, dropout off (``card_vs_cpu_step``).  Returns K1's launches."""
    import math
    from superconductor_vae_tpu_torch.models import config_from_meta
    from superconductor_vae_tpu_torch.ops.decode_attention import decode_step_attention
    from superconductor_vae_tpu_torch.ops.fused_attention import flash_attention
    from superconductor_vae_tpu_torch.tokenizer import default_tokenizer
    from superconductor_vae_tpu_torch.training import (
        TrainConfig, build_luts, create_train_state, default_dyn, make_train_step)

    meta = json.loads(META.read_text())
    cfg = config_from_meta(meta['model_config'], pallas_decode=True)
    tcfg = TrainConfig(batch_size=BATCH)
    configs = {'defaults': tcfg, 'soft': dataclasses.replace(tcfg, soft_token_enabled=True)}
    dyn = dict(default_dyn(tcfg), physz_w=float(meta['controllers']['physz']['weight']),
               soft_ratio=tcfg.soft_token_end_ratio)
    luts = build_luts(default_tokenizer(max_len=cfg.max_len), device=dev)
    steps = {k: make_train_step(c, luts) for k, c in configs.items()}
    states = {k: create_train_state(cfg, c, seed=SEED, device=dev) for k, c in configs.items()}
    for k in configs:                                                   # warm-up
        states[k], _ = steps[k](states[k], batches[0], SEED, dyn)
    rates = {k: [] for k in configs}
    torch.cuda.synchronize()
    decode_step_attention.launches = 0
    flash_attention.launches = 0
    for i, how in enumerate(('defaults', 'soft', 'soft', 'defaults')):
        t0 = time.perf_counter()
        for j in range(N_SOFT_STEPS):
            states[how], m = steps[how](states[how], batches[(i + j + 1) % len(batches)],
                                        SEED, dyn)
        torch.cuda.synchronize()
        rates[how].append(N_SOFT_STEPS * BATCH / (time.perf_counter() - t0))
        vals = {key: v.item() for key, v in m.items()}
        bad = [key for key, x in vals.items() if not math.isfinite(x)]
        check(not bad, f'soft ({how}): metrics not finite: {bad}')
        if how == 'soft':
            soft_vals = vals
    launches = decode_step_attention.launches
    per_step = cfg.num_layers * (cfg.max_len - 1)
    n_steps = 4 * N_SOFT_STEPS
    check(flash_attention.launches == 0, 'soft: K2 was launched')
    check(launches == n_steps * per_step,
          f'soft: K1 launches {launches} over {n_steps} steps != {n_steps} x {per_step}')
    print(f'soft: ratio {dyn["soft_ratio"]}, temperature {tcfg.soft_token_temperature}; K1 '
          f'launches {launches} over {n_steps} steps = {per_step} a step (the round trip)')
    print(f'soft: last soft-token step: total {soft_vals["total"]:.4f}, formula_loss '
          f'{soft_vals["formula_loss"]:.4f}, grad_norm {soft_vals["grad_norm"]:.3f}')
    print('soft: train samples/s in turns (steps of ' + f'{BATCH}, {N_SOFT_STEPS} a turn): '
          + '; '.join(f'{how} ' + ', '.join(f'{x:.1f}' for x in v) for how, v in rates.items()))
    del states, steps
    torch.cuda.empty_cache()
    card_vs_cpu_step(torch, dev, batches[0], cfg, configs['soft'], dyn, 'soft (b)')
    torch.cuda.empty_cache()
    return launches


# -- RL phase -----------------------------------------------------------------

RL_BATCH = 512                    # bench.py's RL batch: a [2 x 512] SCST rollout
N_RL_STEPS = 4
RLOO_K, N_RLOO_STEPS = 4, 2       # a [4 x 512] rollout
RESCORE_TOL = 2e-4                # rollout log-probs against the TF re-score


class CallLog:
    """Stands in for ``module.name`` (ops/rl.py ``_rollout``, or the eval's
    ``generate_with_kv_cache``) while entered: calls it and keeps each
    output, so that a run can count the decode steps it took; or, given
    ``replay``, returns that rollout instead (another run's, moved to this
    run's device)."""

    def __init__(self, module, name, replay=None):
        self.module, self.name, self.replay, self.outputs = module, name, replay, []
        self.original = getattr(module, name)

    def __call__(self, *args, **kwargs):
        if self.replay is not None:
            dev = args[1].device                   # z
            return {k: v.to(dev) for k, v in self.replay.items()}
        out = self.original(*args, **kwargs)
        self.outputs.append(out)
        return out

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.original)


class K1Log(CallLog):
    """A ``CallLog`` that also counts K1's launches made inside the calls."""

    def __init__(self, module, name):
        super().__init__(module, name)
        self.launches = 0

    def __call__(self, *args, **kwargs):
        from superconductor_vae_tpu_torch.ops.decode_attention import decode_step_attention
        before = decode_step_attention.launches
        out = super().__call__(*args, **kwargs)
        self.launches += decode_step_attention.launches - before
        return out


def rl_step_run(torch, step, state, batches, dyn, n_steps, rl, eos_id):
    """``n_steps`` timed RL steps after one warm-up, through the rollout
    log; the kernels' counts at 0 just before, read just after.  Returns
    (wall s, metrics, decode steps of each rollout, K1 and K2 launches,
    peak bytes)."""
    from superconductor_vae_tpu_torch.ops.decode_attention import decode_step_attention
    from superconductor_vae_tpu_torch.ops.fused_attention import flash_attention
    state, _ = step(state, batches[0], SEED, dyn)              # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with CallLog(rl, '_rollout') as log:
        decode_step_attention.launches = 0
        flash_attention.launches = 0
        t0 = time.perf_counter()
        metrics = [step(state, batches[(i + 1) % len(batches)], SEED, dyn)[1]
                   for i in range(n_steps)]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = (decode_step_attention.launches, flash_attention.launches)
    steps = [steps_run(o['tokens'], eos_id) for o in log.outputs]
    return wall, metrics, steps, launches, torch.cuda.max_memory_allocated()


def rl_phase(torch, dev, batches):
    """The RL train step (SCST, then RLOO) at run4's widths with weights
    from a seed, float32, dropout 0.1, through K1 (pallas_decode), with
    bench.py's RL TrainConfig (rl.max_len = max_len, rl_w 1) on 512 of the
    1,024 rows and the stop and type heads fixed as in the e2e phase.
    Checks (a) finite metrics and every group changed, (b) K1 launches =
    layers x decode steps, (c) the rollout's log-probs against the TF
    re-score, (d) the greedy half against a plain-path greedy rollout, (e)
    one step of 8 rows on the card and on the CPU, the CPU fed the card's
    rollout.  Returns {'scst': (samples/s, K1 launches), 'rloo': ...}."""
    import math
    from superconductor_vae_tpu_torch.models import config_from_meta
    from superconductor_vae_tpu_torch.ops import rl
    from superconductor_vae_tpu_torch.tokenizer import EOS_ID, default_tokenizer
    from superconductor_vae_tpu_torch.training import (
        TrainConfig, build_luts, create_train_state, default_dyn, make_train_step)

    meta = json.loads(META.read_text())
    cfg = config_from_meta(meta['model_config'], pallas_decode=True)
    tok = default_tokenizer(max_len=cfg.max_len)
    luts = build_luts(tok, device=dev)
    rows = [{k: torch.cat([a[k], b[k]]) for k in a} for a, b in zip(batches[::2], batches[1::2])]
    check(all(len(r['tokens']) == RL_BATCH for r in rows), 'RL batches of 512 rows')
    results = {}
    for method, n_steps in (('scst', N_RL_STEPS), ('rloo', N_RLOO_STEPS)):
        tcfg = TrainConfig(batch_size=RL_BATCH, use_physics_z=True, magpie_proj_learnable=True,
                           hungarian_enabled=False, use_round_trip=False,
                           rl=rl.RLConfig(max_len=cfg.max_len, method=method,
                                          n_samples_rloo=RLOO_K))
        dyn = dict(default_dyn(tcfg), rl_w=1.0)
        k = 2 if method == 'scst' else RLOO_K
        print(f'rl: {method}, run4 widths, float32, dropout {cfg.dropout}, batch {RL_BATCH} '
              f'({k * RL_BATCH}-row rollout through K1), rl_w 1, temperature '
              f'{dyn["rl_temperature"]}, gates: stop boost {tcfg.rl.stop_boost}, hard stop '
              f'{tcfg.rl.hard_stop_threshold}, type masking {tcfg.rl.use_type_masking}, '
              f'early exit {tcfg.rl.early_exit}')
        state = create_train_state(cfg, tcfg, seed=SEED, device=dev)
        fix_rollout_heads(torch, state.decoder)
        step = make_train_step(tcfg, luts, rl_enabled=True)
        start = _group_tensors(state)
        wall, metrics, steps, launches, peak = rl_step_run(
            torch, step, state, rows, dyn, n_steps, rl, EOS_ID)
        vals = [{key: v.item() for key, v in m.items()} for m in metrics]
        # (a) finite metrics, every group of parameters changed
        for i, v in enumerate(vals):
            bad = [key for key, x in v.items() if not math.isfinite(x)]
            check(not bad, f'rl {method} step {i + 1}: metrics not finite: {bad}')
        end = _group_tensors(state)
        for name in start:
            changed = sum(not torch.equal(start[name][key][0], end[name][key][0])
                          for key in start[name])
            print(f'rl: {method}: {name}: {changed} of {len(start[name])} parameter '
                  'tensors changed')
            check(changed > 0, f'rl {method}: no parameter of the {name} changed')
        del start, end
        # (b) K1 at every decode step of every layer, K2 never
        print(f'rl: {method}: decode steps of each rollout {steps}; K1/K2 launches {launches}')
        check(launches[0] > 0, f'rl {method}: K1 was not launched')
        check(launches == (cfg.num_layers * sum(steps), 0),
              f'rl {method}: K1/K2 launches {launches} != (layers x steps '
              f'{cfg.num_layers * sum(steps)}, 0)')
        rate = n_steps * RL_BATCH / wall
        print(f'rl: {method}: {n_steps} steps of {RL_BATCH} in {wall:.3f} s = {rate:.1f} RL '
              f'samples/s; peak memory {peak / 2 ** 30:.2f} GiB')
        for i in (0, n_steps - 1):
            print(f'rl: {method} step {i + 2}: total {vals[i]["total"]:.4f}, reinforce '
                  f'{vals[i]["reinforce_loss"]:.4f}, mean_reward {vals[i]["mean_reward"]:.4f}, '
                  f'reward_var {vals[i]["reward_var"]:.4f}, grad_norm {vals[i]["grad_norm"]:.3f}')
        results[method] = (rate, launches[0])
        # the re-score's remat (torch.utils.checkpoint): one step without it
        with _patched(rl, 'checkpoint', lambda fn, *args, use_reentrant: fn(*args)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            step(state, rows[0], SEED, dyn)
            torch.cuda.synchronize()
            peak_off = torch.cuda.max_memory_allocated()
        print(f'rl: {method}: peak memory with the TF re-score rematerialised '
              f'{peak / 2 ** 30:.2f} GiB (the timed steps), without {peak_off / 2 ** 30:.2f} GiB '
              '(one step)')
        if method == 'scst':
            trace_batch(torch, lambda: step(state, rows[1], SEED, dyn),
                        f'one SCST step of {RL_BATCH}', own='decode_attention_kernel')
            rollout_checks(torch, dev, cfg, tcfg, state, rows[0], luts, dyn)
        del state, step, metrics
        torch.cuda.empty_cache()

    # (e) one SCST step of 8 rows with dropout off, card against CPU, the
    # CPU step fed the card's rollout.  With random weights many rows get
    # the same reward greedy and sampled (the floor plus the same
    # constraint penalties), so the first 8 rows whose RL loss is not 0
    # are taken: the check then covers the policy gradient
    cfg0 = dataclasses.replace(cfg, dropout=0.0)
    tcfg = TrainConfig(batch_size=N_CPU_ROWS, use_physics_z=True, magpie_proj_learnable=True,
                       hungarian_enabled=False, use_round_trip=False,
                       rl=rl.RLConfig(max_len=cfg.max_len))
    dyn = dict(default_dyn(tcfg), rl_w=1.0)

    def one_step(where, small, replay=None):
        st = create_train_state(cfg0, tcfg, seed=SEED + 2, device=where)
        fix_rollout_heads(torch, st.decoder)
        before = _group_tensors(st)
        with CallLog(rl, '_rollout', replay=replay) as log:       # a replayed step samples nothing
            st, m = make_train_step(tcfg, build_luts(tok, device=where), rl_enabled=True)(
                st, {key: v.to(where) for key, v in small.items()}, SEED, dyn)
        return (m, before, _group_tensors(st)), (log.outputs or [replay])[0]

    for start in range(0, RL_BATCH, N_CPU_ROWS):
        small = {key: v[start:start + N_CPU_ROWS] for key, v in rows[0].items()}
        card, card_rollout = one_step(dev, small)
        if card[0]['reinforce_loss'].item() != 0.0:
            break
    print(f'rl: card vs CPU on rows {start}..{start + N_CPU_ROWS - 1}: reinforce_loss '
          f'{card[0]["reinforce_loss"].item():.4f}')
    check(card[0]['reinforce_loss'].item() != 0.0, 'rl: no 8 rows with an RL loss other than 0')
    runs = [card, one_step(torch.device('cpu'), small, replay=card_rollout)[0]]
    (m_c, before_c, after_c), (m_h, before_h, after_h) = runs
    for key in ('reinforce_loss', 'total'):
        print(f'rl: card vs CPU {key}: card {m_c[key].item()!r}, CPU {m_h[key].item()!r}')
    check_metrics('rl', m_c, m_h, 'SCST step metrics')
    check_updates(torch, 'rl', before_c, after_c, before_h, after_h, tcfg.learning_rate)
    return results


def rollout_checks(torch, dev, cfg, tcfg, state, batch, luts, dyn):
    """(c) and (d) on one fused SCST rollout of the batch through K1, from
    the trained state's weights."""
    from superconductor_vae_tpu_torch.generation import generate_with_kv_cache
    from superconductor_vae_tpu_torch.models import FormulaDecoder
    from superconductor_vae_tpu_torch.ops import rl
    from superconductor_vae_tpu_torch.tokenizer import EOS_ID
    from superconductor_vae_tpu_torch.training import stoich_conditioning
    enc, dec = state.encoder.eval(), state.decoder.eval()
    rlcfg, temp = tcfg.rl, dyn['rl_temperature']
    b = len(batch['tokens'])
    with torch.no_grad():
        enc_out = enc(batch['element_indices'], batch['element_fractions'],
                      batch['element_mask'], batch['magpie'], batch['tc'])
        z, hv, st = enc_out['z'], enc.heads_pred_for_decoder(enc_out), stoich_conditioning(batch)
        two = lambda x: torch.cat([x, x])
        gmask = torch.arange(2 * b, device=dev) < b
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        both = rl._rollout(dec, two(z), two(st), two(hv),
                           torch.Generator(device=dev).manual_seed(SEED), rlcfg, luts,
                           greedy=False, temperature=temp,
                           memory=two(dec.build_memory(z, st, hv)), greedy_mask=gmask)
        torch.cuda.synchronize()
        t_rollout = time.perf_counter() - t0
        trace_batch(torch, lambda: rl._rollout(
            dec, two(z), two(st), two(hv), torch.Generator(device=dev).manual_seed(SEED), rlcfg,
            luts, greedy=False, temperature=temp, memory=two(dec.build_memory(z, st, hv)),
            greedy_mask=gmask), f'one fused SCST rollout of {2 * b} rows',
            own='decode_attention_kernel')
    n = steps_run(both['tokens'], EOS_ID)
    # (c) the sampled half's log-probs against the TF re-score, which runs
    # no K1; timed with its backward, as the step runs it
    t0 = time.perf_counter()
    lp = rl.rescore_log_probs(dec, z, st, hv, both['tokens'][b:], rlcfg, luts, temperature=temp)
    (lp * both['mask'][b:]).sum().backward()
    torch.cuda.synchronize()
    t_rescore = time.perf_counter() - t0
    dec.zero_grad(set_to_none=True)
    print(f'rl: parts of an SCST step of {b} (host clock, synchronised): the fused rollout of '
          f'{2 * b} rows {t_rollout * 1e3:.1f} ms ({n} steps, {t_rollout / n * 1e3:.2f} ms a '
          f'step), the TF re-score of {b} rows with its backward {t_rescore * 1e3:.1f} ms')
    lp = lp.detach()
    with torch.no_grad():
        # where the rollout ran: after a row's EOS it keeps log-prob 0
        live = both['mask'][b:, :n] > 0
        got, want_lp = both['log_probs'][b:, :n][live], lp[:, :n][live]
        err = (got - want_lp).abs()
        print(f'rl: rollout ({n} steps) vs TF re-score, sampled half of {b}, {live.sum().item()} '
              f'live positions: max_abs_err {err.max().item():.3e} (tol {RESCORE_TOL} + '
              f'{RESCORE_TOL} relative)')
        check(bool((err <= RESCORE_TOL + RESCORE_TOL * want_lp.abs()).all()),
              'rl: the rollout log-probs disagree with the TF re-score')
        # (d) the greedy half against a greedy rollout of the plain path
        plain = FormulaDecoder(dataclasses.replace(cfg, pallas_decode=False), device=dev).eval()
        plain.load_state_dict(dec.state_dict())
        want = generate_with_kv_cache(plain, z, st, hv, None, rl._gen_cfg(rlcfg, greedy=True),
                                      type_masks=luts['type_masks'])
    ties = compare_streams({'generated': both['tokens'][:b], 'margin': want['margin']},
                           {'generated': want['tokens'], 'margin': want['margin']},
                           EOS_ID, 'rl greedy half vs plain greedy')
    print(f'rl: greedy half of the K1 rollout equals the plain path\'s greedy rollout; '
          f'near-tie divergences {ties}')
    state.encoder.train()
    state.decoder.train()


# -- bench phase --------------------------------------------------------------

# the port's bench (superconductor_vae_tpu_torch/bench.py) at ModelConfig(),
# bf16 compute, batch 512, through its probe functions with fewer reps than
# the standalone bench (train 20 steps, RL 1 warm + 3 timed chunks of 8,
# gen 1 warm + 5 timed calls)
BENCH_TRAIN_STEPS = 5
BENCH_RL_CHUNKS = (1, 1)                  # (warm, timed) chunks of 8 SCST steps
BENCH_GEN_CALLS = (1, 3)                  # (warm, timed) generate calls
K1_BF16_B = (512, 1024)                   # the gen probe's rows; the SCST rollout of 512
# run5's recipe at batch 128: the round trip's int(128 * 0.1) rows and the
# SCST rollout's [2 x 128]
K1_RECIPE_B = (12, 256)
# (c) holds K1's bf16 decode to the plain bf16 path's own distance from
# the float32 decode of the same weights, as tests/test_torch_port_bf16.py
# holds the port's bf16 to JAX's: K1 bf16's largest logit difference from
# float32 at most min(3 x the plain path's, BF16_CAP).  Measured on an H100
# at 700 W, over a 29-step forced stream of 512 rows: token logits K1 0.0167,
# plain 0.0171; top two type logits K1 0.0332, plain 0.0309; K1 against the
# plain path 0.0156 / 0.0254, where the old bound (twice that within 2**-4)
# had been passed by 0.0352 once.  At each K1 call K1 and its plain version
# were 3.860e-03 of the largest output from float64, one bf16 rounding.
BF16_CAP = 2 ** -4
K1_BF16_REL = 2 ** -8 + 1e-6      # K1 bf16 against float64: one bf16 rounding, float32's sums
# the 17 terms of multitask_loss's total, as its metrics name them
BF16_LOSS_TERMS = ('formula_loss', 'reinforce_loss', 'tc_loss', 'magpie_loss', 'kl_loss',
                   'stoich_loss', 'count_loss', 'tc_class_loss', 'constraint_zoo_loss',
                   'z_norm_penalty', 'stop_loss', 'type_loss', 'site_dup_loss', 'hp_loss',
                   'sc_loss', 'family_loss', 'physics_z_loss')


def k1_bf16_phase(torch, dev):
    """(b) K1 bf16 against its plain version at the bench paths' shapes
    (B=512, 1024; T=30, Dh=72) and run5's recipe's (B=12, 256) at every
    position, caches equal; then its device time beside the plain
    version's and SDPA's, averaged over positions 0..28, with the mean
    bytes bound.  Returns the kernels-line numbers at B=1024 and the
    largest error."""
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    h, t, dh = 8, 30, 72
    worst = 0.0
    rows = {}
    for label, sizes in (('bench', K1_BF16_B), ('k1 bf16 (run5 recipe)', K1_RECIPE_B)):
        positions = range(t) if label == 'bench' else K1_MAIN_POSITIONS
        for b in sizes:
            err = max(k1_held(torch, gen, b, h, t, dh, torch.bfloat16, p) for p in positions)
            print(f'{label}: K1 check bfloat16 B={b} T={t} Dh={dh} pos {list(positions)}: '
                  f'max_abs_err {err:.3e} (tol {K1_TOL["bfloat16"]}) caches_equal=True')
            worst = max(worst, err)
        rows.update({b: k1_position_means(torch, gen, b, h, t, dh, torch.bfloat16, label)
                     for b in sizes})
    torch.cuda.empty_cache()
    return rows[K1_BF16_B[-1]], worst


def bench_phase(torch, dev):
    """The port's bench at ModelConfig() in bf16 (batch 512, K1 in the
    rollouts): its train, RL and gen probes with random heads, as the bench
    runs them, then the gen probe again with the stop and type heads fixed
    (every rollout 29 steps); an SCST step under the profiler.  Checks (a)
    the bf16 path is real: float32 parameters and
    AdamW moments, bf16 logits and caches, finite losses, K1's bf16 instance
    launched 12 times a decode step of every probe rollout and nothing
    else; (c) a 29-step greedy rollout of 512 rows through K1 against the
    plain path; (d) one bf16 train step of 8 rows on the card against the
    CPU.  Returns K1 bf16's launches on the probes."""
    import math
    from superconductor_vae_tpu_torch import bench
    from superconductor_vae_tpu_torch.ops.decode_attention import decode_step_attention
    from superconductor_vae_tpu_torch.ops.fused_attention import flash_attention
    from superconductor_vae_tpu_torch.training import default_dyn, make_train_step

    def zero():
        decode_step_attention.launches = 0
        decode_step_attention.launches_by_dtype = dict.fromkeys(
            decode_step_attention.launches_by_dtype, 0)
        flash_attention.launches = 0

    def read():
        return (decode_step_attention.launches_by_dtype[torch.bfloat16],
                decode_step_attention.launches, flash_attention.launches)

    t0 = time.perf_counter()
    s = bench.build(device=dev)
    cfg = s.mcfg
    print(f'bench: ModelConfig() {dataclasses.asdict(cfg)}')
    print(f'bench: compute dtype {s.dtype}, batch {len(s.batch["tokens"])}, decode route '
          f'{bench.decode_route(s)}, built in {time.perf_counter() - t0:.1f} s; the standalone '
          f'bench runs train 20 steps, RL 1 + 3 chunks of {bench.RL_CHUNK}, gen 1 + 5 '
          f'calls; this phase train {BENCH_TRAIN_STEPS}, RL {BENCH_RL_CHUNKS[0]} + '
          f'{BENCH_RL_CHUNKS[1]}, gen {BENCH_GEN_CALLS[0]} + {BENCH_GEN_CALLS[1]}')
    # (a) float32 parameters, bf16 compute
    with torch.no_grad():
        z = s.state.encoder(s.batch['element_indices'][:4], s.batch['element_fractions'][:4],
                            s.batch['element_mask'][:4], s.batch['magpie'][:4],
                            s.batch['tc'][:4])
        logits = s.state.decoder(z['z'], s.batch['tokens'][:4], torch.zeros(
            4, cfg.stoich_input_dim, device=dev), torch.zeros(4, cfg.heads_input_dim,
                                                             device=dev))['logits']
    caches = s.state.decoder.init_cache(2)
    check(logits.dtype == torch.bfloat16 and caches[0].dtype == torch.bfloat16,
          f'bench: pre-boundary logits {logits.dtype}, caches {caches[0].dtype}: not bf16')
    del z, logits, caches

    def paths(heads, warm, names):
        """The probes ``names`` on the main path: counts at 0 just before
        each, read just after; K1's bf16 instance 12 x the decode steps of
        every rollout (warm-ups included), nothing else launched.
        ``warm``: with the probes' warm-up chunk and call (the second pass
        runs warm)."""
        out = {}
        probes = {'rl': lambda: bench.rl_probe(
                      s, chunks=BENCH_RL_CHUNKS[1], warm_chunks=BENCH_RL_CHUNKS[0] if warm else 0),
                  'gen': lambda: bench.gen_probe(
                      s, calls=BENCH_GEN_CALLS[1], warm_calls=BENCH_GEN_CALLS[0] if warm else 0)}
        for name in names:
            probe = probes[name]
            zero()
            r = probe()
            torch.cuda.synchronize()
            bf16, total, k2 = read()
            steps = (r['warm_decode_steps'] + r['decode_steps']
                     + r.get('round_trip_decode_steps', []))
            check(bf16 > 0, f'bench {name} ({heads}): K1 bf16 was not launched')
            check((bf16, total, k2) == (cfg.num_layers * sum(steps),) * 2 + (0,),
                  f'bench {name} ({heads}): K1 bf16 / all K1 / K2 launches {(bf16, total, k2)} '
                  f'!= layers x decode steps {cfg.num_layers * sum(steps)}, the same, 0')
            out[name] = (r, bf16)
        return out

    # the train probe: K1 in every step's round trip (a rollout of a tenth
    # of the batch, all max_len - 1 steps), warm-up included
    zero()
    train = bench.train_probe(s, steps=BENCH_TRAIN_STEPS)
    torch.cuda.synchronize()
    rt_steps = train['round_trip_decode_steps']
    train_k1 = read()[0]
    check(rt_steps == [cfg.max_len - 1] * (BENCH_TRAIN_STEPS + 1),
          f'bench train: round-trip rollouts {rt_steps}')
    check(read() == (cfg.num_layers * sum(rt_steps),) * 2 + (0,),
          f'bench train: K1 bf16 / all K1 / K2 launches {read()} != layers x the round '
          f'trips\' decode steps {cfg.num_layers * sum(rt_steps)}, the same, 0')
    t_probes = time.perf_counter()
    runs = {'random heads': paths('random heads', warm=True, names=('rl', 'gen'))}
    fix_rollout_heads(torch, s.state.decoder)
    # the heads-fixed pass runs gen alone (its RL probe went for the smoke's
    # time limit; the phase's (c) rolls out 29 steps with the heads fixed)
    runs['heads fixed'] = paths('heads fixed', warm=False, names=('gen',))
    print(f'bench: the probes\' two passes {time.perf_counter() - t_probes:.1f} s')
    # (a) parameters and moments float32 after the steps; losses finite
    for params, opt in s.state.groups():
        check(all(p.dtype == torch.float32 and opt.state[p]['exp_avg'].dtype == torch.float32
                  and opt.state[p]['exp_avg_sq'].dtype == torch.float32 for p in params),
              'bench: a parameter or AdamW moment is not float32')
    for name, m in [('train', train['metrics'])] + [
            (f'rl ({h})', r['rl'][0]['metrics']) for h, r in runs.items() if 'rl' in r]:
        bad = [k for k, v in m.items() if not math.isfinite(v)]
        check(not bad, f'bench {name}: metrics not finite: {bad}')
    n = len(s.batch['tokens'])
    print(f'bench: train {BENCH_TRAIN_STEPS} steps of {n} in {train["seconds"]:.3f} s = '
          f'{train["samples_per_s"]:.1f} train samples/s; peak {train["peak_gib"]:.2f} GiB; '
          f'total {train["metrics"]["total"]:.4f}, formula {train["metrics"]["formula_loss"]:.4f}, '
          f'a5_z_mse {train["metrics"]["a5_z_mse"]:.4f}, hungarian_loss '
          f'{train["metrics"]["hungarian_loss"]:.4f}; K1 bf16 launches {train_k1} (round trips '
          f'of {max(int(n * s.tcfg.round_trip_subset_fraction), 1)} rows, warm-up included)')
    launches = train_k1
    for heads, r in runs.items():
        if 'rl' in r:
            rl_r, rl_k1 = r['rl']
            launches += rl_k1
            print(f'bench: rl ({heads}): {rl_r["steps"]} SCST steps of {rl_r["rl_batch_size"]} '
                  f'in {rl_r["seconds"]:.3f} s = {rl_r["samples_per_s"]:.1f} RL samples/s; peak '
                  f'{rl_r["peak_gib"]:.2f} GiB; decode steps of each rollout '
                  f'{rl_r["warm_decode_steps"]} (warm) {rl_r["decode_steps"]}, and '
                  f'{len(rl_r["round_trip_decode_steps"])} round trips of '
                  f'{rl_r["round_trip_decode_steps"][0]}; K1 bf16 launches '
                  f'{rl_k1}; reinforce {rl_r["metrics"]["reinforce_loss"]:.4f}, mean_reward '
                  f'{rl_r["metrics"]["mean_reward"]:.4f}')
        gen_r, gen_k1 = r['gen']
        launches += gen_k1
        print(f'bench: gen ({heads}): {gen_r["calls"]} calls of {n} in {gen_r["seconds"]:.3f} s '
              f'= {gen_r["formulas_per_s"]:.1f} formulas/s; decode steps {gen_r["decode_steps"]}; '
              f'K1 bf16 launches {gen_k1}')
    # (gen casting the weights at every call, against once a rollout, went
    # for the smoke's time limit)

    # (the bf16 train step's trace went for the smoke's time limit)
    rl_tcfg = dataclasses.replace(s.tcfg, rl=dataclasses.replace(s.tcfg.rl, max_len=cfg.max_len))
    trace_batch(torch, lambda: make_train_step(rl_tcfg, s.luts, rl_enabled=True)(
        s.state, s.batch, 8, dict(default_dyn(rl_tcfg), rl_w=1.0)),
        f'one bf16 SCST step of {n} (heads fixed)', own='decode_attention_kernel')
    t_c = time.perf_counter()
    bf16_rollout_check(torch, dev, s)
    del s
    torch.cuda.empty_cache()
    t_d = time.perf_counter()
    bf16_step_check(torch, dev)
    print(f'bench: (c) {t_d - t_c:.1f} s, (d) {time.perf_counter() - t_d:.1f} s')
    return launches, runs


@contextlib.contextmanager
def _patched(module, name, value):
    original = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, original)


class K1Probe:
    """Stands in for the decoder's K1 while entered: launches it, and holds
    its output against the plain version in bf16
    (``decode_step_attention_ref``) and the float64 attention of the same
    bf16 inputs, keeping the largest difference of each from float64 over
    the largest float64 output (``worst``), and the share of outputs where
    K1 and the plain version differ."""

    def __init__(self, torch):
        from superconductor_vae_tpu_torch.models import decoder as decoder_module
        from superconductor_vae_tpu_torch.ops.decode_attention import decode_step_attention
        self.torch, self.module, self.k1 = torch, decoder_module, decode_step_attention
        self.worst = {'k1': 0.0, 'plain': 0.0}
        self.apart, self.outputs = 0, 0

    def __call__(self, q, k_new, v_new, k_cache, v_cache, position):
        import math
        from superconductor_vae_tpu_torch.ops.decode_attention import decode_step_attention_ref
        torch = self.torch
        kc, vc = k_cache.clone(), v_cache.clone()
        out = self.k1(q, k_new, v_new, k_cache, v_cache, position)
        plain = decode_step_attention_ref(q, k_new, v_new, kc, vc, position)
        n = position + 1
        s = torch.einsum('bhd,bhtd->bht', q.double(), kc[:, :, :n].double()) / math.sqrt(
            q.shape[-1])
        f64 = torch.einsum('bht,bhtd->bhd', torch.softmax(s, dim=-1), vc[:, :, :n].double())
        scale = f64.abs().max().item()
        for name, o in (('k1', out), ('plain', plain)):
            self.worst[name] = max(self.worst[name],
                                   (o.double() - f64).abs().max().item() / scale)
        self.apart += int((out != plain).sum())
        self.outputs += out.numel()
        return out

    def __enter__(self):
        self.module.decode_step_attention = self
        return self

    def __exit__(self, *exc):
        self.module.decode_step_attention = self.k1


def bf16_rollout_check(torch, dev, s):
    """(c) A greedy rollout of the batch's 512 rows in bf16 through K1, the
    stop and type heads fixed (29 steps), against the plain decode path
    with the same weights.  First, over K1's stream forced into every path,
    the largest difference of the token logits and of the top two type
    logits of K1 bf16 and of the plain bf16 path from the float32 decode of
    the same weights, and of the two bf16 paths from each other; at every
    K1 call, K1 and its plain version in bf16 against the float64 attention
    of the same inputs (``K1Probe``).  Then the streams, equal except where
    the top two gated logits, or the top two type logits (which pick the
    type mask), were within twice the two bf16 paths' largest difference in
    either run.  K1 bf16's distance from float32 must be at most min(3 x the
    plain bf16 path's, BF16_CAP), and at each call K1 within K1_BF16_REL of
    float64."""
    from superconductor_vae_tpu_torch import bench
    from superconductor_vae_tpu_torch.generation import generate_with_kv_cache
    from superconductor_vae_tpu_torch.models import FormulaDecoder
    from superconductor_vae_tpu_torch.models.layers import cast_weights_once
    from superconductor_vae_tpu_torch.tokenizer import BOS_ID, EOS_ID
    from superconductor_vae_tpu_torch.training import stoich_conditioning
    cfg, bt = s.mcfg, s.batch
    enc, k1 = s.state.encoder.eval(), s.state.decoder.eval()
    plain_cfg = dataclasses.replace(cfg, pallas_decode=False)
    plain = FormulaDecoder(plain_cfg, device=dev, dtype=s.dtype).eval()
    plain.load_state_dict(k1.state_dict())
    f32 = FormulaDecoder(plain_cfg, device=dev, dtype=torch.float32).eval()
    f32.load_state_dict(k1.state_dict())
    gcfg = bench.gen_config(cfg)
    with torch.no_grad():
        out = enc(bt['element_indices'], bt['element_fractions'], bt['element_mask'],
                  bt['magpie'], bt['tc'])
        cond = (out['z'], stoich_conditioning(bt), enc.heads_pred_for_decoder(out))
        runs = [generate_with_kv_cache(d, *cond, None, gcfg, type_masks=s.luts['type_masks'])
                for d in (k1, plain)]
        n_steps = steps_run(runs[0]['tokens'], EOS_ID)
        check(n_steps == cfg.max_len - 1, f'bench (c): the rollout ran {n_steps} steps')
        keys = ('logits', 'type_logits')
        worst = {pair: dict.fromkeys(keys, 0.0)
                 for pair in ('k1 vs plain', 'k1 vs f32', 'plain vs f32')}
        type_gap = [torch.zeros_like(r['margin']) for r in runs]
        decoders = (k1, plain, f32)
        with cast_weights_once(k1), cast_weights_once(plain), K1Probe(torch) as probe:
            state = []
            for d in decoders:
                c = tuple(x.float() for x in cond) if d is f32 else cond
                mkv = d.memory_kv(d.build_memory(*c))
                state.append((mkv, *d.init_cache(len(bt['tokens']))))
            tok = torch.full_like(runs[0]['tokens'][:, 0], BOS_ID)
            for pos in range(n_steps):
                heads = [d.decode_step(tok, pos, kc, vc, mkv)[0]
                         for d, (mkv, kc, vc) in zip(decoders, state)]
                # the type logits that pick the mask: the top two of each run
                top2 = [h['type_logits'].float().topk(2, dim=-1).values for h in heads]
                for (a, b), pair in (((0, 1), 'k1 vs plain'), ((0, 2), 'k1 vs f32'),
                                     ((1, 2), 'plain vs f32')):
                    w = worst[pair]
                    w['logits'] = max(w['logits'], (heads[a]['logits'].float()
                                                    - heads[b]['logits'].float()).abs().max().item())
                    w['type_logits'] = max(w['type_logits'],
                                           (top2[a] - top2[b]).abs().max().item())
                for gap, t2 in zip(type_gap, top2):
                    gap[:, pos] = t2[:, 0] - t2[:, 1]
                tok = runs[0]['tokens'][:, pos]
    for pair, w in worst.items():
        print(f'bench (c): {pair} over K1\'s stream ({n_steps} steps, {len(tok)} rows): largest '
              f'difference of the token logits {w["logits"]:.4f}, of the top two type logits '
              f'{w["type_logits"]:.4f}')
    print(f'bench (c): K1 bf16 at each of its {probe.outputs // (len(tok) * cfg.nhead * cfg.head_dim)} '
          f'calls against the float64 attention of the same bf16 inputs, largest error over the '
          f'largest output: K1 {probe.worst["k1"]:.3e}, its plain version in bf16 '
          f'{probe.worst["plain"]:.3e}; outputs where the two differ '
          f'{probe.apart / probe.outputs:.4%}')
    for key in keys:
        bound = min(3 * worst['plain vs f32'][key], BF16_CAP)
        check(worst['k1 vs f32'][key] <= bound,
              f'bench (c): K1 bf16\'s {key} {worst["k1 vs f32"][key]:.4f} from float32, over '
              f'min(3 x the plain bf16 path\'s {worst["plain vs f32"][key]:.4f}, {BF16_CAP})')
    check(probe.worst['k1'] <= K1_BF16_REL,
          f'bench (c): K1 bf16 {probe.worst["k1"]:.3e} from float64, over {K1_BF16_REL:.3e}')
    # a step is a near-tie if its gated logits' or its type logits' top two
    # were within twice the two paths' largest difference on the forced stream
    tie = 2 * max(worst['k1 vs plain'].values())
    got, want = ({'generated': r['tokens'], 'margin': torch.minimum(r['margin'], gap)}
                 for r, gap in zip(runs, type_gap))
    excused = compare_streams(got, want, EOS_ID, 'bench (c) K1 vs plain, bf16', tie=tie)
    print(f'bench (c): K1 bf16 within min(3 x the plain path\'s distance, {BF16_CAP}) of float32 '
          f'and within {K1_BF16_REL:.3e} of float64; greedy bf16 streams of {len(tok)} rows '
          f'through K1 equal the plain path\'s; rows excused as near-ties (gap under {tie:.4f}) '
          f'{excused}')
    s.state.encoder.train()
    s.state.decoder.train()


def bf16_step_pairs(torch, dev, cfg):
    """One bf16 train step of 8 rows at ``cfg``, dropout off, physics-Z
    weight 1 (so that every group has a gradient), from the same seed on
    the card and on the CPU, and in float32 on the CPU.  Returns
    [(what, card bf16 vs CPU bf16, CPU bf16 vs CPU float32)] for the 17
    loss terms with the total (each relative to its float32 value, the
    largest), each group's AdamW first moment (relative L2 norm) and its
    parameter update (L1 norm with each element weighted by its float32
    gradient's magnitude, relative: the update's first-order effect on
    the loss; a first AdamW update is lr * sign(g) plus the decay, so two
    runs part only where g is near 0)."""
    from superconductor_vae_tpu_torch.data import synthetic_dataset
    from superconductor_vae_tpu_torch.tokenizer import default_tokenizer
    from superconductor_vae_tpu_torch.training import (
        TrainConfig, build_luts, create_train_state, default_dyn, make_train_step)
    from superconductor_vae_tpu_torch.training.evaluate import _to_device
    import numpy as np
    data = synthetic_dataset(n=N_CPU_ROWS, max_len=cfg.max_len, magpie_dim=cfg.magpie_dim,
                             seed=SEED + 3).batch(np.arange(N_CPU_ROWS))
    terms = BF16_LOSS_TERMS + ('total',)
    runs = {}
    for name, where, dtype in (('card bf16', dev, 'bfloat16'),
                               ('cpu bf16', torch.device('cpu'), 'bfloat16'),
                               ('cpu f32', torch.device('cpu'), 'float32')):
        t0 = time.perf_counter()
        tcfg = TrainConfig(batch_size=N_CPU_ROWS, max_formula_len=cfg.max_len,
                           use_physics_z=True, compute_dtype=dtype,
                           hungarian_enabled=False, use_round_trip=False)
        st = create_train_state(cfg, tcfg, seed=SEED + 3, device=where)
        before = _group_tensors(st)
        st, m = make_train_step(tcfg, build_luts(default_tokenizer(max_len=cfg.max_len),
                                                 device=where))(
            st, _to_device(data, where), SEED, dict(default_dyn(tcfg), physz_w=1.0))
        after = _group_tensors(st)
        runs[name] = (np.array([m[k].item() for k in terms]),
                      {g: (torch.cat([v[1].flatten().cpu() for v in after[g].values()]),
                           torch.cat([(v[0] - before[g][k][0]).flatten().cpu()
                                      for k, v in after[g].items()])) for g in after})
        del st
        print(f'bench (d): {name} step of {N_CPU_ROWS} rows in '
              f'{time.perf_counter() - t0:.1f} s: total {runs[name][0][-1]:.6f}')
    (mc, tc_), (mb, tb), (mf, tf) = runs['card bf16'], runs['cpu bf16'], runs['cpu f32']
    scale = np.maximum(np.abs(mf), 1e-30)
    pairs = [('17 loss terms and total (largest, relative to float32)',
              (np.abs(mc - mb) / scale).max(), (np.abs(mb - mf) / scale).max())]
    for g in tb:
        ref = tf[g][0].norm().item()
        pairs.append((f'{g} AdamW mu (relative L2)', (tc_[g][0] - tb[g][0]).norm().item() / ref,
                      (tb[g][0] - tf[g][0]).norm().item() / ref))
        weight = tf[g][0].abs()
        ref = (weight * tf[g][1].abs()).sum().item()
        pairs.append((f'{g} update (|g|-weighted L1, relative)',
                      (weight * (tc_[g][1] - tb[g][1]).abs()).sum().item() / ref,
                      (weight * (tb[g][1] - tf[g][1]).abs()).sum().item() / ref))
    return pairs


def bf16_step_check(torch, dev):
    """(d) One bf16 train step of 8 rows at ModelConfig(), card against CPU
    (``bf16_step_pairs``).  The 17 loss terms with the total and each
    group's AdamW first moment (the clipped gradient, which sets the
    update) must be within half of the CPU's own bf16-vs-float32
    difference, which a card step that ran in float32 would be a whole
    difference away from.  The updates are printed beside them, not held:
    a first AdamW update is lr * sign(g) plus the decay, so it differs only
    where a gradient changes sign, and two bf16 implementations (cuBLAS
    and oneDNN here) part chaotically through the 12 layers wherever one
    rounding differed, which flips the signs of near-zero gradients about
    as often as float32 against bf16 does."""
    from superconductor_vae_tpu_torch.models import ModelConfig
    cfg = dataclasses.replace(ModelConfig(), dropout=0.0)
    for what, err, gap in bf16_step_pairs(torch, dev, cfg):
        held = 'update' not in what
        print(f'bench (d): {what}: card bf16 vs CPU bf16 {err:.3e}; CPU bf16 vs CPU float32 '
              f'{gap:.3e}; ' + (f'tolerance {gap / 2:.3e} (half); ratio {err / gap:.3f}' if held
                                else f'ratio {err / gap:.3f} (printed, not held)'))
        if held:
            check(err <= gap / 2, f'bench (d): card and CPU bf16 disagree on {what}: '
                  f'{err:.3e} > {gap / 2:.3e}')


# -- loop phase -----------------------------------------------------------------

# the first rows of the loaded corpus, 4 steps of 256 an epoch (a default
# step, with its round trip, takes about 0.5 s)
LOOP_ROWS = 1024
LOOP_E_ROWS = 512                 # (e)'s epochs: 2 steps, for the smoke's time limit
LOOP_EPOCHS = (4, 5)              # epochs after the first call, after the resume
LOOP_DIR = ROOT / 'outputs' / 'chip_smoke_loop'


def profile_counts(torch, fn):
    """``fn`` under torch.profiler: (wall ms, device busy ms, kernel
    launches).  Device activity only: the host's op events of an epoch
    (about 60,000 launches) take the profiler longer to gather than the
    epoch takes to run."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    device = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and not getattr(e, 'is_user_annotation', False)]
    kernels = [e for e in device if not e.key.startswith('Memcpy') and
               not e.key.startswith('Memset')]
    busy = sum(e.self_device_time_total for e in device) / 1e3
    return wall, busy, sum(e.count for e in kernels)


def host_syncs(torch, fn):
    """``fn()`` under ``torch.cuda.set_sync_debug_mode('warn')``: (its
    result, the operations in it that made the host wait for the card,
    counted by the file and line that called them)."""
    import collections
    import warnings
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('warn')
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter('always')
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode('default')
    return out, collections.Counter(f'{Path(w.filename).name}:{w.lineno}' for w in caught
                                    if 'synchronizing CUDA operation' in str(w.message))


class Timings:
    """Stands in for each ``owner.name`` of ``targets`` ((owner, name) or
    (owner, name, label): a module's function, a class's or an object's
    method) while entered and keeps (seconds, result) of each call by
    label, and (label, start, end) of each call in order.  The card is
    synchronised at the end of each call but those of the host functions
    labelled in ``host``."""

    def __init__(self, torch, *targets, host=()):
        self.torch, self.targets, self.host = torch, targets, host
        self.calls, self.events = {}, []

    def _wrap(self, name, fn):
        sync = name not in self.host

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            if sync:
                self.torch.cuda.synchronize()
            t1 = time.perf_counter()
            self.calls.setdefault(name, []).append((t1 - t0, out))
            self.events.append((name, t0, t1))
            return out
        return timed

    def __enter__(self):
        self.originals = [(t[0], t[1], getattr(t[0], t[1])) for t in self.targets]
        for (owner, name, fn), t in zip(self.originals, self.targets):
            setattr(owner, name, self._wrap(t[-1] if len(t) > 2 else name, fn))
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self.originals:
            setattr(owner, name, fn)

    def seconds(self, name, lo=0.0, hi=float('inf')):
        """Seconds of the calls of ``name`` that started in [lo, hi)."""
        return sum(e - s for n, s, e in self.events if n == name and lo <= s < hi)

    def first(self, name, lo=0.0):
        """Start of the first call of ``name`` at or after ``lo``."""
        return min((s for n, s, _ in self.events if n == name and s >= lo), default=None)


def loop_config(cfg, **kw):
    """The loop phase's TrainConfig: TrainConfig()'s defaults (the set
    decoder and the round trip on) at batch 256, an eval of 2 batches every
    epoch, a checkpoint every 2 epochs, and RL (SCST, rl_w 1 ramped by its
    warm-up) activated at epoch 1 by its plateau rule, every 4th epoch from
    there: epoch 1 is the one RL epoch, the others teacher-forced."""
    from superconductor_vae_tpu_torch.ops.rl import RLConfig
    from superconductor_vae_tpu_torch.training import TrainConfig
    return TrainConfig(**dict(
        num_epochs=LOOP_EPOCHS[0], batch_size=BATCH, max_formula_len=cfg.max_len,
        skew_transform='rank_gauss',
        eval_interval=1, eval_max_batches=2, checkpoint_interval=2,
        rl_weight=0.0, rl_reactivation_min_exact=0.0, rl_reactivation_window=2,
        rl_reactivation_force_exact=1.0, rl_min_ar_exact=0.0, rl_epoch_interval=4,
        rl=RLConfig(max_len=cfg.max_len)) | kw)


def _same_tree(a, b):
    """Nested dicts and lists of tensors (card or host) equal bit for bit."""
    if hasattr(a, 'dtype') and hasattr(a, 'cpu'):
        return a.dtype == b.dtype and a.shape == b.shape and bool((a.cpu() == b.cpu()).all())
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same_tree(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same_tree(x, y) for x, y in zip(a, b))
    return a == b


def loop_phase(torch, dev, ds, step_rate):
    """training/train_loop.py train() at run4's architecture in float32 on
    the first LOOP_ROWS rows, with K1 in the eval's and the RL epoch's
    rollouts, then a resume for one more epoch.  Checks (a) the loop ran:
    the epochs' rows, finite losses, the metrics CSV appended across the
    resume; (b) K1 launched 12 times a decode step of every eval and RL
    rollout; (c) the checkpoint round trip: what load_checkpoint gives back
    equals the saved state bit for bit, the controllers too, and the resume
    starts at the saved epoch + 1; (d) one accumulated update (k=2) of 8
    rows on the card against the CPU, and its accumulators through a
    save and a load; (e) one epoch of make_epoch_runner under the
    profiler (the device's busy share) and under the sync debug mode: no
    operation of the epoch makes the host wait for the card, and its one
    read of the sums does.  Returns K1's launches."""
    import math
    import shutil
    import numpy as np
    from superconductor_vae_tpu_torch.analysis import TopologyAnalyzer
    from superconductor_vae_tpu_torch.checkpoint import load_checkpoint
    from superconductor_vae_tpu_torch.generation.latent_analyzer import LatentSpaceAnalyzer
    from superconductor_vae_tpu_torch.models import ModelConfig, config_from_meta
    from superconductor_vae_tpu_torch.ops import rl, round_trip
    from superconductor_vae_tpu_torch.ops.decode_attention import decode_step_attention
    from superconductor_vae_tpu_torch.tokenizer import EOS_ID
    from superconductor_vae_tpu_torch.training import evaluate, train, train_loop

    t_phase = time.perf_counter()
    meta = json.loads(META.read_text())
    cfg = config_from_meta(meta['model_config'], pallas_decode=True)
    check(cfg == ModelConfig(magpie_dim=ds.magpie_dim, pallas_decode=True),
          "loop: run4's config is not ModelConfig() at the corpus's magpie_dim")
    sub = ds.subset(np.arange(LOOP_ROWS))
    shutil.rmtree(LOOP_DIR, ignore_errors=True)
    logs = []
    calls = []
    with CallLog(evaluate, 'generate_with_kv_cache') as gen_log, \
            CallLog(rl, '_rollout') as rl_log, \
            CallLog(round_trip, 'generate_with_kv_cache') as rt_log, \
            Timings(torch, (train_loop, 'save_checkpoint'), (train_loop, 'evaluate_autoregressive'),
                    (LatentSpaceAnalyzer, 'build_cache'),
                    (TopologyAnalyzer, 'analyze')) as timings:
        decode_step_attention.launches = 0
        for kw in (dict(), dict(num_epochs=LOOP_EPOCHS[1], resume='auto')):
            t0 = time.perf_counter()
            out = train(model_config=cfg, train_config=loop_config(cfg, **kw), dataset=sub,
                        output_dir=LOOP_DIR, log_fn=logs.append, device=dev)
            torch.cuda.synchronize()
            calls.append((out, time.perf_counter() - t0))
        launches = decode_step_attention.launches
    t_parts = {'train() calls': time.perf_counter() - t_phase}
    for line in logs:
        print(f'loop: {line}')
    (first, first_s), (resumed, resumed_s) = calls
    hist = first['history'] + resumed['history']
    # (a) the epochs, finite losses, one CSV row an epoch across both calls
    check([r['epoch'] for r in hist] == list(range(LOOP_EPOCHS[1])),
          f'loop: epochs {[r["epoch"] for r in hist]}')
    for r in hist:
        bad = [k for k in ('total', 'formula_loss', 'tc_loss') if not math.isfinite(r[k])]
        check(not bad, f'loop: epoch {r["epoch"]}: {bad} not finite')
    rows = (LOOP_DIR / 'training_metrics.csv').read_text().splitlines()
    check([int(x.split(',')[0]) for x in rows[1:]] == list(range(LOOP_EPOCHS[1])),
          f'loop: the metrics CSV holds {rows[1:]}')
    kinds = ['RL' if r['rl_weight'] > 0 else 'TF' for r in hist]
    check(kinds.count('RL') == 1 and kinds[1] == 'RL', f'loop: epoch kinds {kinds}')
    for r, kind in zip(hist, kinds):
        print(f'loop: epoch {r["epoch"]} ({kind}{", first use" if r["epoch"] == 0 else ""}): '
              f'{r["samples_per_s"]} samples/s in {r["epoch_time_s"]} s; total '
              f'{r["total"]:.4f}, rl_weight {r["rl_weight"]:.3f}, true-AR {r["true_ar_exact"]}')
    tf_rates = [r['samples_per_s'] for r, k in zip(hist[1:], kinds[1:]) if k == 'TF']
    print(f'loop: TF epochs after the first {tf_rates} samples/s; the train phase\'s step alone '
          f'{step_rate:.1f} samples/s in this call (epoch / step {min(tf_rates) / step_rate:.3f}'
          f'-{max(tf_rates) / step_rate:.3f})')
    # (b) K1 at every decode step of every eval, RL and round-trip rollout
    eval_steps = [steps_run(o['tokens'], EOS_ID) for o in gen_log.outputs]
    rl_steps = [steps_run(o['tokens'], EOS_ID) for o in rl_log.outputs]
    rt_steps = [o['tokens'].shape[1] for o in rt_log.outputs]      # no early exit
    print(f'loop: eval rollouts {len(eval_steps)} (decode steps {eval_steps}); RL rollouts '
          f'{len(rl_steps)} of {2 * BATCH} rows (decode steps {rl_steps}); round-trip rollouts '
          f'{len(rt_steps)} of {rt_log.outputs[0]["tokens"].shape[0]} rows, '
          f'{cfg.max_len - 1} steps each; K1 launches {launches}')
    n_steps = LOOP_EPOCHS[1] * (LOOP_ROWS // BATCH)
    check(len(eval_steps) == 2 * LOOP_EPOCHS[1] and len(rl_steps) == LOOP_ROWS // BATCH
          and rt_steps == [cfg.max_len - 1] * n_steps,
          'loop: eval, RL or round-trip rollouts missing')
    check(launches > 0, 'loop: K1 was not launched')
    all_steps = sum(eval_steps) + sum(rl_steps) + sum(rt_steps)
    check(launches == cfg.num_layers * all_steps,
          f'loop: K1 launches {launches} != layers x decode steps {cfg.num_layers * all_steps}')
    # (c) the checkpoint round trip on the card
    saves = [(path.name, secs, sum(f.stat().st_size for f in path.iterdir()))
             for secs, path in timings.calls.pop('save_checkpoint')]
    for name, timed in timings.calls.items():
        print(f'loop: {name}: ' + ', '.join(f'{secs:.2f}' for secs, _ in timed) + ' s')
    for name, secs, size in saves:
        print(f'loop: save {name}: {secs:.2f} s, {size / 1e9:.3f} GB '
              f'({size / 1e9 / secs:.2f} GB/s)')
    last = f'epoch_{LOOP_EPOCHS[0] - 1:05d}'
    check(last in [name for name, _, _ in saves], f'loop: saves {saves}')
    t0 = time.perf_counter()
    restored, saved_meta = load_checkpoint(LOOP_DIR / 'checkpoints' / last)
    load_s = time.perf_counter() - t0
    st = first['state']
    live = {'step': st.step, 'enc_params': st.encoder.state_dict(),
            'dec_params': st.decoder.state_dict(), 'pz_params': st.pz_proj.state_dict(),
            'set_params': st.set_decoder.state_dict(),
            'enc_opt': st.enc_opt.state_dict(), 'dec_opt': st.dec_opt.state_dict(),
            'pz_opt': st.pz_opt.state_dict(), 'set_opt': st.set_opt.state_dict()}
    for key, value in live.items():
        check(_same_tree(restored[key], value), f'loop: {key} differs after load_checkpoint')
    check(saved_meta['controllers'] == json.loads(json.dumps(first['controllers'])),
          'loop: the controllers differ after load_checkpoint')
    check(resumed['history'][0]['epoch'] == saved_meta['epoch'] + 1,
          'loop: the resume did not start at the saved epoch + 1')
    print(f'loop: load_checkpoint {load_s:.2f} s: params, AdamW moments and step counts of '
          f'the four groups (the set decoder\'s set_params and set_opt included), step '
          f'{restored["step"]}, and the controllers equal the saved state bit for bit; the '
          f'resume started at epoch {saved_meta["epoch"] + 1}')
    state = resumed['state']
    del first, resumed, restored, live, st
    # the Phase-2 phase's standalone CLI starts from this checkpoint
    shutil.rmtree(PHASE2_DIR, ignore_errors=True)
    PHASE2_DIR.mkdir(parents=True)
    os.replace(LOOP_DIR / 'checkpoints' / last, PHASE2_DIR / 'loop_checkpoint')
    shutil.rmtree(LOOP_DIR / 'checkpoints')
    torch.cuda.empty_cache()
    t_parts['(a)-(c)'] = time.perf_counter() - t_phase - sum(t_parts.values())
    accumulation_check(torch, dev, cfg)
    t_parts['(d)'] = time.perf_counter() - t_phase - sum(t_parts.values())
    epoch_runner_check(torch, dev, cfg, sub, state, step_rate)
    t_parts['(e)'] = time.perf_counter() - t_phase - sum(t_parts.values())
    shutil.rmtree(LOOP_DIR, ignore_errors=True)
    print(f'loop: train() {calls[0][1]:.1f} s ({LOOP_EPOCHS[0]} epochs) + {calls[1][1]:.1f} s '
          f'(resume, 1 epoch); the phase {time.perf_counter() - t_phase:.1f} s: '
          + ', '.join(f'{k} {v:.1f} s' for k, v in t_parts.items()))
    return launches


def accumulation_check(torch, dev, cfg):
    """(d) One accumulated update (k=2, two mini-steps of 4 rows) at run4's
    widths with 2 of its 12 layers (the train phase holds the whole depth
    card against CPU), dropout off, on the card and on the CPU from the
    same seed:
    every mini-step's metrics, then each group's AdamW first moment and
    update (``check_updates``); the card's accumulators after the first
    mini-step through save_checkpoint and load_checkpoint, bit for bit."""
    import numpy as np
    from superconductor_vae_tpu_torch.checkpoint import load_checkpoint, save_checkpoint
    from superconductor_vae_tpu_torch.data import synthetic_dataset
    from superconductor_vae_tpu_torch.training import (
        build_luts, create_train_state, default_dyn, make_train_step)
    from superconductor_vae_tpu_torch.training.evaluate import _to_device
    from superconductor_vae_tpu_torch.tokenizer import default_tokenizer
    cfg0 = dataclasses.replace(cfg, num_layers=2, dropout=0.0, pallas_decode=False)
    tcfg = loop_config(cfg0, accumulation_steps=2, batch_size=N_CPU_ROWS // 2)
    data = synthetic_dataset(n=N_CPU_ROWS, max_len=cfg.max_len, magpie_dim=cfg.magpie_dim,
                             seed=SEED + 4)
    dyn = dict(default_dyn(tcfg), physz_w=1.0)
    runs = []
    for where in (dev, torch.device('cpu')):
        st = no_set_dropout(create_train_state(cfg0, tcfg, seed=SEED + 4, device=where))
        step = make_train_step(tcfg, build_luts(default_tokenizer(max_len=cfg.max_len),
                                                device=where))
        before = _group_tensors(st)
        metrics = []
        for half in range(2):
            st, m = step(st, _to_device(data.batch(np.arange(half * 4, half * 4 + 4)), where),
                         SEED, dyn)
            metrics.append(m)
            if half == 0 and where == dev:
                acc = [[a.clone() for a in opt.acc_grads] for _, opt in st.groups()]
                check(all(opt.mini_step == 1 for _, opt in st.groups()), 'loop (d): mini-step')
                unmoved = _group_tensors(st)
                check(all(torch.equal(before[g][k][0], unmoved[g][k][0])
                          for g in before for k in before[g]),
                      'loop (d): parameters moved between updates')
                path = save_checkpoint(LOOP_DIR / 'accumulation', st, cfg0, tcfg, epoch=0)
                restored, _ = load_checkpoint(path)
                check(all(_same_tree(restored[name]['acc_grads'], a) for name, a in
                          zip(('enc_opt', 'dec_opt', 'pz_opt', 'set_opt'), acc)),
                      'loop (d): the accumulators differ after load_checkpoint')
                check(restored['enc_opt']['mini_step'] == 1, 'loop (d): the mini-step')
                del restored
                print(f'loop (d): after the first mini-step: parameters unmoved; the '
                      f'accumulators of the {len(acc)} groups equal through save and load')
        runs.append((metrics, before, _group_tensors(st)))
        check(all(int(opt.state[p]['step']) == 1 for params, opt in st.groups()
                  for p in params), 'loop (d): AdamW did not count one update')
        del st
    (m_c, before_c, after_c), (m_h, before_h, after_h) = runs
    for i in range(2):
        check_metrics('loop (d)', m_c[i], m_h[i], f'mini-step {i + 1} metrics')
    check_updates(torch, 'loop (d)', before_c, after_c, before_h, after_h, tcfg.learning_rate)


def epoch_runner_check(torch, dev, cfg, sub, st, step_rate):
    """(e) One teacher-forced epoch of make_epoch_runner (LOOP_E_ROWS /
    BATCH steps over the device-resident rows) from the resumed run's state
    ``st``, with the host's one read of its metric sums: under the
    profiler, the device's busy share; under the sync debug mode, the
    epoch without its read makes the host wait for the card at no
    operation, and the read does (so the mode sees the copy).  Then epochs
    through the runner and through the per-batch path (a host gather and a
    copy a step), one of each, timed."""
    import numpy as np
    from superconductor_vae_tpu_torch.data import WeightedEpochSampler
    from superconductor_vae_tpu_torch.tokenizer import default_tokenizer
    from superconductor_vae_tpu_torch.training import (
        build_luts, default_dyn, make_epoch_runner, make_train_step)
    from superconductor_vae_tpu_torch.training.evaluate import _to_device
    from superconductor_vae_tpu_torch.training.train_loop import _read_sums
    tcfg = loop_config(cfg)
    luts = build_luts(default_tokenizer(max_len=cfg.max_len), device=dev)
    sub = sub.subset(np.arange(LOOP_E_ROWS))
    data = _to_device(sub.batch(np.arange(len(sub))), dev)
    sampler = WeightedEpochSampler(np.ones(len(sub)), BATCH, seed=SEED)
    run = make_epoch_runner(tcfg, luts)
    step = make_train_step(tcfg, luts)
    dyn = default_dyn(tcfg)
    n_steps = sampler.n_batches()

    def runner_epoch(e, read=True):
        nonlocal st
        st, sums = run(st, data, np.stack(list(sampler.epoch(e))), 1, dyn)
        return _read_sums(sums, n_steps) if read else sums

    def per_batch_epoch(e):
        nonlocal st
        sums = {}
        for idx in sampler.epoch(e):
            st, m = step(st, _to_device(sub.batch(idx), dev), 1, dyn)
            sums = {k: sums[k] + v if k in sums else v for k, v in m.items()}
        return _read_sums(sums, n_steps)

    wall, busy, n_kernels = profile_counts(torch, lambda: runner_epoch(1))
    check(busy > 0, 'loop (e): the profiler recorded no device time')
    print(f'loop (e): one epoch of make_epoch_runner ({n_steps} steps of {BATCH}) with the '
          f'read of its sums: wall {wall:.1f} ms, device busy {busy:.1f} ms '
          f'({100 * busy / wall:.1f}%), {n_kernels} launches')
    sums, epoch_syncs = host_syncs(torch, lambda: runner_epoch(2, read=False))
    _, read_syncs = host_syncs(torch, lambda: _read_sums(sums, n_steps))
    print(f'loop (e): operations that made the host wait for the card: in an epoch of '
          f'{n_steps} steps {dict(epoch_syncs)}, in the read of its sums {dict(read_syncs)}')
    check(not epoch_syncs, f'loop (e): the epoch made the host wait at {dict(epoch_syncs)}')
    check(sum(read_syncs.values()) >= 1, 'loop (e): the sync debug mode missed the read')
    rates = {'runner': [], 'per batch': []}
    for i, how in enumerate(('runner', 'per batch')):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (runner_epoch if how == 'runner' else per_batch_epoch)(3 + i)
        rates[how].append(n_steps * BATCH / (time.perf_counter() - t0))
    print('loop (e): TF epochs, one of each: ' + '; '.join(
        f'{how} ' + ', '.join(f'{x:.1f}' for x in v) + ' samples/s' for how, v in rates.items())
        + f'; the train phase\'s step alone {step_rate:.1f}')
    del st, data
    torch.cuda.empty_cache()


# -- Phase-2 phase --------------------------------------------------------------

# Phase 2's rollouts: n_samples / 2 rows each, B=32 at TrainConfig's
# phase2_n_samples (64) and B=128 at the standalone CLI's default (256)
# -- resume phase ---------------------------------------------------------------

RUN5_RECIPE = ROOT / 'superconductor_vae_tpu_torch' / 'scripts' / 'launch_run5.sh'
RESUME_DIR = ROOT / 'outputs' / 'chip_smoke_resume'
RESUME_LIMIT = 256                # run5 corpus rows; order augmentation K=1 nearly doubles them
RESUME_EPOCHS = 902               # after run4's epoch 899: 900 (teacher-forced) and 901 (RL)


def recipe_flags(path):
    """The training CLI's flags in a run recipe: the words after ``--`` on
    its ``exec`` line, continuation lines joined."""
    import shlex
    text = path.read_text().replace('\\\n', ' ')
    words = shlex.split(next(line for line in text.splitlines() if line.startswith('exec ')))
    return words[words.index('--') + 1:]


def with_flags(flags, **values):
    """``flags`` with the value of each ``--name`` in ``values`` (underscores
    for dashes) replaced, or the pair appended."""
    out = list(flags)
    for name, value in values.items():
        flag = '--' + name.replace('_', '-')
        if flag in out:
            out[out.index(flag) + 1] = str(value)
        else:
            out += [flag, str(value)]
    return out


class FirstEpochState:
    """While entered, keeps the state that train_loop.train() builds and,
    at the first epoch's learning-rate update (after the resume, before
    any step), a copy of its four modules' parameters on the host, its
    step and whether its optimizers hold any state."""

    def __init__(self, train_loop):
        self.loop, self.state, self.params = train_loop, None, None
        self.create, self.set_lr = train_loop.create_train_state, train_loop.set_learning_rate

    def _create(self, *args, **kwargs):
        self.state = self.create(*args, **kwargs)
        return self.state

    def _set_lr(self, opt, lr):
        if self.params is None:
            st = self.state
            self.params = {name: {k: v.detach().cpu().clone()
                                  for k, v in getattr(st, name).state_dict().items()}
                           for name in ('encoder', 'decoder', 'pz_proj', 'set_decoder')}
            self.step = st.step
            self.fresh = all(not o.state for _, o in st.groups())
        return self.set_lr(opt, lr)

    def __enter__(self):
        self.loop.create_train_state, self.loop.set_learning_rate = self._create, self._set_lr
        return self

    def __exit__(self, *exc):
        self.loop.create_train_state, self.loop.set_learning_rate = self.create, self.set_lr


def resume_phase(torch, dev):
    """run5's recipe (superconductor_vae_tpu_torch/scripts/launch_run5.sh)
    seeded as its comment says, from run4's snapshot, through the port's
    training CLI on the card ('resume' lines): checkpoints/epoch_00899 a
    symlink to results/run4/ckpt_snapshot, the recipe's flags verbatim but
    --output, --epochs, --limit and --pallas-decode (K1 in every rollout).
    (a) the resume, read at the first epoch's start: the resume line (epoch
    900, format orbax, params only, run4's step), run4's mastery arrays
    skipped, the four modules' parameters bit-equal to params_from_jax's of
    the same snapshot, fresh optimizers; (b) one float32 step at
    TrainConfig()'s defaults, dropout 0, from those weights on the corpus's
    first 32 rows, card against CPU; (c) the recipe in bf16 for epochs 900
    (TF) and 901 (RL): finite losses, samples/s and exact match an epoch,
    K1 launched layers x decode steps on each path (round trip, SCST
    rollout, Phase 2, eval).  Returns K1's launches in (c) by path."""
    import io
    import math
    import shutil
    import numpy as np
    from superconductor_vae_tpu_torch.checkpoint import params_from_jax
    from superconductor_vae_tpu_torch.checkpoint.ocdbt import read_snapshot
    from superconductor_vae_tpu_torch.ops import rl, round_trip
    from superconductor_vae_tpu_torch.ops.decode_attention import decode_step_attention
    from superconductor_vae_tpu_torch.scripts import train as cli
    from superconductor_vae_tpu_torch.tokenizer import EOS_ID
    from superconductor_vae_tpu_torch.training import (
        TrainConfig, default_dyn, evaluate, self_supervised, train_loop)
    from superconductor_vae_tpu_torch.training.evaluate import _to_device

    t_phase = time.perf_counter()
    t_parts = {}

    def part(name):
        t_parts[name] = time.perf_counter() - t_phase - sum(t_parts.values())

    shutil.rmtree(RESUME_DIR, ignore_errors=True)
    (RESUME_DIR / 'checkpoints').mkdir(parents=True)
    (RESUME_DIR / 'checkpoints' / 'epoch_00899').symlink_to(RUN4, target_is_directory=True)
    flags = recipe_flags(RUN5_RECIPE)
    argv = with_flags(flags, csv=ROOT / flags[flags.index('--csv') + 1], output=RESUME_DIR,
                      epochs=RESUME_EPOCHS, limit=RESUME_LIMIT) + ['--pallas-decode']
    print(f'resume: seeded {RESUME_DIR / "checkpoints" / "epoch_00899"} -> {RUN4}; the CLI\'s '
          f'flags {" ".join(argv)}')
    parser = cli.build_parser()
    tcfg, mcfg = cli.configs(parser, parser.parse_args(argv))
    check(tcfg.compute_dtype == 'bfloat16' and tcfg.resume == 'auto' and mcfg.pallas_decode,
          f'resume: the recipe parsed to {tcfg.compute_dtype}, resume {tcfg.resume}')

    # (c) the recipe through the CLI; (a) is read at its first epoch's start
    paths = {'round trip': (round_trip, 'generate_with_kv_cache'),
             'SCST rollout': (rl, '_rollout'),
             'Phase 2': (self_supervised, 'generate_with_kv_cache'),
             'eval': (evaluate, 'generate_with_kv_cache')}
    logs = {name: K1Log(*where) for name, where in paths.items()}
    buf = io.StringIO()
    with contextlib.ExitStack() as stack:
        for log in logs.values():
            stack.enter_context(log)
        first = stack.enter_context(FirstEpochState(train_loop))
        stack.enter_context(contextlib.redirect_stdout(buf))
        torch.cuda.synchronize()
        decode_step_attention.launches = 0
        t0 = time.perf_counter()
        out = cli.main(argv)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = decode_step_attention.launches
    lines = buf.getvalue().splitlines()
    for line in lines:
        print(f'resume (c): {line}')
    part('(c) run')

    # (a) the resume, as the first epoch found it
    trees = read_snapshot(RUN4 / 'state')
    step0 = int(trees['step'])
    line = next((x for x in lines if x.startswith('[resume] ') and ' -> epoch ' in x), '')
    check('epoch_00899 -> epoch 900 (opt=False ctl=True; format orbax; optimizer moments: '
          f'none, params only; step {step0})' in line, f'resume (a): the resume line {line!r}')
    check(any('mastery arrays of 26917 rows skipped' in x for x in lines),
          'resume (a): run4\'s mastery arrays were not skipped')
    cfg, ds = out['model_config'], out['dataset']
    want = params_from_jax(trees['enc_params'], trees['dec_params'], cfg,
                           device='cpu', pz_params=trees['pz_params'],
                           set_params=trees['set_params'])
    for name, ref in zip(('encoder', 'decoder', 'pz_proj', 'set_decoder'), want):
        got, ref = first.params[name], ref.state_dict()
        check(got.keys() == ref.keys() and all(
            v.dtype == torch.float32 and torch.equal(v, ref[k]) for k, v in got.items()),
            f'resume (a): {name} differs from params_from_jax of the snapshot')
    check(first.step == step0 and first.fresh, 'resume (a): the step or the fresh optimizers')
    print(f'resume (a): at epoch 900\'s start, before any update: the four modules equal '
          f'params_from_jax of the snapshot bit for bit (float32 from bf16), step '
          f'{first.step}, fresh optimizers; {len(ds)} rows of the corpus (--limit '
          f'{RESUME_LIMIT}, order augmentation {tcfg.order_augment}, {tcfg.skew_transform})')
    del want, trees
    part('(a)')

    # (b) a float32 default step from run4's weights, card against CPU
    tcfg32 = TrainConfig()
    batch = _to_device(ds.batch(np.arange(N_DEFAULT_CPU_ROWS)), dev)
    card_vs_cpu_step(torch, dev, batch, cfg, tcfg32, dict(default_dyn(tcfg32), physz_w=1.0),
                     'resume (b)', weights=first.params)
    del batch, first
    part('(b)')

    # (c)'s checks
    hist = out['history']
    check(out['decoder'].dtype == torch.bfloat16, 'resume (c): the decoder is not bf16')
    check([r['epoch'] for r in hist] == list(range(900, RESUME_EPOCHS)),
          f'resume (c): epochs {[r["epoch"] for r in hist]}')
    kinds = ['RL' if r['rl_weight'] > 0 else 'TF' for r in hist]
    check(kinds[:2] == ['TF', 'RL'], f'resume (c): epoch kinds {kinds}')
    for r, kind in zip(hist, kinds):
        bad = [k for k in ('total', 'formula_loss', 'tc_loss') if not math.isfinite(r[k])]
        check(not bad, f'resume (c): epoch {r["epoch"]}: {bad} not finite')
        print(f'resume (c): epoch {r["epoch"]} ({kind}): {r["samples_per_s"]} samples/s in '
              f'{r["epoch_time_s"]} s; exact {r["exact_match"]:.4f}, true-AR '
              f'{r["true_ar_exact"]:.4f}, total {r["total"]:.4f}, rl_weight '
              f'{r["rl_weight"]:.3f}, lr {r["lr"]:.3e}')
    layers = cfg.num_layers
    by_path = {}
    for name, log in logs.items():
        steps = [o['tokens'].shape[1] if name in ('round trip', 'Phase 2')
                 else steps_run(o['tokens'], EOS_ID) for o in log.outputs]
        rows = sorted({o['tokens'].shape[0] for o in log.outputs})
        print(f'resume (c): {name}: {len(steps)} rollouts of {rows} rows, {sum(steps)} decode '
              f'steps; K1 bf16 launches {log.launches} = {layers} x {sum(steps)}')
        check(log.launches == layers * sum(steps),
              f'resume (c): {name}: K1 launches {log.launches} != {layers} x {sum(steps)}')
        by_path[name] = log.launches
    check(by_path['round trip'] > 0 and by_path['SCST rollout'] > 0 and by_path['eval'] > 0,
          f'resume (c): K1 missing on a path: {by_path}')
    if not by_path['Phase 2']:
        print(f'resume (c): Phase 2 runs at epochs 911, 927, ... (phase2_interval '
              f'{tcfg.phase2_interval}) once TF exact >= {tcfg.phase2_auto_min_exact}: '
              f'none in epochs 900-{RESUME_EPOCHS - 1}')
    check(launches == sum(by_path.values()),
          f'resume (c): K1 launches {launches} outside the four paths {by_path}')
    print(f'resume (c): the recipe {run_s:.1f} s for epochs 900-{RESUME_EPOCHS - 1}; K1 bf16 '
          f'{launches} launches {by_path}')
    del out
    shutil.rmtree(RESUME_DIR)
    torch.cuda.empty_cache()
    print(f'resume: the phase {time.perf_counter() - t_phase:.1f} s: '
          + ', '.join(f'{k} {v:.1f} s' for k, v in t_parts.items()))
    return {f'resume (run5 recipe): {k}': v for k, v in by_path.items()}


P2_K1_B = (32, 128)
P2_ROWS = BATCH * N_BATCHES        # the e2e phase's rows: the z-cache
PHASE2_DIR = ROOT / 'outputs' / 'chip_smoke_phase2'
P2_TRAIN_ROWS = 512


def _p2_params(p2):
    """{group: {name: tensor}} of a Phase-2 epoch's two models, cloned."""
    return {name: {n: p.detach().clone() for n, p in m.named_parameters()}
            for name, m in (('encoder', p2.encoder), ('decoder', p2.decoder))}


def _p2_after(p2):
    """{group: {name: (param, exp_avg, exp_avg_sq)}} after an update."""
    return {name: {n: (p.detach().clone(), opt.state[p]['exp_avg'].clone(),
                       opt.state[p]['exp_avg_sq'].clone())
                   for n, p in m.named_parameters()}
            for name, m, opt in (('encoder', p2.encoder, p2._enc_opt),
                                 ('decoder', p2.decoder, p2._dec_opt))}


def phase2_phase(torch, dev, ds):
    """Phase 2 (training/self_supervised.py) at run4's widths with the e2e
    phase's weights and the K1 decoder, float32 unless a step says
    otherwise: (a) K1 at Phase 2's shapes against its plain version and
    timed; (b) the z-cache of the e2e rows and the coverage fit; (c) one
    sub-epoch of 64 samples with the real validators; (d) one of 256 with
    the permissive ones, so that the update runs; (e) that update on 16 of
    its rows, card against CPU, and a greedy rollout of 8 rows; (f) one
    sub-epoch in bf16 compute; (g) train() with Phase 2 at every epoch;
    (h) the standalone CLI on the loop phase's checkpoint.  Returns K1's
    float32 launches on the main paths (c), (d), (g) and (h), and its
    bfloat16 launches in (f)."""
    import math
    import shutil
    from types import SimpleNamespace
    import numpy as np
    from superconductor_vae_tpu_torch.generation.latent_analyzer import LatentSpaceAnalyzer
    from superconductor_vae_tpu_torch.models import config_from_meta
    from superconductor_vae_tpu_torch.ops.decode_attention import decode_step_attention
    from superconductor_vae_tpu_torch.ops.fused_attention import flash_attention
    from superconductor_vae_tpu_torch.tokenizer import default_tokenizer
    from superconductor_vae_tpu_torch.training import (
        Phase2Config, SelfSupervisedEpoch, build_luts)

    t_phase = time.perf_counter()
    t_parts = {}
    meta = json.loads(META.read_text())
    cfg = config_from_meta(meta['model_config'], pallas_decode=True)
    layers, steps = cfg.num_layers, cfg.max_len - 1
    per_sub_epoch = 2 * layers * steps                       # two rollouts, no early exit
    check(per_sub_epoch == 696, f'phase2: {per_sub_epoch} K1 launches a sub-epoch')

    # (a) K1 at B=32 and B=128, every position, both dtypes; then timed
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for name, dtype in (('float32', torch.float32), ('bfloat16', torch.bfloat16)):
        for b in P2_K1_B:
            worst = max(k1_held(torch, gen, b, cfg.nhead, cfg.max_len, cfg.head_dim, dtype, p)
                        for p in range(steps))
            print(f'phase2 (a): K1 {name} B={b} H={cfg.nhead} T={cfg.max_len} '
                  f'Dh={cfg.head_dim} positions 0..{steps - 1}: max_abs_err={worst:.3e} '
                  f'(tol {K1_TOL[name]}) caches_equal=True')
            k1_position_means(torch, gen, b, cfg.nhead, cfg.max_len, cfg.head_dim, dtype,
                              'phase2 (a)')
    t_parts['(a)'] = time.perf_counter() - t_phase

    # (b) the z-cache of the e2e phase's rows, and the coverage fit
    encoder, decoder = seeded_models(torch, dev, cfg)
    tok = default_tokenizer(max_len=cfg.max_len)
    luts = build_luts(tok, device=dev)
    sub = ds.subset(np.arange(P2_ROWS))
    t0 = time.perf_counter()
    cache = LatentSpaceAnalyzer(encoder).build_cache(sub)
    cache_s = time.perf_counter() - t0
    p2 = SelfSupervisedEpoch(encoder, decoder, tok, sub, luts, cfg=Phase2Config(n_samples=64))
    t0 = time.perf_counter()
    p2.coverage.fit(cache.z, method='hdbscan')
    fit_s = time.perf_counter() - t0
    print(f'phase2 (b): z-cache of {len(sub)} rows {cache_s:.2f} s, z {cache.z.shape} '
          f'finite {bool(np.isfinite(cache.z).all())}; coverage fit (hdbscan asked) ran '
          f'{p2.coverage.fitted_with}: {len(p2.coverage.centers)} clusters in {fit_s:.2f} s')
    check(np.isfinite(cache.z).all() and cache.z.shape == (P2_ROWS, cfg.latent_dim),
          'phase2 (b): the z-cache')
    check(p2.coverage.fitted_with in ('hdbscan', 'kmeans') and len(p2.coverage.centers) >= 4,
          'phase2 (b): the coverage fit')
    t_parts['(b)'] = time.perf_counter() - t_phase - sum(t_parts.values())

    def sub_epoch(p2, n, what, generator, dtype=torch.float32):
        """One sub-epoch through the main path, from train mode, K1 and K2
        counts at 0 just before and read just after; prints its parts'
        seconds."""
        p2.encoder.train()
        p2.decoder.train()
        with Timings(torch, *((SelfSupervisedEpoch, m) for m in (
                'sample_latents', 'rollouts', 'filter_candidates', 'update'))) as timings:
            torch.cuda.synchronize()
            decode_step_attention.launches = 0
            decode_step_attention.launches_by_dtype[dtype] = 0
            flash_attention.launches = 0
            t0 = time.perf_counter()
            out = p2.run(cache.z, generator, phase2_weight=0.1)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = decode_step_attention.launches_by_dtype[dtype]
            k2 = flash_attention.launches
        m = out['metrics']
        parts = {k: sum(s for s, _ in v) for k, v in timings.calls.items()}
        print(f'phase2 {what}: {n} samples, {str(dtype).split(".")[1]}: n_sampled '
              f'{m["n_sampled"]}, n_accepted {m["n_accepted"]}, n_novel {m["n_novel"]}, '
              f'unique_rate {m["unique_rate"]:.3f}, explore_temp {m["explore_temp"]:.3f}; '
              f'{wall:.3f} s: ' + ', '.join(f'{k} {parts.get(k, 0.0):.3f} s' for k in (
                  'sample_latents', 'rollouts', 'filter_candidates', 'update'))
              + ('' if 'update' in parts else ' (no update: nothing accepted)')
              + f'; K1 launches {launches}, K2 launches {k2}')
        check(m['n_sampled'] == n, f'phase2 {what}: n_sampled {m["n_sampled"]}')
        check(launches == per_sub_epoch, f'phase2 {what}: K1 launches {launches} != 696')
        check(k2 == 0, f'phase2 {what}: K2 launched {k2} times')
        check(p2.encoder.training and p2.decoder.training,
              f'phase2 {what}: the modules\' train modes were not given back')
        return out, launches

    generator = torch.Generator(device=dev).manual_seed(SEED)
    # (c) 64 samples, the real validators
    _, launches_c = sub_epoch(p2, 64, '(c)', generator)
    t_parts['(c)'] = time.perf_counter() - t_phase - sum(t_parts.values())

    # (d) 256 samples, the permissive validators: the update runs
    accept = SimpleNamespace(validate=lambda f: SimpleNamespace(
        is_valid=True, score=1.0, is_plausible=True))
    p2 = SelfSupervisedEpoch(encoder, decoder, tok, sub, luts, cfg=Phase2Config(n_samples=256))
    p2.validator = p2.physics = accept
    enc0 = {k: v.clone() for k, v in encoder.state_dict().items()}
    dec0 = {k: v.clone() for k, v in decoder.state_dict().items()}
    before = _p2_params(p2)
    batches = []
    loss = p2.loss
    p2.loss = lambda b: (batches.append(b), loss(b))[1]
    out, launches_d = sub_epoch(p2, 256, '(d)', generator)
    m = out['metrics']
    losses = {k: m.get(k, float('nan')) for k in (
        'loss1_round_trip', 'loss2_consistency', 'loss3_physics', 'loss4_reinforce')}
    print(f'phase2 (d): losses {losses}, phase2_loss {m.get("phase2_loss")}, round_trip_z_mse '
          f'{m.get("round_trip_z_mse")}')
    check(len(batches) == 1 and all(math.isfinite(v) for v in losses.values()),
          'phase2 (d): the update did not run or a loss is not finite')
    after = _p2_params(p2)
    for name in before:
        moved = sum(not torch.equal(before[name][k], after[name][k]) for k in before[name])
        print(f'phase2 (d): {name}: {moved} of {len(before[name])} parameter tensors changed')
        check(moved > 0, f'phase2 (d): the {name} did not change')
    del before, after
    t_parts['(d)'] = time.perf_counter() - t_phase - sum(t_parts.values())

    # (e) the update, card against CPU, on 16 of (d)'s rows from (d)'s
    # starting weights, the modules in train mode (dropout 0.1); first a
    # greedy rollout of 8 of those rows on each
    phase2_card_vs_cpu(torch, dev, cfg, tok, sub, enc0, dec0,
                       {k: v[:16] if torch.is_tensor(v) else v for k, v in batches[0].items()})
    del batches, p2
    t_parts['(e)'] = time.perf_counter() - t_phase - sum(t_parts.values())

    # (f) one sub-epoch in bf16 compute (float32 parameters), as run4 ran it
    enc_bf, dec_bf = seeded_models(torch, dev, cfg, dtype=torch.bfloat16)
    p2 = SelfSupervisedEpoch(enc_bf, dec_bf, tok, sub, luts, cfg=Phase2Config(n_samples=64))
    p2.validator = p2.physics = accept
    out, launches_f = sub_epoch(p2, 64, '(f)', generator, dtype=torch.bfloat16)
    bf_losses = [out['metrics'].get(k, float('nan')) for k in losses]
    print(f'phase2 (f): bf16 losses {bf_losses}')
    check(all(math.isfinite(v) for v in bf_losses), 'phase2 (f): a bf16 loss is not finite')
    del p2, enc_bf, dec_bf, encoder, decoder, enc0, dec0
    torch.cuda.empty_cache()
    t_parts['(f)'] = time.perf_counter() - t_phase - sum(t_parts.values())

    launches_g = phase2_train_check(torch, dev, cfg, ds, per_sub_epoch)
    t_parts['(g)'] = time.perf_counter() - t_phase - sum(t_parts.values())
    launches_h = phase2_standalone_check(torch, dev, per_sub_epoch)
    t_parts['(h)'] = time.perf_counter() - t_phase - sum(t_parts.values())
    torch.cuda.empty_cache()
    print(f'phase2: the phase {time.perf_counter() - t_phase:.1f} s: '
          + ', '.join(f'{k} {v:.1f} s' for k, v in t_parts.items()))
    return launches_c + launches_d + launches_g + launches_h, launches_f


def phase2_card_vs_cpu(torch, dev, cfg, tok, sub, enc_state, dec_state, batch):
    """(e) From the same weights on the card and on the CPU, the modules in
    train mode: a greedy rollout of 8 rows (the tokens agree up to EOS
    except at a near-tie), then one Phase-2 update on ``batch`` (the losses
    within METRIC_TOL, the AdamW moments and the parameter updates as the
    train phase holds them)."""
    from superconductor_vae_tpu_torch.generation import GenerationConfig, generate_with_kv_cache
    from superconductor_vae_tpu_torch.models import FormulaDecoder, MaterialsEncoder
    from superconductor_vae_tpu_torch.tokenizer import EOS_ID
    from superconductor_vae_tpu_torch.training import (
        Phase2Config, SelfSupervisedEpoch, build_luts)
    cpu = torch.device('cpu')
    gcfg = GenerationConfig(max_len=cfg.max_len, temperature=0.0)
    streams, runs = {}, {}
    for where, device in (('card', dev), ('cpu', cpu)):
        enc = MaterialsEncoder(cfg, device=device)
        dec = FormulaDecoder(cfg, device=device)
        enc.load_state_dict(enc_state)
        dec.load_state_dict(dec_state)
        enc.train()
        dec.train()
        p2 = SelfSupervisedEpoch(enc, dec, tok, sub, build_luts(tok, device=device),
                                 cfg=Phase2Config(n_samples=16))
        b = {k: v.to(device) if torch.is_tensor(v) else v for k, v in batch.items()}
        z = b['z_acc'][:8]
        enc.eval()
        dec.eval()
        with torch.no_grad():
            heads = enc.heads_from_z(z)
        out = generate_with_kv_cache(dec, z, heads['stoich'], heads['heads_vec'], None, gcfg)
        streams[where] = {'generated': out['tokens'].cpu(), 'margin': out['margin'].cpu()}
        enc.train()
        dec.train()
        before = _p2_params(p2)
        metrics = p2.update(b)
        check(enc.training and dec.training, 'phase2 (e): the train modes were not given back')
        runs[where] = (metrics, before, _p2_after(p2))
        del enc, dec, p2
    ties = compare_streams(streams['card'], streams['cpu'], EOS_ID, 'phase2 (e) greedy')
    print(f'phase2 (e): the greedy rollout of 8 rows agrees card vs CPU up to EOS '
          f'(near-tie divergences {ties})')
    (m_c, before_c, after_c), (m_h, before_h, after_h) = runs['card'], runs['cpu']
    check_metrics('phase2 (e)', {k: torch.tensor(v) for k, v in m_c.items()},
                  {k: torch.tensor(v) for k, v in m_h.items()}, 'Phase-2 losses')
    for name in after_h:
        _tree_check('phase2 (e)', {k: v[2] for k, v in after_c[name].items()},
                    {k: v[2] for k, v in after_h[name].items()}, f'{name} AdamW nu')
    def mu(after):
        return {g: {k: v[:2] for k, v in t.items()} for g, t in after.items()}

    def params(before):
        return {g: {k: (v,) for k, v in t.items()} for g, t in before.items()}
    check_updates(torch, 'phase2 (e)', params(before_c), mu(after_c), params(before_h),
                  mu(after_h), 3e-5 * 0.1)
    torch.cuda.empty_cache()


def phase2_train_check(torch, dev, cfg, ds, per_sub_epoch):
    """(g) train() with Phase 2 open at every epoch (no TF-exact gate),
    2 epochs on P2_TRAIN_ROWS rows, batch 256, without the set decoder and
    the round trip: one phase2_log.jsonl line an epoch, and K1 launched 12
    times a decode step of each eval rollout plus 696 a sub-epoch.  Returns
    K1's launches."""
    import math
    import numpy as np
    from superconductor_vae_tpu_torch.ops.decode_attention import decode_step_attention
    from superconductor_vae_tpu_torch.tokenizer import EOS_ID
    from superconductor_vae_tpu_torch.training import TrainConfig, evaluate, train
    out_dir = PHASE2_DIR / 'train'
    tcfg = TrainConfig(num_epochs=2, batch_size=BATCH, max_formula_len=cfg.max_len,
                       skew_transform='rank_gauss', eval_interval=1,
                       hungarian_enabled=False, use_round_trip=False,
                       phase2_enabled=True, phase2_auto_min_exact=0.0, phase2_interval=1)
    logs = []
    with CallLog(evaluate, 'generate_with_kv_cache') as gen_log:
        torch.cuda.synchronize()
        decode_step_attention.launches = 0
        t0 = time.perf_counter()
        out = train(model_config=cfg, train_config=tcfg,
                    dataset=ds.subset(np.arange(P2_TRAIN_ROWS)), output_dir=out_dir,
                    log_fn=logs.append, device=dev)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches = decode_step_attention.launches
    for line in logs:
        print(f'phase2 (g): {line}')
    records = [json.loads(x) for x in (out_dir / 'phase2_log.jsonl').read_text().splitlines()]
    eval_steps = [steps_run(o['tokens'], EOS_ID) for o in gen_log.outputs]
    want = cfg.num_layers * sum(eval_steps) + per_sub_epoch * len(records)
    print(f'phase2 (g): train() {secs:.1f} s for {len(out["history"])} epochs of '
          f'{P2_TRAIN_ROWS} rows; phase2_log.jsonl epochs {[r["epoch"] for r in records]}; '
          f'eval decode steps {eval_steps}; K1 launches {launches} = 12 x eval steps + 696 x '
          f'{len(records)} sub-epochs = {want}')
    check([r['epoch'] for r in records] == [0, 1], 'phase2 (g): one log line an epoch')
    check(launches == want, f'phase2 (g): K1 launches {launches} != {want}')
    check(all(math.isfinite(r['total']) for r in out['history']), 'phase2 (g): a loss')
    del out
    torch.cuda.empty_cache()
    return launches


def phase2_standalone_check(torch, dev, per_sub_epoch):
    """(h) The port's phase2_standalone CLI on the loop phase's checkpoint:
    2 sub-epochs of 64 samples through K1 over the corpus's first 1,024
    rows, then --save-checkpoint, which must load back to the CLI's final
    parameters bit for bit.  Returns K1's launches."""
    from superconductor_vae_tpu_torch.checkpoint import load_checkpoint
    from superconductor_vae_tpu_torch.ops.decode_attention import decode_step_attention
    from superconductor_vae_tpu_torch.scripts import phase2_standalone
    saved = PHASE2_DIR / 'saved'
    torch.cuda.synchronize()
    decode_step_attention.launches = 0
    t0 = time.perf_counter()
    out = phase2_standalone.main([
        '--checkpoint', str(PHASE2_DIR / 'loop_checkpoint'), '--csv', str(CSV),
        '--limit', str(P2_ROWS), '--sub-epochs', '2', '--n-samples', '64', '--pallas-decode',
        '--out-dir', str(PHASE2_DIR / 'standalone'), '--save-checkpoint', str(saved)])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = decode_step_attention.launches
    log = [json.loads(x) for x in
           (PHASE2_DIR / 'standalone' / 'phase2_log.jsonl').read_text().splitlines()]
    print(f'phase2 (h): phase2_standalone {secs:.1f} s: sub-epochs '
          + '; '.join(f'{r["sub_epoch"]}: {r["wall_s"]} s, accepted {r["metrics"]["n_accepted"]}'
                      for r in log) + f'; K1 launches {launches}')
    check(len(log) == 2 and launches == 2 * per_sub_epoch,
          f'phase2 (h): {len(log)} sub-epochs, K1 launches {launches}')
    restored, meta = load_checkpoint(saved)
    check(meta.get('phase2') == out['summary'], 'phase2 (h): the summary in meta.json')
    for key, module in (('enc_params', out['encoder']), ('dec_params', out['decoder'])):
        check(_same_tree(restored[key], module.state_dict()),
              f'phase2 (h): {key} differs after load_checkpoint')
    print(f'phase2 (h): the saved checkpoint loads back to the CLI\'s final parameters bit '
          f'for bit ({", ".join(sorted(restored))})')
    del out, restored
    torch.cuda.empty_cache()
    return launches


# -- holdout phase --------------------------------------------------------------

HOLDOUT_K1_B = 2048               # the discovery decode's chunk (decode_latents chunk=2048)
HOLDOUT_CANDIDATES = 256          # SuperconductorDiscoveryPipeline.run(n_candidates)
HOLDOUT_RUN_ROWS = 4096           # run()'s corpus: its host k-means over all 26,917 took ~28 s
HOLDOUT_POOL = 2 * HOLDOUT_K1_B + 100    # two full decode chunks and a padded third
HOLDOUT_TARGETS = 1               # every tier still runs on it; a second target only doubled the time
HOLDOUT_BUDGET = 1024            # (d) and the CLI (f); 2048 before the smoke's time limit cut it
# the search (d) runs without zoom-in rounds: search()'s default, 2, runs
# each tier three times (87-91 s a target on an H100); the CLI (f), a check
# of the entry point, also with an inversion of 48 steps (384 took 31-35 s
# a target in (d) on an H100)
HOLDOUT_REFINE = 0
HOLDOUT_INVERSION_STEPS = 128     # (d): search()'s default is 384 (the smoke's time limit)
HOLDOUT_CLI_INVERSION_STEPS = 48
HOLDOUT_GRAD_REL = 1e-4           # card vs CPU: first gradients w.r.t. z, of the largest component
HOLDOUT_Z_TOL = 1e-3              # card vs CPU: z after 8 Adam steps


def _rel_err(torch, got, want):
    """Largest difference over the largest magnitude of ``want``."""
    got, want = got.detach().float().cpu(), want.detach().float().cpu()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def holdout_phase(torch, dev, ds):
    """Discovery and the generative holdout search (generation/discovery.py,
    generation/holdout_search.py) at run4's widths with the e2e phase's
    weights and the K1 decoder, float32, on the loaded corpus ('holdout'
    lines): (a) K1 at B=2048 against its plain version and timed; (b)
    SuperconductorDiscoveryPipeline.run; (c) a chunked greedy decode
    through K1 against the plain attention path and the CPU; (d) a search
    of one target with every tier, no zoom-in rounds; (e) the descents' gradients and z, and
    predict_tc_mc, card against CPU; (f) the holdout CLI and the stream's
    summary.  Returns K1's launches on the main paths (b), (d) and (f) and
    the B=2048 times."""
    import shutil
    import numpy as np
    from superconductor_vae_tpu_torch.generation import SuperconductorDiscoveryPipeline
    from superconductor_vae_tpu_torch.generation import discovery
    from superconductor_vae_tpu_torch.generation import holdout_search as hs
    from superconductor_vae_tpu_torch.models import config_from_meta
    from superconductor_vae_tpu_torch.models.decoder import plain_layout
    from superconductor_vae_tpu_torch.ops.decode_attention import decode_step_attention
    from superconductor_vae_tpu_torch.ops.fused_attention import flash_attention
    from superconductor_vae_tpu_torch.tokenizer import EOS_ID, default_tokenizer

    t_phase = time.perf_counter()
    t_parts = {}

    def part(name):
        t_parts[name] = time.perf_counter() - t_phase - sum(t_parts.values())

    meta = json.loads(META.read_text())
    cfg = config_from_meta(meta['model_config'], pallas_decode=True)
    layers, steps = cfg.num_layers, cfg.max_len - 1

    # (a) K1 at the discovery chunk, every position, caches exact; timed
    gen = torch.Generator(device=dev).manual_seed(SEED)
    worst = max(k1_held(torch, gen, HOLDOUT_K1_B, cfg.nhead, cfg.max_len, cfg.head_dim,
                        torch.float32, p) for p in range(steps))
    print(f'holdout (a): K1 float32 B={HOLDOUT_K1_B} H={cfg.nhead} T={cfg.max_len} '
          f'Dh={cfg.head_dim} positions 0..{steps - 1}: max_abs_err={worst:.3e} '
          f'(tol {K1_TOL["float32"]}) caches_equal=True')
    b2048 = k1_position_means(torch, gen, HOLDOUT_K1_B, cfg.nhead, cfg.max_len, cfg.head_dim,
                              torch.float32, 'holdout (a)')
    part('(a)')

    encoder, decoder = seeded_models(torch, dev, cfg)
    tok = default_tokenizer(max_len=cfg.max_len)
    pipe = SuperconductorDiscoveryPipeline(encoder, decoder, tok, ds, type_masks=tok.type_masks)

    def counted(what, fn):
        """``fn()`` through the main path, K1 and K2 counts at 0 just
        before and read just after; K1 must have run 12 x the decode steps
        of every rollout the call made.  Returns (out, seconds, K1)."""
        with CallLog(discovery, 'generate_with_kv_cache') as gen_log:
            torch.cuda.synchronize()
            decode_step_attention.launches = 0
            flash_attention.launches = 0
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            launches, k2 = decode_step_attention.launches, flash_attention.launches
        decode_steps = [steps_run(o['tokens'], EOS_ID) for o in gen_log.outputs]
        print(f'holdout {what}: {secs:.2f} s; {len(decode_steps)} rollouts of '
              f'{sum(decode_steps)} decode steps; K1 launches {launches} = {layers} x '
              f'{sum(decode_steps)}; K2 launches {k2}')
        check(launches == layers * sum(decode_steps) and launches > 0,
              f'holdout {what}: K1 launches {launches} != {layers} x {sum(decode_steps)}')
        check(k2 == 0, f'holdout {what}: K2 launched {k2} times')
        return out, secs, launches, gen_log.outputs

    # (b) the analyzer's cache over the corpus, then the discovery pipeline
    t0 = time.perf_counter()
    cache = pipe.analyzer.build_cache(ds)
    torch.cuda.synchronize()
    print(f'holdout (b): analyzer cache of {len(ds)} rows {time.perf_counter() - t0:.2f} s, '
          f'z {cache.z.shape} finite {bool(np.isfinite(cache.z).all())}')
    check(cache.z.shape == (len(ds), cfg.latent_dim) and np.isfinite(cache.z).all(),
          'holdout (b): the cache')
    host = ('correct', 'validate', 'physics')
    pipe_b = SuperconductorDiscoveryPipeline(encoder, decoder, tok,
                                             ds.subset(np.arange(HOLDOUT_RUN_ROWS)),
                                             type_masks=tok.type_masks)
    with Timings(torch, (pipe_b.analyzer, 'build_cache'),
                 (pipe_b.analyzer, 'find_high_tc_clusters'),
                 (pipe_b.generator, 'gradient_ascent_tc'), (pipe_b.generator, 'evolutionary'),
                 (pipe_b, 'decode_latents'), (discovery, 'predict_tc_mc'),
                 (pipe_b.corrector, 'correct'), (pipe_b.validator, 'validate'),
                 (pipe_b.physics, 'validate', 'physics'), host=host) as log:
        cands, secs, launches_b, _ = counted('(b) run', lambda: pipe_b.run(
            n_candidates=HOLDOUT_CANDIDATES, seed=SEED))
    print('holdout (b): run\'s parts: ' + ', '.join(
        f'{n} {log.seconds(n):.2f} s' for n in (
            'build_cache', 'find_high_tc_clusters', 'gradient_ascent_tc', 'evolutionary',
            'decode_latents', 'predict_tc_mc') + host))
    strategies = {}
    for c in cands:
        strategies[c.strategy] = strategies.get(c.strategy, 0) + 1
    print(f'holdout (b): run(n_candidates={HOLDOUT_CANDIDATES}) over the first '
          f'{HOLDOUT_RUN_ROWS} rows {secs:.2f} s: {len(cands)} '
          f'candidates by strategy {strategies}; top '
          + '; '.join(f'{c.formula} rank {c.rank_score:.3g}' for c in cands[:3]))
    check(all(np.isfinite([c.rank_score, c.tc_pred_kelvin, c.tc_uncertainty]).all()
              for c in cands), 'holdout (b): a candidate is not finite')
    check(not encoder.training and not decoder.training, 'holdout (b): the modes')
    del pipe_b
    part('(b)')

    # (c) a chunked greedy decode of a pool through K1 against the plain
    # attention path (the same weights), and 8 rows against the CPU
    search = hs.HoldoutSearch(pipe)
    target = search.targets[0]
    z = search._candidate_latents(target, cache, HOLDOUT_POOL,
                                  torch.Generator(device=dev).manual_seed(SEED))
    check(z.shape == (HOLDOUT_POOL, cfg.latent_dim), f'holdout (c): the pool {tuple(z.shape)}')
    formulas, secs, _, k1_out = counted('(c) decode', lambda: pipe.decode_latents(
        z, chunk=HOLDOUT_K1_B, snap_stoich=True))
    check([o['tokens'].shape[0] for o in k1_out] == [HOLDOUT_K1_B] * 3,
          'holdout (c): three chunks of 2048 rows')
    plain = SuperconductorDiscoveryPipeline(encoder, plain_layout(decoder), tok, ds,
                                            type_masks=tok.type_masks)
    with CallLog(discovery, 'generate_with_kv_cache') as plain_log:
        plain_formulas = plain.decode_latents(z, chunk=HOLDOUT_K1_B, snap_stoich=True)
    ties = sum(compare_streams({'generated': a['tokens'], 'margin': a['margin']},
                               {'generated': b['tokens'], 'margin': b['margin']}, EOS_ID,
                               f'holdout (c) chunk {i}')
               for i, (a, b) in enumerate(zip(k1_out, plain_log.outputs)))
    n_diff = sum(a != b for a, b in zip(formulas, plain_formulas))
    print(f'holdout (c): {len(formulas)} formulas ({len(set(formulas))} distinct) in {secs:.2f} '
          f's through K1: {len(formulas) / secs:.0f} formulas/s; against the plain path: '
          f'{n_diff} differ, near-tie divergences {ties}')
    check(len(formulas) == HOLDOUT_POOL and n_diff <= ties, 'holdout (c): K1 vs plain')
    cpu = torch.device('cpu')
    enc_h, dec_h = _cpu_twins(torch, cfg, encoder, decoder)
    pipe_h = SuperconductorDiscoveryPipeline(enc_h, dec_h, tok, ds, type_masks=tok.type_masks)
    rows = torch.arange(0, HOLDOUT_POOL, HOLDOUT_POOL // N_CPU_ROWS)[:N_CPU_ROWS]
    with CallLog(discovery, 'generate_with_kv_cache') as cpu_log:
        cpu_formulas = pipe_h.decode_latents(z[rows.to(dev)].cpu(), snap_stoich=True)
    card_rows = torch.cat([o['tokens'] for o in k1_out])[rows.to(dev)]
    card_margin = torch.cat([o['margin'] for o in k1_out])[rows.to(dev)]
    ties = compare_streams({'generated': card_rows.cpu(), 'margin': card_margin.cpu()},
                           {'generated': cpu_log.outputs[0]['tokens'],
                            'margin': cpu_log.outputs[0]['margin']}, EOS_ID,
                           'holdout (c) card vs CPU')
    print(f'holdout (c): {N_CPU_ROWS} rows card vs CPU agree up to EOS (near-tie divergences '
          f'{ties}); the CPU formulas equal the card\'s: '
          f'{[formulas[r] for r in rows.tolist()] == cpu_formulas}')
    del plain, plain_log, k1_out
    part('(c)')

    # (d) a search of the first target at the default tiers, a shorter inversion
    quiet = []
    with Timings(torch, *((search, m) for m in (
            '_candidate_latents', 'head_guided_latents', '_inverse_regression_latents',
            'decoder_inversion_latents', 'oracle_reconstruct', 'consistency_check')),
            (pipe, 'decode_latents'), (hs, 'element_similarity'),
            (hs, 'canonical_composition_key'),
            host=('element_similarity', 'canonical_composition_key')) as log:
        results, secs, launches_d, _ = counted('(d) search', lambda: search.search(
            budget_per_target=HOLDOUT_BUDGET, targets=search.targets[:HOLDOUT_TARGETS],
            refine_rounds=HOLDOUT_REFINE, inversion_steps=HOLDOUT_INVERSION_STEPS, seed=SEED,
            log_fn=quiet.append))
    for line in quiet:
        print(f'holdout (d): {line}')
    # a target starts at its pool (the first tier's first step) and ends
    # after its oracle (the last step but the consistency check)
    bounds = [log.first('_candidate_latents', lo) for lo in
              [0.0] + [e for n, _, e in log.events if n == 'oracle_reconstruct']][:HOLDOUT_TARGETS]
    for t_i, r in enumerate(results):
        lo = bounds[t_i]
        hi = bounds[t_i + 1] if t_i + 1 < len(bounds) else float('inf')
        g0, i0 = log.first('head_guided_latents', lo), log.first('decoder_inversion_latents', lo)
        o0 = log.first('oracle_reconstruct', lo)
        inv_s = log.seconds('decoder_inversion_latents', lo, hi)
        n_inv = sum(1 for n, s, _ in log.events
                    if n == 'decoder_inversion_latents' and lo <= s < hi)
        scoring = (log.seconds('element_similarity', lo, hi)
                   + log.seconds('canonical_composition_key', lo, hi))
        print(f'holdout (d): target {t_i} {r.target}: {r.wall_s} s; tiers: navigation '
              f'{g0 - lo:.2f} s, guided {i0 - g0:.2f} s, inversion {o0 - i0:.2f} s; oracle and '
              f'consistency {r.wall_s - (o0 - lo):.2f} s; '
              f'decode {log.seconds("decode_latents", lo, hi):.2f} s, guided descent '
              f'{log.seconds("head_guided_latents", lo, hi):.2f} s, inversion descent '
              f'{inv_s:.2f} s ({n_inv} x {HOLDOUT_INVERSION_STEPS} steps of 24 starts: '
              f'{n_inv * HOLDOUT_INVERSION_STEPS / max(inv_s, 1e-9):.1f} '
              f'steps/s), pool {log.seconds("_candidate_latents", lo, hi):.2f} s, inverse '
              f'regression {log.seconds("_inverse_regression_latents", lo, hi):.2f} s, host '
              f'scoring {scoring:.2f} s; {r.n_candidates} distinct formulas, best '
              f'{r.best_match[:40]!r} sim {r.best_similarity:.3f}, tier_sim {r.tier_sim}, '
              f'inversion_diag {r.inversion_diag}')
        check(r.tier_sim is not None and set(r.tier_sim) == {'navigation', 'guided', 'inversion'},
              f'holdout (d): target {t_i} did not run every tier: {r.tier_sim}')
    print(f'holdout (d): search of {HOLDOUT_TARGETS} targets at budget {HOLDOUT_BUDGET}: '
          f'{secs:.1f} s; summary {hs.HoldoutSearch.summarize(results)}')
    check(not encoder.training and not decoder.training and
          all(p.grad is None for m in (encoder, decoder) for p in m.parameters()),
          'holdout (d): the modes or a weight gradient')
    part('(d)')

    # (e) the descents, card against CPU from the same weights
    search_h = hs.HoldoutSearch(pipe_h)
    holdout_card_vs_cpu(torch, dev, cfg, search, search_h, cache)
    del search_h, pipe_h, enc_h, dec_h
    part('(e)')

    # (f) the CLI on the loop phase's checkpoint, then its stream's summary
    launches_f = holdout_cli_check(torch, counted)
    part('(f)')
    shutil.rmtree(PHASE2_DIR, ignore_errors=True)
    del pipe, search, encoder, decoder, cache
    torch.cuda.empty_cache()
    print(f'holdout: the phase {time.perf_counter() - t_phase:.1f} s: '
          + ', '.join(f'{k} {v:.1f} s' for k, v in t_parts.items()))
    return launches_b + launches_d + launches_f, b2048


def _cpu_twins(torch, cfg, encoder, decoder):
    """CPU copies of the card's models (the same weights), in eval mode."""
    from superconductor_vae_tpu_torch.models import FormulaDecoder, MaterialsEncoder
    enc = MaterialsEncoder(cfg, device='cpu')
    dec = FormulaDecoder(cfg, device='cpu')
    enc.load_state_dict(encoder.state_dict())
    dec.load_state_dict(decoder.state_dict())
    return enc.eval(), dec.eval()


def holdout_card_vs_cpu(torch, dev, cfg, search, search_h, cache):
    """(e) The first gradient with respect to z of the guided objective
    (both slot conventions) and of the inversion objective on 4 starts,
    within HOLDOUT_GRAD_REL of the largest component; z after 8 Adam steps
    of each within HOLDOUT_Z_TOL; predict_tc_mc at dropout 0 against
    tc_pred (std 0)."""
    import dataclasses
    from superconductor_vae_tpu_torch.models import MaterialsEncoder
    from superconductor_vae_tpu_torch.models.encoder import predict_tc_mc
    from superconductor_vae_tpu_torch.models.layers import eval_mode
    target = next(t for t in search.targets if search._target_token_ids(t) is not None)
    z0 = search._anchor_latents(target, cache, n=4)
    for order_free in (False, True):
        grads, zs = [], []
        for s in (search, search_h):
            start = z0.to(s.device)
            arrays = s._guided_arrays(target, order_free)
            z = start.clone().requires_grad_(True)
            with eval_mode(s.pipe.encoder):
                grads.append(torch.autograd.grad(
                    s._guided_objective(z, start, arrays, 2e-3, order_free), z)[0])
            zs.append(s.head_guided_latents(target, start, steps=8, n_snapshots=1,
                                            order_free=order_free))
        g_err, z_err = _rel_err(torch, *grads), float((zs[0].cpu() - zs[1]).abs().max())
        print(f'holdout (e): guided (order_free={order_free}) card vs CPU: first gradient '
              f'{g_err:.2e} of its largest component (tol {HOLDOUT_GRAD_REL}), z after 8 Adam '
              f'steps max |dz| {z_err:.2e} (tol {HOLDOUT_Z_TOL})')
        check(g_err <= HOLDOUT_GRAD_REL and z_err <= HOLDOUT_Z_TOL, 'holdout (e): guided')
    grads, zs, diags = [], [], []
    ids = search._target_token_ids(target)
    for s in (search, search_h):
        start = z0.to(s.device)
        toks = s._inversion_tokens(ids, 4)
        z = start.clone().requires_grad_(True)
        with eval_mode(s.pipe.encoder, s.pipe.decoder):
            grads.append(torch.autograd.grad(
                s._inversion_objective(z, start, toks, 1e-3, 0.25), z)[0])
        zs.append(s.decoder_inversion_latents(target, start, steps=8, n_snapshots=1))
        diags.append(s.last_inversion_diag)
    g_err, z_err = _rel_err(torch, *grads), float((zs[0].cpu() - zs[1]).abs().max())
    print(f'holdout (e): inversion card vs CPU: first gradient {g_err:.2e} of its largest '
          f'component (tol {HOLDOUT_GRAD_REL}), z after 8 Adam steps max |dz| {z_err:.2e} '
          f'(tol {HOLDOUT_Z_TOL}); diagnostics card {diags[0]}, CPU {diags[1]}')
    check(g_err <= HOLDOUT_GRAD_REL and z_err <= HOLDOUT_Z_TOL, 'holdout (e): inversion')
    enc0 = MaterialsEncoder(dataclasses.replace(cfg, dropout=0.0), device=dev)
    enc0.load_state_dict(search.pipe.encoder.state_dict())
    zc = torch.as_tensor(cache.z[:256], device=dev)
    mean, std = predict_tc_mc(enc0, zc, seed=SEED)
    with torch.no_grad():
        tc = enc0.eval().decode(zc)['tc_pred']
    mc_err, std_max = _rel_err(torch, mean, tc), float(std.abs().max())
    print(f'holdout (e): predict_tc_mc at dropout 0 on 256 rows: mean vs tc_pred {mc_err:.2e} '
          f'of the largest, std max {std_max:.2e}')
    # the ten copies of a row may meet other GEMM tiles than the single pass
    check(mc_err <= 1e-5 and std_max <= 1e-6 * float(tc.abs().max()),
          'holdout (e): predict_tc_mc')


def holdout_cli_check(torch, counted):
    """(f) The port's holdout CLI on the loop phase's checkpoint through
    K1, a search of one target at budget 1024 with a stream (no zoom-in
    rounds, an inversion of 48 steps), then
    --oracle-only; the stream summarised by the port's holdout_summarize.
    Returns K1's launches."""
    from superconductor_vae_tpu_torch.scripts import holdout_search as cli
    from superconductor_vae_tpu_torch.scripts import holdout_summarize
    out_dir = PHASE2_DIR / 'holdout'
    common = ['--checkpoint', str(PHASE2_DIR / 'loop_checkpoint'), '--csv', str(CSV),
              '--pallas-decode', '--n-targets', '1']
    res, secs, launches, _ = counted('(f) CLI search', lambda: cli.main(common + [
        '--budget', str(HOLDOUT_BUDGET), '--refine-rounds', str(HOLDOUT_REFINE),
        '--inversion-steps', str(HOLDOUT_CLI_INVERSION_STEPS),
        '--stream', str(out_dir / 'stream.jsonl'),
        '--out', str(out_dir / 'search.json')]))
    written = json.loads((out_dir / 'search.json').read_text())
    summary = holdout_summarize.main(['--stream', str(out_dir / 'stream.jsonl'),
                                      '--out', str(out_dir / 'summary.json')])
    print(f'holdout (f): CLI search {secs:.1f} s: {written["summary"]}; stream summary '
          f'targets_completed {summary["targets_completed"]}, mean_similarity '
          f'{summary["mean_similarity"]:.3f}')
    check(written['summary'] == res['summary'] and summary['targets_completed'] == 1,
          'holdout (f): the CLI search\'s JSON or its stream')
    res, secs, launches_o, _ = counted('(f) CLI oracle', lambda: cli.main(common + [
        '--oracle-only', '--out', str(out_dir / 'oracle.json')]))
    written = json.loads((out_dir / 'oracle.json').read_text())
    print(f'holdout (f): CLI --oracle-only {secs:.1f} s: {written["summary"]}, '
          f'{written["results"][0]["oracle_formula"]!r}')
    check(written['summary']['n_targets'] == 1, 'holdout (f): the oracle JSON')
    return launches + launches_o


# -- surgery and diagnostics phase ----------------------------------------------

SURGERY_WIDE = (1152, 4608)       # d_model, dim_feedforward: run4's x2, Dh 144
SURGERY_DEEPEN = 1
SURGERY_K1_POSITIONS = (0, 14, 29)
SURGERY_DIR = ROOT / 'outputs' / 'chip_smoke_surgery'
SURGERY_CSV_ROWS = 4096           # the diagnostics' corpus: its first rows (each CLI loads it)
DIAG_ROWS = 128                   # the diagnostics' rows: the smoke's time limit
ORACLE_ROWS = 8                   # oracle_bisect decodes one row a rollout (32 took 20 s)
CAMPAIGN_TARGETS = 1              # a search subprocess costs 26-35 s: the smoke's time limit
CAMPAIGN = ['--n-targets', str(CAMPAIGN_TARGETS), '--window', '1', '--budget', '64', '--refine-rounds', '0',
            '--no-guided', '--no-inverse', '--inversion-steps', '8', '--no-oracle']
SURGERY_TF_ATOL = 1e-4            # function preservation (float32, other summation orders)
LEGACY_REL = 1e-5                 # legacy models card vs CPU, of the largest magnitude


def _counted_cli(torch, what, fn, layers):
    """``fn()`` (an entry point) with K1's count at 0 just before and read
    just after; K1 must have run ``layers`` x decode steps of every rollout
    the call made (eval and discovery decodes).  Returns (out, seconds,
    launches, rows decoded)."""
    from superconductor_vae_tpu_torch.generation import discovery
    from superconductor_vae_tpu_torch.ops.decode_attention import decode_step_attention
    from superconductor_vae_tpu_torch.ops.fused_attention import flash_attention
    from superconductor_vae_tpu_torch.tokenizer import EOS_ID
    from superconductor_vae_tpu_torch.training import evaluate
    with CallLog(evaluate, 'generate_with_kv_cache') as ev, \
            CallLog(discovery, 'generate_with_kv_cache') as dv:
        torch.cuda.synchronize()
        decode_step_attention.launches = 0
        flash_attention.launches = 0
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        launches, k2 = decode_step_attention.launches, flash_attention.launches
    rollouts = ev.outputs + dv.outputs
    steps = sum(steps_run(o['tokens'], EOS_ID) for o in rollouts)
    rows = sum(o['tokens'].shape[0] for o in rollouts)
    print(f'surgery {what}: {secs:.2f} s; {len(rollouts)} rollouts of {rows} rows, {steps} '
          f'decode steps ({rows / secs:.1f} formulas/s); K1 launches {launches}; K2 {k2}')
    check(launches == layers * steps and launches > 0,
          f'surgery {what}: K1 launches {launches} != {layers} x {steps}')
    check(k2 == 0, f'surgery {what}: K2 launched {k2} times')
    return out, secs, launches, rows


def _surgery_models(torch, dev, cfg, encoder, decoder):
    """The decoder deepened by SURGERY_DEEPEN layers and widened to
    SURGERY_WIDE, and the encoder widened x2, on the card, in eval mode."""
    from superconductor_vae_tpu_torch.models import FormulaDecoder, MaterialsEncoder, surgery

    def loaded(module, sd):
        module.load_state_dict(sd, strict=True)
        return module.eval()

    sd = decoder.state_dict()
    deep = loaded(FormulaDecoder(dataclasses.replace(
        cfg, num_layers=cfg.num_layers + SURGERY_DEEPEN), device=dev),
        surgery.deepen_decoder(sd, SURGERY_DEEPEN))
    wide = loaded(FormulaDecoder(surgery.widened_config(cfg, *SURGERY_WIDE), device=dev),
                  surgery.expand_decoder_width(sd, cfg, *SURGERY_WIDE))
    args = (2 * cfg.fusion_dim, tuple(2 * w for w in cfg.encoder_hidden),
            tuple(2 * w for w in cfg.decoder_hidden))
    wide_enc = loaded(MaterialsEncoder(surgery.widened_encoder_config(cfg, *args), device=dev),
                      surgery.expand_encoder_widths(encoder.state_dict(), cfg, *args))
    return deep, wide, wide_enc


def surgery_phase(torch, dev, ds, batches):
    """Model surgery, the migrate CLI, the diagnostics and the legacy
    models ('surgery' lines): (a) the seeded run4 decoder deepened by one
    layer and widened x2 (Dh 144), and the encoder widened x2: greedy
    streams of 256 corpus rows through K1 equal the original's but at
    near-ties, K1 = layers x steps, TF logits and the encoder's outputs
    within SURGERY_TF_ATOL; K1 at Dh 144 against its plain version and
    timed; (b) migrate_checkpoint deepen on a saved seeded checkpoint and
    the eval CLI on both through K1; (c) the diagnostics CLIs through K1 on
    that checkpoint, and the campaign driver twice in a subprocess (the
    second starts no search); (d) the legacy models' forward and backward,
    card against CPU.  Returns K1's launches by path and the Dh 144 times."""
    import shutil
    import subprocess
    from superconductor_vae_tpu_torch.checkpoint import (
        ckpt_skew_transform, save_params_checkpoint)
    from superconductor_vae_tpu_torch.models import config_from_meta
    from superconductor_vae_tpu_torch.ops.decode_attention import decode_step_attention
    from superconductor_vae_tpu_torch.tokenizer import EOS_ID, default_tokenizer
    from superconductor_vae_tpu_torch.training import (
        build_luts, eval_batch, eval_generation_config, eval_train_config)

    t_phase = time.perf_counter()
    t_parts = {}

    def part(name):
        t_parts[name] = time.perf_counter() - t_phase - sum(t_parts.values())

    shutil.rmtree(SURGERY_DIR, ignore_errors=True)
    SURGERY_DIR.mkdir(parents=True)
    meta = json.loads(META.read_text())
    cfg = config_from_meta(meta['model_config'], pallas_decode=True)
    gcfg = eval_generation_config(eval_train_config(cfg.max_len, meta['eval_gating']),
                                  cfg.max_len)
    type_masks = build_luts(default_tokenizer(max_len=cfg.max_len), device=dev)['type_masks']
    encoder, decoder = seeded_models(torch, dev, cfg)
    t0 = time.perf_counter()
    deep, wide, wide_enc = _surgery_models(torch, dev, cfg, encoder, decoder)
    print(f'surgery (a): deepen +{SURGERY_DEEPEN}, widen to {SURGERY_WIDE} (Dh '
          f'{wide.cfg.head_dim}), widen the encoder x2: {time.perf_counter() - t0:.1f} s on the '
          f'host; {sum(p.numel() for p in wide.parameters()) / 1e6:.1f}M decoder parameters')
    check(wide.cfg.head_dim == 144 and wide.cfg.pos_dim == cfg.d_model, 'surgery (a): wide cfg')

    # (a) greedy streams through K1 on the corpus's first 256 rows
    batch = batches[0]
    launches = {}
    outs = {}
    for name, dec in (('original', decoder), ('deepened', deep), ('widened', wide)):
        eval_batch(encoder, dec, batch, gcfg, type_masks=type_masks)    # warm-up
        torch.cuda.synchronize()
        decode_step_attention.launches = 0
        t0 = time.perf_counter()
        outs[name] = eval_batch(encoder, dec, batch, gcfg, type_masks=type_masks)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        n = decode_step_attention.launches
        steps = steps_run(outs[name]['generated'], EOS_ID)
        print(f'surgery (a): {name} decoder, {dec.cfg.num_layers} layers, d_model '
              f'{dec.cfg.d_model}: {BATCH} rows in {secs * 1e3:.1f} ms ({BATCH / secs:.0f} '
              f'formulas/s), {steps} decode steps, K1 launches {n} = {dec.cfg.num_layers} x '
              f'{steps}')
        check(n == dec.cfg.num_layers * steps and n > 0,
              f'surgery (a): {name}: K1 launches {n} != {dec.cfg.num_layers} x {steps}')
        launches[f'surgery {name}'] = n
    for name in ('deepened', 'widened'):
        ties = compare_streams(outs[name], outs['original'], EOS_ID,
                               f'surgery (a) {name} vs original')
        print(f'surgery (a): {name} streams equal the original\'s up to EOS; near-tie '
              f'divergences {ties}')
    gen = torch.Generator(device=dev).manual_seed(SEED)
    z = torch.randn(BATCH, cfg.latent_dim, generator=gen, device=dev)
    st = torch.randn(BATCH, cfg.stoich_input_dim, generator=gen, device=dev)
    hv = torch.randn(BATCH, cfg.heads_input_dim, generator=gen, device=dev)
    with torch.no_grad():
        want = decoder(z, batch['tokens'], st, hv)
        for name, dec in (('deepened', deep), ('widened', wide)):
            got = dec(z, batch['tokens'], st, hv)
            errs = {k: float((got[k] - want[k]).abs().max()) for k in (
                'logits', 'stop_logits', 'type_logits')}
            print(f'surgery (a): {name} TF heads vs the original: max abs '
                  + ', '.join(f'{k} {v:.2e}' for k, v in errs.items())
                  + f' (tol {SURGERY_TF_ATOL})')
            check(max(errs.values()) <= SURGERY_TF_ATOL, f'surgery (a): {name} TF heads')
        x = [batch[k] for k in ('element_indices', 'element_fractions', 'element_mask',
                                'magpie', 'tc')]
        e0, e1 = encoder(*x), wide_enc(*x)
        keys = ('z', 'tc_pred', 'sc_pred', 'fraction_pred', 'hp_pred', 'competence',
                'tc_class_logits', 'magpie_pred', 'family_composed_14')
        err = max(float((e1[k] - e0[k]).abs().max()) for k in keys)
        print(f'surgery (a): widened encoder vs the original: max abs {err:.2e} over {keys} '
              f'(tol {SURGERY_TF_ATOL})')
        check(err <= SURGERY_TF_ATOL, 'surgery (a): widened encoder outputs')
    del deep, wide, wide_enc, outs
    torch.cuda.empty_cache()
    part('(a) models')

    # K1 at the widened decoder's Dh, float32, B=256
    worst = max(k1_held(torch, gen, BATCH, cfg.nhead, cfg.max_len, 2 * cfg.head_dim,
                        torch.float32, p) for p in SURGERY_K1_POSITIONS)
    print(f'surgery (a): K1 float32 B={BATCH} H={cfg.nhead} T={cfg.max_len} '
          f'Dh={2 * cfg.head_dim} positions {SURGERY_K1_POSITIONS}: max_abs_err {worst:.3e} '
          f'(tol {K1_TOL["float32"]}) caches_equal=True')
    dh144 = k1_position_means(torch, gen, BATCH, cfg.nhead, cfg.max_len, 2 * cfg.head_dim,
                              torch.float32, 'surgery (a)')
    part('(a) K1')

    # (b) a saved seeded checkpoint, deepened by the migrate CLI; the eval CLI on both
    from superconductor_vae_tpu_torch.scripts import evaluate, migrate_checkpoint
    csv = SURGERY_DIR / 'head.csv'
    with gzip.open(CSV, 'rt') as fh:
        csv.write_text(''.join(next(fh) for _ in range(SURGERY_CSV_ROWS + 1)))
    src = save_params_checkpoint(SURGERY_DIR / 'src', {
        'enc_params': encoder.state_dict(), 'dec_params': decoder.state_dict()}, {
        'epoch': 0, 'model_config': dataclasses.asdict(dataclasses.replace(
            cfg, pallas_decode=False)), 'eval_gating': meta['eval_gating'],
        'data_norm': {'skew_transform': ckpt_skew_transform(meta)}})
    del encoder, decoder
    torch.cuda.empty_cache()
    deep_ckpt = migrate_checkpoint.main(['deepen', str(src), '--layers', str(SURGERY_DEEPEN),
                                         '--out', str(SURGERY_DIR / 'deep')])
    common = ['--pallas-decode', '--csv', str(csv)]
    evals = {}
    for name, path, layers in (('source', src, cfg.num_layers),
                               ('deepened', deep_ckpt, cfg.num_layers + SURGERY_DEEPEN)):
        evals[name], _, n, _ = _counted_cli(
            torch, f'(b) eval CLI {name}', lambda: evaluate.main(
                ['--checkpoint', str(path), '--limit', str(DIAG_ROWS)] + common), layers)
        launches[f'surgery eval CLI {name}'] = n
    a, b = evals['source'], evals['deepened']
    print(f'surgery (b): eval CLI --limit {DIAG_ROWS}: source true-AR {a["true_ar_exact"]} TF '
          f'{a["tf_exact"]}; deepened true-AR {b["true_ar_exact"]} TF {b["tf_exact"]}')
    check((a['true_ar_exact'], a['tf_exact'], a['n_evaluated']) ==
          (b['true_ar_exact'], b['tf_exact'], b['n_evaluated']) and a['n_evaluated'] > 0,
          'surgery (b): the deepened checkpoint\'s exact match differs from the source\'s')
    part('(b)')

    # (c) the diagnostics through K1 on the source checkpoint
    from superconductor_vae_tpu_torch.scripts import (
        generation_quality, holdout_inversion_control, oracle_bisect, order_robust_eval)
    from superconductor_vae_tpu_torch.scripts.holdout_search import K1_LINE
    base = ['--checkpoint', str(src)] + common
    rates = {}
    layers = cfg.num_layers
    out, secs, n, rows = _counted_cli(torch, '(c) order_robust_eval', lambda: order_robust_eval.main(
        base + ['--limit', str(DIAG_ROWS), '--k', '2']), layers)
    check({'respelled_ar_exact', 'composition_exact', 'canonical_output_rate', 'z_cosine_mean',
           'z_cosine_p5'} <= set(out) and out['n_source_rows'] == DIAG_ROWS
          and 0.0 <= out['z_cosine_p5'] <= out['z_cosine_mean'] <= 1.0 + 1e-6,
          f'surgery (c): order_robust_eval {out}')
    print(f'surgery (c): order_robust_eval: {out}')
    launches['surgery order_robust_eval'], rates['order_robust_eval'] = n, rows / secs
    out, secs, n, rows = _counted_cli(torch, '(c) generation_quality',
                                      lambda: generation_quality.main(base + [
                                          '--limit', str(DIAG_ROWS), '--out',
                                          str(SURGERY_DIR / 'generation_quality.json')]), layers)
    check(out['n_evaluated'] > 0 and {'ar_exact', 'error_taxonomy', 'error_validity_rate',
                                      'error_mean_similarity'} <= set(out),
          f'surgery (c): generation_quality {out}')
    print(f'surgery (c): generation_quality: {out}')
    launches['surgery generation_quality'], rates['generation_quality'] = n, rows / secs
    out, secs, n, rows = _counted_cli(torch, '(c) oracle_bisect', lambda: oracle_bisect.main(
        base + ['--n', str(ORACLE_ROWS)]), layers)
    check(out['n_requested'] == ORACLE_ROWS and 0 < out['n_encoded'] <= ORACLE_ROWS
          and 0.0 <= out['train_oracle_exact'] <= 1.0 and 'sample_misses' in out,
          f'surgery (c): oracle_bisect {out}')
    print(f'surgery (c): oracle_bisect: train_oracle_exact {out["train_oracle_exact"]} of '
          f'{out["n_encoded"]}')
    launches['surgery oracle_bisect'], rates['oracle_bisect'] = n, rows / secs
    out, secs, n, rows = _counted_cli(torch, '(c) holdout_inversion_control',
                                      lambda: holdout_inversion_control.main(base + [
                                          '--n-scrambled', '2', '--n-non-sc', '1',
                                          '--budget', '64', '--inversion-steps', '16',
                                          '--refine-rounds', '0',
                                          '--out', str(SURGERY_DIR / 'control.json')]), layers)
    s = out['summary']
    check(s['n_controls'] == 3 and {k: v['n'] for k, v in s['by_kind'].items()} ==
          {'scrambled': 2, 'mutated_non_sc': 1}, f'surgery (c): inversion control {s}')
    print(f'surgery (c): holdout_inversion_control: {s["by_kind"]}, hit rate {s["hit_rate"]}')
    launches['surgery holdout_inversion_control'] = n
    rates['holdout_inversion_control'] = rows / secs
    print('surgery (c): formulas/s through K1: '
          + ', '.join(f'{k} {v:.1f}' for k, v in rates.items()))
    part('(c) diagnostics')

    # the campaign driver in a subprocess, twice; its searches are
    # subprocesses that print their own K1 launches
    cmd = [sys.executable, '-u', '-m', 'superconductor_vae_tpu_torch.scripts.holdout_campaign',
           *base, *CAMPAIGN, '--out', str(SURGERY_DIR / 'campaign' / 'summary.json')]
    n_campaign = 0
    for run in (1, 2):
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=900)
        secs = time.perf_counter() - t0
        check(proc.returncode == 0, f'surgery (c): campaign run {run} exit code '
              f'{proc.returncode}: {proc.stderr[-3000:]}')
        counts = [int(line.split()[-1]) for line in proc.stdout.splitlines()
                  if line.startswith(K1_LINE)]
        started = [line for line in proc.stdout.splitlines() if line.endswith(': running')]
        summary = json.loads((SURGERY_DIR / 'campaign' / 'summary.json').read_text())
        print(f'surgery (c): campaign run {run}: {secs:.1f} s, {len(started)} searches '
              f'started, their K1 launches {counts}; targets_completed '
              f'{summary["targets_completed"]}, n_missing {summary["n_missing"]}')
        check(summary['targets_completed'] == CAMPAIGN_TARGETS and summary['n_missing'] == 0
              and len(summary['per_target']) == CAMPAIGN_TARGETS
              and 'mean_similarity' in summary,
              f'surgery (c): campaign summary {summary}')
        if run == 1:
            check(len(started) == len(counts) == CAMPAIGN_TARGETS
                  and all(c > 0 for c in counts),
                  f'surgery (c): campaign run 1 started {started}, K1 {counts}')
            n_campaign = sum(counts)
        else:
            check(not started and not counts
                  and proc.stdout.count(': cached') == CAMPAIGN_TARGETS,
                  f'surgery (c): the second campaign run started a search: {proc.stdout}')
    launches['surgery campaign (subprocesses)'] = n_campaign
    part('(c) campaign')

    # (d) the legacy models, card against CPU
    legacy_check(torch, dev)
    part('(d)')
    shutil.rmtree(SURGERY_DIR, ignore_errors=True)
    print(f'surgery: the phase {time.perf_counter() - t_phase:.1f} s: '
          + ', '.join(f'{k} {v:.1f} s' for k, v in t_parts.items()))
    return launches, dh144


def legacy_check(torch, dev):
    """(d) One forward and one backward of BidirectionalVAE.loss (fed noise),
    PointerGeneratorDecoder and GroupedFeatureEncoder (with its attention
    map) on the card and on the CPU from the same weights and inputs: the
    loss and the output within LEGACY_REL of the largest CPU value, every
    parameter gradient within LEGACY_REL of the model's largest CPU
    gradient component."""
    from superconductor_vae_tpu_torch.models.feature_groups import (
        EXTENDED_GROUP_DIMS, GroupedFeatureEncoder)
    from superconductor_vae_tpu_torch.models.legacy import (
        BidirectionalVAE, PointerGeneratorDecoder)
    gen = torch.Generator().manual_seed(SEED)
    b = 64

    def vae_loss(m, inputs):
        x, tc, eps = inputs
        out = m(x, noise=eps)
        return m.loss(out, x, tc)['total'], out['recon']

    def pg_loss(m, inputs):
        src, mask, tgt = inputs
        out = m(src, mask, tgt)
        return -out['log_probs'].gather(-1, tgt[..., None]).mean(), out['log_probs']

    def fg_loss(m, inputs):
        out, attn = m(inputs, return_attention=True)
        return (out ** 2).mean() + attn.var(), out

    groups = {k: torch.randn(b, d, generator=gen) for k, d in EXTENDED_GROUP_DIMS.items()}
    groups['experimental'] = None                   # an absent group
    cases = [
        ('BidirectionalVAE.loss', lambda d: BidirectionalVAE(device=d), vae_loss,
         (torch.randn(b, 145, generator=gen), torch.randn(b, generator=gen),
          torch.randn(b, 64, generator=gen))),
        ('PointerGeneratorDecoder', lambda d: PointerGeneratorDecoder(4752, device=d), pg_loss,
         (torch.randint(5, 4752, (b, 12), generator=gen),
          torch.arange(12)[None, :] < torch.randint(1, 13, (b, 1), generator=gen),
          torch.randint(0, 4752, (b, 30), generator=gen))),
        ('GroupedFeatureEncoder', lambda d: GroupedFeatureEncoder(EXTENDED_GROUP_DIMS,
                                                                  device=d), fg_loss, groups),
    ]
    for name, build, loss_fn, inputs in cases:
        torch.manual_seed(SEED)
        cpu = build('cpu').eval()
        card = build(dev).eval()
        card.load_state_dict(cpu.state_dict())
        moved = ({k: None if v is None else v.to(dev) for k, v in inputs.items()}
                 if isinstance(inputs, dict) else tuple(v.to(dev) for v in inputs))
        results = []
        for m, inp in ((cpu, inputs), (card, moved)):
            loss, out = loss_fn(m, inp)
            loss.backward()
            results.append((loss, out, {k: p.grad for k, p in m.named_parameters()
                                        if p.grad is not None}))
        (l_h, o_h, g_h), (l_c, o_c, g_c) = results
        check(set(g_h) == set(g_c) and g_h, f'surgery (d): {name}: gradient sets differ')
        # a gradient that is zero in exact arithmetic (a key bias under the
        # softmax) holds only rounding noise, so each is held against the
        # largest gradient of its model
        g_scale = max(float(g.abs().max()) for g in g_h.values())
        errs = {'loss': _rel_err(torch, l_c, l_h), 'output': _rel_err(torch, o_c, o_h),
                'gradients': max(float((g_c[k].cpu() - g_h[k]).abs().max()) for k in g_h)
                / g_scale}
        print(f'surgery (d): {name} card vs CPU, of the largest CPU value (gradients: of the '
              f'model\'s largest gradient component): '
              + ', '.join(f'{k} {v:.2e}' for k, v in errs.items())
              + f' over {len(g_h)} parameter gradients (tol {LEGACY_REL})')
        check(max(errs.values()) <= LEGACY_REL, f'surgery (d): {name} card vs CPU')


# -- dist phase -----------------------------------------------------------------

N_DIST_STEPS = 1                   # default steps a world, warm-up included (the smoke's clock)
N_DIST_RL_STEPS = 1
DIST_TOL = dict(rtol=1e-5, atol=1e-7)   # tests/test_torch_port_distributed.py's
# AdamW moments against the one-process step's: of each group's largest.
# The CPU tests hold them to 1e-5; on the card float32 GEMMs sum a 128-row
# shard in another order than the 256-row batch (4.98e-5 measured at gloo
# world 2 on an H100 80GB HBM3 at 700 W)
DIST_MOMENT_REL = 1e-4
DIST_GLOO_WORLD = 2


def dist_phase(torch, dev, batches):
    """Data parallelism (parallel/, the train step's global-batch shares):
    (a) scripts/dryrun_multichip.py's ``run_dp`` in NCCL ranks, one a card
    (torch.cuda.device_count()), and in gloo ranks, DIST_GLOO_WORLD of
    them on this card: at run4 width (dropout 0, the set decoder's too) the
    DP default step at TrainConfig(batch_size=256)'s defaults for
    N_DIST_STEPS steps and the DP SCST step (the same with rl_w 1, the
    rollout heads fixed as in the e2e phase) for N_DIST_RL_STEPS, each
    against the one-process step that rank 0 runs from the same state
    (metrics within DIST_TOL, the gradient norm within METRIC_TOL, AdamW
    moments within DIST_MOMENT_REL of each group's largest, printed by
    group), every rank's parameters and moments rank 0's; K1 348 launches
    a step on the rank that holds the round trip (rank 0) and none on the
    others in the default step, and in the SCST step 348 more on every
    rank (each rank rolls out the whole global batch); samples/s of the DP
    steps beside the one-process step's; (b) one step of 32 rows under
    debug_numerics (utils/debug.py) and a NaN put into a weight raising
    with its module's name; (c) the reference-checkpoint converter at run4
    widths: TF logits card vs CPU; (d) the native tokenizer and parser on
    the corpus's formulas bit-equal to the Python path, host seconds of
    each.  Returns the K1 launches of the DP steps by world."""
    import numpy as np
    import superconductor_vae_tpu_torch.native as native
    from superconductor_vae_tpu_torch.checkpoint import torch_convert
    from superconductor_vae_tpu_torch.data import composition_slots, read_csv_rows
    from superconductor_vae_tpu_torch.models import FormulaDecoder, config_from_meta
    from superconductor_vae_tpu_torch.ops.rl import RLConfig
    from superconductor_vae_tpu_torch.scripts import dryrun_multichip
    from superconductor_vae_tpu_torch.tokenizer import default_tokenizer
    from superconductor_vae_tpu_torch.training import (
        TrainConfig, build_luts, create_train_state, default_dyn, make_train_step)
    from superconductor_vae_tpu_torch.utils.debug import enable_nan_debugging

    meta = json.loads(META.read_text())
    cfg = config_from_meta(meta['model_config'], pallas_decode=True)
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    cfg0 = config_from_meta(meta['model_config'], pallas_decode=True, dropout=0.0)
    cases = []
    for rl_on in (False, True):
        tcfg = TrainConfig(batch_size=BATCH, rl=RLConfig(max_len=cfg0.max_len))
        state = no_set_dropout(create_train_state(cfg0, tcfg, seed=SEED, device=dev))
        if rl_on:
            fix_rollout_heads(torch, state.decoder)
        dyn = dict(default_dyn(tcfg), physz_w=float(meta['controllers']['physz']['weight']),
                   rl_w=1.0 if rl_on else 0.0)
        cases.append(dryrun_multichip.dp_case(state, tcfg, dyn, rl=rl_on,
                                              steps=N_DIST_RL_STEPS if rl_on else None))
        del state
    job = dict(cases=cases, max_len=cfg0.max_len, seed=SEED, snapshots=False,
               batches=[{k: v.cpu() for k, v in b.items()} for b in batches[:N_DIST_STEPS]])
    per_step = cfg.num_layers * (cfg.max_len - 1)
    rt_rows = max(int(BATCH * TrainConfig().round_trip_subset_fraction), 1)
    launches = {}
    for backend, world in (('nccl', torch.cuda.device_count()), ('gloo', DIST_GLOO_WORLD)):
        name = f'{backend} world {world}'
        t0 = time.perf_counter()
        ranks = dryrun_multichip.run_dp(job, world, 'cuda', backend)
        wall = time.perf_counter() - t0
        worst = dryrun_multichip.check_dp(ranks, DIST_TOL, METRIC_TOL, DIST_MOMENT_REL,
                                          f'chip_smoke: dist ({name})')
        for c, what in enumerate(('default', 'SCST')):
            for r, res in enumerate(ranks):
                want = per_step * ((r == 0) + c)
                got = [s['k1'] for s in res['cases'][c]['step']['steps']]
                check(got == [want] * len(got),
                      f'dist ({name}) {what}: rank {r} launched K1 {got} times a step, not '
                      f'{want}')
        launches[name] = sum(s['k1'] for res in ranks for case in res['cases']
                             for s in case['step']['steps'])
        steps0, rl0 = (ranks[0]['cases'][c]['step']['steps'] for c in (0, 1))
        print(f'dist ({name}): {world} ranks on {torch.cuda.device_count()} card(s), '
              f'{N_DIST_STEPS} DP default steps of {BATCH} ({steps0[0]["rows"]} rows a rank) '
              f'and {N_DIST_RL_STEPS} DP SCST steps, each against the one-process step from the '
              f'same state: metrics within {DIST_TOL["rtol"]:g} (grad_norm '
              f'{METRIC_TOL["rtol"]:g}), moments within {worst:.2e} of each group\'s largest '
              f'(tol {DIST_MOMENT_REL:g}); K1 {per_step} a default step on rank 0 (the round '
              f'trip\'s {rt_rows} rows), 0 elsewhere, and {per_step} more a SCST step on every '
              f'rank; parameters and moments equal on every rank; peak '
              f'{max(r["peak_gib"] for r in ranks):.2f} GiB; the phase part {wall:.1f} s')
        print(f'dist ({name}): train samples/s by step (warm-up included): DP '
              + ', '.join(f'{BATCH / s["seconds"]:.1f}' for s in steps0) + '; one process '
              + ', '.join(f'{BATCH / s["one_seconds"]:.1f}' for s in steps0) + f' [{card}]')
        print(f'dist ({name}): SCST steps of {BATCH}, seconds by step (warm-up '
              f'included): DP by rank ' + '; '.join(
                  f'{r}: ' + ', '.join(f'{s["seconds"]:.3f}' for s in res['cases'][1]['step'][
                      'steps']) for r, res in enumerate(ranks))
              + '; one process ' + ', '.join(f'{s["one_seconds"]:.3f}' for s in rl0)
              + f'; every rank rolls out the gathered [2 x {BATCH}] rows [{card}]')
        print(f'dist ({name}): default-step moments against the one-process step, of each '
              f'group\'s largest (group column: step 0, 1, 2): ' + '; '.join(
                  f'{k} ' + ', '.join(f'{s["moments_worst"][k]:.1e}' for s in steps0)
                  for k in steps0[0]['moments_worst']))

    # (b) debug_numerics: one step of 32 rows (without the round trip's
    # rollout, whose ops would each wait for the card), then a NaN put in
    tcfg = TrainConfig(batch_size=32, use_round_trip=False)
    luts = build_luts(default_tokenizer(max_len=cfg.max_len), device=dev)
    state = create_train_state(cfg, tcfg, seed=SEED, device=dev)
    small = {k: v[:32] for k, v in batches[0].items()}
    dyn = default_dyn(tcfg)
    modules = (state.encoder, state.decoder, state.pz_proj, state.set_decoder)
    dbg = enable_nan_debugging(*modules)
    try:
        t0 = time.perf_counter()
        state, m = make_train_step(tcfg, luts)(state, small, SEED, dyn)
        dbg_s = time.perf_counter() - t0
    finally:
        dbg.remove()
    check(np.isfinite(m['total'].item()), 'dist (b): a debug step\'s loss is not finite')
    with torch.no_grad():
        state.decoder.layer_3.ff2.weight[0, 0] = float('nan')
    dbg = enable_nan_debugging(*modules)
    try:
        make_train_step(tcfg, luts)(state, small, SEED, dyn)
        raised = ''
    except FloatingPointError as e:
        raised = str(e)
    finally:
        dbg.remove()
    check('layer_3.ff2' in raised, f'dist (b): the injected NaN raised {raised!r}')
    print(f'dist (b): one step of 32 rows (no round trip) under debug_numerics {dbg_s:.2f} s '
          f'[{card}], loss {m["total"].item():.4f}; a NaN in decoder.layer_3.ff2 raised: '
          f'{raised}')
    del state
    torch.cuda.empty_cache()

    # (c) the reference-checkpoint converter at run4 widths: TF logits
    rng = np.random.default_rng(SEED)
    shapes = {k: tuple(v.shape) for k, v in FormulaDecoder(cfg, device='cpu').state_dict().items()}
    ref_sd = {}
    for kind, ref, port in torch_convert.decoder_name_map(cfg):
        ref_sd[f'{ref}.weight'] = torch.from_numpy(
            rng.standard_normal(shapes[f'{port}.weight']).astype(np.float32) * 0.05)
        if f'{port}.bias' in shapes:
            ref_sd[f'{ref}.bias'] = torch.from_numpy(
                rng.standard_normal(shapes[f'{port}.bias']).astype(np.float32) * 0.05)
    d = cfg.d_model
    for i in range(cfg.num_layers):
        for attn in ('self_attn', 'multihead_attn'):
            tl = f'transformer_decoder.layers.{i}.{attn}'
            ref_sd[f'{tl}.in_proj_weight'] = torch.from_numpy(
                rng.standard_normal((3 * d, d)).astype(np.float32) * 0.05)
            ref_sd[f'{tl}.in_proj_bias'] = torch.zeros(3 * d)
    sd = torch_convert.convert_decoder_state(ref_sd, cfg)
    decs = {}
    for where in ('cpu', dev):
        decs[where] = FormulaDecoder(cfg, device=where)
        decs[where].load_state_dict(sd, strict=True)
        decs[where].eval()
    b = 8
    inputs = (torch.from_numpy(rng.standard_normal((b, cfg.latent_dim)).astype(np.float32)),
              batches[0]['tokens'][:b].cpu(),
              torch.from_numpy(rng.random((b, cfg.stoich_input_dim)).astype(np.float32)),
              torch.from_numpy(rng.standard_normal((b, cfg.heads_input_dim)).astype(np.float32)))
    with torch.no_grad():
        want = decs['cpu'](*inputs)['logits']
        got = decs[dev](*(x.to(dev) for x in inputs))['logits'].cpu()
    err = ((got - want).abs().max() / want.abs().max()).item()
    print(f'dist (c): a reference-layout decoder state dict at run4 widths '
          f'({len(ref_sd)} tensors) through checkpoint/torch_convert.py: TF logits card vs '
          f'CPU {err:.2e} of the largest (tol {METRIC_TOL["rtol"]:g})')
    check(err <= METRIC_TOL['rtol'], 'dist (c): converted decoder card vs CPU')
    del decs
    torch.cuda.empty_cache()

    # (d) the native tokenizer against the Python path on the corpus
    formulas = read_csv_rows(CSV)['formula']
    tok = default_tokenizer(max_len=cfg.max_len)
    t0 = time.perf_counter()
    native.build()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    n_tok = native.tokenize_batch(formulas, tok)
    n_comp = native.parse_compositions(formulas, tok)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    p_tok = tok.encode_batch(formulas)
    p_comp = composition_slots(formulas)
    python_s = time.perf_counter() - t0
    check(np.array_equal(n_tok, p_tok) and all(
        np.array_equal(a, b) and a.dtype == b.dtype for a, b in zip(n_comp, p_comp)),
        'dist (d): the native tokenizer or parser differs from the Python path')
    print(f'dist (d): native tokenizer and parser ({native.library_path().name}, built or '
          f'found in {build_s:.2f} s) on the {len(formulas)} corpus formulas: {native_s:.3f} s '
          f'on the host against the Python path\'s {python_s:.3f} s '
          f'({python_s / native_s:.1f}x) [{card}], tokens and compositions bit-equal; the data '
          f'phase\'s load_dataset ran the native path and matched the corpus constants')
    return launches


# -- TP phase -------------------------------------------------------------------

N_TP_STEPS = 1                     # warm-up included (the smoke's clock)
TP_DECODE_ROWS = BATCH


def tp_phase(torch, dev, batches, world=2, backend='gloo'):
    """Tensor parallelism (parallel/mesh.py, parallel/tensor.py, the train
    step over a grid): scripts/dryrun_multichip.py's ``run_tp`` in
    ``world`` ranks, 2 on the model axis (2 gloo ranks on this card, a 1 x
    2 grid, by default; 4 NCCL ranks on four cards, a 2 x 2 grid), at run4
    width with dropout 0 (the
    set decoder's too) and TrainConfig(batch_size=256)'s defaults, for
    N_TP_STEPS steps against the one-process step that rank 0 runs from
    the gathered state (metrics within DIST_TOL, the gradient norm within
    METRIC_TOL, AdamW moments within DIST_MOMENT_REL of each group's
    largest, printed by group); the replicated parameters and their
    gradients equal across each model group; K1 348 launches a step on
    each rank of data index 0 (the round trip's rows), at 4 heads, and
    none on the others; then the first TP_DECODE_ROWS corpus rows decoded
    greedily with run4's gates through the TP decoder and the whole one
    (the e2e phase's fixed heads): streams equal but at near-ties, K1 = 12
    x 29 on each rank.  Returns K1's launches on every rank."""
    from superconductor_vae_tpu_torch.models import config_from_meta
    from superconductor_vae_tpu_torch.scripts import dryrun_multichip
    from superconductor_vae_tpu_torch.tokenizer import EOS_ID
    from superconductor_vae_tpu_torch.training import (
        TrainConfig, create_train_state, default_dyn, eval_generation_config,
        eval_train_config)

    meta = json.loads(META.read_text())
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    cfg0 = config_from_meta(meta['model_config'], pallas_decode=True, dropout=0.0)
    tcfg = TrainConfig(batch_size=BATCH)
    state = no_set_dropout(create_train_state(cfg0, tcfg, seed=SEED, device=dev))
    fix_rollout_heads(torch, state.decoder)
    dyn = dict(default_dyn(tcfg), physz_w=float(meta['controllers']['physz']['weight']))
    gcfg = eval_generation_config(eval_train_config(cfg0.max_len, meta['eval_gating']),
                                  cfg0.max_len)
    decode_batch = {k: v[:TP_DECODE_ROWS].cpu() for k, v in batches[0].items()}
    job = dict(cases=[dryrun_multichip.dp_case(state, tcfg, dyn)], max_len=cfg0.max_len,
               seed=SEED, snapshots=False,
               batches=[{k: v.cpu() for k, v in b.items()} for b in batches[:N_TP_STEPS]],
               decode=dict(case=0, batch=decode_batch, gcfg=gcfg, type_masks=True))
    del state
    torch.cuda.empty_cache()
    per_step = cfg0.num_layers * (cfg0.max_len - 1)
    t0 = time.perf_counter()
    ranks = dryrun_multichip.run_tp(job, world, 'cuda', n_model=2, backend=backend,
                                    timeout=600)
    wall = time.perf_counter() - t0
    grid = f'{world // 2} x 2 grid of {backend} ranks on {torch.cuda.device_count()} card(s)'
    worst = dryrun_multichip.check_tp(ranks, DIST_TOL, METRIC_TOL, DIST_MOMENT_REL,
                                      f'chip_smoke: tp ({grid})')
    for r, res in enumerate(ranks):
        want = per_step if res['grid'][0] == 0 else 0
        got = [s['k1'] for s in res['cases'][0]['step']['steps']]
        check(got == [want] * len(got),
              f'tp: rank {r} launched K1 {got} times a step, not {want}')
    steps0 = ranks[0]['cases'][0]['step']['steps']
    n_sharded = ranks[0]['cases'][0]['step']['n_sharded']
    print(f'tp: run4 widths on a {grid}, {n_sharded} decoder '
          f'parameters sharded, {cfg0.nhead // 2} heads a rank; {N_TP_STEPS} default steps of '
          f'{BATCH} rows ({steps0[0]["rows"]} a rank) against the one-process step from the '
          f'gathered state: metrics within '
          f'{DIST_TOL["rtol"]:g} (grad_norm {METRIC_TOL["rtol"]:g}), total within '
          f'{dryrun_multichip.TP_TOTAL_TOL:g}, moments within {worst:.2e} of each group\'s '
          f'largest (tol {DIST_MOMENT_REL:g}); replicated parameters and gradients equal '
          f'across each model group; K1 {per_step} a step on each rank of data index 0 at '
          f'H={cfg0.nhead // 2}, 0 elsewhere; peak '
          f'{max(r["peak_gib"] for r in ranks):.2f} GiB a rank; the phase part {wall:.1f} s')
    print(f'tp: train samples/s by step (warm-up included): TP by rank '
          + '; '.join(f'{r}: ' + ', '.join(f'{BATCH / s["seconds"]:.1f}' for s in res['cases'][0][
              'step']['steps']) for r, res in enumerate(ranks))
          + '; one process ' + ', '.join(f'{BATCH / s["one_seconds"]:.1f}' for s in steps0)
          + f' [{card}]')
    print('tp: moments against the one-process step, of each group\'s largest (by step): '
          + '; '.join(f'{k} ' + ', '.join(f'{s["moments_worst"][k]:.1e}' for s in steps0)
                      for k in steps0[0]['moments_worst']))

    tp, one = ranks[0]['decode']['tp'], ranks[0]['decode']['one']
    for r, res in enumerate(ranks):
        check(res['decode']['tp']['k1'] == per_step,
              f'tp: the decode launched K1 {res["decode"]["tp"]["k1"]} times on rank {r}, '
              f'not {per_step}')
    ties = compare_streams(tp, one, EOS_ID, 'tp decode')
    tf_same = float((tp['tf_pred'] == one['tf_pred']).float().mean())
    print(f'tp: greedy eval_batch of the first {TP_DECODE_ROWS} corpus rows through the TP '
          f'decoder and the whole one: streams equal up to EOS but {ties} near-tie rows '
          f'(top-two gap < {TIE:g}); TF argmax equal at {tf_same:.4f} of positions; K1 '
          f'{per_step} on each rank; formulas/s TP '
          f'{TP_DECODE_ROWS / tp["seconds"]:.1f}, one process '
          f'{TP_DECODE_ROWS / one["seconds"]:.1f} [{card}]')
    return sum(s['k1'] for res in ranks for s in res['cases'][0]['step']['steps']) \
        + sum(res['decode']['tp']['k1'] for res in ranks)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available; this script runs on a GPU only',
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from superconductor_vae_tpu_torch.ops import _build

    t_start = time.perf_counter()
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'],
                         capture_output=True, text=True, check=True).stdout
    print(smi.strip().splitlines()[0])
    print(f'python {sys.version.split()[0]}, torch {torch.__version__}, '
          f'CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}')
    torch.backends.cuda.matmul.allow_tf32 = False     # float32 matmuls in full float32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device('cuda')

    t0 = time.perf_counter()
    libs = _build.build('decode_attention', 'flash_attention')   # one nvcc each, together
    print(f'build: {time.perf_counter() - t0:.1f} s')
    build_report(libs, _build.nvcc())

    phase_s = {'build': time.perf_counter() - t0}

    def timed(name, out):
        phase_s[name] = time.perf_counter() - t_start - sum(phase_s.values())
        print(f'phase {name}: {phase_s[name]:.1f} s', flush=True)
        return out

    k1, k1_err = timed('kernel', kernel_phase(torch, dev))
    ds, batches = timed('data', data_phase(torch, dev))
    launches, (encoder, decoder) = timed('e2e', e2e_phase(torch, dev, ds, batches))
    real_launches = timed('real', real_weights_phase(torch, dev, ds, batches))
    spec_launches = timed('spec', spec_phase(torch, dev, ds, batches, encoder, decoder))
    del encoder, decoder
    torch.cuda.empty_cache()
    k2_rows, k2_err, k2_launches = timed('k2', k2_phase(torch, dev))
    step_rate, _ = timed('train', train_phase(torch, dev, batches))
    defaults_launches, _, _ = timed('defaults', defaults_phase(torch, dev, batches))
    soft_launches = timed('soft', soft_token_phase(torch, dev, batches))
    dist_launches = timed('dist', dist_phase(torch, dev, batches))
    tp_launches = timed('tp', tp_phase(torch, dev, batches))
    rl_results = timed('rl', rl_phase(torch, dev, batches))
    k1_bf16, k1_bf16_err = timed('k1 bf16', k1_bf16_phase(torch, dev))
    bench_launches, _ = timed('bench', bench_phase(torch, dev))
    loop_launches = timed('loop', loop_phase(torch, dev, ds, step_rate))
    resume_launches = timed('resume', resume_phase(torch, dev))
    p2_launches, p2_bf16_launches = timed('phase2', phase2_phase(torch, dev, ds))
    holdout_launches, k1_b2048 = timed('holdout', holdout_phase(torch, dev, ds))
    surgery_launches, k1_dh144 = timed('surgery', surgery_phase(torch, dev, ds, batches))

    k1_paths = {'eval': launches, 'real weights (run4)': real_launches,
                'spec (plain scan)': spec_launches,
                'defaults (round trip)': defaults_launches,
                'soft-token (round trip)': soft_launches,
                **{f'dist {k} (round trip, SCST rollout)': v for k, v in dist_launches.items()},
                'tp gloo 1 x 2 (round trip and decode, H=4, both ranks)': tp_launches,
                'rl scst': rl_results['scst'][1], 'rl rloo': rl_results['rloo'][1],
                'loop': loop_launches, 'phase2': p2_launches, 'holdout': holdout_launches,
                **surgery_launches}
    launches = sum(k1_paths.values())
    k1_bf16_paths = {'bench probes: train, rl and gen': bench_launches,
                     **resume_launches, 'phase2 bf16': p2_bf16_launches}
    bf16_launches = sum(k1_bf16_paths.values())
    print(f'total: {time.perf_counter() - t_start:.1f} s; by phase: '
          + ', '.join(f'{k} {v:.1f} s' for k, v in phase_s.items()))
    print(f'kernels: ["K1 decode_step_attention", "K1 decode_step_attention bf16", '
          f'"K2 flash_attention", "K2 flash_attention bf16"] launches: '
          f'{{"K1 decode_step_attention": {launches} {k1_paths}, '
          f'"K1 decode_step_attention bf16": {bf16_launches} {k1_bf16_paths}, '
          f'"K2 flash_attention": {k2_launches[torch.float32]}, "K2 flash_attention bf16": '
          f'{k2_launches[torch.bfloat16]}}}')
    print(json.dumps({'kernels': [{
        'name': 'K1 decode_step_attention', 'route': 'cuda',
        'source': 'superconductor_vae_tpu_torch/csrc/decode_attention.cu',
        'replaces': 'superconductor_vae_tpu/ops/pallas_decode.py:80',
        'launches': launches, 'max_abs_err': k1_err,
        **k1, 'b2048': k1_b2048, 'dh144': k1_dh144,
    }, {
        'name': 'K1 decode_step_attention bf16', 'route': 'cuda',
        'source': 'superconductor_vae_tpu_torch/csrc/decode_attention.cu',
        'replaces': 'superconductor_vae_tpu/ops/pallas_decode.py:80',
        'launches': bf16_launches, 'max_abs_err': k1_bf16_err,
        **k1_bf16,
    }, {
        'name': 'K2 flash_attention', 'route': 'cuda',
        'source': 'superconductor_vae_tpu_torch/csrc/flash_attention.cu',
        'replaces': 'superconductor_vae_tpu/ops/pallas_attention.py:73',
        'launches': k2_launches[torch.float32], 'max_abs_err': k2_err[torch.float32],
        **k2_rows[(torch.float32, 128)],
    }, {
        'name': 'K2 flash_attention bf16', 'route': 'cuda',
        'source': 'superconductor_vae_tpu_torch/csrc/flash_attention.cu',
        'replaces': 'superconductor_vae_tpu/ops/pallas_attention.py:73',
        'launches': k2_launches[torch.bfloat16], 'max_abs_err': k2_err[torch.bfloat16],
        **k2_rows[(torch.bfloat16, 128)],
    }]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
