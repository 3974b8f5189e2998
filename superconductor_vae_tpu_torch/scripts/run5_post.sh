#!/bin/sh
# The post-training evaluation battery of the converged run5 model over the
# port (scripts/run5_post.sh of the JAX package, the same flags), run one
# after another on one card, from the repo root:
#   sh superconductor_vae_tpu_torch/scripts/run5_post.sh [checkpoint] [results dir]
# The checkpoint is in the port's format (default: a params-only snapshot
# written by snapshot_params); the results go to their own directory, so
# that the JAX package's committed results/run5/ stay as they are.
set -x
CKPT=${1:-outputs/run5/snapshot}
OUT=${2:-results/run5_port}
CSV=data/processed/jarvis_merged_v2.csv.gz
mkdir -p "$OUT"

# 1. the whole-corpus eval (all 47,494 rows) with per-sample error records
python -m superconductor_vae_tpu_torch.scripts.evaluate --checkpoint "$CKPT" --csv "$CSV" \
  --batch-size 512 --errors-out "$OUT/final_eval_errors.jsonl" \
  --out "$OUT/final_eval.json"

# 2. order-robust AR: K=2 respellings of a 2,048-row stratified slice
python -m superconductor_vae_tpu_torch.scripts.order_robust_eval --checkpoint "$CKPT" --csv "$CSV" \
  --limit 2048 --k 2 --out "$OUT/order_robust.json"

# 3. oracle reconstruction of the holdout targets
python -m superconductor_vae_tpu_torch.scripts.holdout_search --checkpoint "$CKPT" --csv "$CSV" \
  --oracle-only --out "$OUT/oracle_reconstruction.json"

# 4. the decode A/B on the same slice: plain attention, K1, speculative
python -m superconductor_vae_tpu_torch.scripts.evaluate --checkpoint "$CKPT" --csv "$CSV" \
  --limit 2048 --out "$OUT/eval_ab_xla.json"
python -m superconductor_vae_tpu_torch.scripts.evaluate --checkpoint "$CKPT" --csv "$CSV" \
  --limit 2048 --pallas-decode --out "$OUT/eval_ab_pallas.json"
python -m superconductor_vae_tpu_torch.scripts.evaluate --checkpoint "$CKPT" --csv "$CSV" \
  --limit 2048 --speculative --out "$OUT/eval_ab_spec.json"
