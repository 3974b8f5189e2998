#!/bin/sh
# Run5's recipe over the port (scripts/launch_run5.sh of the JAX package,
# the same flags): a fine-tune of run4@899 on the 47,494-row corpus at a
# 50/50 SC balance (jarvis_merged_v2.csv.gz), the quantile skew transform,
# order augmentation K=1 (one extra spelling a row already doubles an
# epoch's draws) and the chunked RL epochs.
#
# Seed outputs/run5/checkpoints/epoch_00899 with run4's snapshot first, as
# the JAX recipe does, so that `--resume auto` picks it up: the port reads
# the JAX package's Orbax checkpoint itself, so a symlink will do
#   mkdir -p outputs/run5/checkpoints
#   ln -s ../../../results/run4/ckpt_snapshot outputs/run5/checkpoints/epoch_00899
# The inputs shift under the new normalisation and corpus, so expect an
# early dip in exact match that the fine-tune recovers. Run from the repo
# root.
exec python -u -m superconductor_vae_tpu_torch.scripts.train_resilient --stall-timeout 1800 -- \
  --csv data/processed/jarvis_merged_v2.csv.gz --epochs 1100 \
  --batch-size 128 --bf16 --lr 1e-4 --checkpoint-interval 25 \
  --output outputs/run5 --resume auto \
  --set lr_warmup_epochs=0 --set rl_epoch_interval=3 \
  --set phase2_enabled=true --set phase2_interval=16 \
  --set eval_interval=8 --set order_augment=1 \
  --set skew_transform=quantile --set resume_grace_epochs=30
