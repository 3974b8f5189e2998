#!/bin/sh
# Run5's second resume over the port (scripts/launch_run5_r5.sh of the JAX
# package, the same flags): launch_run5_resume.sh with one change,
# order_augment_resample=true, which redraws every augmented row's element
# order each epoch, so that training supervises the rule (emit the
# elements in the conditioning's order) and not one extra spelling.
# Run from the repo root.
exec python -u -m superconductor_vae_tpu_torch.scripts.train_resilient --stall-timeout 1800 -- \
  --csv data/processed/jarvis_merged_v2.csv.gz --epochs 1300 \
  --batch-size 128 --bf16 --lr 1e-4 --checkpoint-interval 25 \
  --output outputs/run5 --resume auto \
  --set lr_warmup_epochs=0 --set rl_epoch_interval=3 \
  --set phase2_enabled=true --set phase2_interval=16 \
  --set eval_interval=8 --set order_augment=1 \
  --set order_augment_resample=true \
  --set skew_transform=quantile --set resume_grace_epochs=30
