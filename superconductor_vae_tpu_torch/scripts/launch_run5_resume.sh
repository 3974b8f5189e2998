#!/bin/sh
# Run5's resume over the port (scripts/launch_run5_resume.sh of the JAX
# package, the same flags): launch_run5.sh's corpus and pipeline with the
# cosine stretched to 1,300 epochs, so that the learning rate at epoch 912
# is about 2.1e-5 instead of the 8e-6 tail. Run from the repo root.
exec python -u -m superconductor_vae_tpu_torch.scripts.train_resilient --stall-timeout 1800 -- \
  --csv data/processed/jarvis_merged_v2.csv.gz --epochs 1300 \
  --batch-size 128 --bf16 --lr 1e-4 --checkpoint-interval 25 \
  --output outputs/run5 --resume auto \
  --set lr_warmup_epochs=0 --set rl_epoch_interval=3 \
  --set phase2_enabled=true --set phase2_interval=16 \
  --set eval_interval=8 --set order_augment=1 \
  --set skew_transform=quantile --set resume_grace_epochs=30
