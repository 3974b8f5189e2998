#!/bin/sh
# Run4's recipe over the port (scripts/launch_run4.sh of the JAX package,
# the same flags): a fine-tune continuation of run3 from its epoch-543
# params, seeded into outputs/run4/checkpoints/epoch_00543 (a checkpoint
# in the port's format, e.g. written by snapshot_params) so that
# `--resume auto`, and every relaunch after a crash, picks it up.
#
# LR: cosine(1e-4, horizon 900, no warmup) at epoch 544 is about 3.4e-5,
# decaying to 1e-6. Run from the repo root:
#   sh superconductor_vae_tpu_torch/scripts/launch_run4.sh
exec python -u -m superconductor_vae_tpu_torch.scripts.train_resilient --stall-timeout 1800 -- \
  --csv data/processed/jarvis_merged.csv.gz --epochs 900 \
  --batch-size 128 --bf16 --lr 1e-4 --checkpoint-interval 25 \
  --output outputs/run4 --resume auto \
  --set lr_warmup_epochs=0 --set rl_epoch_interval=3 \
  --set phase2_enabled=true --set phase2_interval=16 \
  --set eval_interval=8
