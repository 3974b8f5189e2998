#!/bin/bash
# Successive-pass holdout rerun (port of scripts/holdout_autoloop.sh): wait
# for an in-flight rerun driver to exit, then keep re-attacking the
# remaining non-exact targets until a pass makes no progress.  Each pass
# rereads the stream, so it queues only the targets still missed; the
# budgets, guided starts and seeds rise pass by pass.
#
# Usage (from the repository's root):
#   superconductor_vae_tpu_torch/scripts/holdout_autoloop.sh <stream.jsonl> \
#       <checkpoint> [wait_pid] [-- <more holdout_rerun_misses flags>]
# e.g. -- --pallas-decode on the card, -- --cpu on the CPU.
set -u
STREAM=${1:?stream jsonl}
CKPT=${2:?checkpoint}
shift 2
WAITPID=
if [ $# -gt 0 ] && [ "$1" != "--" ]; then WAITPID=$1; shift; fi
[ $# -gt 0 ] && [ "$1" = "--" ] && shift
PY=${PYTHON:-python3}

if [ -n "$WAITPID" ]; then
  while kill -0 "$WAITPID" 2>/dev/null; do sleep 60; done
fi

misses() {
  "$PY" - "$STREAM" <<'PYEOF'
import json, sys
from superconductor_vae_tpu_torch.scripts.holdout_campaign import misses_nearest_first
recs = [json.loads(l) for l in open(sys.argv[1]) if l.strip()]
print(len(misses_nearest_first(recs)))
PYEOF
}

BUDGETS=(12000 16000 20000)
STARTS=(24 32 32)
SEEDS=(2 3 4)
for p in 0 1 2; do
  BEFORE=$(misses)
  echo "=== autoloop pass $((p+1)): $BEFORE misses remain ==="
  [ "$BEFORE" -eq 0 ] && break
  "$PY" -m superconductor_vae_tpu_torch.scripts.holdout_rerun_misses \
    --stream "$STREAM" --checkpoint "$CKPT" \
    --budget "${BUDGETS[$p]}" --refine-rounds 2 \
    --guided-starts "${STARTS[$p]}" --seed "${SEEDS[$p]}" \
    --timeout 2400 "$@"
  AFTER=$(misses)
  echo "=== autoloop pass $((p+1)) done: $BEFORE -> $AFTER misses ==="
  [ "$AFTER" -ge "$BEFORE" ] && { echo "no progress; stopping"; break; }
done
echo "=== autoloop complete: $(misses) misses remain ==="
