#!/usr/bin/env bash
# Manual multi-process training of the PyTorch port (reference
# tools/scripts/dist_train.sh). Run ONE copy per process:
#
#   # process 0 (it serves the rendezvous at the coordinator's address):
#   scripts/torch_multihost_train.sh 0 2 host0:12996 configs/models/.../cfg.yaml
#   # process 1, on host0 or another host:
#   scripts/torch_multihost_train.sh 1 2 host0:12996 configs/models/.../cfg.yaml
#
# Process I drives cuda:(I % cards visible on its host). With a card per
# process the group takes NCCL; where processes share a card (or run with
# --device cpu) it takes gloo. Every argument after the config goes to
# modest_tpu_torch.cli.train as it is (--batch_size is the global batch;
# --set goes last). Rank 0 writes the checkpoints, metrics and log.
set -euo pipefail

usage="usage: torch_multihost_train.sh <process_id> <num_processes> <host:port> <cfg.yaml> [args...]"
PID=${1:?$usage}
NPROC=${2:?$usage}
COORD=${3:?$usage}
CFG=${4:?$usage}
shift 4

exec python -m modest_tpu_torch.cli.train \
    --cfg_file "$CFG" --launcher manual \
    --coordinator "$COORD" --num_processes "$NPROC" --process_id "$PID" "$@"
