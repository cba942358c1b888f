#!/usr/bin/env bash
# Training of the PyTorch port under SLURM (reference
# tools/scripts/slurm_train.sh), one task per GPU:
#
#   sbatch -N 2 --ntasks-per-node=8 --gres=gpu:8 scripts/torch_slurm_train.sh \
#       configs/models/lyft_models/pointrcnn_dynamic_obj.yaml my_tag
#
# Each task runs one process of modest_tpu_torch.cli.train. init_multihost
# (modest_tpu_torch/parallel/multihost.py) reads SLURM_NTASKS, SLURM_PROCID
# and the first host of SLURM_STEP_NODELIST (rendezvous port
# MODEST_TPU_COORD_PORT, default 12996) and gives task I the card
# SLURM_LOCALID (else I) modulo its host's cards. With a card per task the
# gradients and batch statistics are summed over NCCL; tasks that share a
# card take gloo. Rank 0 writes the checkpoints, metrics and log.
set -euo pipefail

CFG=${1:?usage: torch_slurm_train.sh <cfg.yaml> [extra_tag] [extra args...]}
TAG=${2:-default}
shift $(( $# >= 2 ? 2 : 1 ))

srun python -m modest_tpu_torch.cli.train \
    --cfg_file "$CFG" --extra_tag "$TAG" --launcher slurm "$@"
