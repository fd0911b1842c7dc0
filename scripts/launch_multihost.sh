#!/usr/bin/env bash
# Multi-host launch example — the role of the reference's SLURM + mpirun
# Horovod launcher (dlmodels/color-information/run.sh) on GPU hosts.
#
# One process per host, and that process sees all of its host's GPUs (do
# not set CUDA_VISIBLE_DEVICES per process): jax.distributed joins the
# hosts, the mesh spans every GPU, and XLA lowers the collectives to NCCL.
# Never start two JAX processes on one GPU: each reserves most of the
# card's memory when it first uses it, so the second one fails.
#
# Usage (N hosts, run once per host with its rank; the coordinator is
# host 0 at any free port):
#   COORDINATOR=host0:8476 NUM_HOSTS=2 HOST_ID=0 ./scripts/launch_multihost.sh
#   COORDINATOR=host0:8476 NUM_HOSTS=2 HOST_ID=1 ./scripts/launch_multihost.sh
#
# On a single host run it with no variables: one process drives all GPUs.
set -euo pipefail

: "${COORDINATOR:=}"
: "${NUM_HOSTS:=1}"
: "${HOST_ID:=0}"
: "${STEPS:=1000}"

ARGS=(--steps "$STEPS")
if [[ -n "$COORDINATOR" && "$NUM_HOSTS" -gt 1 ]]; then
  ARGS+=(--coordinator "$COORDINATOR" --num-processes "$NUM_HOSTS"
         --process-id "$HOST_ID")
fi

exec python "$(dirname "$0")/train_flow.py" "${ARGS[@]}" "$@"
