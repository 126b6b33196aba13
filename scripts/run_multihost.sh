#!/usr/bin/env bash
# One-command multi-host launch for the BASELINE >= 85% weak-scaling
# measurement (samples/s from 1 host to >= 2 hosts). The reference has no
# multi-process capability at all (SURVEY.md §2c; Makefile.in:32 is a
# single-process build) — this wires jax.distributed.initialize around the
# chain-sharded workload in benchmarks/scaling.py.
#
# With no arguments the coordinates come from the cluster's launcher
# (jax.distributed auto-detection), where it provides them:
#
#     scripts/run_multihost.sh
#
# Explicit coordinates (CPU/GPU clusters, manual launch — run once per
# host with its own process id):
#
#     scripts/run_multihost.sh <coordinator-host:port> <num-processes> <id>
#
# Each process prints one JSON line with its local_samples_per_sec; the
# global rate is their sum. Efficiency(2 hosts) =
#     sum(rate, 2-host run) / (2 * sum(rate, 1-host run)).
#
# Software smoke test without hardware (2 Gloo-coupled CPU processes with
# 2 virtual devices each; also exercised by tests/test_multiprocess.py):
#
#     MCMC_MULTIHOST_CPU=2 scripts/run_multihost.sh localhost:9876 2 0 &
#     MCMC_MULTIHOST_CPU=2 scripts/run_multihost.sh localhost:9876 2 1
set -euo pipefail
cd "$(dirname "$0")/.."

ARGS=(--multihost)
if [[ $# -ge 3 ]]; then
  ARGS+=(--coordinator "$1" --num-processes "$2" --process-id "$3")
  shift 3
elif [[ $# -ne 0 ]]; then
  echo "usage: $0 [<coordinator-host:port> <num-processes> <process-id>]" >&2
  exit 2
fi

exec python benchmarks/scaling.py "${ARGS[@]}" "$@"
