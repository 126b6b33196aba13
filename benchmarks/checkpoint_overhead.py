"""Measure the durability tax of the streaming checkpoint pipeline.

The reference has no persistence at all (SURVEY.md §5 — one synchronous call,
state in stack locals). mcmc_tpu's crash-durable path (ChunkedRunner: chunked
scans -> async D2H copy -> native double-buffered C++ sink -> atomic state
checkpoint) necessarily pays the device->host transfer of every kept draw; a
well-built pipeline should cost no more than the LARGER of device compute and
that transfer — i.e. it overlaps one with the other and adds nothing itself.

This script measures exactly that:

  pipeline_efficiency = max(t_compute, bytes / D2H_bandwidth) / t_checkpointed

t_compute comes from an identical in-memory run (draws stay on device); the
D2H bandwidth from timing a raw jax.device_get of a large array. Efficiency
~1.0 means the pipeline is bandwidth- or compute-bound with full overlap —
the framework adds no serial cost. (Where device-to-host bandwidth is low
the transfer bound dominates; on a host-attached GPU PCIe moves GiB/s and
the compute bound dominates instead. The efficiency metric is meaningful in
both regimes.)

Usage: python benchmarks/checkpoint_overhead.py
Prints one JSON line.
"""

import json
import pathlib
import shutil
import sys
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import mcmc_tpu
from mcmc_tpu.models.targets import (
    logistic_regression_model,
    make_logistic_regression_data,
)

N_CHAINS, DIM, N_DATA = 2048, 100, 1000
N_BURNIN, N_KEEP, CHUNK = 100, 1000, 250

if "--cpu" in sys.argv:
    # CPU mode isolates the pipeline's intrinsic cost: device and host share
    # memory so the D2H term vanishes, and any checkpointed-vs-in-memory gap
    # is pure framework overhead (sink memcpy+fwrite, atomic state save,
    # chunk scheduling). Smaller shapes keep the CPU compute tractable.
    jax.config.update("jax_platforms", "cpu")
    N_CHAINS, N_DATA = 256, 200


def run(checkpoint_dir, n_chains=N_CHAINS, n_burnin=N_BURNIN, n_keep=N_KEEP):
    key = jax.random.PRNGKey(0)
    X, y, _ = make_logistic_regression_data(key, N_DATA, DIM)
    log_kernel = logistic_regression_model(X, y)
    s = mcmc_tpu.HMCSettings(
        n_burnin_draws=n_burnin, n_keep_draws=n_keep,
        n_leap_steps=8, step_size=0.01,
    )
    t0 = time.perf_counter()
    out = mcmc_tpu.hmc(
        jnp.zeros(DIM), log_kernel, s, n_chains=n_chains,
        key=jax.random.PRNGKey(1), checkpoint_dir=checkpoint_dir,
        checkpoint_every=CHUNK,
    )
    jax.block_until_ready(out.draws[-1] if checkpoint_dir is None
                          else jnp.asarray(out.draws[-1]))
    return time.perf_counter() - t0


def d2h_bandwidth():
    """Raw device->host bandwidth, MiB/s (median of 3 x 64 MiB pulls).

    Each pull uses a FRESH array: jax caches an array's host copy after its
    first transfer, so re-pulling the same buffer measures nothing."""
    nbytes = 16 * 1024 * 1024 * 4  # 64 MiB
    times = []
    for i in range(3):
        x = jax.block_until_ready(
            jnp.full((16, 1024, 1024), float(i + 1), jnp.float32))
        t0 = time.perf_counter()
        np.asarray(x)
        times.append(time.perf_counter() - t0)
    return nbytes / 2**20 / sorted(times)[1]


def main():
    from mcmc_tpu.device import enable_compile_cache
    enable_compile_cache()
    tmp = tempfile.mkdtemp(prefix="ckpt_bench_")
    try:
        # each mode runs twice at identical shapes and the second is timed:
        # the first pays every trace+compile (shape-keyed, so a smaller
        # warmup config would not warm them)
        run(None)
        run(tmp + "/warm")

        bw = d2h_bandwidth()
        t_mem = run(None)
        t_ckpt = run(tmp + "/timed")

        draws_bytes = N_KEEP * N_CHAINS * DIM * 4
        if jax.devices()[0].platform == "cpu":
            t_transfer = 0.0  # shared memory: no D2H term
        else:
            t_transfer = draws_bytes / (bw * 2**20)
        bound = max(t_mem, t_transfer)
        result = {
            "metric": "checkpoint_pipeline_efficiency",
            "value": round(bound / t_ckpt, 3),
            "unit": "fraction_of_bound",
            "in_memory_seconds": round(t_mem, 2),
            "checkpointed_seconds": round(t_ckpt, 2),
            "d2h_bandwidth_mib_per_sec": round(bw, 1),
            "transfer_bound_seconds": round(t_transfer, 2),
            "binding_constraint": "transfer" if t_transfer > t_mem else "compute",
            "draws_streamed_mib": round(draws_bytes / 2**20, 1),
            "n_chains": N_CHAINS, "dim": DIM, "n_keep": N_KEEP,
            "checkpoint_every": CHUNK,
            "platform": jax.devices()[0].platform,
        }
        print(json.dumps(result))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


if __name__ == "__main__":
    main()
