#!/usr/bin/env python
"""Scaling-efficiency harness: samples/s vs device count (BASELINE.md:
">= 85% samples/s efficiency from 1 host to >= 2 hosts").

Runs the chain-sharded HMC workload on meshes of 1, 2, ..., all available
devices with the per-device chain count held fixed (weak scaling — the
configuration that matters for MCMC, where you add chips to run more
chains), and reports samples/s plus parallel efficiency vs the single-device
rate. On a multi-host slice, call ``mcmc_tpu.parallel.init_distributed()``
on every process first and build the mesh with
``mcmc_tpu.parallel.global_mesh()``; the cross-process plumbing (global
arrays, SPMD collectives over the process boundary) is exercised in
software by ``tests/test_multiprocess.py`` (2 CPU processes x 4 virtual
devices). On a single chip this harness degenerates to one row. Pass
``--cpu`` to exercise the full code path on the virtual host-device mesh
(validates the harness, not interconnect bandwidth).

Prints one JSON line: {"devices": [...], "samples_per_sec": [...],
"efficiency": [...]}.

``--multiprocess N`` (CPU) self-spawns N-process runs for process counts
1..N (``--devices-per-process`` virtual devices each, Gloo collectives
across the process boundary — the DCN path's software stand-in) and reports
the weak-scaling efficiency across *processes*, the quantity the >= 85%
multi-host target is about. Size processes x devices to the PHYSICAL core
count (e.g. 2 x 2 on a 4-core host): oversubscribed cores measure host
contention, not the communication path.

``--workload de`` switches the multiprocess sweep to the sharded DE-MCMC
population sweep — one ``all_gather`` per generation CROSSING the process
boundary (the collective-bearing path; the default chain-parallel HMC
workload is collective-free).
"""

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def _worker():
    """Multi-process worker: join the distributed runtime, run the
    chain-sharded workload on the global mesh, print samples/s (proc 0)."""
    import os
    dpp = int(os.environ.get("MCMC_SCALING_DPP", "4"))
    os.environ["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={dpp}"
    # Pin each process to its own disjoint core set (process i owns cores
    # [i*dpp, (i+1)*dpp)): XLA:CPU sizes its intra-op thread pool to ALL
    # host cores regardless of the virtual device count, so without
    # affinity two co-located processes contend on every core and the
    # measurement reflects the host, not the communication path. Pinning is
    # exactly the multi-host semantics being stood in for — each "host"
    # owns its cores. Applied before jax initializes its thread pools.
    _pid_ = int(os.environ["MCMC_SCALING_PID"])
    _cores = os.sched_getaffinity(0)
    want = set(range(_pid_ * dpp, (_pid_ + 1) * dpp))
    if want <= _cores:
        os.sched_setaffinity(0, want)
    import jax
    jax.config.update("jax_platforms", "cpu")

    port = os.environ["MCMC_SCALING_PORT"]
    nproc = int(os.environ["MCMC_SCALING_NPROC"])
    pid = int(os.environ["MCMC_SCALING_PID"])
    chains_per_dev = int(os.environ.get("MCMC_SCALING_CPD", "64"))
    seconds = float(os.environ.get("MCMC_SCALING_SECONDS", "4"))
    workload = os.environ.get("MCMC_SCALING_WORKLOAD", "hmc")

    if nproc > 1:
        jax.distributed.initialize(coordinator_address=f"localhost:{port}",
                                   num_processes=nproc, process_id=pid)

    if workload == "de":
        _worker_de(chains_per_dev, seconds, nproc, pid)
        return
    _chain_workload(chains_per_dev, seconds, nproc, pid)


def _chain_workload(chains_per_dev, seconds, nproc, pid):
    """The chain-sharded HMC workload on the global mesh of an
    already-joined distributed runtime (or a single process). Prints one
    JSON line with THIS process's local rate. Shared by the CPU
    multiprocess sweep (``_worker``) and the real multi-host launcher
    (``--multihost`` / scripts/run_multihost.sh)."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    from mcmc_tpu.parallel import global_mesh, shard_chain_axis
    from mcmc_tpu.samplers import common
    from mcmc_tpu.samplers.hmc import build_hmc_kernel
    from mcmc_tpu import models

    D, N, L = 25, 200, 4
    X, y, _ = models.make_logistic_regression_data(jax.random.PRNGKey(0), N, D)
    lk = models.logistic_regression_model(X, y)
    precond = common.make_spd(None, D, jnp.float32)
    init, step = build_hmc_kernel(lk, jax.grad(lk), precond, 0.02, L)
    bstep = jax.vmap(step, axis_name=common.CHAIN_AXIS_NAME)

    mesh = global_mesh()
    C = chains_per_dev * jax.device_count()
    state = jax.vmap(init)(
        0.05 * jax.random.normal(jax.random.PRNGKey(1), (C, D)))
    keys = jax.random.split(jax.random.PRNGKey(2), C)
    state = shard_chain_axis(state, mesh)
    keys = shard_chain_axis(keys, mesh)

    STEPS = 20

    @jax.jit
    def run(keys, state):
        def body(c, _):
            st, ks = c
            pair = jax.vmap(lambda k: jax.random.split(k, 2))(ks)
            st, _info = bstep(pair[:, 1], st)
            return (st, pair[:, 0]), None
        (st, ks), _ = lax.scan(body, (state, keys), None, length=STEPS)
        return ks, st

    keys, state = run(keys, state)
    jax.block_until_ready(state)
    t0 = time.perf_counter()
    n = 0
    while time.perf_counter() - t0 < seconds:
        keys, state = run(keys, state)
        jax.block_until_ready(state)
        n += 1
    el = time.perf_counter() - t0
    # Every worker reports its OWN completed iteration count: the workload
    # is collective-free, so processes advance independently and finish
    # different numbers of run() calls under host contention. The parent
    # sums per-process local rates — extrapolating pid 0's count to all
    # processes would hide exactly the degradation this sweep measures.
    local_chains = C // nproc
    print(json.dumps({"nproc": nproc, "pid": pid,
                      "devices": jax.device_count(),
                      "n_iters": n, "elapsed": round(el, 4),
                      "local_chains": local_chains, "steps": STEPS,
                      "local_samples_per_sec":
                          round(n * STEPS * local_chains / el, 1)}),
          flush=True)


def _multihost(args):
    """Real multi-host entry (scripts/run_multihost.sh): join the JAX
    distributed runtime, run the chain-sharded workload on the global
    mesh, print this process's local rate. Sum local_samples_per_sec
    over hosts and compare against the 1-host run for the BASELINE
    >= 85% weak-scaling number. Pass all three coordinates explicitly
    unless the cluster's launcher provides them to jax.distributed.

    ``MCMC_MULTIHOST_CPU=<n>`` forces CPU with n virtual devices per
    process — the Gloo smoke-test mode ``tests/test_multiprocess.py``
    exercises so the launch path stays verified without hardware."""
    import os
    cpu_dev = os.environ.get("MCMC_MULTIHOST_CPU")
    if cpu_dev:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "") +
            f" --xla_force_host_platform_device_count={cpu_dev}").strip()
    import jax
    if cpu_dev:
        jax.config.update("jax_platforms", "cpu")
    from mcmc_tpu.parallel import init_distributed
    init_distributed(coordinator_address=args.coordinator,
                     num_processes=args.num_processes,
                     process_id=args.process_id)
    _chain_workload(args.chains_per_device, args.seconds,
                    jax.process_count(), jax.process_index())


def _worker_de(walkers_per_dev, seconds, nproc, pid):
    """Collective-bearing multiprocess workload: the sharded DE population
    sweep — ONE ``all_gather`` of the previous generation per sweep, crossing
    the Gloo process boundary (the path the chain-parallel HMC workload never
    exercises). Unlike the collective-free workload, the all_gather is a
    barrier: every process completes the same sweep count, so the iteration
    budget is FIXED (a time-based loop would deadlock the lagging process in
    the collective when the leader stops calling)."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    from mcmc_tpu.parallel import global_mesh, shard_chain_axis
    from mcmc_tpu.parallel.de_sharded import build_sharded_de_sweep
    from mcmc_tpu.samplers.de import DEState
    from mcmc_tpu import models
    from mcmc_tpu.settings import DESettings

    # the flagship 100-d logistic regression at tall-data size: enough
    # per-generation compute (~20 ms/device) that the ~3 ms cross-process
    # Gloo all_gather latency amortizes — the quantity weak scaling is
    # about (a population too small to occupy one device has nothing to
    # scale; on real DCN the collective is sub-ms for this 400 KB payload)
    D, N = 100, 8000
    X, y, _ = models.make_logistic_regression_data(jax.random.PRNGKey(0), N, D)
    lk = models.logistic_regression_model(X, y)

    mesh = global_mesh()
    n_pop = walkers_per_dev * jax.device_count()
    cfg = DESettings(n_pop=n_pop, n_keep_draws=1)
    sweep = build_sharded_de_sweep(lk, cfg, D, mesh)

    X0 = 0.05 * jax.random.normal(jax.random.PRNGKey(1), (n_pop, D))
    kv0 = jax.vmap(lk)(X0)
    state = DEState(X=shard_chain_axis(X0, mesh),
                    kernel_vals=shard_chain_axis(kv0, mesh),
                    gen_ind=jnp.asarray(0, jnp.int32))
    keys = shard_chain_axis(jax.random.split(jax.random.PRNGKey(2), n_pop),
                            mesh)

    STEPS = 20

    @jax.jit
    def run(keys, state):
        def body(c, _):
            st, ks = c
            pair = jax.vmap(lambda k: jax.random.split(k, 2))(ks)
            st, _info = sweep(pair[:, 1], st)
            return (st, pair[:, 0]), None
        (st, ks), _ = lax.scan(body, (state, keys), None, length=STEPS)
        return ks, st

    keys, state = run(keys, state)           # compile
    jax.block_until_ready(state.X)
    # fixed call budget so every process-count row runs the same per-walker
    # work; sync per call — XLA:CPU's in-process collective rendezvous
    # deadlocks when many executions pipeline (device A races into call
    # N+1's all_gather while device B still runs call N), so the collective
    # workload cannot use the async back-to-back dispatch the collective-
    # free one does (the 20-sweep scan inside each call still amortizes
    # dispatch)
    n_calls = max(4, int(seconds * 25))
    t0 = time.perf_counter()
    for _ in range(n_calls):
        keys, state = run(keys, state)
        jax.block_until_ready(state.X)
    el = time.perf_counter() - t0
    print(json.dumps({"nproc": nproc, "pid": pid,
                      "devices": jax.device_count(),
                      "n_iters": n_calls, "elapsed": round(el, 4),
                      "local_chains": n_pop // nproc, "steps": STEPS,
                      "collective": "all_gather/sweep"}),
          flush=True)


def _multiprocess_sweep(max_procs, chains_per_dev, seconds,
                        devices_per_process=4, workload="hmc"):
    """Spawn worker sets for 1..max_procs processes; report efficiency."""
    import os
    import socket
    import subprocess

    ncores = os.cpu_count() or 1
    oversubscribed = max_procs * devices_per_process > ncores
    results = []
    for nproc in range(1, max_procs + 1):
        s = socket.socket(); s.bind(("localhost", 0))
        port = s.getsockname()[1]; s.close()
        env_base = {**os.environ,
                    "MCMC_SCALING_WORKER": "1",
                    "MCMC_SCALING_PORT": str(port),
                    "MCMC_SCALING_NPROC": str(nproc),
                    "MCMC_SCALING_CPD": str(chains_per_dev),
                    "MCMC_SCALING_DPP": str(devices_per_process),
                    "MCMC_SCALING_WORKLOAD": workload,
                    "MCMC_SCALING_SECONDS": str(seconds)}
        procs = []
        try:
            for pid in range(nproc):
                env = {**env_base, "MCMC_SCALING_PID": str(pid)}
                procs.append(subprocess.Popen(
                    [sys.executable, __file__], env=env,
                    stdout=subprocess.PIPE, stderr=subprocess.PIPE))
            rows = []
            for pid, p in enumerate(procs):
                out, err = p.communicate(timeout=600)
                if p.returncode != 0:
                    raise RuntimeError(f"worker {pid}/{nproc} failed: "
                                       f"{err.decode()[-800:]}")
                lines = [l for l in out.decode().splitlines()
                         if l.startswith("{")]
                rows.append(json.loads(lines[-1]))
        finally:
            # a failed/hung worker must not leave siblings (or the hung
            # rendezvous partner) orphaned holding cores + the coordinator
            # port for the next sweep iteration
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        # global rate = sum of independent per-process local rates
        sps = sum(r["n_iters"] * r["steps"] * r["local_chains"] / r["elapsed"]
                  for r in rows)
        results.append({"nproc": nproc, "samples_per_sec": round(sps, 1)})

    base = results[0]["samples_per_sec"]
    wl_desc = {"hmc": "chain-sharded HMC (collective-free)",
               "de": "sharded DE population sweep (one all_gather per "
                     "generation crossing the process boundary)"}[workload]
    note = ("single-machine CPU validation of the cross-process software "
            "path (Gloo = the DCN stand-in); run on >= 2 real hosts for "
            "the BASELINE hardware number")
    if oversubscribed:
        note += (f" — WARNING: {max_procs} x {devices_per_process} devices "
                 f"oversubscribe the {ncores} physical cores, efficiency "
                 f"reflects host contention")
    print(json.dumps({
        "workload": f"{wl_desc}, weak scaling over PROCESSES "
                    f"({devices_per_process} virtual CPU devices each; "
                    f"Gloo cross-process)",
        "note": note,
        "physical_cores": ncores,
        "chains_per_device": chains_per_dev,
        "processes": [r["nproc"] for r in results],
        "samples_per_sec": [r["samples_per_sec"] for r in results],
        "efficiency": [round(r["samples_per_sec"] / (base * r["nproc"]), 3)
                       for r in results],
    }))


def main():
    import os
    if os.environ.get("MCMC_SCALING_WORKER"):
        _worker()
        return
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="force CPU + 8 virtual devices (harness validation)")
    ap.add_argument("--multiprocess", type=int, default=0, metavar="N",
                    help="self-spawn 1..N CPU processes and report "
                         "cross-process weak-scaling efficiency (the "
                         "workers always run on the CPU: a GPU takes one "
                         "JAX process)")
    ap.add_argument("--devices-per-process", type=int, default=4,
                    help="virtual CPU devices per process in --multiprocess "
                         "(size N x this to the physical core count)")
    ap.add_argument("--workload", choices=["hmc", "de"], default="hmc",
                    help="--multiprocess workload: hmc = collective-free "
                         "chain-parallel; de = all_gather per generation "
                         "across the process boundary")
    ap.add_argument("--chains-per-device", type=int, default=4096)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--multihost", action="store_true",
                    help="join the JAX distributed runtime and run the "
                         "chain-sharded workload on the global mesh "
                         "(scripts/run_multihost.sh wraps this)")
    ap.add_argument("--coordinator", default=None,
                    help="--multihost coordinator host:port (omit only "
                         "where the cluster launcher provides it)")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    args = ap.parse_args()

    if args.multihost:
        _multihost(args)
        return

    if args.multiprocess:
        # the collective-free HMC worker saturates a core at 64 chains; the
        # DE worker needs a larger population for the collective to amortize
        cap = 64 if args.workload == "hmc" else 512
        _multiprocess_sweep(args.multiprocess,
                            min(args.chains_per_device, cap), args.seconds,
                            args.devices_per_process, args.workload)
        return

    import os
    if args.cpu:
        os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from mcmc_tpu.device import enable_compile_cache
    enable_compile_cache()
    from jax import lax

    from mcmc_tpu import models
    from mcmc_tpu.samplers import common
    from mcmc_tpu.samplers.hmc import build_hmc_kernel
    from mcmc_tpu.parallel import make_mesh, shard_chain_axis

    D, N, L = 100, 1000, 4
    X, y, _ = models.make_logistic_regression_data(jax.random.PRNGKey(0), N, D)
    lk = models.logistic_regression_model(X, y, matmul_dtype=jnp.bfloat16)
    precond = common.make_spd(None, D, jnp.float32)
    init, step = build_hmc_kernel(lk, jax.grad(lk), precond, 0.01, L)
    bstep = jax.vmap(step, axis_name=common.CHAIN_AXIS_NAME)

    n_dev_all = jax.device_count()
    sizes = []
    d = 1
    while d <= n_dev_all:
        sizes.append(d)
        d *= 2
    if sizes[-1] != n_dev_all:
        sizes.append(n_dev_all)

    STEPS = 20
    results = []
    for nd in sizes:
        mesh = make_mesh(nd)
        C = args.chains_per_device * nd
        state = jax.vmap(init)(
            0.05 * jax.random.normal(jax.random.PRNGKey(1), (C, D)))
        keys = jax.random.split(jax.random.PRNGKey(2), C)
        state = shard_chain_axis(state, mesh)
        keys = shard_chain_axis(keys, mesh)

        @jax.jit
        def run(keys, state):
            def body(c, _):
                st, ks = c
                pair = jax.vmap(lambda k: jax.random.split(k, 2))(ks)
                st, _info = bstep(pair[:, 1], st)
                return (st, pair[:, 0]), None
            (st, ks), _ = lax.scan(body, (state, keys), None, length=STEPS)
            return ks, st

        keys, state = run(keys, state)
        jax.block_until_ready(state)
        t0 = time.perf_counter()
        n = 0
        while time.perf_counter() - t0 < args.seconds:
            keys, state = run(keys, state)
            jax.block_until_ready(state)
            n += 1
        el = time.perf_counter() - t0
        sps = n * STEPS * C / el
        results.append((nd, sps))

    base = results[0][1]
    out = {
        "workload": "chain-sharded HMC, weak scaling (fixed chains/device)",
        "chains_per_device": args.chains_per_device,
        "devices": [r[0] for r in results],
        "samples_per_sec": [round(r[1], 1) for r in results],
        "efficiency": [round(r[1] / (base * r[0]), 3) for r in results],
        "platform": jax.devices()[0].platform,
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
