"""Multi-process chain-sharded HMC (the multi-host pattern).

Run the same script once per process/host; on CPU (for trying it out):

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \
      python distributed_hmc.py --coordinator localhost:9876 --nproc 2 --pid 0 &
    XLA_FLAGS=--xla_force_host_platform_device_count=4 \
      python distributed_hmc.py --coordinator localhost:9876 --nproc 2 --pid 1

On a GPU cluster, run it once per host with that host's process id and
the coordinator's address:

    python distributed_hmc.py --coordinator HOST0:9876 --nproc N --pid I
"""

import argparse

from _common import setup

jax = setup()
import jax.numpy as jnp

import mcmc_tpu
from mcmc_tpu.parallel import init_distributed, global_mesh

ap = argparse.ArgumentParser()
ap.add_argument("--coordinator", default=None)
ap.add_argument("--nproc", type=int, default=None)
ap.add_argument("--pid", type=int, default=None)
args = ap.parse_args()

if args.nproc and args.nproc > 1:
    init_distributed(coordinator_address=args.coordinator,
                     num_processes=args.nproc, process_id=args.pid)
print(f"process {jax.process_index()}/{jax.process_count()}: "
      f"{jax.local_device_count()} local / {jax.device_count()} global devices")

mesh = global_mesh()

log_kernel = lambda v: -0.5 * jnp.sum((v - 2.0) ** 2)
out = mcmc_tpu.hmc(
    jnp.zeros(4), log_kernel,
    mcmc_tpu.HMCSettings(n_burnin_draws=500, n_keep_draws=1000,
                         step_size=0.5, n_leap_steps=4),
    n_chains=16 * jax.device_count(), key=jax.random.PRNGKey(0), mesh=mesh,
)
# global reductions are SPMD-legal on every process
print(f"process {jax.process_index()}: posterior mean "
      f"{float(jnp.mean(out.draws)):.3f} (truth 2.0), "
      f"accept {float(jnp.mean(out.n_accept_draws)) / 1000:.2f}")
