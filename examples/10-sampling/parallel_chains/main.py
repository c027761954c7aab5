"""Parallel chains: the batch axis is the scaling axis.

Mirrors the reference's parallel-chains lesson
(``examples/10-sampling/01-mcmc/03-parallel-chains``): "10,000 chains cost
one integer". In JAX the story goes further — the chain axis is a
``NamedSharding`` over a device mesh, so the same compiled program spreads
chains across chips with zero code changes to the sampler.
"""

import sys, os
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..", ".."))
import _common

smoke = _common.setup()
if not smoke:
    # demonstrate the mesh path on CPU with 8 virtual devices
    os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
    import jax
    jax.config.update("jax_platforms", "cpu")

import time

import jax
import jax.numpy as jnp

from torchebm_tpu.core import GaussianMixtureEnergy
from torchebm_tpu.parallel import batch_sharding, make_mesh, shard_batch
from torchebm_tpu.samplers import LangevinDynamics, summarize_chains


def main():
    key = jax.random.PRNGKey(0)
    mix = GaussianMixtureEnergy.eight_gaussians(radius=4.0, scale=0.5)
    sampler = LangevinDynamics(mix, step_size=0.05)

    n_chains = 512 if smoke else 10_000
    n_steps = _common.n(1000, 50)

    # One call, n_chains chains: population statistics from a *short* run
    # instead of one long chain.
    t0 = time.perf_counter()
    samples = jax.block_until_ready(
        sampler.sample(key, dim=2, n_samples=n_chains, n_steps=n_steps)
    )
    dt = time.perf_counter() - t0
    print(f"{n_chains} chains x {n_steps} steps in {dt:.2f}s "
          f"({n_chains * n_steps / dt:.2e} chain-updates/s, compile included)")
    print(f"population mean radius {float(jnp.mean(jnp.linalg.norm(samples, axis=-1))):.2f}"
          " (target 4.0)")

    # Cross-chain diagnostics come free: many short chains -> split R-hat/ESS.
    traj = sampler.sample(jax.random.fold_in(key, 1),
                          x=mix.sample(key, 64), n_steps=n_steps,
                          return_trajectory=True)
    s = summarize_chains(traj)
    print(f"64 chains: split R-hat {s['r_hat']}  ESS {s['ess']}")
    print("  (R-hat >> 1 is the diagnostic WORKING: chains start in separate "
          "modes and plain Langevin cannot hop between them — see the "
          "parallel-tempering example for the fix)")

    # Shard the SAME program over a device mesh: chains ride the 'data' axis.
    n_dev = len(jax.devices())
    if n_dev > 1:
        mesh = make_mesh(("data",))
        sharding = batch_sharding(mesh, ndim=2)
        x0 = shard_batch(jax.random.normal(key, (n_chains, 2)), mesh)
        sharded = jax.jit(
            lambda k, x: sampler.sample(k, x=x, n_steps=n_steps),
            out_shardings=sharding,
        )(jax.random.fold_in(key, 2), x0)
        jax.block_until_ready(sharded)
        print(f"sharded over {n_dev} devices: "
              f"{sharded.sharding.spec} -> per-device {n_chains // n_dev} chains; "
              f"mean radius {float(jnp.mean(jnp.linalg.norm(sharded, axis=-1))):.2f}")
    print("OK")


if __name__ == "__main__":
    main()
