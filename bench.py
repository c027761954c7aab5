#!/usr/bin/env python
"""Langevin chain-update throughput on one accelerator.

Prints ONE JSON line: ``{"metric", "value", "unit", "platform",
"device_kind", "device_count", "card", "steps", "seconds"}``.

Workload: ``LangevinDynamics`` on the 2D 8-gaussians mixture energy, 10,000
parallel chains, step size 0.05, through ``sample()`` as users call it (on
a GPU the whole-chain kernel, ``ops/fused_langevin.py``; ``fused="off"``
would run the compiled scan). ``value`` is chain-updates per second: chains
× steps over the median wall time of ``ITERS`` calls, each ended by
``block_until_ready`` after one untimed compile call. ``STEPS`` keeps a call
at about a second on the kernel and under half a minute on the scan.
Refuses to run on the CPU.
"""

import json
import os
import sys

N_CHAINS = 10_000
STEPS = 3_000_000
ITERS = 5


def main() -> None:
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, os.path.join(here, "benchmarks"))
    from device import median_time, require_accelerator

    from torchebm_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    info = require_accelerator()

    import jax
    import jax.numpy as jnp

    from torchebm_tpu.core import GaussianMixtureEnergy
    from torchebm_tpu.samplers import LangevinDynamics

    key = jax.random.PRNGKey(0)
    mix = GaussianMixtureEnergy.eight_gaussians()
    sampler = LangevinDynamics(mix, step_size=0.05)

    def run(i):
        return sampler.sample(jax.random.fold_in(key, i), dim=2, n_samples=N_CHAINS,
                              n_steps=STEPS)

    seconds = median_time(run, ITERS)
    radius = float(jnp.mean(jnp.linalg.norm(run(0), axis=-1)))
    if not 3.0 < radius < 5.0:
        raise SystemExit(f"sampler off-distribution: mean radius {radius}")
    print(json.dumps({
        "metric": "langevin_updates_per_sec_8gaussians_10k_chains",
        "value": N_CHAINS * STEPS / seconds,
        "unit": "chain-updates/s",
        "steps": STEPS,
        "seconds": seconds,
        **info,
    }))


if __name__ == "__main__":
    main()
