#!/usr/bin/env python
"""The whole-chain Langevin kernel against the compiled scan, on one GPU.

Workload: ``LangevinDynamics`` on ``GaussianMixtureEnergy.eight_gaussians()``
with 10,000 chains and step size 0.05, driven through ``sample()`` exactly
as users call it. Variants:

- ``kernel``: ``fused="force"`` (the Triton-route kernel), and the kernel
  called directly at each (chains per program, warps) block shape, set
  through ``fused_langevin.DEFAULT_BLOCK`` / ``DEFAULT_WARPS``;
- ``scan``: ``fused="off"`` with ``noise_block`` in {1, 4} and
  ``rng_impl`` in {threefry, rbg, unsafe_rbg};
- ``traj``: a cosine-scheduled step size with a ``thin=10`` trajectory, on
  the kernel and on the scan.

Every variant first runs a probe to size its step count so that one timed
call takes at least ``--seconds`` of wall time, then reports the median of
``--iters`` calls, each ended by ``block_until_ready``. One JSON line per
variant, each naming the device::

    python benchmarks/kernel_vs_scan.py [--seconds 1.5] [--iters 3]
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

from device import median_time, require_accelerator  # noqa: E402

N_CHAINS = 10_000
BLOCKS = ((32, 1), (64, 1), (64, 2), (128, 1), (128, 2), (128, 4), (256, 2), (256, 4))
#: thin=10 keeps 160k states of 80 KB (12.8 GB). A call holds the trajectory
#: up to four times over (the kernel's layout, the returned array, the
#: sampler's axis move and that transpose's autotuning buffers), so 2.2M
#: steps (17.6 GB a copy) ran out of an 80 GB H100's default 60 GB share
TRAJ_MAX_STEPS = 1_600_000


def sized(run, probe_steps: int, seconds: float, iters: int, cap: int = 1 << 30):
    """Time ``run(n_steps, i)`` at a step count giving >= ``seconds`` a call."""
    t_probe = median_time(lambda i: run(probe_steps, i), 1)
    steps = min(cap, max(probe_steps, int(probe_steps * math.ceil(seconds / max(t_probe, 1e-6)))))
    return steps, median_time(lambda i: run(steps, i), iters)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=1.5)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--variants", default="kernel,blocks,scan,traj",
                    help="comma-separated subset of kernel,blocks,scan,traj")
    args = ap.parse_args()
    variants = set(args.variants.split(","))

    from torchebm_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    info = require_accelerator()

    import jax

    from torchebm_tpu.core import CosineScheduler, GaussianMixtureEnergy
    from torchebm_tpu.ops import fused_langevin as fl
    from torchebm_tpu.samplers import LangevinDynamics

    mix = GaussianMixtureEnergy.eight_gaussians()
    key = jax.random.PRNGKey(0)
    x0 = mix.sample(key, N_CHAINS)

    def report(variant, steps, seconds, **extra):
        print(json.dumps(dict(
            variant=variant, chains=N_CHAINS, steps=steps, seconds=seconds,
            us_per_step=1e6 * seconds / steps, updates_per_s=N_CHAINS * steps / seconds,
            **extra, **info,
        )), flush=True)

    def sampler_run(sampler, **kw):
        return lambda n, i: sampler.sample(
            jax.random.fold_in(key, i), x=x0, n_steps=n, **kw)

    kernel = LangevinDynamics(mix, step_size=0.05, fused="force")
    if "kernel" in variants:
        report("kernel", *sized(sampler_run(kernel), 100_000, args.seconds, args.iters))
    defaults = fl.DEFAULT_BLOCK, fl.DEFAULT_WARPS
    for block, warps in BLOCKS if "blocks" in variants else ():
        fl.DEFAULT_BLOCK, fl.DEFAULT_WARPS = block, warps  # read when traced
        run = jax.jit(
            lambda x, s, n: fl.mixture_langevin_chain(
                x, mix.means, n, 0.05, 1.0, scale=0.4, log_weights=mix.log_weights, seed=s),
            static_argnums=2,
        )
        report("kernel_block", *sized(lambda n, i: run(x0, i, n), 100_000, args.seconds,
                                      args.iters), block=block, num_warps=warps)
    fl.DEFAULT_BLOCK, fl.DEFAULT_WARPS = defaults
    for rng in ("threefry", "rbg", "unsafe_rbg") if "scan" in variants else ():
        for nb in (1, 4):
            scan = LangevinDynamics(mix, step_size=0.05, fused="off", rng_impl=rng,
                                    noise_block=nb)
            report("scan", *sized(sampler_run(scan), 10_000, args.seconds, args.iters),
                   rng_impl=rng, noise_block=nb)
    for fused in ("force", "off") if "traj" in variants else ():
        def run(n, i, fused=fused):
            s = LangevinDynamics(mix, step_size=CosineScheduler(0.05, 0.01, n), fused=fused)
            return s.sample(jax.random.fold_in(key, i), x=x0, n_steps=n, thin=10,
                            return_trajectory=True)

        # the kernel's probe is long enough that the call's fixed cost
        # (schedule table, moving the trajectory's axes) does not dominate it
        probe = 100_000 if fused == "force" else 10_000
        report("traj_sched_thin10", *sized(run, probe, args.seconds, args.iters,
                                           cap=TRAJ_MAX_STEPS),
               path="kernel" if fused == "force" else "scan")


if __name__ == "__main__":
    main()
