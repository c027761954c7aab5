#!/usr/bin/env python
"""Chain-throughput scaling over an N-device mesh.

Two modes over the headline Langevin workload (8gaussians mixture), chains
sharded over a 1-D ``("data",)`` mesh at device counts 1, 2, 4, …:

- **strong** (default): fixed total chains; reports updates/s and efficiency
  ``thru_N / (N * thru_1)``. Meaningful numbers require real accelerators;
  with ``--cpu`` the virtual devices share host cores and efficiency only
  validates compile+run (the report says ``platform: cpu``).
- **weak** (``--weak``): fixed chains PER DEVICE; reports per-step wall time
  vs the expected bound. Per-device work is constant, so on real chips the
  wall time must stay flat; on the shared-core CPU backend the expected wall
  is ``base × max(1, n_devices / host_cores)`` (oversubscription), and an
  accidental cross-device serialization or resharding-induced collective
  shows up as wall ≈ ``n × base`` — well above the bound. This makes a CPU
  run assert more than "it compiles": ``flat_ok`` fails if normalized wall exceeds ``--weak-tol`` (default 1.6×).

Under multi-host, start one process per host — ``init_distributed`` no-ops
on a single process.

    python benchmarks/scaling.py [--cpu] [--chains 65536] [--steps 200]
    python benchmarks/scaling.py --cpu --weak [--chains-per-device 8192]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

from device import device_info, median_time  # noqa: E402


def run_at(n_devices: int, chains: int, steps: int, iters: int) -> float:
    import jax

    from torchebm_tpu.core import GaussianMixtureEnergy
    from torchebm_tpu.parallel import make_mesh, shard_batch
    from torchebm_tpu.samplers import LangevinDynamics

    mesh = make_mesh(("data",), devices=jax.devices()[:n_devices])
    sampler = LangevinDynamics(GaussianMixtureEnergy.eight_gaussians(), step_size=0.05)
    key = jax.random.PRNGKey(0)
    x0 = shard_batch(jax.random.normal(key, (chains, 2)), mesh)

    def run(n, i):
        return sampler.sample(jax.random.fold_in(key, i), x=x0, n_steps=n)

    n = 5 * steps
    return chains * n / median_time(lambda i: run(n, i), iters)


def weak_run_at(n_devices: int, chains_per_device: int, steps: int, iters: int) -> float:
    """Per-step wall seconds with ``chains_per_device`` chains on each of
    ``n_devices`` devices (constant per-device work)."""
    thru = run_at(n_devices, chains_per_device * n_devices, steps, iters)
    return chains_per_device * n_devices / thru  # wall seconds per chain step


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--cpu", action="store_true",
                    help="8 virtual host devices (compile/run validation only)")
    ap.add_argument("--chains", type=int, default=65536)
    ap.add_argument("--weak", action="store_true",
                    help="weak scaling: fixed chains per device, assert flat "
                         "per-step wall time (oversubscription-normalized on CPU)")
    ap.add_argument("--chains-per-device", type=int, default=8192)
    ap.add_argument("--weak-tol", type=float, default=1.6,
                    help="max normalized wall-time ratio before flat_ok fails")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if args.out is None:
        args.out = os.path.join(
            HERE, "results", "scaling_weak.json" if args.weak else "scaling.json"
        )

    if args.cpu:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
        )
    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    from torchebm_tpu.parallel import init_distributed

    pi, pc = init_distributed()
    n_total = len(jax.devices())
    counts = [n for n in (1, 2, 4, 8, 16, 32) if n <= n_total]
    if args.chains % max(counts) != 0:
        raise SystemExit(f"--chains must be divisible by {max(counts)}")

    backend = jax.devices()[0].platform
    print(f"backend={backend} devices={n_total} hosts={pc}")
    results = {}

    if args.weak:
        host_cores = os.cpu_count() or 1
        base = None
        all_flat = True
        for n in counts:
            wall = weak_run_at(n, args.chains_per_device, args.steps, args.iters)
            base = wall if base is None else base
            # expected wall: flat on real chips; oversubscription bound when
            # virtual devices share host cores
            bound = max(1, n / host_cores) if backend == "cpu" else 1.0
            norm = wall / (base * bound)
            flat = norm <= args.weak_tol
            all_flat &= flat
            results[str(n)] = {
                "wall_s_per_step": wall,
                "normalized": norm,
                "expected_bound": bound,
                "flat_ok": flat,
            }
            print(
                f"devices={n:3d}  {wall * 1e6:10.2f} us/step  "
                f"normalized {norm:5.2f}x (bound {bound:.1f}x)  "
                f"{'OK' if flat else 'FAIL'}"
            )
        print(
            "weak scaling "
            + ("FLAT within tolerance" if all_flat else "NOT flat — investigate "
               "cross-device serialization or an unintended collective")
        )
        payload = {
            "device": device_info(), "devices": n_total, "hosts": pc,
            "mode": "weak", "chains_per_device": args.chains_per_device,
            "host_cores": host_cores, "weak_tol": args.weak_tol,
            "steps": args.steps, "flat_ok": all_flat, "results": results,
        }
    else:
        base = None
        for n in counts:
            thru = run_at(n, args.chains, args.steps, args.iters)
            base = thru if base is None else base
            eff = thru / (n * base)
            results[str(n)] = {"updates_per_s": thru, "efficiency": eff}
            print(f"devices={n:3d}  {thru:12.3e} updates/s  efficiency {eff:5.1%}")
        if backend == "cpu":
            print("NOTE: virtual CPU devices share host cores; strong-scaling "
                  "efficiency is not meaningful here (validation run only) — "
                  "use --weak for a CPU-meaningful flatness check.")
        payload = {"device": device_info(), "devices": n_total, "hosts": pc,
                   "mode": "strong", "chains": args.chains, "steps": args.steps,
                   "results": results}

    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=2)
    print(f"report -> {args.out}")
    return 0 if (not args.weak or payload["flat_ok"]) else 1


if __name__ == "__main__":
    sys.exit(main())
