"""Gradient-MCMC shootout: MALA vs HMC vs NUTS on one target.

The production recipe: every sampler is tuned on the
same correlated 2D Gaussian, then judged by effective sample size — per draw
(statistical efficiency) and per second (what you actually pay). NUTS's
adapted mean tree depth then picks HMC's trajectory length
(``n_leapfrog ~= 2^depth``): on SIMD hardware, batched NUTS pays the max tree size
across lockstep chains every draw, so the winning workflow is "NUTS to find
the trajectory length, HMC (or MALA) at that length for production draws".
"""

import sys, os, time
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "..", ".."))
import _common

smoke = _common.setup()

import jax
import jax.numpy as jnp

from torchebm_tpu.core import GaussianEnergy
from torchebm_tpu.samplers import (
    HamiltonianMonteCarlo,
    MetropolisAdjustedLangevin,
    NoUTurnSampler,
    summarize_chains,
    tune_trajectory_length,
)


def min_ess(traj):
    return float(jnp.min(summarize_chains(traj)["ess"]))


def timed(fn):
    out = fn()  # compile + warm
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    out = fn()
    # Fence on a scalar reduction so the timing excludes the host copy of
    # the full trajectory.
    arr = out[0] if isinstance(out, tuple) else out
    float(jnp.sum(arr))
    return out, time.perf_counter() - t0


def main():
    key = jax.random.PRNGKey(0)
    chains = 64 if smoke else 256
    draws = _common.n(1000, 60)

    cov = jnp.array([[1.0, 0.8], [0.8, 1.0]])
    energy = GaussianEnergy.create(mean=jnp.zeros(2), cov=cov)

    rows = []

    # --- NUTS: dual-averaged warmup, then sample; record mean tree depth
    nuts = NoUTurnSampler(energy, step_size=0.2, max_tree_depth=6)
    x0, eps_nuts = nuts.warmup(key, dim=2, n_warmup=_common.n(200, 30), n_samples=chains)
    tuned = nuts.replace(step_size=eps_nuts)
    (traj, diag), dt = timed(
        lambda: tuned.sample(
            jax.random.fold_in(key, 1), x=x0, n_steps=draws,
            return_trajectory=True, return_diagnostics=True,
        )
    )
    rows.append(("NUTS", eps_nuts, min_ess(traj), dt))

    # --- HMC at the NUTS-suggested trajectory length: the library's turnkey
    # handoff (pilot NUTS -> mean tree depth -> HMC warmup at L=2^depth)
    tuning = tune_trajectory_length(
        jax.random.fold_in(key, 10), energy, dim=2, n_samples=chains,
        n_warmup=_common.n(200, 30), n_pilot=_common.n(100, 20),
        max_tree_depth=6,
    )
    depth, n_leap = tuning.mean_tree_depth, tuning.n_leapfrog
    hmc = HamiltonianMonteCarlo(
        energy, step_size=tuning.step_size, n_leapfrog_steps=n_leap
    )
    traj_h, dt_h = timed(
        lambda: hmc.sample(
            jax.random.fold_in(key, 2), x=tuning.x, n_steps=draws,
            return_trajectory=True,
        )
    )
    rows.append((f"HMC(L={n_leap})", float(tuning.step_size), min_ess(traj_h), dt_h))

    # --- MALA: pilot-tune toward the 0.574 optimal-scaling acceptance rate
    best, best_gap = 0.25, 1.0
    for trial in (0.1, 0.25, 0.5, 0.9):
        s = MetropolisAdjustedLangevin(energy, step_size=trial)
        _, d = s.sample(jax.random.fold_in(key, 3), dim=2, n_samples=chains,
                        n_steps=_common.n(100, 20), return_diagnostics=True)
        gap = abs(float(d["acceptance_rate"][-1]) - 0.574)
        if gap < best_gap:
            best, best_gap = trial, gap
    mala = MetropolisAdjustedLangevin(energy, step_size=best)
    xm = mala.sample(jax.random.fold_in(key, 4), dim=2, n_samples=chains,
                     n_steps=_common.n(200, 30))
    traj_m, dt_m = timed(
        lambda: mala.sample(jax.random.fold_in(key, 5), x=xm, n_steps=draws,
                            return_trajectory=True)
    )
    rows.append((f"MALA(eps={best})", best, min_ess(traj_m), dt_m))

    print(f"target: corr-Gaussian rho=0.8 | {chains} chains x {draws} draws")
    print(f"NUTS mean tree depth {depth:.2f} -> HMC L={n_leap}")
    print(f"{'sampler':16s} {'step':>8s} {'min-ESS':>9s} {'ESS/draw':>9s} {'ESS/s':>11s}")
    for name, eps, ess, dt in rows:
        print(f"{name:16s} {eps:8.4f} {ess:9.0f} {ess / draws:9.3f} {ess / dt:11.0f}")

    # every tuned sampler should actually explore the target
    for name, _, ess, _ in rows:
        assert ess > chains * 0.3, (name, ess)
    print("OK")


if __name__ == "__main__":
    main()
