#!/usr/bin/env python
"""Headline BASELINE-config benchmarks: the five driver workloads + ESS/s.

Measures the library's main workloads (Langevin/HMC samples/s on
8gaussians, CD/PCD training steps/s, ESS/s, flow training and generation):

1. ``langevin_8gaussians``  — 10k chains x 1k steps on the 8gaussians mixture
   → chain-updates/s (same workload as repo-root ``bench.py``).
2. ``hmc_ess``/``nuts_ess``/``mala_ess`` — HMC (dual-averaged warmup), NUTS
   and MALA on the same correlated 2D Gaussian → ESS/s (min over dims of
   split-chain effective sample size), side by side.
3. ``cd_train_2d``          — CD-10 training step (Langevin negatives, MLP
   energy, batch 256) → steps/s.
4. ``pcd_mnist_conv``       — persistent CD step with a conv energy on
   28x28 images (batch 64, k=40, replay buffer 4096) → steps/s.
5. ``flow``                 — flow-matching loss step (Sinkhorn-coupled,
   batch 256) → steps/s, and FlowSampler ODE generation (euler, 50 steps,
   4096 samples) → samples/s.

Runs on the accelerator JAX finds and refuses to run on the CPU. Each
timing is the median of ``--iters`` calls at a fixed work count, each call
ended by ``block_until_ready``; roofline fields use the peak table of
``benchmarks/device.py``. Writes a JSON report naming the device::

    python benchmarks/headline.py [--iters 5] [--only a,b] [--out PATH]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))


sys.path.insert(0, HERE)

from device import median_time, peaks, require_accelerator  # noqa: E402


def _per_unit_time(fn, n: int, iters: int) -> float:
    """Seconds per work unit: the median time of ``fn(n, i)`` (which does
    ``n`` units in one call) divided by ``n``. Pick ``n`` so a call takes
    well over the per-call dispatch time."""
    return median_time(lambda i: fn(n, i), iters) / n


def _mfu_fields(step_fn, args, per_step_s: float, peak: str = "f32") -> dict:
    """Roofline accounting: XLA ``cost_analysis`` FLOPs and bytes of the
    compiled step over the measured per-step time, as shares of the device's
    published peaks (``benchmarks/device.py::PEAKS``; ``peak`` names the
    compute rate: "bf16", "tf32" or "f32")."""
    import jax

    table = peaks(jax.devices()[0].device_kind)
    cost = step_fn.lower(*args).compile().cost_analysis() or {}
    if isinstance(cost, (list, tuple)):
        cost = cost[0] if cost else {}
    flops = float(cost.get("flops", 0.0))
    hbm = float(cost.get("bytes accessed", 0.0))
    if flops <= 0.0:
        return {}
    tflops = flops / per_step_s / 1e12
    out = {
        "flops_per_step": flops,
        "tflops_per_s": tflops,
        "peak_share_pct": 100.0 * tflops * 1e12 / table[peak],
        "peak": peak,
    }
    if hbm > 0.0:
        out["hbm_bytes_per_step"] = hbm
        out["hbm_gb_per_s"] = hbm / per_step_s / 1e9
        out["hbm_bw_pct"] = 100.0 * hbm / per_step_s / table["hbm_bytes_per_s"]
    return out


def bench_langevin(iters: int) -> dict:
    import jax

    from torchebm_tpu.core import GaussianMixtureEnergy
    from torchebm_tpu.samplers import LangevinDynamics

    chains = 10_000
    key = jax.random.PRNGKey(0)
    sampler = LangevinDynamics(GaussianMixtureEnergy.eight_gaussians(), step_size=0.05)

    def run(n, i):
        return sampler.sample(jax.random.fold_in(key, i), dim=2, n_samples=chains, n_steps=n)

    per_step = _per_unit_time(run, 3_000_000, iters)
    return {"updates_per_s": chains / per_step, "per_step_s": per_step,
            "config": f"{chains} chains, 8gaussians, 3M steps per call"}


def bench_annealed_traj(iters: int) -> dict:
    """The Energy-Matching R̂/ESS workload — a ``TemperatureScheduler`` noise
    ramp with the trajectory recorded — on the whole-chain kernel
    (``fused="auto"``) and on the scan, same workload."""
    import jax
    import jax.numpy as jnp

    from torchebm_tpu.core import GaussianMixtureEnergy, TemperatureScheduler
    from torchebm_tpu.samplers import LangevinDynamics

    chains, thin = 10_000, 8
    key = jax.random.PRNGKey(0)
    mix = GaussianMixtureEnergy.eight_gaussians()

    def make(fused):
        return LangevinDynamics(
            mix,
            step_size=0.05,
            noise_scale=TemperatureScheduler(
                epsilon_max=1.0, tau_star=0.2, n_steps=100_000
            ),
            fused=fused,
        )

    def run(sampler):
        def go(n, i):
            traj = sampler.sample(
                jax.random.fold_in(key, i),
                dim=2,
                n_samples=chains,
                n_steps=n,
                thin=thin,
                return_trajectory=True,
            )
            return jnp.sum(traj[:, -1])  # scalar fence: never fetch the traj

        return go

    per_fused = _per_unit_time(run(make("auto")), 100_000, iters)
    per_scan = _per_unit_time(run(make("off")), 20_000, iters)
    return {
        "fused_per_step_s": per_fused,
        "scan_per_step_s": per_scan,
        "fused_speedup": per_scan / per_fused,
        "updates_per_s": chains / per_fused,
        "config": (
            f"{chains} chains, 8gaussians, TemperatureScheduler noise ramp, "
            f"trajectory thin={thin}"
        ),
    }


def bench_pt_8gaussians(iters: int) -> dict:
    """Parallel-tempered Langevin on 8gaussians (the compiled scan)."""
    import jax
    import jax.numpy as jnp

    from torchebm_tpu.core import GaussianMixtureEnergy
    from torchebm_tpu.samplers import ParallelTemperingLangevin

    chains = 10_000
    temps = (1.0, 1.6, 2.56, 4.1)
    key = jax.random.PRNGKey(0)
    mix = GaussianMixtureEnergy.eight_gaussians()

    sampler = ParallelTemperingLangevin(mix, temperatures=temps, step_size=0.05, swap_every=5)

    def run(sampler):
        def go(n, i):
            cold = sampler.sample(
                jax.random.fold_in(key, i), dim=2, n_samples=chains, n_steps=n
            )
            return jnp.sum(cold)  # scalar fence

        return go

    per_step = _per_unit_time(run(sampler), 60_000, iters)
    r = len(temps)
    return {
        "per_step_s": per_step,
        # one "step" advances the full ladder: R x chains replica-updates
        "replica_updates_per_s": r * chains / per_step,
        "config": (
            f"{chains} chains x {r} replicas, 8gaussians, swap_every=5, "
            "even/odd exchange"
        ),
    }


def bench_ais(iters: int) -> dict:
    """AIS log-Z estimation on 8gaussians (the compiled scan)."""
    import jax
    import jax.numpy as jnp

    from torchebm_tpu.core import GaussianEnergy, GaussianMixtureEnergy
    from torchebm_tpu.samplers import annealed_importance_sampling

    chains = 16384
    key = jax.random.PRNGKey(0)
    mix = GaussianMixtureEnergy.eight_gaussians()
    base = GaussianEnergy.create(jnp.zeros(2), 9.0 * jnp.eye(2))

    def run_scan(n, i):
        res = annealed_importance_sampling(
            jax.random.fold_in(key, i), mix, base=base,
            n_samples=chains, n_rungs=n, step_size=0.05,
        )
        return res.log_z

    per_rung = _per_unit_time(run_scan, 60_000, iters)
    # quality sanity at the nominal 200-rung config (true log Z = 0)
    logz = float(
        annealed_importance_sampling(
            key, mix, base=base, n_samples=chains, n_rungs=200, step_size=0.05
        ).log_z
    )
    return {
        "per_rung_s": per_rung,
        "chain_rungs_per_s": chains / per_rung,
        "log_z_at_200_rungs": logz,
        "config": f"{chains} chains, 8gaussians target, wide-Gaussian base",
    }


def bench_hmc_ess(iters: int) -> dict:
    import jax
    import jax.numpy as jnp

    from torchebm_tpu.core import GaussianEnergy
    from torchebm_tpu.samplers import HamiltonianMonteCarlo, summarize_chains

    cov = jnp.array([[1.0, 0.8], [0.8, 1.0]])
    energy = GaussianEnergy.create(mean=jnp.zeros(2), cov=cov)
    hmc = HamiltonianMonteCarlo(
        energy, step_size=0.2, n_leapfrog_steps=8, dual_averaging=True
    )
    key = jax.random.PRNGKey(0)
    chains, steps = 256, 1_000
    x0, eps = hmc.warmup(key, dim=2, n_warmup=200, n_samples=chains)
    tuned = hmc.replace(step_size=eps)

    def run(n, i):
        return tuned.sample(jax.random.fold_in(key, i), x=x0, n_steps=n)

    # 20k draws per timed call: seconds of device work on the scan
    per_draw = _per_unit_time(run, 20 * steps, iters)
    traj = tuned.sample(key, x=x0, n_steps=steps, return_trajectory=True)
    ess = float(jnp.min(summarize_chains(traj)["ess"]))
    return {"ess_per_s": ess / (steps * per_draw), "min_ess": ess,
            "per_draw_s": per_draw, "adapted_step_size": eps,
            "config": f"{chains} chains x {steps} draws, corr-Gaussian, dual-averaged"}


def _corr_gaussian():
    import jax.numpy as jnp

    from torchebm_tpu.core import GaussianEnergy

    cov = jnp.array([[1.0, 0.8], [0.8, 1.0]])
    return GaussianEnergy.create(mean=jnp.zeros(2), cov=cov)


def bench_nuts_ess(iters: int) -> dict:
    """NUTS ESS/s on the same corr-Gaussian protocol as ``hmc_ess``.

    NUTS's per-chain tree builder is vmapped lockstep iteration — per-draw
    cost is set by the max tree depth across chains — so this measures
    whether dynamic trajectories buy enough ESS/draw to pay for it
    (VERDICT r2 weak #2)."""
    import jax
    import jax.numpy as jnp

    from torchebm_tpu.samplers import NoUTurnSampler, summarize_chains

    nuts = NoUTurnSampler(_corr_gaussian(), step_size=0.2, max_tree_depth=8)
    key = jax.random.PRNGKey(0)
    chains, steps = 256, 250
    x0, eps = nuts.warmup(key, dim=2, n_warmup=200, n_samples=chains)
    tuned = nuts.replace(step_size=eps)

    def run(n, i):
        return tuned.sample(jax.random.fold_in(key, i), x=x0, n_steps=n)

    per_draw = _per_unit_time(run, 8 * steps, iters)
    traj, diag = tuned.sample(
        key, x=x0, n_steps=steps, return_trajectory=True, return_diagnostics=True
    )
    ess = float(jnp.min(summarize_chains(traj)["ess"]))
    return {"ess_per_s": ess / (steps * per_draw), "min_ess": ess,
            "per_draw_s": per_draw, "adapted_step_size": eps,
            "mean_tree_depth": float(jnp.mean(diag["tree_depth"])),
            "config": f"{chains} chains x {steps} draws, corr-Gaussian, dual-averaged"}


def bench_mala_ess(iters: int) -> dict:
    """MALA ESS/s, same protocol; step size pilot-tuned toward the 0.574
    optimal-scaling acceptance rate (MALA has no dual-averaging warmup)."""
    import jax
    import jax.numpy as jnp

    from torchebm_tpu.samplers import MetropolisAdjustedLangevin, summarize_chains

    energy = _corr_gaussian()
    key = jax.random.PRNGKey(0)
    chains, steps = 256, 1_000

    best, best_gap = 0.5, 1.0
    for trial in (0.1, 0.25, 0.5, 0.9):
        s = MetropolisAdjustedLangevin(energy, step_size=trial)
        _, diag = s.sample(key, dim=2, n_samples=chains, n_steps=100,
                           return_diagnostics=True)
        gap = abs(float(diag["acceptance_rate"][-1]) - 0.574)
        if gap < best_gap:
            best, best_gap = trial, gap
    mala = MetropolisAdjustedLangevin(energy, step_size=best)
    x0 = mala.sample(key, dim=2, n_samples=chains, n_steps=200)  # burn-in

    def run(n, i):
        return mala.sample(jax.random.fold_in(key, i), x=x0, n_steps=n)

    per_draw = _per_unit_time(run, 20 * steps, iters)
    traj = mala.sample(key, x=x0, n_steps=steps, return_trajectory=True)
    ess = float(jnp.min(summarize_chains(traj)["ess"]))
    return {"ess_per_s": ess / (steps * per_draw), "min_ess": ess,
            "per_draw_s": per_draw, "pilot_step_size": best,
            "config": f"{chains} chains x {steps} draws, corr-Gaussian, pilot-tuned"}


def _cd_step_factory(energy_net, data_shape, batch, k_steps, step_size,
                     persistent, buffer_size, key, clamp=None,
                     state_dtype=None):
    import jax
    import optax

    import jax.numpy as jnp
    from torchebm_tpu.core import as_energy
    from torchebm_tpu.losses import ContrastiveDivergence
    from torchebm_tpu.samplers import LangevinDynamics

    params = energy_net.init(key, jnp.zeros((1, *data_shape)))
    energy = as_energy(energy_net, params)
    sampler = LangevinDynamics(energy, step_size=step_size, clamp=clamp)
    cd = ContrastiveDivergence(
        model=energy, sampler=sampler, k_steps=k_steps,
        persistent=persistent, buffer_size=buffer_size, init_steps=0,
    )
    buffer = cd.init_buffer(key, data_shape) if persistent else None
    if state_dtype is not None and buffer is not None:
        # end-to-end reduced-precision chain state: buffer AND data carry
        # state_dtype, so the k-step MCMC never touches f32 activations of
        # the state (the r5 PCD optimization; the sampling loop preserves
        # the caller's state dtype)
        buffer = buffer.replace(samples=buffer.samples.astype(state_dtype))
    opt = optax.adam(1e-4)
    opt_state = opt.init(params)

    @jax.jit
    def step(p, s, b, x, k):
        (l, (_, b2)), g = jax.value_and_grad(lambda pp: cd(pp, x, k, b), has_aux=True)(p)
        u, s = opt.update(g, s)
        return optax.apply_updates(p, u), s, b2, l

    data = jax.random.normal(key, (batch, *data_shape))
    if state_dtype is not None:
        data = data.astype(state_dtype)

    def run(n, i):
        """Chain n train steps (state threaded, one fetch at the end)."""
        p, s, b = params, opt_state, buffer
        l = None
        for j in range(n):
            p, s, b, l = step(p, s, b, data, jax.random.fold_in(key, i * 100_003 + j))
        return l

    @jax.jit
    def step_scan(p, s, b, x, k, n):
        """n train steps inside ONE program: isolates device time from the
        ~1.3-2.3 ms per-call remote-dispatch cost (timing rule 3)."""

        def body(i, carry):
            p, s, b = carry
            (l, (_, b2)), g = jax.value_and_grad(
                lambda pp: cd(pp, x, jax.random.fold_in(k, i), b), has_aux=True
            )(p)
            u, s = opt.update(g, s)
            return optax.apply_updates(p, u), s, b2

        p, s, b = jax.lax.fori_loop(0, n, body, (p, s, b))
        return jax.tree_util.tree_reduce(lambda a, c: a + jnp.sum(c), p, 0.0)

    def run_scan(n, i):
        return step_scan(params, opt_state, buffer, data,
                         jax.random.fold_in(key, i), jnp.int32(n))

    def mfu(per_step_s, peak="f32"):
        return _mfu_fields(step, (params, opt_state, buffer, data, key), per_step_s, peak)

    return run, run_scan, mfu


def bench_cd_2d(iters: int) -> dict:
    import jax

    from torchebm_tpu.models import MLPEnergy

    key = jax.random.PRNGKey(0)
    run, run_scan, mfu = _cd_step_factory(
        MLPEnergy(hidden_dims=(128, 128)), (2,), batch=256, k_steps=10,
        step_size=0.01, persistent=False, buffer_size=0, key=key,
    )
    per_step = _per_unit_time(run, 105, iters)
    per_dev = _per_unit_time(run_scan, 4100, iters)
    return {"steps_per_s": 1.0 / per_step, "per_step_s": per_step,
            "device_us_per_step": per_dev * 1e6,
            "device_steps_per_s": 1.0 / per_dev,
            **mfu(per_step),
            "config": "CD-10 Langevin negatives, MLP(128,128), batch 256, 2D"}


def bench_pcd_mnist(iters: int) -> dict:
    import jax

    from torchebm_tpu.models import ConvEnergy2D

    key = jax.random.PRNGKey(0)
    run, run_scan, mfu = _cd_step_factory(
        ConvEnergy2D(channels=(32, 64, 64)), (1, 28, 28), batch=64, k_steps=40,
        step_size=10.0, persistent=True, buffer_size=4096, key=key,
        clamp=(-1.0, 1.0),
    )
    per_step = _per_unit_time(run, 55, iters)
    per_dev = _per_unit_time(run_scan, 620, iters)
    return {"steps_per_s": 1.0 / per_step, "per_step_s": per_step,
            "device_us_per_step": per_dev * 1e6,
            "device_steps_per_s": 1.0 / per_dev,
            **mfu(per_step),
            "config": "PCD k=40, ConvEnergy2D, batch 64, 28x28, buffer 4096"}


def bench_pcd_mnist_bf16(iters: int) -> dict:
    """BASELINE config 4 under the bf16 mixed-precision policy (params f32,
    conv compute bf16) — the MXU speedup measurement the policy exists for."""
    import jax
    import jax.numpy as jnp

    from torchebm_tpu.models import ConvEnergy2D

    key = jax.random.PRNGKey(0)
    run, run_scan, mfu = _cd_step_factory(
        ConvEnergy2D(channels=(32, 64, 64), dtype=jnp.bfloat16), (1, 28, 28),
        batch=64, k_steps=40, step_size=10.0, persistent=True,
        buffer_size=4096, key=key, clamp=(-1.0, 1.0),
        state_dtype=jnp.bfloat16,
    )
    per_step = _per_unit_time(run, 55, iters)
    per_dev = _per_unit_time(run_scan, 620, iters)
    return {"steps_per_s": 1.0 / per_step, "per_step_s": per_step,
            "device_us_per_step": per_dev * 1e6,
            "device_steps_per_s": 1.0 / per_dev,
            **mfu(per_dev, peak="bf16"),
            "config": ("PCD k=40, ConvEnergy2D bf16 END-TO-END "
                       "(compute + chain state + buffer), batch 64, 28x28")}


def bench_dit_step(iters: int) -> dict:
    """DiT flow-matching train step, f32 vs bf16 compute.

    Under XLA's DEFAULT matmul precision a float32 product may already run
    in TF32 on the GPU, so the f32 row is not a true float32 rate.
    """
    import jax
    import jax.numpy as jnp
    import optax

    from torchebm_tpu.models import ConditionalTransformer2D

    key = jax.random.PRNGKey(0)
    batch = 256

    def make_run(dtype):
        net = ConditionalTransformer2D(
            in_channels=1, out_channels=1, input_size=32, patch_size=4,
            embed_dim=768, depth=12, num_heads=12, cond_dim=768, dtype=dtype,
        )
        x = jax.random.normal(key, (batch, 1, 32, 32))
        cond = jax.random.normal(key, (batch, 768))
        params = net.init(key, x[:1], cond[:1])
        opt = optax.adamw(1e-4)
        opt_state = opt.init(params)

        @jax.jit
        def step(p, s, k):
            tgt = jax.random.normal(k, x.shape)
            l, g = jax.value_and_grad(
                lambda pp: jnp.mean(jnp.square(net.apply(pp, x, cond) - tgt))
            )(p)
            u, s = opt.update(g, s, p)
            return optax.apply_updates(p, u), s, l

        def run(n, i):
            p, s, l = params, opt_state, None
            for j in range(n):
                p, s, l = step(p, s, jax.random.fold_in(key, i * 100_003 + j))
            return l

        def mfu(per_step_s, peak):
            return _mfu_fields(step, (params, opt_state, key), per_step_s, peak)

        return run, mfu

    def measure(dtype, peak):
        # build → time → cost-profile → release before the next dtype: two
        # DiT-768x12 train states + compiled programs don't fit HBM together
        run, mfu = make_run(dtype)
        per = _per_unit_time(run, 12, iters)
        fields = mfu(per, peak)
        jax.clear_caches()
        return per, fields

    per32, f32 = measure(jnp.float32, "f32")
    per16, bf16 = measure(jnp.bfloat16, "bf16")
    return {
        "f32_steps_per_s": 1.0 / per32,
        "bf16_steps_per_s": 1.0 / per16,
        "bf16_speedup": per32 / per16,
        "f32_mfu": f32,
        "bf16_mfu": bf16,
        "config": "DiT 768x12 flow-matching step, batch 256, 32x32 images",
    }


def bench_flow(iters: int) -> dict:
    import jax
    import jax.numpy as jnp
    import optax

    from torchebm_tpu.couplings import SinkhornCoupling
    from torchebm_tpu.interpolants import LinearInterpolant
    from torchebm_tpu.losses import EquilibriumMatchingLoss
    from torchebm_tpu.models import MLPVelocityField
    from torchebm_tpu.samplers import FlowSampler
    from torchebm_tpu.samplers.flow import WrappedField

    key = jax.random.PRNGKey(0)
    batch = 256
    net = MLPVelocityField(hidden_dims=(128, 128, 128))
    params = net.init(key, jnp.zeros((1, 2)), jnp.zeros((1,)))
    field = WrappedField(fn=net.apply, params=params)
    loss = EquilibriumMatchingLoss(
        model=field,
        interpolant=LinearInterpolant(),
        coupling=SinkhornCoupling(n_iters=50, reg=0.05),
    )
    opt = optax.adam(1e-3)
    opt_state = opt.init(params)

    @jax.jit
    def train_step(p, s, x, k):
        l, g = jax.value_and_grad(lambda pp: loss(pp, x, k))(p)
        u, s = opt.update(g, s)
        return optax.apply_updates(p, u), s, l

    data = jax.random.normal(key, (batch, 2)) + jnp.array([2.0, 0.0])

    def run_train(n, i):
        p, s, l = params, opt_state, None
        for j in range(n):
            p, s, l = train_step(p, s, data, jax.random.fold_in(key, i * 100_003 + j))
        return l

    per_train = _per_unit_time(run_train, 105, iters)

    # Device time per step: the per-call loop above includes one host
    # dispatch per step; scanning N steps inside ONE program isolates the
    # device time, and comparing couplings isolates the Sinkhorn share.
    def make_scan(coupling):
        loss_c = EquilibriumMatchingLoss(
            model=field, interpolant=LinearInterpolant(), coupling=coupling
        )

        @jax.jit
        def train_scan(p, s, x, k, n):
            def body(i, carry):
                pp, ss = carry
                l, g = jax.value_and_grad(
                    lambda q: loss_c(q, x, jax.random.fold_in(k, i))
                )(pp)
                u, ss = opt.update(g, ss)
                return optax.apply_updates(pp, u), ss

            p, s = jax.lax.fori_loop(0, n, body, (p, s))
            return jax.tree_util.tree_reduce(lambda a, b: a + jnp.sum(b), p, 0.0)

        return lambda n, i: train_scan(
            params, opt_state, data, jax.random.fold_in(key, i), jnp.int32(n)
        )

    dev_now = _per_unit_time(make_scan(SinkhornCoupling(n_iters=50, reg=0.05)), 5200, iters)
    dev_fixed = _per_unit_time(make_scan(SinkhornCoupling(n_iters=50, reg=0.05, tol=0.0)), 5200, iters)

    flow = FlowSampler(model=field, integrator="euler", negate_velocity=True)
    n_gen = 4096

    def run_gen(n, i):
        return flow.sample(jax.random.fold_in(key, i), dim=2, n_samples=n_gen, n_steps=n)

    per_ode_step = _per_unit_time(run_gen, 2_000, iters)
    med_gen = 50 * per_ode_step  # the nominal 50-step generation
    return {
        "train_steps_per_s": 1.0 / per_train,
        "gen_samples_per_s": n_gen / med_gen,
        "per_train_step_s": per_train,
        "per_ode_step_s": per_ode_step,
        "device_us_per_step": dev_now * 1e6,
        "device_us_per_step_sinkhorn_no_tol": dev_fixed * 1e6,
        "sinkhorn_tol_speedup": dev_fixed / dev_now,
        **_mfu_fields(train_step, (params, opt_state, data, key), per_train),
        "config": f"EqM+Sinkhorn batch {batch}; ODE euler 50 steps x {n_gen}",
    }


def bench_batch_scale(iters: int) -> dict:
    """Utilization-at-scale study: the 2D configs are
    latency-bound at their nominal batch sizes — these rows measure WHERE
    that stops. Each row: device µs/step (in-program scan slope), MFU and
    HBM-bandwidth share at that batch, for the CD-2D, EqM-flow and PCD-conv
    train steps. Guidance curve for users sizing real workloads."""
    import jax
    import jax.numpy as jnp
    import optax

    from torchebm_tpu.couplings import SinkhornCoupling
    from torchebm_tpu.interpolants import LinearInterpolant
    from torchebm_tpu.losses import EquilibriumMatchingLoss
    from torchebm_tpu.models import ConvEnergy2D, MLPEnergy, MLPVelocityField
    from torchebm_tpu.samplers.flow import WrappedField

    key = jax.random.PRNGKey(0)
    rows = []

    def add_row(config, batch, run_scan, step_fn, step_args, lo, hi, peak="f32"):
        per_dev = _per_unit_time(run_scan, hi, iters)
        row = {
            "config": config,
            "batch": batch,
            "device_us_per_step": per_dev * 1e6,
            "device_steps_per_s": 1.0 / per_dev,
            "samples_per_s": batch / per_dev,
            **_mfu_fields(step_fn, step_args, per_dev, peak),
        }
        rows.append(row)
        print(f"  [batch_scale] {config} batch={batch}: "
              f"{per_dev * 1e6:.1f} us/step")
        jax.clear_caches()

    # ---- CD-2D MLP(128,128), k=10 Langevin negatives
    for batch, (lo, hi) in [(256, (100, 4100)), (4096, (50, 1050)),
                            (65536, (5, 85))]:
        run, run_scan, _ = _cd_step_factory(
            MLPEnergy(hidden_dims=(128, 128)), (2,), batch=batch, k_steps=10,
            step_size=0.01, persistent=False, buffer_size=0, key=key,
        )
        add_row("cd_2d_mlp", batch, run_scan, *_cd_cost_probe(batch, key), lo, hi)

    # ---- EqM flow + Sinkhorn (cost matrix is O(B^2): capped at 16384)
    net = MLPVelocityField(hidden_dims=(128, 128, 128))
    params = net.init(key, jnp.zeros((1, 2)), jnp.zeros((1,)))
    field = WrappedField(fn=net.apply, params=params)
    opt = optax.adam(1e-3)
    opt_state = opt.init(params)
    for batch, (lo, hi) in [(256, (200, 5200)), (2048, (50, 1050)),
                            (16384, (3, 33))]:
        loss = EquilibriumMatchingLoss(
            model=field,
            interpolant=LinearInterpolant(),
            coupling=SinkhornCoupling(n_iters=50, reg=0.05),
        )
        data = jax.random.normal(key, (batch, 2)) + jnp.array([2.0, 0.0])

        @jax.jit
        def train_step(p, s, x, k):
            l, g = jax.value_and_grad(lambda pp: loss(pp, x, k))(p)
            u, s = opt.update(g, s)
            return optax.apply_updates(p, u), s, l

        @jax.jit
        def train_scan(p, s, x, k, n):
            def body(i, carry):
                pp, ss = carry
                l, g = jax.value_and_grad(
                    lambda q: loss(q, x, jax.random.fold_in(k, i))
                )(pp)
                u, ss = opt.update(g, ss)
                return optax.apply_updates(pp, u), ss

            p, s = jax.lax.fori_loop(0, n, body, (p, s))
            return jax.tree_util.tree_reduce(lambda a, b: a + jnp.sum(b), p, 0.0)

        run_scan = lambda n, i, _d=data: train_scan(
            params, opt_state, _d, jax.random.fold_in(key, i), jnp.int32(n)
        )
        add_row("eqm_flow_sinkhorn", batch, run_scan, train_step,
                (params, opt_state, data, key), lo, hi)

    # ---- PCD conv 28x28, k=40
    for batch, (lo, hi) in [(64, (20, 620)), (512, (10, 110)), (4096, (2, 18))]:
        run, run_scan, _ = _cd_step_factory(
            ConvEnergy2D(channels=(32, 64, 64)), (1, 28, 28), batch=batch,
            k_steps=40, step_size=10.0, persistent=True,
            buffer_size=max(4096, batch), key=key, clamp=(-1.0, 1.0),
        )
        add_row("pcd_conv_28x28", batch, run_scan,
                *_pcd_cost_probe(batch, key), lo, hi)

    return {"rows": rows, "config": "device-time batch-scaling study"}


def _cd_cost_probe(batch, key):
    """(step_fn, args) for cost analysis of the CD-2D step at ``batch``."""
    import jax
    import jax.numpy as jnp
    import optax

    from torchebm_tpu.core import as_energy
    from torchebm_tpu.losses import ContrastiveDivergence
    from torchebm_tpu.models import MLPEnergy
    from torchebm_tpu.samplers import LangevinDynamics

    net = MLPEnergy(hidden_dims=(128, 128))
    params = net.init(key, jnp.zeros((1, 2)))
    energy = as_energy(net, params)
    cd = ContrastiveDivergence(
        model=energy, sampler=LangevinDynamics(energy, step_size=0.01),
        k_steps=10,
    )
    opt = optax.adam(1e-4)
    opt_state = opt.init(params)

    @jax.jit
    def step(p, s, x, k):
        (l, _), g = jax.value_and_grad(lambda pp: cd(pp, x, k), has_aux=True)(p)
        u, s = opt.update(g, s)
        return optax.apply_updates(p, u), s, l

    data = jax.random.normal(key, (batch, 2))
    return step, (params, opt_state, data, key)


def _pcd_cost_probe(batch, key):
    """(step_fn, args) for cost analysis of the PCD-conv step at ``batch``."""
    import jax
    import jax.numpy as jnp
    import optax

    from torchebm_tpu.core import as_energy
    from torchebm_tpu.losses import ContrastiveDivergence
    from torchebm_tpu.models import ConvEnergy2D
    from torchebm_tpu.samplers import LangevinDynamics

    net = ConvEnergy2D(channels=(32, 64, 64))
    params = net.init(key, jnp.zeros((1, 1, 28, 28)))
    energy = as_energy(net, params)
    cd = ContrastiveDivergence(
        model=energy,
        sampler=LangevinDynamics(energy, step_size=10.0, clamp=(-1.0, 1.0)),
        k_steps=40, persistent=True, buffer_size=max(4096, batch),
        init_steps=0,
    )
    buffer = cd.init_buffer(key, (1, 28, 28))
    opt = optax.adam(1e-4)
    opt_state = opt.init(params)

    @jax.jit
    def step(p, s, b, x, k):
        (l, (_, b2)), g = jax.value_and_grad(
            lambda pp: cd(pp, x, k, b), has_aux=True
        )(p)
        u, s = opt.update(g, s)
        return optax.apply_updates(p, u), s, b2, l

    data = jax.random.normal(key, (batch, 1, 28, 28))
    return step, (params, opt_state, buffer, data, key)


BENCHES = {
    "langevin_8gaussians": bench_langevin,
    "annealed_traj": bench_annealed_traj,
    "hmc_ess": bench_hmc_ess,
    "nuts_ess": bench_nuts_ess,
    "mala_ess": bench_mala_ess,
    "cd_train_2d": bench_cd_2d,
    "pcd_mnist_conv": bench_pcd_mnist,
    "pcd_mnist_conv_bf16": bench_pcd_mnist_bf16,
    "dit_step": bench_dit_step,
    "flow": bench_flow,
    "pt_8gaussians": bench_pt_8gaussians,
    "ais_logz": bench_ais,
    "batch_scale": bench_batch_scale,
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--only", default="", help="comma-separated subset of benches")
    ap.add_argument("--out", default=os.path.join(HERE, "results", "headline.json"))
    args = ap.parse_args()

    from torchebm_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    info = require_accelerator()
    import jax

    selected = [s for s in args.only.split(",") if s] or list(BENCHES)
    report = {"device": info, "iters": args.iters, "results": {}}
    for name in selected:
        t0 = time.perf_counter()
        res = BENCHES[name](args.iters)
        res["total_bench_s"] = time.perf_counter() - t0
        report["results"][name] = res
        print(f"{name:24s} {json.dumps(res)}")
        jax.clear_caches()  # free each bench's compiled programs / HBM

    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    print(f"report -> {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
