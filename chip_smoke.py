#!/usr/bin/env python3
"""Bring-up smoke test on one NVIDIA GPU: the library's main paths, once each.

Run from the root of a checkout::

    python chip_smoke.py          # one GPU: every phase below
    python chip_smoke.py --four   # four GPUs: the data x fsdp mesh phase only

Phases (one process, data and weights made from ``--seed``):

- ``langevin``: ``LangevinDynamics`` on ``GaussianMixtureEnergy.eight_gaussians()``
  with 10,000 chains (the whole-chain kernel on a GPU). Checks the mean
  radius is in (3, 5) and every one of the 8 modes holds >= 5% of the chains.
- ``kernel``: the Triton-route Langevin kernel as compiled for the card
  against the plain ``jnp`` reference chain, same injected noise, float32,
  1,000 steps, at 10,000 chains x d=2 (8 gaussians) and d=64 with K=16
  components; and the kernel's generator words bit for bit against their
  ``jnp`` twin.
- ``dit_train``: the DiT flow-matching train step at full width
  (``ConditionalTransformer2D`` 768 x 12 layers, 12 heads, patch 4, 32x32x1
  images, batch 256, label-dropout CFG, ``optax.adamw``), 5 steps with
  finite losses; its forward pass at ``highest`` matmul precision on the GPU
  matches the same pass on the CPU device (batch 4).
- ``dit_generate``: ``FlowSampler`` euler-50 generation through
  ``LabelClassifierFreeGuidance``; finite samples.
- ``pcd``: ``ContrastiveDivergence(persistent=True)`` with ``ConvEnergy2D``,
  k=40 Langevin steps under the outer jit, batch 64 of 28x28 images, 5 steps
  through ``ContrastiveDivergenceTrainer``; finite losses.

Each phase prints its result, its wall time and its compile time. No phase's
exception is caught. The script exits non-zero unless JAX's platform is
``gpu``; the last line of a successful run is one JSON object
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
``--rehearse`` (tests only) runs every phase at tiny sizes on any backend,
with the kernel in interpret mode.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "benchmarks"))

#: float32 parity tolerances, with their reasons (see ``phase_dit_train`` and
#: ``phase_four``; the kernel's are in ``fused_langevin``).
DIT_RTOL = 1e-4
FOUR_RTOL = 1e-4


def check(ok: bool, message: str) -> None:
    if not ok:
        raise RuntimeError(message)


def log(**fields) -> None:
    print(json.dumps(fields), flush=True)


class Timer:
    def __init__(self):
        self.t0 = time.perf_counter()

    def __call__(self) -> float:
        return round(time.perf_counter() - self.t0, 3)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_langevin(cfg, seed):
    import jax
    import jax.numpy as jnp

    from torchebm_tpu.core import GaussianMixtureEnergy
    from torchebm_tpu.samplers import LangevinDynamics

    mix = GaussianMixtureEnergy.eight_gaussians()
    sampler = LangevinDynamics(mix, step_size=0.05, fused=cfg["fused"])
    key = jax.random.PRNGKey(seed)
    wall = Timer()
    first = Timer()
    jax.block_until_ready(sampler.sample(
        jax.random.fold_in(key, 0), dim=2, n_samples=cfg["chains"], n_steps=cfg["steps"]))
    t_first = first()
    warm = Timer()
    out = jax.block_until_ready(
        sampler.sample(jax.random.fold_in(key, 1), dim=2, n_samples=cfg["chains"], n_steps=cfg["steps"])
    )
    t_warm = warm()
    radius = float(jnp.mean(jnp.linalg.norm(out, axis=-1)))
    nearest = jnp.argmin(jnp.sum((out[:, None, :] - mix.means[None]) ** 2, -1), axis=1)
    shares = [float(s) for s in jnp.bincount(nearest, length=8) / out.shape[0]]
    check(bool(jnp.all(jnp.isfinite(out))), "non-finite Langevin samples")
    check(3.0 < radius < 5.0, f"mean radius {radius} outside (3, 5)")
    check(min(shares) >= 0.05, f"a mode holds < 5% of the chains: {shares}")
    log(phase="langevin", chains=cfg["chains"], steps=cfg["steps"], mean_radius=radius,
        mode_shares=[round(s, 4) for s in shares], run_s=t_warm,
        compile_s=round(t_first - t_warm, 3), wall_s=wall())


def phase_kernel(cfg, seed):
    """Compiled kernel vs the plain reference with the same injected noise,
    after 1,000 float32 steps. ``fused_langevin.parity_errors`` takes each
    chain's largest |kernel - reference|; the largest over chains must stay
    within ``PARITY_ATOL`` and the 99.9th percentile within
    ``PARITY_BULK_ATOL`` (their comment gives the readings behind them).
    The d=64 means are drawn close enough (0.25·N(0, 1), σ=1) that the
    responsibilities mix; ``mean_max_resp`` reports it."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from torchebm_tpu.core import GaussianMixtureEnergy
    from torchebm_tpu.ops import fused_langevin as fl

    interpret = cfg["interpret"]
    key = jax.random.PRNGKey(seed)
    wall = Timer()
    results = {}
    cases = {
        "d2_8gaussians": GaussianMixtureEnergy.eight_gaussians(),
        "d64_k16": GaussianMixtureEnergy.create(
            0.25 * jax.random.normal(jax.random.fold_in(key, 64), (16, 64)), scale=1.0
        ),
    }
    for name, mix in cases.items():
        k, d = mix.means.shape
        n, steps = cfg["chains"], cfg["parity_steps"]
        x0 = mix.sample(jax.random.fold_in(key, d), n)
        noise = jax.random.normal(jax.random.fold_in(key, d + 1), (steps, n, d))
        run = jax.jit(lambda x, z, m=mix: fl.mixture_langevin_chain(
            x, m.means, steps, 0.01, 1.0, scale=float(m.scale),
            log_weights=m.log_weights, noise=z, interpret=interpret))
        t_c = Timer()
        compiled = run.lower(x0, noise).compile()
        t_compile = t_c()
        got = jax.block_until_ready(compiled(x0, noise))
        with jax.default_matmul_precision("highest"):
            want = jax.block_until_ready(
                jax.jit(lambda x, z, m=mix: fl.reference_chain(m.gradient, x, steps, 0.01, 1.0, z))(x0, noise)
            )
        worst, bulk = fl.parity_errors(got, want)
        err = np.abs(np.asarray(got) - np.asarray(want))
        mem = compiled.memory_analysis()
        sq = jnp.sum((want[:, None, :] - mix.means[None]) ** 2, -1)
        logits = mix.log_weights - 0.5 * sq / mix.scale**2
        results[name] = dict(
            chains=n, d=d, k=k, steps=steps, max_abs_err=worst, p999_abs_err=bulk,
            median_abs_err=float(np.median(err)), compile_s=t_compile,
            temp_bytes=getattr(mem, "temp_size_in_bytes", None),
            mean_max_resp=float(jnp.mean(jnp.max(jax.nn.softmax(logits, -1), -1))),
        )
        check(np.all(np.isfinite(np.asarray(got))), f"{name}: non-finite kernel output")
        check(worst <= fl.PARITY_ATOL, f"{name}: max abs err {worst} > {fl.PARITY_ATOL}")
        check(bulk <= fl.PARITY_BULK_ATOL,
              f"{name}: 99.9th percentile abs err {bulk} > {fl.PARITY_BULK_ATOL}")
    # the in-kernel generator, bit for bit
    n, d, steps = cfg["chains"], 2, 16
    w0, w1 = fl.kernel_words(seed, n, d, steps, interpret=interpret)
    t = jnp.arange(steps, dtype=jnp.uint32)[:, None, None]
    c = jnp.arange(n, dtype=jnp.uint32)[None, :, None]
    b0, b1 = fl.threefry2x32(jnp.uint32(seed), c, t, jnp.zeros((1, 1, 1), jnp.uint32))
    bits_equal = bool(jnp.array_equal(w0, b0) and jnp.array_equal(w1, b1))
    check(bits_equal, "in-kernel generator words differ from the jnp twin")
    log(phase="kernel", tolerance_abs=fl.PARITY_ATOL, tolerance_p999_abs=fl.PARITY_BULK_ATOL,
        generator_bits_equal=bits_equal, cases=results, wall_s=wall())


def _dit(cfg):
    from __graft_entry__ import LabelDiT

    return LabelDiT(
        embed_dim=cfg["width"], num_classes=10, input_size=32, patch_size=4,
        depth=cfg["depth"], num_heads=cfg["heads"], dropout_prob=0.1,
    )


def phase_dit_train(cfg, seed, state):
    """Tolerance: ||gpu - cpu|| / ||cpu|| <= DIT_RTOL for one forward pass at
    ``highest`` precision (true float32 products on both devices). What is
    left is summation order in 12 layers of 768-wide products and the
    normalisations, ~1e-6 relative each; 1e-4 leaves room for their growth
    through depth while still catching a TF32 product (~1e-3)."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from torchebm_tpu.interpolants import LinearInterpolant

    net = _dit(cfg)
    key = jax.random.PRNGKey(seed)
    k_init, k_data, k_pert = jax.random.split(key, 3)
    b = cfg["batch"]
    x1 = jax.random.normal(k_data, (b, 1, 32, 32))
    y = jax.random.randint(jax.random.fold_in(k_data, 1), (b,), 0, 10)
    wall = Timer()
    params = net.init(
        {"params": k_init, "label_dropout": k_init},
        x1[:1], jnp.zeros((1,)), y=y[:1], train=True,
    )
    n_params = sum(int(p.size) for p in jax.tree_util.tree_leaves(params))
    interp = LinearInterpolant()
    opt = optax.adamw(1e-4)
    opt_state = opt.init(params)

    def loss_fn(p, x1, y, k):
        k0, kt, kd = jax.random.split(k, 3)
        x0 = jax.random.normal(k0, x1.shape)
        t = jax.random.uniform(kt, (x1.shape[0],))
        xt, ut = interp.interpolate(x0, x1, t)
        pred = net.apply(p, xt, t, y=y, train=True, rngs={"label_dropout": kd})
        return jnp.mean(jnp.square(pred - ut))

    def step(p, s, x1, y, k):
        loss, g = jax.value_and_grad(loss_fn)(p, x1, y, k)
        u, s = opt.update(g, s, p)
        return optax.apply_updates(p, u), s, loss

    t_c = Timer()
    compiled = jax.jit(step, donate_argnums=(0, 1)).lower(
        params, opt_state, x1, y, key).compile()
    t_compile = t_c()
    # forward parity first: adaLN-Zero starts with a zero output, so the
    # comparison runs on seed-perturbed weights that use every path
    leaves, tree = jax.tree_util.tree_flatten(params)
    pkeys = jax.random.split(k_pert, len(leaves))
    pert = jax.tree_util.tree_unflatten(
        tree, [l + 0.02 * jax.random.normal(k, l.shape) for l, k in zip(leaves, pkeys)])
    t = jnp.linspace(0.1, 0.9, 4)

    def fwd(p, x, t, y):
        return net.apply(p, x, t, y=y, train=False)

    with jax.default_matmul_precision("highest"):
        on_gpu = np.asarray(jax.jit(fwd)(pert, x1[:4], t, y[:4]))
        cpu = jax.devices("cpu")[0]
        on_cpu = np.asarray(jax.jit(fwd)(
            *jax.device_put((pert, x1[:4], t, y[:4]), cpu)))
    rel = float(np.linalg.norm(on_gpu - on_cpu) / np.linalg.norm(on_cpu))
    del pert
    losses, t_run = [], Timer()
    for i in range(5):
        params, opt_state, loss = compiled(params, opt_state, x1, y, jax.random.fold_in(key, i))
        losses.append(loss)
    losses = [float(v) for v in jax.block_until_ready(losses)]
    run_s = t_run()
    check(all(math.isfinite(v) for v in losses), f"non-finite DiT losses {losses}")
    check(rel <= DIT_RTOL, f"DiT forward gpu/cpu relative error {rel} > {DIT_RTOL}")
    state["dit"] = (net, params)
    log(phase="dit_train", params=n_params, batch=b, width=cfg["width"], depth=cfg["depth"],
        losses=losses, forward_rel_err_vs_cpu=rel, tolerance_rel=DIT_RTOL,
        run_s=run_s, compile_s=t_compile, wall_s=wall())


def phase_dit_generate(cfg, seed, state):
    import jax
    import jax.numpy as jnp

    from torchebm_tpu.models import LabelClassifierFreeGuidance
    from torchebm_tpu.samplers import FlowSampler

    net, params = state["dit"]

    def field(x, t, *, y):
        return net.apply(params, x, t, y=y, train=False)

    sampler = FlowSampler(
        model=LabelClassifierFreeGuidance(base=field, null_label_id=10, cfg_scale=2.5,
                                          guide_channels=1),
        integrator="euler",
    )
    n = cfg["gen_samples"]
    y = jnp.arange(n, dtype=jnp.int32) % 10
    key = jax.random.PRNGKey(seed + 7)
    wall = Timer()
    first = Timer()
    jax.block_until_ready(sampler.sample(
        jax.random.fold_in(key, 0), dim=(1, 32, 32), n_samples=n, n_steps=50,
        model_kwargs={"y": y}))
    t_first = first()
    warm = Timer()
    out = jax.block_until_ready(sampler.sample(
        jax.random.fold_in(key, 1), dim=(1, 32, 32), n_samples=n, n_steps=50,
        model_kwargs={"y": y}))
    t_warm = warm()
    check(out.shape == (n, 1, 32, 32) and bool(jnp.all(jnp.isfinite(out))), "bad samples")
    log(phase="dit_generate", samples=n, steps=50, shape=list(out.shape),
        pixel_std=float(jnp.std(out)), run_s=t_warm, compile_s=round(t_first - t_warm, 3),
        wall_s=wall())


def phase_pcd(cfg, seed):
    import jax
    import jax.numpy as jnp

    from torchebm_tpu.core import ContrastiveDivergenceTrainer, WrappedEnergy
    from torchebm_tpu.losses import ContrastiveDivergence
    from torchebm_tpu.models import ConvEnergy2D
    from torchebm_tpu.samplers import LangevinDynamics

    key = jax.random.PRNGKey(seed + 11)
    net = ConvEnergy2D(channels=cfg["pcd_channels"])
    params = net.init(key, jnp.zeros((1, 1, 28, 28)))
    energy = WrappedEnergy(fn=net.apply, params=params)
    sampler = LangevinDynamics(energy, step_size=10.0, noise_scale=0.005, clamp=(-1.0, 1.0))
    cd = ContrastiveDivergence(
        model=energy, sampler=sampler, k_steps=cfg["pcd_k"], persistent=True,
        buffer_size=cfg["pcd_buffer"], init_steps=0, new_sample_ratio=0.05,
    )
    trainer = ContrastiveDivergenceTrainer(cd, learning_rate=1e-4)
    state = trainer.init_state(params, key, cd.init_buffer(key, (1, 28, 28)))
    batch = jax.random.uniform(jax.random.fold_in(key, 1), (cfg["pcd_batch"], 1, 28, 28),
                               minval=-1.0, maxval=1.0)
    wall = Timer()
    first = Timer()
    state, metrics = trainer.train_step(state, batch)
    losses = [metrics["loss"]]
    jax.block_until_ready(losses[0])
    t_first = first()
    t_run = Timer()
    for i in range(4):
        batch = jax.random.uniform(jax.random.fold_in(key, i + 2), batch.shape,
                                   minval=-1.0, maxval=1.0)
        state, metrics = trainer.train_step(state, batch)
        losses.append(metrics["loss"])
    losses = [float(v) for v in jax.block_until_ready(losses)]
    per_step = t_run() / 4
    check(all(math.isfinite(v) for v in losses), f"non-finite PCD losses {losses}")
    log(phase="pcd", k_steps=cfg["pcd_k"], batch=cfg["pcd_batch"], losses=losses,
        step_s=round(per_step, 4), compile_s=round(t_first - per_step, 3), wall_s=wall())


def phase_four(seed):
    """The data x fsdp mesh on four devices against the same steps on one.

    Compared: the two PCD losses, and the fsdp DiT's two losses and two
    gradient norms on seed-perturbed weights (``dryrun_dit_cfg_fsdp``). Same
    steps, same data, float32 at ``highest`` precision: only the reduction
    order (over shards against on one device) differs, ~1e-6 relative per
    reading. FOUR_RTOL = 1e-4 leaves a 100x margin, while a gradient reduced
    over half the batch, or a wrong update, moves a gradient norm or the
    second loss by far more (``dit_update_rel_change`` shows the update's
    own effect on the second loss)."""
    import jax

    from __graft_entry__ import dryrun_multichip

    devices = jax.devices()
    check(len(devices) >= 4, f"--four needs 4 devices, found {len(devices)}")
    wall = Timer()
    with jax.default_matmul_precision("highest"):
        four = dryrun_multichip(4, devices=devices[:4], checkpoint=False)
        one = dryrun_multichip(4, devices=devices[:1], checkpoint=False)
    def readings(r):
        return r["pcd"] + r["dit"]["loss"] + r["dit"]["grad_norm"]

    pairs = list(zip(readings(four), readings(one)))
    rel = max(abs(a - b) / max(abs(b), 1e-12) for a, b in pairs)
    check(rel <= FOUR_RTOL, f"4-device readings differ from 1-device: {pairs}")
    first, second = one["dit"]["loss"]
    log(phase="four", mesh=[2, 2], readings_4dev=four, readings_1dev=one, max_rel_diff=rel,
        tolerance_rel=FOUR_RTOL, dit_update_rel_change=abs(second - first) / abs(first),
        wall_s=wall())


FULL = dict(chains=10_000, steps=2000, parity_steps=1000, fused="auto", interpret=False,
            width=768, depth=12, heads=12, batch=256, gen_samples=256,
            pcd_channels=(32, 64, 64), pcd_k=40, pcd_batch=64, pcd_buffer=10_000)
REHEARSAL = dict(chains=256, steps=300, parity_steps=20, fused="off", interpret=True,
                 width=64, depth=2, heads=4, batch=8, gen_samples=8,
                 pcd_channels=(8, 16), pcd_k=4, pcd_batch=8, pcd_buffer=64)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true", help="run only the 4-GPU mesh phase")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rehearse", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    from device import card_name_and_power  # runs nvidia-smi in a child process

    print("card:", card_name_and_power(), flush=True)
    platforms = os.environ.get("JAX_PLATFORMS")
    if platforms and "cpu" not in platforms.split(","):
        # the DiT parity check needs the CPU device beside the GPU
        os.environ["JAX_PLATFORMS"] = platforms + ",cpu"
    from torchebm_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    import jax
    import jaxlib

    dev = jax.devices()[0]
    print(f"jax {jax.__version__}, jaxlib {jaxlib.__version__}, "
          f"devices {len(jax.devices())} x {dev.device_kind}", flush=True)
    if dev.platform != "gpu" and not args.rehearse:
        print(f"chip_smoke: needs a GPU, JAX found platform {dev.platform!r}", file=sys.stderr)
        return 2

    if args.four:
        phase_four(args.seed)
    else:
        cfg = REHEARSAL if args.rehearse else FULL
        state = {}
        phase_langevin(cfg, args.seed)
        phase_kernel(cfg, args.seed)
        phase_dit_train(cfg, args.seed, state)
        phase_dit_generate(cfg, args.seed, state)
        phase_pcd(cfg, args.seed)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
