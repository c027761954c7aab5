#!/usr/bin/env python
"""PCD-conv device-time decomposition + optimization study.

The PCD train step (ConvEnergy2D 28x28, batch 64, k=40 Langevin negatives,
replay buffer 4096): where the time goes and what moves it.

**Decomposition** (all in-program scans of N steps, so per-call host
dispatch does not set the numbers; each call fenced by
``block_until_ready``):

- full train step (baseline)
- the k=40 sampler chain alone (jitted scan of Langevin steps)
- one energy GRADIENT evaluation (the chain's unit of work)
- one energy FORWARD evaluation
- the loss+optimizer remainder (train step with k=1)
- conv-stack depth sweep (1/2/3 conv layers) — per-layer attribution

**Variants** of the full step:

- bf16 compute (conv dtype bf16; buffer/data f32 — the r4 configuration)
- bf16 END-TO-END: bf16 chain state + buffer + data (possible since the
  sampling loop preserves the caller's state dtype)
- NHWC end-to-end: chain state/buffer/data in the conv-native layout
  (``ConvEnergy2D(data_format="NHWC")``) — removes ~82 transposes/step
- sampler ``unroll`` 4 / 40 (fully unrolled negatives chain)
- combinations of the winners

Writes ``benchmarks/results/pcd_profile.json``. Usage::

    python benchmarks/pcd_profile.py [--iters 3] [--only a,b,...]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
for p in (os.path.dirname(HERE), HERE):
    if p not in sys.path:
        sys.path.insert(0, p)

from device import require_accelerator  # noqa: E402
from headline import _mfu_fields, _per_unit_time  # noqa: E402


def _factory(
    *,
    batch=64,
    k_steps=40,
    channels=(32, 64, 64),
    dtype="f32",
    state_dtype="f32",
    data_format="NCHW",
    unroll=1,
    noise_block=1,
    buffer_size=4096,
):
    import jax
    import jax.numpy as jnp
    import optax

    from torchebm_tpu.core import as_energy
    from torchebm_tpu.losses import ContrastiveDivergence
    from torchebm_tpu.models import ConvEnergy2D
    from torchebm_tpu.samplers import LangevinDynamics

    jd = {"f32": jnp.float32, "bf16": jnp.bfloat16}
    key = jax.random.PRNGKey(0)
    shape = (1, 28, 28) if data_format == "NCHW" else (28, 28, 1)
    net = ConvEnergy2D(channels=channels, dtype=jd[dtype], data_format=data_format)
    params = net.init(key, jnp.zeros((1, *shape)))
    energy = as_energy(net, params)
    sampler = LangevinDynamics(
        energy, step_size=10.0, clamp=(-1.0, 1.0), unroll=unroll,
        noise_block=noise_block,
    )
    cd = ContrastiveDivergence(
        model=energy, sampler=sampler, k_steps=k_steps, persistent=True,
        buffer_size=buffer_size, init_steps=0,
    )
    buffer = cd.init_buffer(key, shape)
    buffer = buffer.replace(samples=buffer.samples.astype(jd[state_dtype]))
    opt = optax.adam(1e-4)
    opt_state = opt.init(params)
    data = jax.random.normal(key, (batch, *shape), jd[state_dtype])

    @jax.jit
    def step(p, s, b, x, k):
        (l, (_, b2)), g = jax.value_and_grad(lambda pp: cd(pp, x, k, b), has_aux=True)(p)
        u, s = opt.update(g, s)
        return optax.apply_updates(p, u), s, b2, l

    @jax.jit
    def step_scan(p, s, b, x, k, n):
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

    ctx = dict(
        jax=jax, jnp=jnp, net=net, params=params, energy=energy,
        sampler=sampler, cd=cd, buffer=buffer, data=data, key=key,
        step=step, run_scan=run_scan, shape=shape, opt_state=opt_state,
    )
    return ctx


# ------------------------------------------------------------ decomposition


def part_full(iters):
    c = _factory()
    t = _per_unit_time(c["run_scan"], 620, iters)
    return {
        "device_us": t * 1e6,
        **_mfu_fields(
            c["step"],
            (c["params"], c["opt_state"], c["buffer"], c["data"], c["key"]),
            t,
        ),
    }


def part_sampler_chain(iters):
    """The k=40 negatives chain alone (per train-step equivalent)."""
    c = _factory()
    jax, jnp = c["jax"], c["jnp"]

    @jax.jit
    def chains(x0, k, n):
        def body(i, x):
            return c["sampler"].sample(
                jax.random.fold_in(k, i), x=x, n_steps=40
            )

        x = jax.lax.fori_loop(0, n, body, x0)
        return jnp.sum(x)

    x0 = c["data"].astype(jnp.float32)

    def run(n, i):
        return chains(x0, jax.random.fold_in(c["key"], i), jnp.int32(n))

    t = _per_unit_time(run, 620, iters)
    return {"device_us": t * 1e6}


def _eval_scan(fn_one, c, iters, hi=6200):
    jax, jnp = c["jax"], c["jnp"]

    @jax.jit
    def evals(x0, n):
        def body(i, x):
            return fn_one(x)

        x = jax.lax.fori_loop(0, n, body, x0)
        return jnp.sum(x)

    x0 = c["data"].astype(jnp.float32)

    def run(n, i):
        return evals(x0, jnp.int32(n))

    t = _per_unit_time(run, hi, iters)
    return {"device_us": t * 1e6}


def part_grad_eval(iters):
    """One ∇E evaluation — the chain's unit of work (41 per train step)."""
    c = _factory()
    e = c["energy"]
    return _eval_scan(lambda x: x * 1e-6 + e.gradient(x), c, iters)


def part_forward_eval(iters):
    c = _factory()
    e = c["energy"]
    return _eval_scan(lambda x: x * 1e-6 + e(x)[:, None, None, None], c, iters)


def part_loss_opt(iters):
    """Train step with k=1: loss fwd/bwd + adam + buffer update + 1 chain step."""
    c = _factory(k_steps=1)
    t = _per_unit_time(c["run_scan"], 1550, iters)
    return {"device_us": t * 1e6}


def part_depth_sweep(iters):
    out = {}
    for depth, chans in [(1, (32,)), (2, (32, 64)), (3, (32, 64, 64))]:
        c = _factory(channels=chans)
        e = c["energy"]
        t = _eval_scan(lambda x: x * 1e-6 + e.gradient(x), c, iters)
        out[f"grad_eval_depth{depth}_us"] = t["device_us"]
    return out


# ------------------------------------------------------------- variants


def _variant(iters, mfu=False, **kw):
    c = _factory(**kw)
    t = _per_unit_time(c["run_scan"], 620, iters)
    out = {"device_us": t * 1e6, **{k: str(v) for k, v in kw.items()}}
    if mfu:
        peak = "bf16" if kw.get("dtype") == "bf16" else "f32"
        out.update(
            _mfu_fields(
                c["step"],
                (c["params"], c["opt_state"], c["buffer"], c["data"], c["key"]),
                t,
                peak,
            )
        )
    return out


def part_op_census(iters):
    """Count substantial ops in the optimized HLO — the latency-floor
    evidence. A 28x28 batch-64 conv fwd+bwd is a chain of ~15 sub-µs
    convolution/fusion ops executed SEQUENTIALLY by the core; measured
    per-grad-eval time divided by this count gives the achieved per-op time
    to compare against the few-hundred-ns op-issue + HBM-latency floor."""
    import re

    c = _factory()
    jax = c["jax"]
    e = c["energy"]

    def census(compiled):
        txt = compiled.as_text()
        counts = {
            "convolution": len(re.findall(r" = .*convolution\(", txt)),
            "dot": len(re.findall(r" = .*dot\(", txt)),
            "fusion": len(re.findall(r" = .*fusion\(", txt)),
            "custom-call": len(re.findall(r" = .*custom-call\(", txt)),
            "copy": len(re.findall(r" = .*copy\(", txt)),
        }
        counts["substantial_total"] = sum(
            counts[k] for k in ("convolution", "dot", "fusion", "custom-call")
        )
        return counts

    grad1 = jax.jit(lambda x: e.gradient(x)).lower(c["data"]).compile()
    step = c["step"].lower(
        c["params"], c["opt_state"], c["buffer"], c["data"], c["key"]
    ).compile()
    return {"grad_eval_ops": census(grad1), "train_step_ops": census(step)}


PARTS = {
    "full_f32": part_full,
    "op_census": part_op_census,
    "sampler_chain_k40": part_sampler_chain,
    "grad_eval": part_grad_eval,
    "forward_eval": part_forward_eval,
    "loss_opt_k1": part_loss_opt,
    "depth_sweep": part_depth_sweep,
    "v_bf16_compute": lambda i: _variant(i, dtype="bf16"),
    "v_bf16_e2e": lambda i: _variant(i, dtype="bf16", state_dtype="bf16"),
    "v_nhwc": lambda i: _variant(i, data_format="NHWC"),
    "v_unroll4": lambda i: _variant(i, unroll=4),
    "v_unroll40": lambda i: _variant(i, unroll=40),
    "v_nhwc_bf16_e2e": lambda i: _variant(
        i, data_format="NHWC", dtype="bf16", state_dtype="bf16"
    ),
    "v_nhwc_bf16_e2e_unroll4": lambda i: _variant(
        i, data_format="NHWC", dtype="bf16", state_dtype="bf16", unroll=4
    ),
    "v_bf16_e2e_mfu": lambda i: _variant(
        i, mfu=True, dtype="bf16", state_dtype="bf16"
    ),
    "v_bf16_e2e_nb4": lambda i: _variant(
        i, dtype="bf16", state_dtype="bf16", noise_block=4
    ),
    "v_bf16_e2e_nb8": lambda i: _variant(
        i, dtype="bf16", state_dtype="bf16", noise_block=8
    ),
    "v_bf16_e2e_unroll4": lambda i: _variant(
        i, dtype="bf16", state_dtype="bf16", unroll=4
    ),
    "v_f32_nb4": lambda i: _variant(i, noise_block=4),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--only", default="")
    ap.add_argument("--out", default=os.path.join(HERE, "results", "pcd_profile.json"))
    args = ap.parse_args()

    from torchebm_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    info = require_accelerator()
    import jax

    selected = [s for s in args.only.split(",") if s] or list(PARTS)
    report = {"device": info, "iters": args.iters, "parts": {}}
    for name in selected:
        t0 = time.perf_counter()
        res = PARTS[name](args.iters)
        res["bench_s"] = round(time.perf_counter() - t0, 1)
        report["parts"][name] = res
        print(f"{name:28s} {json.dumps(res)}")
        jax.clear_caches()

    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    print(f"report -> {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
