#!/usr/bin/env python
"""Profiler CLI: trace + cost-profile registry components, and diff runs.

The JAX equivalent of the reference's ``benchmarks/profiler.py`` (torch
profiler CLI with chrome traces, top-op tables, and markdown diffs):

    # profile one registry component (same callables the benchmarks time)
    python benchmarks/profiler.py run --component samplers.LangevinDynamics \
        --scale small --out profiles/langevin.json [--trace-dir profiles/tb]

    # profile an arbitrary zero-arg callable
    python benchmarks/profiler.py run --callable mymod:make_thunk --scale small ...

    # markdown diff of two runs, sorted by |delta|
    python benchmarks/profiler.py diff profiles/a.json profiles/b.json

Each run records wall-clock stats (compile-excluded, device-fenced) and the
XLA ``cost_analysis`` of the compiled program (FLOPs, bytes accessed,
transcendentals) — the op-cost table analogue. ``--trace-dir`` additionally
captures a TensorBoard/XPlane trace (open with ``tensorboard --logdir`` /
xprof), the chrome-trace analogue. Outputs are gitignored under
``benchmarks/profiles/``.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
for p in (os.path.dirname(HERE), HERE):
    if p not in sys.path:
        sys.path.insert(0, p)


def _build_thunk(args):
    from registry import SCALES, discover

    scale = SCALES[args.scale]
    if args.component:
        for spec in discover():
            if spec.name == args.component:
                return spec.build(scale), spec.name
        raise SystemExit(
            f"unknown component {args.component!r}; available: "
            + ", ".join(s.name for s in discover())
        )
    mod_name, _, attr = args.callable.partition(":")
    fn = getattr(importlib.import_module(mod_name), attr)
    return fn(scale), args.callable


def cmd_run(args) -> int:
    import jax

    if args.device:
        jax.config.update("jax_platforms", args.device)

    from torchebm_tpu.utils import benchmark_fn

    thunk, name = _build_thunk(args)

    jitted = jax.jit(thunk)
    cost = {}
    try:
        compiled = jitted.lower().compile()
        cost = dict(compiled.cost_analysis() or {})
        memory = compiled.memory_analysis()
        if memory is not None:
            for attr in ("temp_size_in_bytes", "argument_size_in_bytes",
                         "output_size_in_bytes", "generated_code_size_in_bytes"):
                v = getattr(memory, attr, None)
                if v is not None:
                    cost[attr] = float(v)
    except Exception as e:  # cost analysis is best-effort per backend
        cost = {"error": str(e)}

    if args.trace_dir:
        os.makedirs(args.trace_dir, exist_ok=True)
        jax.block_until_ready(jitted())  # compile outside the trace
        with jax.profiler.trace(args.trace_dir):
            jax.block_until_ready(jitted())
        print(f"trace -> {args.trace_dir}")

    stats = benchmark_fn(jitted, warmup=2, iters=args.iters)

    payload = {
        "name": name,
        "scale": args.scale,
        "backend": jax.default_backend(),
        "wall": stats,
        "cost_analysis": {k: float(v) for k, v in cost.items() if _is_num(v)},
    }
    if "error" in cost:
        payload["cost_analysis_error"] = cost["error"]
    os.makedirs(os.path.dirname(os.path.abspath(args.out)) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(payload, f, indent=1, sort_keys=True)
    flops = payload["cost_analysis"].get("flops")
    print(f"{name}[{args.scale}] median {stats['median_s'] * 1e3:.3f} ms"
          + (f", {flops / stats['median_s'] / 1e9:.1f} GFLOP/s" if flops else ""))
    print(f"profile -> {args.out}")
    return 0


def _is_num(v):
    try:
        float(v)
        return True
    except (TypeError, ValueError):
        return False


def cmd_diff(args) -> int:
    a = json.load(open(args.a))
    b = json.load(open(args.b))
    rows = []
    rows.append(("wall.median_s", a["wall"]["median_s"], b["wall"]["median_s"]))
    rows.append(("wall.min_s", a["wall"]["min_s"], b["wall"]["min_s"]))
    keys = set(a.get("cost_analysis", {})) | set(b.get("cost_analysis", {}))
    for k in sorted(keys):
        rows.append(
            (f"cost.{k}", a.get("cost_analysis", {}).get(k, 0.0),
             b.get("cost_analysis", {}).get(k, 0.0))
        )
    rows.sort(key=lambda r: -abs(r[2] - r[1]))
    print(f"| metric | {a['name']}[{a['scale']}] | {b['name']}[{b['scale']}] | delta |")
    print("|---|---:|---:|---:|")
    for k, va, vb in rows:
        delta = vb - va
        rel = f" ({delta / va * 100:+.1f}%)" if va else ""
        print(f"| {k} | {va:.6g} | {vb:.6g} | {delta:+.6g}{rel} |")
    return 0


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    pr = sub.add_parser("run")
    g = pr.add_mutually_exclusive_group(required=True)
    g.add_argument("--component")
    g.add_argument("--callable")
    pr.add_argument("--scale", default="small")
    pr.add_argument("--out", default=os.path.join(HERE, "profiles", "profile.json"))
    pr.add_argument("--trace-dir", default="")
    pr.add_argument("--iters", type=int, default=5)
    pr.add_argument("--device", default="")
    pd = sub.add_parser("diff")
    pd.add_argument("a")
    pd.add_argument("b")
    args = p.parse_args()
    return {"run": cmd_run, "diff": cmd_diff}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
