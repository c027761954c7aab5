"""Auto-generated benchmarks: one per (component x scale).

Mirrors the reference's ``benchmarks/test_bench_auto.py:41-75``
(pytest_generate_tests over the discovery registry).
"""

import jax
import pytest

from registry import SCALES, discover


def pytest_generate_tests(metafunc):
    if "spec" not in metafunc.fixturenames:
        return
    scales = metafunc.config.getoption("--bench-scales").split(",")
    groups = [g for g in metafunc.config.getoption("--bench-module").split(",") if g]
    params = []
    for spec in discover():
        if groups and spec.group not in groups:
            continue
        for s in scales:
            params.append(pytest.param(spec, SCALES[s.strip()], id=f"{spec.name}[{s}]"))
    metafunc.parametrize("spec,scale", params)


def test_benchmark(spec, scale, bench_record):
    if spec.gpu_only and jax.default_backend() != "gpu":
        pytest.skip("GPU-only benchmark: the kernel compiles only for a GPU")
    from torchebm_tpu.utils import benchmark_fn

    thunk = spec.build(scale)
    stats = benchmark_fn(thunk, warmup=2, iters=5)
    stats["items_per_s"] = spec.work_items(scale) / stats["median_s"]
    bench_record(spec.name, scale.name, stats)
    assert stats["median_s"] > 0
