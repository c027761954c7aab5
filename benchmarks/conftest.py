"""Benchmark harness pytest configuration.

Separate pytest tree from ``tests/`` (reference keeps benchmarks out of plain
test runs, ``docs/developer_guide/performance.md:90-95``). Options:

- ``--bench-scales=small,medium`` (default: small)
- ``--bench-module=samplers,losses`` (default: all groups)
- ``--bench-output=PATH`` JSON results (default: benchmarks/results/latest.json)
- ``--bench-device=cpu|gpu`` force a backend (default: whatever JAX picks)
"""

import json
import os
import sys
import time

import pytest

# make the library (repo root) and the registry (this dir) importable when the
# harness runs from any working directory
_HERE = os.path.dirname(os.path.abspath(__file__))
for p in (os.path.dirname(_HERE), _HERE):
    if p not in sys.path:
        sys.path.insert(0, p)

RESULTS = {}


def pytest_addoption(parser):
    parser.addoption("--bench-scales", default="small")
    parser.addoption("--bench-module", default="")
    parser.addoption(
        "--bench-output",
        default=os.path.join(os.path.dirname(__file__), "results", "latest.json"),
    )
    parser.addoption("--bench-device", default="")


def pytest_configure(config):
    device = config.getoption("--bench-device")
    if device:
        os.environ.setdefault("JAX_PLATFORMS", device)
        import jax

        jax.config.update("jax_platforms", device)


@pytest.fixture(scope="session")
def bench_record(request):
    def record(name, scale, stats):
        RESULTS[f"{name}[{scale}]"] = stats

    yield record
    out = request.config.getoption("--bench-output")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    import jax

    payload = {
        "timestamp": time.time(),
        "backend": jax.default_backend(),
        "device": str(jax.devices()[0]),
        "results": RESULTS,
    }
    with open(out, "w") as f:
        json.dump(payload, f, indent=1, sort_keys=True)
