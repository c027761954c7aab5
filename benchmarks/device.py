"""Device facts and timing shared by the measurement scripts.

- :func:`device_info` names what a result was measured on: JAX's platform,
  ``device_kind`` and device count, and the card's name and power limit as
  ``nvidia-smi`` reports them (read by a child process that stays off JAX).
- :func:`require_accelerator` stops a measurement that would run on the CPU.
- :data:`PEAKS` holds published peak rates keyed by ``device_kind``; a device
  missing from it is an error, never a default.
- :func:`median_time` times a call that ends in ``jax.block_until_ready``.
"""

from __future__ import annotations

import statistics
import subprocess
import time
from typing import Callable, Dict

#: Published dense peaks per device kind. Source: NVIDIA H100 data sheet,
#: SXM part, at the full 700 W limit (tensor-core rates without sparsity;
#: "f32" is the non-tensor-core FP32 rate).
PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {
        "bf16": 989e12,
        "tf32": 495e12,
        "f32": 67e12,
        "hbm_bytes_per_s": 3.35e12,
    },
}


def peaks(device_kind: str) -> Dict[str, float]:
    """The peak table row for ``device_kind``; unknown devices are an error."""
    if device_kind not in PEAKS:
        raise KeyError(
            f"no published peaks for device kind {device_kind!r}; add its row to "
            "benchmarks/device.py::PEAKS with the source"
        )
    return PEAKS[device_kind]


def card_name_and_power() -> str:
    """``name, power.limit`` from nvidia-smi, or why it could not be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=False,
        )
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else out.stderr.strip()
    except (OSError, subprocess.TimeoutExpired, IndexError) as err:
        return f"nvidia-smi unavailable ({err})"


def device_info() -> dict:
    import jax

    dev = jax.devices()[0]
    return {
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "card": card_name_and_power(),
    }


def require_accelerator() -> dict:
    """``device_info()``, or SystemExit when JAX runs on the CPU: no
    measurement path falls back to the host."""
    info = device_info()
    if info["platform"] == "cpu":
        raise SystemExit("measurement needs an accelerator; JAX found only the CPU")
    return info


def median_time(fn: Callable[[int], object], iters: int, warmup: int = 1) -> float:
    """Median wall seconds of ``fn(i)`` for ``i = 1..iters``, each call ended
    by ``jax.block_until_ready`` on its result; ``warmup`` untimed calls
    (``i = 0``) first absorb compilation."""
    import jax

    for _ in range(warmup):
        jax.block_until_ready(fn(0))
    times = []
    for i in range(1, iters + 1):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(i))
        times.append(time.perf_counter() - t0)
    return statistics.median(times)
