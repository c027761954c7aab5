r"""Profiling helpers: trace contexts, scopes, and wall-clock benchmarking.

Reference: ``torchebm/utils/profiling.py:37-95`` (torch.profiler wrapper with
table print + Chrome trace). JAX equivalents:

- :func:`profile_context` wraps ``jax.profiler.trace`` — produces a
  TensorBoard/XPlane trace (open with ``tensorboard --logdir`` or
  ``xprof``), the chrome-trace analogue.
- :func:`record_function` re-exports ``jax.named_scope`` for hot-loop region
  annotation (the reference re-exports ``torch.profiler.record_function``).
- :func:`benchmark_fn` is a dispatch-overhead-aware wall-clock timer
  (compile-once, then median-of-k with ``block_until_ready``) used by the
  benchmark harness.
"""

from __future__ import annotations

import contextlib
import statistics
import time
from typing import Any, Callable, Dict, Optional

import jax

__all__ = ["profile_context", "record_function", "benchmark_fn"]

record_function = jax.named_scope


@contextlib.contextmanager
def profile_context(
    log_dir: str = "/tmp/torchebm_tpu_profile",
    *,
    create_perfetto_link: bool = False,
):
    """Trace everything inside the block to ``log_dir`` (TensorBoard format)."""
    with jax.profiler.trace(log_dir, create_perfetto_link=create_perfetto_link):
        yield log_dir


def benchmark_fn(
    fn: Callable[[], Any],
    *,
    warmup: int = 2,
    iters: int = 10,
) -> Dict[str, float]:
    """Median/min/mean wall-clock seconds for ``fn`` (device-synchronized).

    ``fn`` should return jax arrays (or pytrees of them); each timed call is
    fenced with ``block_until_ready`` so async dispatch doesn't flatter the
    numbers. The first ``warmup`` calls absorb compilation.
    """
    for _ in range(warmup):
        jax.block_until_ready(fn())
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return {
        "median_s": statistics.median(times),
        "min_s": min(times),
        "mean_s": statistics.fmean(times),
        "iters": float(iters),
    }
