"""Shared example helpers: CPU forcing for smoke runs and iteration scaling."""

import os


def setup(force_cpu_for_smoke: bool = True):
    """Returns True when running in smoke mode (``TORCHEBM_SMOKE=1``).

    Smoke runs force the CPU backend (fast startup, no accelerator needed)
    and examples shrink their iteration counts — the reference's
    ``TORCHEBM_SMOKE`` convention (``tests/examples/test_examples_smoke.py``).
    """
    smoke = os.environ.get("TORCHEBM_SMOKE") == "1"
    if smoke and force_cpu_for_smoke:
        import jax

        jax.config.update("jax_platforms", "cpu")
    return smoke


def n(iters: int, smoke_iters: int = None):
    """Scale an iteration count down in smoke mode."""
    if os.environ.get("TORCHEBM_SMOKE") == "1":
        return smoke_iters if smoke_iters is not None else max(1, iters // 50)
    return iters
