"""Hand-written kernels (the reference's ``torchebm/cuda`` layer).

One kernel lives here: the whole-chain Langevin kernel
(:mod:`torchebm_tpu.ops.fused_langevin`, Pallas on the Triton route), which
:class:`~torchebm_tpu.samplers.LangevinDynamics` and
:class:`~torchebm_tpu.samplers.GradientDescentSampler` dispatch to on
eager GPU calls with supported analytic energies. :func:`kernels_enabled`
is the one place that decides whether a kernel runs.
"""

import jax

from .fused_langevin import (
    doublewell_langevin_chain,
    doublewell_langevin_chain_trajectory,
    kernel_normals,
    kernel_words,
    langevin_chain,
    mixture_langevin_chain,
    mixture_langevin_chain_trajectory,
    reference_chain,
    threefry2x32,
)

__all__ = [
    "kernels_enabled",
    "langevin_chain",
    "reference_chain",
    "threefry2x32",
    "kernel_normals",
    "kernel_words",
    "doublewell_langevin_chain",
    "doublewell_langevin_chain_trajectory",
    "mixture_langevin_chain",
    "mixture_langevin_chain_trajectory",
]

FUSED_MODES = ("auto", "off", "force")


def kernels_enabled(fused: str) -> bool:
    """Whether a ``fused`` setting runs the hand-written kernels here.

    ``"off"``: never. ``"auto"``: on a GPU backend. ``"force"``: on a GPU
    backend, and an error elsewhere — the kernels compile only for the GPU,
    and a forced call must not quietly fall back to something else.
    """
    if fused not in FUSED_MODES:
        raise ValueError(f"fused must be one of {FUSED_MODES}, got {fused!r}")
    if fused == "off":
        return False
    on_gpu = jax.default_backend() == "gpu"
    if fused == "force" and not on_gpu:
        raise RuntimeError(
            f"fused='force' needs a GPU backend; this one is "
            f"{jax.default_backend()!r}. Use fused='auto' or 'off'."
        )
    return on_gpu
