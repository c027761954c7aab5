"""Kernel vs plain-jnp reference: mixture and isotropic-Gaussian targets over
d × schedule × output × clamp, in interpret mode (see ``kernel_cases``)."""

import pytest

from kernel_cases import CLAMPS, run_case


@pytest.mark.parametrize("clamp", list(CLAMPS), ids=str)
@pytest.mark.parametrize("output", ["chain", "traj"])
@pytest.mark.parametrize("schedule", ["const", "sched"])
@pytest.mark.parametrize("d", [1, 2, 8, 64])
@pytest.mark.parametrize("family", ["mixture", "gaussian"])
def test_kernel_matches_reference(family, d, schedule, output, clamp):
    run_case(family, d, schedule, output, CLAMPS[clamp])
