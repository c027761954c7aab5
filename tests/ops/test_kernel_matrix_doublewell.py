"""Kernel vs plain-jnp reference: the double-well target over d × schedule ×
output × clamp, in interpret mode (see ``kernel_cases``)."""

import pytest

from kernel_cases import CLAMPS, run_case


@pytest.mark.parametrize("clamp", list(CLAMPS), ids=str)
@pytest.mark.parametrize("output", ["chain", "traj"])
@pytest.mark.parametrize("schedule", ["const", "sched"])
@pytest.mark.parametrize("d", [1, 2, 8, 64])
def test_kernel_matches_reference(d, schedule, output, clamp):
    run_case("doublewell", d, schedule, output, CLAMPS[clamp])
