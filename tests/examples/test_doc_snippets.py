"""Tutorial code blocks execute as written.

Every ```python block in the tutorial pages runs top-to-bottom in one
shared namespace per page (blocks build on each other, like a reader
following along). Marked ``examples`` so the default test run skips it
(same policy as the example smoke runs); CI's docs job runs it with
``-m examples``.
"""

import os
import re

import pytest

pytestmark = pytest.mark.examples

DOCS = os.path.join(os.path.dirname(__file__), "..", "..", "docs")
PAGES = [
    "tutorials/langevin_sampling.md",
    "tutorials/hamiltonian_mechanics.md",
    "tutorials/neural_energy_functions.md",
    "tutorials/bridges_reflow_couplings.md",
    "tutorials/scaling_mesh.md",
    "datasets.md",
]

_BLOCK = re.compile(r"```python\n(.*?)```", re.DOTALL)


def _blocks(page):
    with open(os.path.join(DOCS, page)) as f:
        return _BLOCK.findall(f.read())


@pytest.mark.parametrize("page", PAGES)
def test_page_has_code(page):
    assert _blocks(page), f"{page} has no python blocks"


@pytest.mark.parametrize("page", PAGES)
def test_tutorial_snippets_execute(page):
    ns = {}
    for i, block in enumerate(_blocks(page)):
        try:
            exec(compile(block, f"{page}[block {i}]", "exec"), ns)
        except Exception as e:  # pragma: no cover - failure reporting
            pytest.fail(f"{page} block {i} failed: {type(e).__name__}: {e}\n{block}")
