"""The benchmark's CPU tests: the checkout's root on the import path, and
small cells (the real configurations at a tiny N) for the runs."""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

CELLS = ("fcc_chiral_n120.sweep", "sc_curv_crossdof_n120.sweep",
         "fcc_chiral_n120.levers", "sc_curv_crossdof_n120.cold")


@pytest.fixture(autouse=True)
def _few_threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def small_cell(name: str, n: int = 8, traced: bool = False):
    """The cell ``name`` with its configuration at grid size ``n``."""
    from benchmark import harness
    c = harness.cell(name, traced)
    return c._replace(config={**c.config, "n": n})
