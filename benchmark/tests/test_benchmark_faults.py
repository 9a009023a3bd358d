"""A run with the timed path broken underneath comes out not correct: the
harness's look for a card is skipped and the rest of a run drives the
program at a tiny grid on the CPU.  The faults a cell of this benchmark
can have: a solve that returns its start block unchanged, half of the
block's columns left out of the operator, and a frequency altered where
the solve produces it.  (Every cell takes one card: no exchange between
cards to leave out.)"""

import dataclasses
import time

import pytest
import torch

from benchmark import harness
from conftest import small_cell

CELLS = ["fcc_chiral_n120.sweep", "sc_curv_crossdof_n120.cold"]


def _run(name, monkeypatch=None, gate=True):
    """A run of the cell at N=8; with ``gate`` False the program's own
    acceptance gate passes everything, so that only the comparison with
    the reference stands between the fault and ``correct``."""
    if not gate:
        from benchmark import chain
        monkeypatch.setattr(chain, "accept", lambda *a, **k: None)
    c = small_cell(name, n=8)
    return harness.run_cell(c, 2 ** 31 + 11, 0.0, False,
                            torch.device("cpu"), time.time())[0]


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    result = _run(name)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0


@pytest.mark.parametrize("gate", [True, False])
@pytest.mark.parametrize("name", CELLS)
def test_a_solve_that_returns_its_state_unchanged(name, gate, monkeypatch):
    from pcx_torch import bandstructure
    from pcx_torch.solvers.lobpcg import SolveResult, Status

    def unchanged(h_func, p_func, x0, nev, **kw):
        m = x0.shape[0]
        lam = torch.linspace(1.0, 2.0, m, dtype=torch.float64)
        return SolveResult(lam.to(x0.real.dtype), x0.clone(), 1,
                           Status.FLOOR, None)

    monkeypatch.setattr(bandstructure, "lobpcg_sep_rs", unchanged)
    result = _run(name, monkeypatch, gate)
    assert not result["correct"]
    if not gate:
        assert result["checks"]["freq_bound"]["value"] > \
            result["checks"]["freq_bound"]["limit"]


@pytest.mark.parametrize("gate", [True, False])
@pytest.mark.parametrize("name", CELLS)
def test_half_of_the_block_left_out(name, gate, monkeypatch):
    from pcx_torch import bandstructure
    real = bandstructure.maxwell.ama_bb

    def half(x, *args, **kw):
        y = real(x, *args, **kw)
        if y.dim() >= 5 and y.shape[-5] > 1:
            y = y.clone()
            y[..., y.shape[-5] // 2:, :, :, :, :] = 0
        return y

    monkeypatch.setattr(bandstructure.maxwell, "ama_bb", half)
    result = _run(name, monkeypatch, gate)
    assert not result["correct"]
    if not gate:
        checks = result["checks"]
        assert any(checks[k]["value"] > checks[k]["limit"]
                   for k in ("omega_gap", "freq_bound"))


@pytest.mark.parametrize("name", CELLS)
def test_a_frequency_altered_where_it_is_produced(name, monkeypatch):
    from pcx_torch.bandstructure import KPointSolver
    real = KPointSolver.solve

    def altered(self, *args, **kw):
        r = real(self, *args, **kw)
        if r.omega_re is None:
            return r
        w = r.omega_re.copy()
        w[1] += 1e-4
        return dataclasses.replace(r, omega_re=w)

    monkeypatch.setattr(KPointSolver, "solve", altered)
    result = _run(name)
    assert not result["correct"]
    assert result["checks"]["omega_gap"]["value"] > \
        result["checks"]["omega_gap"]["limit"]
