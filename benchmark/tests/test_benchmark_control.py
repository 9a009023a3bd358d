"""The control of the comparison: the reference at TF32, put in the
program's place, comes out not correct where the program comes out
correct, on the cells' configurations at a tiny grid."""

import pytest
import torch

from benchmark import harness, traffic
from benchmark.reference import control
from conftest import small_cell


def test_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 2 ** -10, 3.0], dtype=torch.float32)
    assert control.tf32(x).tolist() == [1.0 + 2 ** -10, 1.0 + 2 ** -10, 3.0]
    z = torch.complex(x, -x)
    assert torch.equal(control.tf32(z), torch.complex(control.tf32(x),
                                                      control.tf32(-x)))


@pytest.mark.parametrize("name", ["fcc_chiral_n120.sweep",
                                  "sc_curv_crossdof_n120.cold"])
def test_control_fails_where_the_program_passes(name):
    c = small_cell(name, n=12)
    c = c._replace(mix={**c.mix, "check_per_pass": 99})
    prog = harness.Program(c, torch.device("cpu"))
    plan = traffic.plan(c.mix, c.config, 2 ** 31 + 5)
    entry = prog.warm(plan)
    keeper = harness.Keeper(0, None, None, torch.device("cpu"))
    records, _, _ = harness.window(prog, plan, entry, 0.0, False, keeper)
    program = harness.check(c, records, torch.device("cpu"))
    ctl = harness.check(c, records, torch.device("cpu"), use_control=True)
    assert harness.passed(program), program
    assert not harness.passed(ctl), ctl
    assert ctl["omega_gap"][0] > 3 * program["omega_gap"][0]
