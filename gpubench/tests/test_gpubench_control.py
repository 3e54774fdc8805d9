"""The precision control, kept at a size a test run holds: the reference
with float8 convolutions in the port's place fails the cell's limits,
where the port in the configuration's bfloat16 passes them (the CPU, a
tiny size). On the card, at the cells' own sizes:
``python3 gpubench/readings.py --workload <cell> --seeds ... --control 3``.
"""

import pytest

from gpubench import check, harness
from gpubench.tests.tiny import tiny_cell


@pytest.mark.parametrize("name", ["accuracy.stream", "speed.stream"])
def test_control_fails(name):
    cell = tiny_cell(name)
    run = harness.build(cell, 2 ** 31 + 4242, "cpu")
    harness.run_window(run, 0.0, limit_units=4)
    final = run.pipe._exit_rows(run.layout, run.stream.rv)
    port_ok, port_checks = harness.judge(check.compare_run(run, final),
                                         cell.limits)
    assert port_ok, port_checks
    ctrl_ok, ctrl_checks = harness.judge(check.control(run), cell.limits)
    assert not ctrl_ok, ctrl_checks
