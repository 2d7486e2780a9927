"""The control on the card: the plain reference computed in bfloat16, put in
the program's place, must come out not correct under each cell's committed
limits, while the program's own run at the same size is correct.  At sizes a
test run holds; the cells' own sizes are read by ``benchmark/control.py``."""
import pytest
import torch

from benchmark import harness

SIZES = {"potts_grid_1000.kernel": {"H": 300, "W": 300},
         "potts_grid_1000.uniform": {"H": 300, "W": 300},
         "potts_grid_1000.engine": {"H": 300, "W": 300}}


@pytest.mark.gpu
@pytest.mark.parametrize("workload", sorted(SIZES))
def test_the_control_fails_and_the_program_passes(workload, cuda):
    cs = harness.cell_spec(harness.load_spec(), workload)
    cs["config"].update(SIZES[workload])
    if "pool" in cs["traffic"]:
        cs["traffic"]["pool"] = 2
    else:
        cs["traffic"]["schedule_mode"] = "coloring"
    limits = cs["traffic"]["limits"]
    rec = harness.measure(cs, 2**31 + 101, 2.0, False, cuda, log=lambda m: None,
                          keep_answers=True)
    good, checks = harness.verdict(rec, limits)
    assert good, checks
    control = rec["runner"].judge(rec["sample"], torch.bfloat16)
    bad, checks = harness.verdict(dict(rec, checks=control), limits)
    assert not bad, checks
