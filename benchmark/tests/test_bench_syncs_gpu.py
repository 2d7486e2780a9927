"""Every wait of the host for the device in a solve of each cell goes through
the program's one sync helper (``lp_mp_tpu_torch.tracing.fetch``), so the
program's ``syncs`` counter, and ``syncs_per_solve``, miss none: one solve
of each cell's traffic at 300x300 under
``torch.cuda.set_sync_debug_mode("warn")``, whose every warning must come
from the helper's lines, one for each sync the counter counts."""
import inspect
import warnings
from pathlib import Path

import pytest
import torch

from benchmark import harness, trace

SIZES = {"potts_grid_1000.kernel": {"H": 300, "W": 300},
         "potts_grid_1000.uniform": {"H": 300, "W": 300},
         "potts_grid_1000.engine": {"H": 300, "W": 300}}


@pytest.mark.gpu
@pytest.mark.parametrize("workload", sorted(SIZES))
def test_every_sync_of_a_solve_is_the_helper_s(workload, cuda):
    from lp_mp_tpu_torch import tracing
    cs = harness.cell_spec(harness.load_spec(), workload)
    cs["config"].update(SIZES[workload])
    if "pool" in cs["traffic"]:
        cs["traffic"]["pool"] = 2
    else:
        cs["traffic"]["schedule_mode"] = "coloring"
    ctx = harness.Ctx(cs["config"], cs["traffic"], 2**31 + 5, cuda, trace.Spans(False, cuda),
                      harness.load_module("generators", cs["config"]["generator"]))
    runner = harness.load_module("drivers", cs["traffic"]["driver"]).Runner(ctx)
    ctx.sync()
    lines, first = inspect.getsourcelines(tracing._to_host)
    helper = range(first, first + len(lines))
    before = tracing.counters()["syncs"]
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            s = runner.solve(0)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = [w for w in caught if "synchronizing CUDA operation" in str(w.message)]
    here = Path(tracing.__file__).resolve()
    stray = [(w.filename, w.lineno) for w in syncs
             if not (Path(w.filename).resolve() == here and w.lineno in helper)]
    assert s.ok and not stray, stray
    assert len(syncs) == tracing.counters()["syncs"] - before > 0
