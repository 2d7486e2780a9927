"""The JAX package's values that ``chip_smoke.py`` holds the card's graph
matching and tomography runs against (``JAX_TOMO10X32``, ``JAX_QAP16``),
recomputed from the JAX package on the CPU in float32.

Each case runs in a subprocess of its own: float32 without
``jax_enable_x64`` (which this suite's conftest turns on), no persistent
compilation cache, and the instances built by ``chip_smoke.py``'s own
``tomography_chains`` and ``qap_input`` (bench.py's solver_e2e
``tomography_10x32``, seed 10, and ``qap_16x16``, seed 9), through
``Solver(StandardVisitor(max_iter=MODEL_ITERS), schedule_mode="auto",
pass_style="auto")``.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import chip_smoke

ROOT = Path(__file__).resolve().parents[1]
REL = 1e-6

SCRIPT = """
import json, sys
from lp_mp_tpu import Solver, StandardVisitor, config
from lp_mp_tpu.models.graph_matching import GraphMatchingConstructor
from lp_mp_tpu.models.tomography import DiscreteTomographyConstructor
import chip_smoke as cs
config.set_dtype("float32")
s = Solver(visitor=StandardVisitor(max_iter=cs.MODEL_ITERS), schedule_mode="auto",
           pass_style="auto")
out = {}
if sys.argv[1] == "tomography_10x32":
    cs.tomography_chains(s.add_constructor(DiscreteTomographyConstructor), 10, 32, 3, seed=10)
    s.solve()
else:
    gm = s.add_constructor(GraphMatchingConstructor, construction="left")
    gm.construct(cs.qap_input(16, 600, seed=9))
    s.solve()
    out["matching"] = gm.matching(s.engine, s.best_primal).tolist()
lb, ub = float(s.lower_bound()), float(s.primal_cost())
out.update(lb=lb, ub=ub, rel_gap=(ub - lb) / max(1.0, abs(ub)),
           schedule_mode=s.engine.schedule_mode)
print(json.dumps(out))
"""


def jax_float32(case: str) -> dict:
    env = {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH", "JAX_ENABLE_X64")}
    env.update(JAX_PLATFORMS="cpu", LP_MP_TPU_NO_CACHE="1", PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", SCRIPT, case], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("case, want", [("tomography_10x32", chip_smoke.JAX_TOMO10X32),
                                        ("qap_16x16", chip_smoke.JAX_QAP16)])
def test_chip_smoke_constants_are_the_jax_packages(case, want):
    got = jax_float32(case)
    assert got["schedule_mode"] == want["schedule_mode"]
    for k in ("lb", "ub"):
        assert got[k] == pytest.approx(want[k], rel=REL), (k, got[k], want[k])
    if "rel_gap" in want:
        assert got["rel_gap"] == pytest.approx(want["rel_gap"], abs=REL)
        assert got["matching"] == want["matching"]
