"""Nothing the benchmark runs loads JAX or the JAX package."""
import subprocess
import sys
from pathlib import Path

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]


def test_the_rule_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "lp_mp_tpu_torch_like", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_like", object())
    before = harness.forbidden_loaded()
    assert "lp_mp_tpu_torch_like" not in before and "jaxtyping_like" not in before
    monkeypatch.setitem(sys.modules, "lp_mp_tpu.engine", object())
    assert "lp_mp_tpu.engine" in harness.forbidden_loaded()


SCRIPT = r"""
import json, sys, torch
sys.path.insert(0, sys.argv[1])
from benchmark import harness
spec = harness.load_spec()
for workload, mode in (("potts_grid_1000.kernel", None), ("potts_grid_1000.engine", "coloring")):
    cs = harness.cell_spec(spec, workload)
    cs["config"].update(H=8, W=9)
    cs["traffic"].update(pool=1) if "pool" in cs["traffic"] else None
    if mode:
        cs["traffic"]["schedule_mode"] = mode
    if "visitor" in cs["traffic"]:
        cs["traffic"]["visitor"]["max_iter"] = 30
    rec = harness.measure(cs, 3, 0.5, True, torch.device("cpu"), log=lambda m: None)
    assert rec["n_counted"] > 0, workload
print(json.dumps(harness.forbidden_loaded()))
"""


def test_a_run_of_every_driver_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", SCRIPT, str(ROOT)], capture_output=True,
                         text=True, timeout=600, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
