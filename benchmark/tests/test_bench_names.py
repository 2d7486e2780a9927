"""BENCHMARK.json against the contract's rules of form, and every name in it
found as a file: configurations, traffic, generators, drivers, readers."""
import json
import re
from pathlib import Path

import pytest

from benchmark import harness, window

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def names():
    for c in SPEC["configs"]:
        yield c["name"]
        yield from c["reduced"]
    for w in SPEC["workloads"]:
        yield from (w["name"], w["config"], w["traffic"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        yield m["name"]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("name", sorted(set(names())))
def test_names_use_only_the_allowed_characters(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_fields(metric):
    assert UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
    if metric in SPEC["end_to_end"]:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
        assert set(metric) <= {"name", "unit", "better", "bound", "source", "workloads"}
    else:
        assert metric["source"] in ("device_trace", "program_span", "program_counter",
                                    "host_clock")
        assert TEXT.match(metric["layer"])
        assert metric["moves"] in {m["name"] for m in SPEC["end_to_end"]}
        assert callable(harness.reader(metric["name"]).read)
        assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves",
                               "workloads"}
    if "roofline" in metric["name"] or "mfu" in metric["name"]:
        assert metric["unit"] == "%"
    else:
        assert harness.quantity(metric["name"], (*window.QUANTITIES, "setup_s")) \
            or metric in SPEC["per_layer"]


def test_a_suffix_names_a_cell_s_own_bound_on_the_same_quantity():
    known = (*window.QUANTITIES, "setup_s")
    assert harness.quantity("solve_s.kernel", known) == "solve_s"
    assert harness.quantity("solve_s.p95", known) == "solve_s.p95"
    assert harness.quantity("solve_s.p95.kernel", known) == "solve_s.p95"
    assert harness.quantity("solve_sx", known) is None
    assert harness.reader("iters_per_solve.kernel") is harness.reader("iters_per_solve")
    with pytest.raises(FileNotFoundError):
        harness.reader("no_such_metric.kernel")


def test_a_cell_prints_its_own_names_for_the_window_s_quantities():
    rec = {"e2e": {"dual_iters_per_s": 10.0, "solve_s": 2.0, "final_rel_gap": 0.5},
           "setup_s": 3.0}
    out, missing = harness.select_metrics(
        harness.cell_spec(SPEC, "potts_grid_1000.kernel", ROOT), rec, False)
    assert out["dual_iters_per_s.kernel"]["value"] == 10.0 and out["setup_s"]["value"] == 3.0
    assert out["final_rel_gap"]["value"] == 0.5 and missing == ["solve_s.p95"]


def test_every_cell_reports_what_its_layers_move():
    for w in SPEC["workloads"]:
        cs = harness.cell_spec(SPEC, w["name"], ROOT)
        e2e = {m["name"] for m in cs["end_to_end"]}
        assert "setup_s" in e2e and len(e2e) >= 2 and cs["per_layer"]
        assert all(m["moves"] in e2e for m in cs["per_layer"]), w["name"]
        assert TEXT.match(w["why"]) and w["chips"] in (1, 4)
        assert (ROOT / "benchmark" / "generators" / f"{cs['config']['generator']}.py").is_file()
        assert (ROOT / "benchmark" / "drivers" / f"{cs['traffic']['driver']}.py").is_file()
        assert cs["traffic"]["limits"]


def test_configurations_and_paths():
    files = [c["file"] for c in SPEC["configs"]]
    assert len(set(files)) == len(files)
    for c in SPEC["configs"]:
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
        assert TEXT.match(c["source"]) and TEXT.match(c["why"]) and len(c["reduced"]) <= 16
        assert any(w["config"] == c["name"] for w in SPEC["workloads"])
    assert SPEC["paths"] == ["benchmark"] and SPEC["command"][1] == "benchmark/run.py"
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(set(pairs)) == len(pairs)
