"""The port's command line (lp_mp_tpu_torch.cli, ``python -m
lp_mp_tpu_torch``) and its sqlite and JSONL visitors, on the CPU
(``--device cpu``) in float64: the 5 tests of tests/test_cli_and_db.py,
with the lower and upper bounds the port's ``main`` prints held within
1e-9 of the JAX ``main``'s on the same files, the database rows under the
port's solver name beside the JAX package's in one file, and one run of
``python -m lp_mp_tpu_torch mrf ... --device cpu`` in a subprocess.
"""
import json
import os
import sqlite3
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from lp_mp_tpu.cli import main as jax_main
from lp_mp_tpu_torch.cli import main

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-9

UAI_CHAIN = """MARKOV
3
2 2 3
5
1 0
1 1
1 2
2 0 1
2 1 2

2
 0.436 0.564

2
 0.128 0.872

3
 0.920 0.080 0.222

4
 1e10 0.872
 0.920 0.080

6
 1e10 0.333 0.457
 0.811 0.000 0.189
"""


def bounds(out: str) -> tuple:
    lines = out.splitlines()
    lb = float([line for line in lines if line.startswith("lower")][0].split(":")[1])
    ub = float([line for line in lines if line.startswith("upper")][0].split(":")[1])
    return lb, ub


def both(argv, capsys) -> tuple:
    """(port's (lb, ub), JAX package's (lb, ub)) of one command line."""
    assert main(argv + ["--device", "cpu"]) == 0
    port = bounds(capsys.readouterr().out)
    assert jax_main(argv) == 0
    jax = bounds(capsys.readouterr().out)
    return port, jax


def test_cli_mrf(tmp_path, capsys):
    inp = tmp_path / "chain.uai"
    inp.write_text(UAI_CHAIN)
    out = tmp_path / "primal.txt"
    rc = main(["mrf", str(inp), "--maxIter", "20", "-v", "0",
               "--outputFile", str(out), "--device", "cpu"])
    assert rc == 0
    cap = capsys.readouterr().out
    assert "lower bound:" in cap and "upper bound:" in cap
    lb, ub = bounds(cap)
    assert lb <= ub + 1e-9
    labels = [int(x) for x in out.read_text().split()]
    assert len(labels) == 3
    (plb, pub), (jlb, jub) = both(["mrf", str(inp), "--maxIter", "20", "-v", "0"], capsys)
    assert abs(plb - jlb) <= TOL and abs(pub - jub) <= TOL and plb == lb


def test_cli_gm(tmp_path, capsys):
    inp = tmp_path / "inst.tkr"
    inp.write_text("p 2 2 4 1\na 0 0 0 1.0\na 1 0 1 -1.0\n"
                   "a 2 1 0 -2.0\na 3 1 1 3.0\ne 1 2 -0.5\n")
    (plb, pub), (jlb, jub) = both(["gm", str(inp), "--maxIter", "20", "-v", "0",
                                   "--construction", "both"], capsys)
    assert abs(plb - jlb) <= TOL and abs(pub - jub) <= TOL
    assert plb <= pub + 1e-9


def test_cli_multicut_with_sqlite(tmp_path, capsys):
    inp = tmp_path / "mc.txt"
    inp.write_text("# triangle\n0 1 -1.0\n1 2 1.0\n0 2 1.0\n")
    db = tmp_path / "bench.db"
    argv = ["multicut", str(inp), "--maxIter", "30", "-v", "0",
            "--tighten", "--tightenIteration", "3", "--tightenInterval", "5",
            "--databaseFile", str(db), "--datasetName", "tiny"]
    (plb, pub), (jlb, jub) = both(argv, capsys)
    assert abs(plb - jlb) <= TOL and abs(pub - jub) <= TOL
    conn = sqlite3.connect(db)
    try:
        names = dict(conn.execute("SELECT id, name FROM solvers").fetchall())
        assert sorted(names.values()) == ["lp_mp_tpu", "lp_mp_tpu_torch"]
        pid = [i for i, n in names.items() if n == "lp_mp_tpu_torch"][0]
        n = conn.execute("SELECT COUNT(*) FROM iterations WHERE solver_id=?", (pid,)).fetchone()[0]
        assert n >= 1
        row = conn.execute("SELECT lowerBound FROM iterations WHERE solver_id=? "
                           "ORDER BY iteration DESC LIMIT 1", (pid,)).fetchone()
    finally:
        conn.close()
    assert row[0] == pytest.approx(0.0, abs=1e-6)
    assert row[0] == pytest.approx(plb, abs=1e-12)


def test_jsonl_visitor(tmp_path):
    from lp_mp_tpu_torch import JsonlVisitor, MrfConstructor, Solver
    path = tmp_path / "metrics.jsonl"
    s = Solver(visitor=JsonlVisitor(max_iter=5, jsonl_path=str(path)), device="cpu")
    mrf = s.add_constructor(MrfConstructor)
    rng = np.random.default_rng(0)
    for _ in range(3):
        mrf.add_unary_factor(rng.normal(size=2))
    mrf.add_pairwise_factor(0, 1, rng.normal(size=(2, 2)))
    mrf.add_pairwise_factor(1, 2, rng.normal(size=(2, 2)))
    s.solve()
    s.visitor.close()
    recs = [json.loads(line) for line in path.read_text().splitlines()]
    assert len(recs) >= 1
    assert {"iteration", "time_ms", "lower_bound"} <= set(recs[0])


def test_memory_cap_terminates_cleanly():
    # --maxMemory enforcement (standard_visitor.hxx:156-162): a tiny cap
    # triggers one final rounding iteration and clean termination with the
    # best-so-far primal
    from lp_mp_tpu_torch import MrfConstructor, Solver, StandardVisitor
    from lp_mp_tpu_torch.visitors import _memory_used_mb

    assert _memory_used_mb() > 1.0  # RSS reader works on this platform
    s = Solver(visitor=StandardVisitor(max_iter=100000, max_memory_mb=1.0), device="cpu")
    mrf = s.add_constructor(MrfConstructor, pairwise_rep="dense")
    rng = np.random.default_rng(0)
    for _ in range(4):
        mrf.add_unary_factor(rng.normal(size=3))
    for i in range(3):
        mrf.add_pairwise_factor(i, i + 1, rng.normal(size=(3, 3)))
    lb = s.solve()
    assert s.visitor.cur_iter < 100  # terminated early, not by max_iter
    assert np.isfinite(lb)
    assert np.isfinite(s.primal_cost())  # final rounding iteration ran


def test_python_m_runs_main(tmp_path, capsys):
    inp = tmp_path / "chain.uai"
    inp.write_text(UAI_CHAIN)
    out = tmp_path / "primal.txt"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    r = subprocess.run([sys.executable, "-m", "lp_mp_tpu_torch", "mrf", str(inp), "--maxIter",
                        "20", "-v", "0", "--outputFile", str(out), "--device", "cpu"],
                       cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    lb, ub = bounds(r.stdout)
    assert lb <= ub + 1e-9
    assert len(out.read_text().split()) == 3
    assert main(["mrf", str(inp), "--maxIter", "20", "-v", "0", "--device", "cpu"]) == 0
    assert bounds(capsys.readouterr().out) == (lb, ub)
