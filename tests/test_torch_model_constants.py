"""The JAX package's values that ``chip_smoke.py`` holds the card's graph
matching, tomography, tree, exact-oracle and command-line runs against
(``JAX_TOMO10X32``, ``JAX_QAP16``, ``JAX_TREES``, ``JAX_TREE_SOLVER``,
``JAX_ORACLES``, ``JAX_CLI``) and the grid rounding (``JAX_ROUND``),
recomputed from the JAX package on the CPU in float32.

Each case runs in a subprocess of its own: float32 without
``jax_enable_x64`` (which this suite's conftest turns on), no persistent
compilation cache, and the instances built by ``chip_smoke.py``'s own
``tomography_chains`` and ``qap_input`` (bench.py's solver_e2e
``tomography_10x32``, seed 10, and ``qap_16x16``, seed 9), through
``Solver(StandardVisitor(max_iter=MODEL_ITERS), schedule_mode="auto",
pass_style="auto")``.  The oracles: ``mrf_grid24`` (``chip_smoke``'s
``mrf_grid24_instance``, untightened) after ``Solver(StandardVisitor(
max_iter=ORACLE_ITERS))``, its local polytope's size, LP value and ILP
value.  The command line: ``cli.main`` of the JAX package on the text files
``chip_smoke.cli_inputs`` writes, the lower bounds it prints (the mrf run
in the oracles' subprocess; the gm run, which is qap_16x16's Solver run
through text and takes about 20 s, marked ``slow``).
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
from lp_mp_tpu.models.mrf import MrfConstructor
from lp_mp_tpu.models.tomography import DiscreteTomographyConstructor
from lp_mp_tpu.trees import ChainDecomposition
from lp_mp_tpu.trees_general import TreeSpec
import chip_smoke as cs
config.set_dtype("float32")
s = Solver(visitor=StandardVisitor(max_iter=cs.MODEL_ITERS), schedule_mode="auto",
           pass_style="auto")
out = {}
if sys.argv[1] == "grid_round":
    import numpy as np
    from lp_mp_tpu.models.grid_potts import GridPottsModel, random_grid
    h, w, labels, seed = cs.ROUND_GRID
    m = GridPottsModel(*random_grid(h, w, labels, seed=seed), dtype=np.float32)
    x, ub = m.run_fast(cs.ROUND_ITERS, mode="damped_uniform", kernel="xla").round_primal(
        "damped_uniform")
    print(json.dumps({"digest": cs.labels_digest(x), "ub": ub}))
    sys.exit(0)
if sys.argv[1] in ("chains", "chains_fw", "tree_solver"):
    un, pairs, pw = cs.mrf_304_instance()
    mrf = s.add_constructor(MrfConstructor, pairwise_rep="dense")
    mrf.add_unary_factors(un)
    mrf.add_pairwise_factors(pairs, pw)
    dec = ChainDecomposition.from_mrf(mrf)
    if sys.argv[1] == "chains":
        T, V, _ = dec.unary.shape
        out.update(T=int(T), V=int(V), digest=cs.chains_digest(dec.chains),
                   sg=float(dec.subgradient_ascent(n_iter=50)[0]))
    elif sys.argv[1] == "chains_fw":
        out["fw"] = float(dec.fw_map(n_outer=5, n_inner=10)[0])
    else:
        t = Solver(visitor=StandardVisitor(max_iter=cs.TREE_SOLVER_ITERS), schedule_mode="auto",
                   tree_decomposition_begin=cs.TREE_SOLVER_BEGIN, tree_layout="zero_sum")
        m2 = t.add_constructor(MrfConstructor, pairwise_rep="dense")
        m2.add_unary_factors(un)
        m2.add_pairwise_factors(pairs, pw)
        t.tree_decomposition = [TreeSpec(m) for m in cs.chain_tree_messages(t.graph, m2, dec.chains)]
        out["lb"] = float(t.solve())
    print(json.dumps(out))
    sys.exit(0)
if sys.argv[1] == "oracles":
    from lp_mp_tpu.io.ilp import ilp_round
    from lp_mp_tpu.io.lp_export import build_local_polytope, solve_lp_relaxation
    un, pairs, pw = cs.mrf_grid24_instance()
    o = Solver(visitor=StandardVisitor(max_iter=cs.ORACLE_ITERS))
    mrf = o.add_constructor(MrfConstructor)
    mrf.add_unary_factors(un)
    mrf.add_pairwise_factors(pairs, pw)
    o.solve()
    c, rows, _, _ = build_local_polytope(o.engine)
    out.update(n_vars=len(c), n_rows=len(rows), lp=solve_lp_relaxation(o.engine),
               ilp=float(ilp_round(o.engine, time_limit=cs.ORACLE_ILP_LIMIT)[1]))
if sys.argv[1] in ("oracles", "cli_gm"):
    import contextlib, io, tempfile
    from lp_mp_tpu.cli import main
    with tempfile.TemporaryDirectory() as d:
        files = cs.cli_inputs(d)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            if sys.argv[1] == "oracles":
                main(["mrf", files["mrf"], "--maxIter", str(cs.CLI_MRF_ITERS), "-v", "0"])
            else:
                main(["gm", files["gm"], "--construction", "left", "--maxIter",
                      str(cs.CLI_GM_ITERS), "-v", "0"])
    key = "mrf_lb" if sys.argv[1] == "oracles" else "gm_lb"
    out[key] = cs.printed_bounds(buf.getvalue())[0]
    print(json.dumps(out))
    sys.exit(0)
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
                       capture_output=True, text=True, timeout=600)
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


def test_chip_smoke_oracle_constants_are_the_jax_packages():
    """The oracles and the mrf command line, in one subprocess."""
    got = jax_float32("oracles")
    for k, v in chip_smoke.JAX_ORACLES.items():
        if isinstance(v, int):
            assert got[k] == v, (k, got[k], v)
        else:
            assert got[k] == pytest.approx(v, rel=REL), (k, got[k], v)
    assert got["mrf_lb"] == pytest.approx(chip_smoke.JAX_CLI["mrf_lb"], rel=REL)


@pytest.mark.slow
def test_chip_smoke_gm_cli_constant_is_the_jax_packages():
    assert jax_float32("cli_gm")["gm_lb"] == pytest.approx(chip_smoke.JAX_CLI["gm_lb"], rel=REL)


@pytest.mark.parametrize("case, want", [
    ("chains", {k: chip_smoke.JAX_TREES[k] for k in ("T", "V", "digest", "sg")}),
    pytest.param("chains_fw", {"fw": chip_smoke.JAX_TREES["fw"]}, marks=pytest.mark.slow),
    pytest.param("tree_solver", chip_smoke.JAX_TREE_SOLVER, marks=pytest.mark.slow)])
def test_chip_smoke_tree_constants_are_the_jax_packages(case, want):
    got = jax_float32(case)
    for k, v in want.items():
        if isinstance(v, float):
            assert got[k] == pytest.approx(v, rel=REL), (k, got[k], v)
        else:
            assert got[k] == v, (k, got[k], v)


def test_chip_smoke_round_constant_is_the_jax_packages():
    """``JAX_ROUND``, which the card's rounding kernels are held to
    (``chip_smoke``'s main path, tests/test_torch_grid_cuda.py), is the JAX
    package's float32 rounding; the port's plain rounding on the CPU gives
    the same labels and the cost within ``ROUND_UB_RTOL``."""
    got = jax_float32("grid_round")
    assert got["digest"] == chip_smoke.JAX_ROUND["digest"]
    assert got["ub"] == pytest.approx(chip_smoke.JAX_ROUND["ub"], rel=REL)
    x, ub = chip_smoke.jax_round_case("cpu")
    assert chip_smoke.labels_digest(x) == chip_smoke.JAX_ROUND["digest"]
    assert ub == pytest.approx(chip_smoke.JAX_ROUND["ub"], rel=chip_smoke.ROUND_UB_RTOL)
