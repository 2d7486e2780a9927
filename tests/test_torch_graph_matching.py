"""Graph matching in the port against the JAX package, on the CPU in float64
(mirrors tests/test_graph_matching.py, tests/test_mincostflow.py and the
min-cost-flow and maxflow cases of tests/test_native.py).

- The Torresani parser, the reference instance and random instances in both
  constructions (``left``: FORBIDDEN pairwise entries; ``both``: right-side
  unaries and equality messages), each solved by both packages: equal
  bounds (1e-9 relative), primal costs (1e-12: the same labels summed in
  another order) and matchings.
- ``utils.mincostflow`` and ``utils.maxflow`` (copies on the port's
  ``native``): the reference instance, lower bounds, assignments against
  brute force and against the JAX package, native against the Python
  fallback.
- Every ``EqualityMessage`` function against the JAX one, exactly: the
  marginals, the restricted marginals, the repams with repeated rows,
  primal propagation and ``consistent``.
- ``qap_16x16`` of bench.py through ``Solver`` (fewer iterations: the JAX
  side runs eagerly): bounds within 1e-9 relative, ub within 1e-12, equal
  matching.
- A JAX engine's state over the ``both`` construction carried into the port
  (``convert.engine_state_from_numpy``): both go on alike, and round to the
  same primal.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lp_mp_tpu.messages.equality as jeq
from chip_smoke import qap_input
from lp_mp_tpu import Solver as JSolver, StandardVisitor as JVisitor, native as jnative
from lp_mp_tpu.engine import Engine as JEngine
from lp_mp_tpu.factors.simplex import UNARY_SIMPLEX as J_UNARY
from lp_mp_tpu.graph import FactorGraph as JGraph
from lp_mp_tpu.io.torresani import parse_torresani as j_parse
from lp_mp_tpu.models.graph_matching import GraphMatchingConstructor as JGM
from lp_mp_tpu.utils.maxflow import maxflow as j_maxflow
from lp_mp_tpu.utils.mincostflow import solve_assignment as j_solve_assignment
from lp_mp_tpu_torch import (Engine, FactorGraph, GraphMatchingConstructor, Solver,
                             StandardVisitor, engine_state_from_numpy, native)
from lp_mp_tpu_torch.convert import engine_state_to_numpy
from lp_mp_tpu_torch.factors.simplex import UNARY_SIMPLEX
from lp_mp_tpu_torch.io.torresani import parse_torresani
from lp_mp_tpu_torch.messages.equality import EQUALITY, condition_simplex
from lp_mp_tpu_torch.utils.maxflow import maxflow
from lp_mp_tpu_torch.utils.mincostflow import MinCostFlow, solve_assignment
from tests.test_graph_matching import TORRESANI_INPUT, brute_force
from tests.test_torch_engine import assert_trees_close, jax_numpy

LB_REL = 1e-9
# primal costs are the same labels summed in another order
UB_REL = 1e-12


def twin_solvers(inp_text_or_input, construction, max_iter, **kw):
    """(JAX Solver, its constructor), (port Solver, its constructor) over one
    instance; the JAX side runs eagerly."""
    out = []
    for S, V, GM, extra in ((JSolver, JVisitor, JGM, dict(use_jit=False, pass_style="unrolled")),
                            (Solver, StandardVisitor, GraphMatchingConstructor,
                             dict(device="cpu"))):
        s = S(visitor=V(max_iter=max_iter), **extra, **kw)
        gm = s.add_constructor(GM, construction=construction)
        gm.construct(inp_text_or_input)
        out.append((s, gm))
    return out


def assert_solvers_match(sj, gj, sp, gp):
    lb_j, lb_p = sj.lower_bound(), sp.lower_bound()
    assert abs(lb_j - lb_p) <= LB_REL * max(1.0, abs(lb_j)), (lb_j, lb_p)
    assert abs(sp.primal_cost() - sj.primal_cost()) <= UB_REL * max(1.0, abs(sj.primal_cost()))
    np.testing.assert_array_equal(gp.matching(sp.engine, sp.best_primal),
                                  gj.matching(sj.engine, sj.best_primal))


# ---------------------------------------------------------------------------
# tests/test_graph_matching.py
# ---------------------------------------------------------------------------
def test_parse():
    inp, jinp = parse_torresani(TORRESANI_INPUT), j_parse(TORRESANI_INPUT)
    assert (inp.n_left, inp.n_right) == (3, 2)
    assert len(inp.assignments) == 4
    assert inp.assignments[1] == (1, 0, -2.0)
    assert inp.edges == [(0, 2, -0.5), (1, 3, 0.5)]
    assert (inp.n_left, inp.n_right, inp.assignments, inp.edges) == \
        (jinp.n_left, jinp.n_right, jinp.assignments, jinp.edges)
    with pytest.raises(ValueError, match="unrecognized"):
        parse_torresani("p 1 1 1 0\nx 0 0")


@pytest.mark.parametrize("construction", ["left", "both"])
def test_reference_instance_solved(construction):
    inp = parse_torresani(TORRESANI_INPUT)
    opt = brute_force(inp)
    (sj, gj), (sp, gp) = twin_solvers(inp, construction, 20)
    lb = sp.solve()
    sj.solve()
    assert lb <= opt + 1e-6
    assert lb == pytest.approx(opt, abs=1e-4)  # instance is LP-tight
    assert_solvers_match(sj, gj, sp, gp)

    prim = gp.compute_primal(sp.engine)
    assert prim[UNARY_SIMPLEX.name]["x"].dtype == torch.int32
    cost = sp.engine.evaluate_primal(prim)
    assert cost == pytest.approx(opt, abs=1e-6)
    assert list(gp.matching(sp.engine, prim)) == [-1, 0, -1]


def random_instance(seed, n0=3, n1=3):
    """tests/test_graph_matching.py:78-100: full candidates, a few pairwise
    terms between assignments of distinct left nodes."""
    rng = np.random.default_rng(seed)
    lines = [f"p {n0} {n1} {n0 * n1} 0"]
    aid = 0
    aids = {}
    for i in range(n0):
        for j in range(n1):
            lines.append(f"a {aid} {i} {j} {float(rng.normal())}")
            aids[(i, j)] = aid
            aid += 1
    for _ in range(4):
        i1, i2 = rng.choice(n0, size=2, replace=False)
        j1, j2 = rng.integers(0, n1, size=2)
        if j1 == j2:
            continue
        lines.append(f"e {aids[(i1, j1)]} {aids[(i2, j2)]} {float(rng.normal() * 0.5)}")
    return parse_torresani("\n".join(lines))


@pytest.mark.parametrize("construction", ["left", "both"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_instances(construction, seed):
    inp = random_instance(seed)
    opt = brute_force(inp)
    (sj, gj), (sp, gp) = twin_solvers(inp, construction, 60)
    lb = sp.solve()
    sj.solve()
    assert lb <= opt + 1e-6  # dual bound is valid
    assert_solvers_match(sj, gj, sp, gp)

    prim = gp.compute_primal(sp.engine)
    cost = sp.engine.evaluate_primal(prim)
    assert np.isfinite(cost)
    assert cost >= opt - 1e-9  # feasible matching
    assert cost == pytest.approx(sj.engine.evaluate_primal(gj.compute_primal(sj.engine)),
                                 rel=UB_REL)


# ---------------------------------------------------------------------------
# tests/test_mincostflow.py and the mcf/maxflow cases of tests/test_native.py
# ---------------------------------------------------------------------------
MCF_REFERENCE = ([(0, 1, 4, 1), (0, 2, 8, 5), (1, 2, 5, 0), (2, 4, 10, 1), (3, 1, 8, 1),
                  (3, 5, 8, 1), (4, 3, 8, 0), (4, 5, 8, 9)], [4, 6, 4, 10, 0, 8, 8, 2])


def test_mcf_reference_instance():
    # test/min_cost_flow.cpp:7-31 — 6 nodes, 8 arcs, excess 10 at node 0.
    mcf = MinCostFlow(6)
    e = [mcf.add_edge(t, h, 0, u, c) for t, h, u, c in MCF_REFERENCE[0]]
    mcf.add_node_excess(0, 10)
    mcf.add_node_excess(5, -10)
    assert mcf.solve() == pytest.approx(70.0)
    assert [mcf.get_flow(i) for i in e] == pytest.approx(MCF_REFERENCE[1])


def test_mcf_lower_bounds():
    # force 2 units through a costly arc via lower bound
    mcf = MinCostFlow(3)
    mcf.add_edge(0, 1, 0, 5, 1)
    b = mcf.add_edge(0, 2, 2, 5, 10)
    mcf.add_edge(1, 2, 0, 5, 1)
    mcf.add_node_excess(0, 4)
    mcf.add_node_excess(2, -4)
    obj = mcf.solve()
    assert mcf.get_flow(b) >= 2
    assert obj == pytest.approx(2 * 10 + 2 * 2)


def assignment_instance(seed, n0, n1):
    rng = np.random.default_rng(seed)
    costs = rng.normal(size=(n0, n1))
    costs[rng.random((n0, n1)) < 0.25] = np.inf
    return costs, rng.normal(size=n0) * 0.1


def assignment_cost(costs, slack, m):
    return sum(costs[i, j] if j >= 0 else slack[i] for i, j in enumerate(m))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_assignment_vs_bruteforce_and_jax(seed):
    costs, slack = assignment_instance(seed, 4, 3)
    match = solve_assignment(costs, slack)
    np.testing.assert_array_equal(match, j_solve_assignment(costs, slack))
    used = [j for j in match if j >= 0]
    assert len(used) == len(set(used))
    best = np.inf
    for assign in itertools.product(*[list(range(3)) + [-1]] * 4):
        used = [j for j in assign if j >= 0]
        if len(used) == len(set(used)):
            best = min(best, assignment_cost(costs, slack, assign))
    assert assignment_cost(costs, slack, match) == pytest.approx(best)


@pytest.fixture(scope="module")
def lib():
    lib = native.get_lib()
    if lib is None:
        pytest.skip("native library unavailable (no g++?)")
    return lib


def test_native_mcf_reference_instance(lib):
    arcs = np.asarray(MCF_REFERENCE[0])
    obj, flows = native.mcf_solve(6, arcs[:, 0], arcs[:, 1], [0] * 8, arcs[:, 2], arcs[:, 3],
                                  [10, 0, 0, 0, 0, -10])
    assert obj == pytest.approx(70.0)
    np.testing.assert_allclose(flows, MCF_REFERENCE[1])
    with pytest.raises(RuntimeError):
        native.mcf_solve(2, [0], [1], [0.0], [1.0], [1.0], [5.0, -5.0])


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_native_assignment_matches_python(seed, lib, monkeypatch):
    costs, slack = assignment_instance(seed, 5, 4)
    m_native = solve_assignment(costs, slack)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    m_py = solve_assignment(costs, slack)
    assert assignment_cost(costs, slack, m_native) == \
        pytest.approx(assignment_cost(costs, slack, m_py))


def test_maxflow_native_vs_fallback_and_jax(lib, monkeypatch):
    rng = np.random.default_rng(1)
    n = 8
    edges = []
    for _ in range(20):
        u, v = rng.choice(n, size=2, replace=False)
        edges.append((int(u), int(v), float(rng.random() * 3), float(rng.random())))
    f1, side1 = maxflow(n, edges, 0, n - 1)
    fj, sidej = j_maxflow(n, edges, 0, n - 1)
    assert f1 == pytest.approx(fj)
    np.testing.assert_array_equal(side1, sidej)
    monkeypatch.setattr(native, "get_lib", lambda: None)
    monkeypatch.setattr(jnative, "get_lib", lambda: None)
    f2, side2 = maxflow(n, edges, 0, n - 1)
    assert f1 == pytest.approx(f2) == pytest.approx(j_maxflow(n, edges, 0, n - 1)[0])
    assert side1[0] and side2[0]
    assert not side1[n - 1] and not side2[n - 1]


# ---------------------------------------------------------------------------
# EqualityMessage, function by function (exact)
# ---------------------------------------------------------------------------
def equality_batch(seed, kind):
    """Unary blocks with 2..5 labels (padded lanes take part), built by both
    packages, and M messages whose left rows repeat (every candidate of a
    node is a message) with distinct (row, entry) pairs on each side."""
    rng = np.random.default_rng(seed)
    F = 6
    vecs = [rng.integers(-1, 2, size=int(n)).astype(np.float64) if kind == "ties"
            else rng.normal(size=int(n)) for n in rng.integers(2, 6, size=F)]
    nl = np.array([len(v) for v in vecs])
    pairs_l = [(f, k) for f in range(F) for k in range(nl[f])]
    pairs_r = list(pairs_l)
    rng.shuffle(pairs_r)
    M = 12
    sel_l = rng.choice(len(pairs_l), size=M, replace=False)
    sel_r = rng.choice(len(pairs_r), size=M, replace=False)
    lidx = np.array([pairs_l[s][0] for s in sel_l])
    ridx = np.array([pairs_r[s][0] for s in sel_r])
    data = [(pairs_l[a][1], pairs_r[b][1]) for a, b in zip(sel_l, sel_r)]
    jb, pb = J_UNARY.build(vecs), UNARY_SIMPLEX.build(vecs)
    jd, pd = jeq.EQUALITY.build(data), EQUALITY.build(data)
    np.testing.assert_array_equal(jd["li"], pd["li"])
    np.testing.assert_array_equal(jd["ri"], pd["ri"])
    assert pd["li"].dtype == np.int64
    return dict(
        jax=({k: jnp.asarray(v) for k, v in jb.items()}, {k: jnp.asarray(v) for k, v in jd.items()},
             jnp.asarray(lidx), jnp.asarray(ridx)),
        port=({k: torch.from_numpy(np.array(v)) for k, v in pb.items()},
              {k: torch.from_numpy(v) for k, v in pd.items()},
              torch.from_numpy(lidx), torch.from_numpy(ridx)),
        rng=rng, F=F, L=jb["c"].shape[1], M=M)


def gathered(block, idx):
    return {k: v[idx] for k, v in block.items()}


def exact(j, p):
    j, p = np.asarray(j), p.detach().cpu().numpy()
    assert j.shape == p.shape
    np.testing.assert_array_equal(p, j)


def twin_primal(rng, F, L):
    x = rng.integers(-1, L, size=F).astype(np.int32)
    return {"x": jnp.asarray(x)}, {"x": torch.from_numpy(x.copy())}


@pytest.mark.parametrize("kind", ["ties", "normal"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_equality_message_functions_match_jax(seed, kind):
    b = equality_batch(seed, kind)
    (jb, jd, jl, jr), (pb, pd, pl, pr) = b["jax"], b["port"]
    jm, pm = jeq.EQUALITY, EQUALITY
    exact(jm.marginal_left(gathered(jb, jl), jd), pm.marginal_left(gathered(pb, pl), pd))
    exact(jm.marginal_right(gathered(jb, jr), jd), pm.marginal_right(gathered(pb, pr), pd))

    jp, pp = twin_primal(b["rng"], b["F"], b["L"])
    exact(jm.restricted_marginal_left(gathered(jb, jl), gathered(jp, jl), jd),
          pm.restricted_marginal_left(gathered(pb, pl), gathered(pp, pl), pd))
    exact(jm.restricted_marginal_right(gathered(jb, jr), gathered(jp, jr), jd),
          pm.restricted_marginal_right(gathered(pb, pr), gathered(pp, pr), pd))
    exact(jeq.condition_simplex(jb["c"], jb["nl"], jp["x"]),
          condition_simplex(pb["c"], pb["nl"], pp["x"]))
    exact(jeq.condition_simplex(jb["c"], None, jp["x"]), condition_simplex(pb["c"], None, pp["x"]))

    delta = b["rng"].normal(size=b["M"])
    before = pb["c"].clone()
    for side, ji, pi in (("left", jl, pl), ("right", jr, pr)):
        jout = getattr(jm, f"repam_{side}")(jb, ji, jnp.asarray(delta), jd)
        pout = getattr(pm, f"repam_{side}")(pb, pi, torch.from_numpy(delta), pd)
        exact(jout["c"], pout["c"])
        assert torch.equal(pb["c"], before)          # out of place

    for _ in range(3):
        (jlp, plp), (jrp, prp) = twin_primal(b["rng"], b["F"], b["L"]), \
            twin_primal(b["rng"], b["F"], b["L"])
        exact(jm.consistent(jlp, jrp, jl, jr, jd), pm.consistent(plp, prp, pl, pr, pd))
        exact(jm.propagate_primal_l2r(jlp, jrp, jl, jr, jd)["x"],
              pm.propagate_primal_l2r(plp, prp, pl, pr, pd)["x"])
        exact(jm.propagate_primal_r2l(jlp, jrp, jl, jr, jd)["x"],
              pm.propagate_primal_r2l(plp, prp, pl, pr, pd)["x"])


# ---------------------------------------------------------------------------
# qap_16x16 through Solver, and a carried state
# ---------------------------------------------------------------------------
def test_qap_16x16_solver_matches_jax():
    (sj, gj), (sp, gp) = twin_solvers(qap_input(16, 600, seed=9), "left", 10,
                                      schedule_mode="auto")
    sj.solve()
    sp.solve()
    assert sp.engine.schedule_mode == sj.engine.schedule_mode == "wavefront"
    assert_solvers_match(sj, gj, sp, gp)
    assert np.isfinite(sp.primal_cost()) and sp.primal_cost() >= sp.lower_bound()


def test_equality_state_carried_from_jax():
    """The ``both`` construction (equality messages between left and right
    unaries): a JAX engine's state after 3 passes, carried into the port;
    3 more passes on each; equal bounds, states and rounded primals."""
    inp = qap_input(6, 40, seed=3)
    gj_graph, gp_graph = JGraph(), FactorGraph()
    gj, gp = JGM(gj_graph, construction="both"), GraphMatchingConstructor(gp_graph, "both")
    gj.construct(inp)
    gp.construct(inp)
    je = JEngine(gj_graph, use_jit=False, pass_style="unrolled")
    pe = Engine(gp_graph, device="cpu")
    assert "equality" in pe.msgs
    np.testing.assert_array_equal(pe.msgs["equality"].data["li"].numpy(),
                                  np.asarray(je.msgs["equality"].data["li"]))
    for _ in range(3):
        je.compute_pass("anisotropic")
    pe.set_state(engine_state_from_numpy(jax_numpy(je.state)))
    for _ in range(3):
        je.compute_pass("anisotropic")
        pe.compute_pass("anisotropic")
    assert abs(je.lower_bound() - pe.lower_bound()) <= LB_REL * abs(je.lower_bound())
    assert_trees_close(jax_numpy(je.state), engine_state_to_numpy(pe.state))
    pj, pp = gj.compute_primal(je), gp.compute_primal(pe)
    assert_trees_close(jax_numpy(pj), engine_state_to_numpy(pp))
    assert pe.evaluate_primal(pp) == pytest.approx(je.evaluate_primal(pj), rel=UB_REL)
    np.testing.assert_array_equal(gp.matching(pe, pp), gj.matching(je, pj))
