"""The port's LP export (lp_mp_tpu_torch.io.lp_export) and the LP hooks of
every factor and message type, against the JAX package's, on the CPU in
float64.

- Parity: for every model family (MRF with dense and with Potts pairwise
  factors and mixed label counts, MRF with a ternary tightening factor,
  multicut with triplets, a K4 wheel and a 5-wheel, graph matching with
  equality messages, tomography with counting chains of two lengths, one
  with +inf projection costs, and a graph of vector-equality messages) the
  port's engine runs a few passes, its state is carried into a JAX engine
  over the same graph, and the two local polytopes are equal (cost vector,
  rows, rhs and offsets), the CPLEX text is byte-equal and the LP values
  lie within 1e-9.
- The 4 tests (6 cases) of tests/test_lp_export.py and the 8 cases of
  tests/test_lp_all_types.py, on the port.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest

from lp_mp_tpu import Solver as JSolver
from lp_mp_tpu import StandardVisitor as JVisitor
from lp_mp_tpu.factors.simplex import UNARY_SIMPLEX as J_UNARY
from lp_mp_tpu.io import lp_export as jlp
from lp_mp_tpu.io.torresani import GraphMatchingInput as JGMInput
from lp_mp_tpu.messages.vector_equality import VECTOR_EQUALITY as J_VEQ
from lp_mp_tpu.models.graph_matching import GraphMatchingConstructor as JGM
from lp_mp_tpu.models.mrf import MrfConstructor as JMrf
from lp_mp_tpu.models.multicut import MulticutConstructor as JMc
from lp_mp_tpu.models.tomography import DiscreteTomographyConstructor as JTomo
from lp_mp_tpu_torch import (VECTOR_EQUALITY, DiscreteTomographyConstructor,
                             GraphMatchingConstructor, GraphMatchingInput, MrfConstructor,
                             MulticutConstructor, Solver, StandardVisitor, combi_lp,
                             engine_state_to_numpy, export_lp_text, ilp_round,
                             solve_lp_relaxation)
from lp_mp_tpu_torch.factors.simplex import UNARY_SIMPLEX
from lp_mp_tpu_torch.io import lp_export as plp

LP_TOL = 1e-9


class Pkg:
    """One package's entry points under common names (the JAX side eager:
    it runs no pass here, it only holds a carried state)."""

    def __init__(self, jax: bool):
        if jax:
            self.Solver = lambda **kw: JSolver(use_jit=False, pass_style="unrolled", **kw)
            self.Visitor, self.Mrf, self.Mc, self.GM = JVisitor, JMrf, JMc, JGM
            self.GMInput, self.Tomo, self.UNARY, self.VEQ = JGMInput, JTomo, J_UNARY, J_VEQ
        else:
            self.Solver = lambda **kw: Solver(device="cpu", **kw)
            self.Visitor, self.Mrf, self.Mc = StandardVisitor, MrfConstructor, MulticutConstructor
            self.GM, self.GMInput, self.Tomo = (GraphMatchingConstructor, GraphMatchingInput,
                                                DiscreteTomographyConstructor)
            self.UNARY, self.VEQ = UNARY_SIMPLEX, VECTOR_EQUALITY


JAX, PORT = Pkg(True), Pkg(False)


# ---------------------------------------------------------------------------
# model families, as recipes run on either package: pkg -> Solver with a graph
# ---------------------------------------------------------------------------
def mrf_dense(pkg, seed=0, n=5):
    rng = np.random.default_rng(seed)
    s = pkg.Solver(visitor=pkg.Visitor(max_iter=10))
    mrf = s.add_constructor(pkg.Mrf, pairwise_rep="dense")
    Ls = rng.integers(2, 5, size=n)
    for i in range(n):
        mrf.add_unary_factor(rng.normal(size=Ls[i]))
    for i, j in [(0, 1), (1, 2), (2, 3), (3, 4), (0, 4), (1, 3)]:
        mrf.add_pairwise_factor(i, j, rng.normal(size=(Ls[i], Ls[j])))
    return s


def mrf_potts(pkg, seed=1):
    """Potts factors of two label counts in one block (padded lanes)."""
    rng = np.random.default_rng(seed)
    s = pkg.Solver(visitor=pkg.Visitor(max_iter=10))
    mrf = s.add_constructor(pkg.Mrf, pairwise_rep="potts")
    Ls = [3, 3, 3, 2, 2]
    for L in Ls:
        mrf.add_unary_factor(rng.normal(size=L))
    for i, j in [(0, 1), (1, 2), (0, 2), (3, 4)]:
        mrf.add_pairwise_factor(i, j, rng.normal() * (1.0 - np.eye(Ls[i])))
    return s


def mrf_ternary(pkg, seed=2):
    s = mrf_dense(pkg, seed=seed)
    s.constructors[0].add_tightening_triplet(1, 2, 3)
    return s


def multicut_wheels(pkg, seed=3, n=6):
    rng = np.random.default_rng(seed)
    s = pkg.Solver(visitor=pkg.Visitor(max_iter=8))
    mc = s.add_constructor(pkg.Mc)
    for i in range(n):
        for j in range(i + 1, n):
            mc.add_edge(i, j, float(rng.normal()))
    mc.add_triplet(0, 1, 2)
    mc.add_triplet(2, 3, 4)
    mc.add_odd_3_wheel(0, 1, 2, 3)
    mc.add_odd_wheel_k(0, (1, 2, 3, 4, 5))
    return s


def graph_matching(pkg, seed=4, n=3):
    rng = np.random.default_rng(seed)
    assignments = [(i, j, float(rng.normal())) for i in range(n) for j in range(n)]
    s = pkg.Solver(visitor=pkg.Visitor(max_iter=10))
    gm = s.add_constructor(pkg.GM, construction="both")
    gm.construct(pkg.GMInput(n, n, assignments, [(0, 4, 0.3), (1, 5, -0.2)]))
    return s


def tomography(pkg, seed=5, inf_costs=False):
    """Two projections of 5 and 3 pixels, added one after the other so
    that they share one built chain block: the short chain's padded
    variables hold [0, +inf, +inf] and its sums past 6 hold +inf.  With
    ``inf_costs`` every sum but a few is forbidden by a +inf cost."""
    rng = np.random.default_rng(seed)
    s = pkg.Solver(visitor=pkg.Visitor(max_iter=8))
    dt = s.add_constructor(pkg.Tomo)
    L = 3
    v = 0
    rays = []
    for nv in (5, 3):
        first = v
        for q in range(nv):
            dt.add_unary_factor(rng.normal(size=L))
            if q:
                dt.add_pairwise_factor(v - 1, v, rng.normal(size=(L, L)) * 0.5)
            v += 1
        pc = 0.7 * np.abs(np.arange((L - 1) * nv + 1) - 3.0)
        if inf_costs:
            pc[np.abs(np.arange(len(pc)) - 3) > 1] = np.inf
        rays.append((range(first, v), pc))
    for ray, pc in rays:
        dt.add_projection(ray, pc)
    return s


def vector_equality(pkg):
    """The seven unaries of tests/test_model.py, coupled by VECTOR_EQUALITY."""
    s = pkg.Solver(visitor=pkg.Visitor(max_iter=10))
    g = s.graph
    f1 = g.add_factor(pkg.UNARY, np.array([0.0, 1.0]))
    for first_pair in (False, True, True):
        f2 = g.add_factor(pkg.UNARY, np.array([1.0, 0.0]))
        f3 = g.add_factor(pkg.UNARY, np.array([0.0, 0.0]))
        g.add_message(pkg.VEQ, f1, f2)
        g.add_message(pkg.VEQ, f2 if first_pair else f1, f3)
    return s


FAMILIES = {"mrf_dense": mrf_dense, "mrf_potts": mrf_potts, "mrf_ternary": mrf_ternary,
            "multicut_wheels": multicut_wheels, "graph_matching": graph_matching,
            "tomography": tomography,
            "tomography_inf": lambda pkg: tomography(pkg, inf_costs=True),
            "vector_equality": vector_equality}


def carried_engines(recipe, passes=3):
    """(port engine after ``passes`` anisotropic passes, JAX engine over
    the same graph holding the port's state exactly)."""
    sp, sj = recipe(PORT), recipe(JAX)
    sp.build_engine()
    sj.build_engine()
    for _ in range(passes):
        sp.engine.compute_pass("anisotropic")
    st = engine_state_to_numpy(sp.engine.state)
    jst = sj.engine.state
    assert st.keys() == jst.keys()
    sj.engine.state = {n: {k: jnp.asarray(v, dtype=jst[n][k].dtype) for k, v in b.items()}
                       for n, b in st.items()}
    return sp.engine, sj.engine


@pytest.mark.parametrize("family", FAMILIES)
def test_local_polytope_equals_jax(family):
    pe, je = carried_engines(FAMILIES[family])
    pc, prows, pb, poff = plp.build_local_polytope(pe)
    jc, jrows, jb, joff = jlp.build_local_polytope(je)
    assert pc.dtype == np.float64
    np.testing.assert_array_equal(pc, jc)
    assert prows == jrows
    assert pb == jb
    assert poff == joff
    assert plp.export_lp_text(pe) == jlp.export_lp_text(je)
    if np.isfinite(pc).all():
        lp = plp.solve_lp_relaxation(pe)
        assert abs(lp - jlp.solve_lp_relaxation(je)) <= LP_TOL
    else:
        # the counting chain's +inf sums reach the LP as they do in JAX:
        # HiGHS refuses a non-finite objective in both packages alike
        assert family == "tomography_inf" and np.isinf(pc).any()
        with pytest.raises(ValueError) as pe_err:
            plp.solve_lp_relaxation(pe)
        with pytest.raises(ValueError) as je_err:
            jlp.solve_lp_relaxation(je)
        assert str(pe_err.value) == str(je_err.value)


def test_lp_file_equals_text(tmp_path):
    pe, _ = carried_engines(mrf_potts)
    path = tmp_path / "m.lp"
    plp.export_lp_file(pe, str(path))
    assert path.read_text() == export_lp_text(pe)


# ---------------------------------------------------------------------------
# tests/test_lp_export.py on the port
# ---------------------------------------------------------------------------
def _random_mrf(seed, n=4, L=3, rep="dense"):
    rng = np.random.default_rng(seed)
    s = Solver(visitor=StandardVisitor(max_iter=30), device="cpu")
    mrf = s.add_constructor(MrfConstructor, pairwise_rep=rep)
    for _ in range(n):
        mrf.add_unary_factor(rng.normal(size=L))
    for i in range(n - 1):
        mrf.add_pairwise_factor(i, i + 1, rng.normal(size=(L, L)))
    mrf.add_pairwise_factor(0, n - 1, rng.normal(size=(L, L)))
    return s, mrf


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lp_value_bounds_dbca(seed):
    """DBCA bound <= LP relaxation value; LP value is invariant under the
    zero-sum reparametrization."""
    s, mrf = _random_mrf(seed)
    s.build_engine()
    lp_before = solve_lp_relaxation(s.engine)
    lb = s.solve()
    lp_after = solve_lp_relaxation(s.engine)
    assert lp_before == pytest.approx(lp_after, abs=1e-6)
    assert lb <= lp_after + 1e-6
    # message passing converges to the LP bound on these small instances
    assert lb == pytest.approx(lp_after, abs=1e-3)


def test_potts_lp_matches_dense():
    L = 3
    potts = 0.7 * (1.0 - np.eye(L))
    vals = {}
    for rep in ("dense", "potts"):
        s = Solver(visitor=StandardVisitor(max_iter=1), device="cpu")
        mrf = s.add_constructor(MrfConstructor, pairwise_rep=rep)
        rng2 = np.random.default_rng(7)
        for _ in range(3):
            mrf.add_unary_factor(rng2.normal(size=L))
        mrf.add_pairwise_factor(0, 1, potts)
        mrf.add_pairwise_factor(1, 2, potts)
        s.build_engine()
        vals[rep] = solve_lp_relaxation(s.engine)
    assert vals["dense"] == pytest.approx(vals["potts"], abs=1e-9)


def test_frustrated_cycle_lp_and_tightened_lp():
    """LP bound 0 on the frustrated cycle; with a triplet factor the export
    includes the marginalization constraints and the LP becomes tight
    (test/graphical_model.cpp:232-246 semantics)."""
    eq = np.array([[0.0, 1.0], [1.0, 0.0]])
    ne = np.array([[1.0, 0.0], [0.0, 1.0]])
    s = Solver(visitor=StandardVisitor(max_iter=5), device="cpu")
    mrf = s.add_constructor(MrfConstructor, pairwise_rep="dense")
    for _ in range(3):
        mrf.add_unary_factor(np.zeros(2))
    mrf.add_pairwise_factor(0, 1, eq)
    mrf.add_pairwise_factor(1, 2, eq)
    mrf.add_pairwise_factor(0, 2, ne)
    s.build_engine()
    assert solve_lp_relaxation(s.engine) == pytest.approx(0.0, abs=1e-9)
    mrf.add_tightening_triplet(0, 1, 2)
    s.build_engine()
    assert solve_lp_relaxation(s.engine) == pytest.approx(1.0, abs=1e-9)


def test_export_text_format():
    s, mrf = _random_mrf(3, n=3, L=2)
    s.build_engine()
    txt = export_lp_text(s.engine)
    assert txt.startswith("Minimize")
    assert "Subject To" in txt and "Bounds" in txt and txt.endswith("End\n")
    # one simplex constraint per factor: 3 unaries + 3 pairwise
    n_simplex = sum(1 for line in txt.splitlines() if "= 1" in line)
    assert n_simplex == 6


# ---------------------------------------------------------------------------
# tests/test_lp_all_types.py on the port
# ---------------------------------------------------------------------------
def _multicut_instance(seed=0, n=6, with_wheel=True):
    rng = np.random.default_rng(seed)
    s = Solver(visitor=StandardVisitor(max_iter=8), device="cpu")
    mc = s.add_constructor(MulticutConstructor)
    costs = {}
    for i in range(n):
        for j in range(i + 1, n):
            c = float(rng.normal())
            mc.add_edge(i, j, c)
            costs[(i, j)] = c
    mc.add_triplet(0, 1, 2)
    mc.add_triplet(1, 2, 3)
    if with_wheel:
        mc.add_odd_3_wheel(0, 1, 2, 3)
    return s, mc, costs


def _multicut_brute(costs, n):
    best = np.inf
    for lab in itertools.product(range(n), repeat=n):
        v = sum(c for (i, j), c in costs.items() if lab[i] != lab[j])
        best = min(best, v)
    return best


@pytest.mark.parametrize("with_wheel", [False, True])
def test_multicut_ilp_round_bounds(with_wheel):
    """With partial triangulation the ILP optimizes the *decomposition*
    (a relaxation of multicut): its value lower-bounds the true optimum
    and upper-bounds the message-passing dual."""
    s, mc, costs = _multicut_instance(seed=3, with_wheel=with_wheel)
    s.build_engine()
    s.engine.compute_pass("anisotropic")
    prim, cost = ilp_round(s.engine)
    assert prim is not None
    opt = _multicut_brute(costs, 6)
    assert cost <= opt + 1e-6
    assert cost >= s.engine.lower_bound() - 1e-6
    assert s.engine.check_primal_consistency(prim)


def test_multicut_ilp_exact_on_complete_triangulation():
    """All C(5,3) triplets on K5: triangle consistency == partition
    consistency, so the ILP value IS the multicut optimum."""
    rng = np.random.default_rng(11)
    n = 5
    s = Solver(visitor=StandardVisitor(max_iter=5), device="cpu")
    mc = s.add_constructor(MulticutConstructor)
    costs = {}
    for i in range(n):
        for j in range(i + 1, n):
            c = float(rng.normal())
            mc.add_edge(i, j, c)
            costs[(i, j)] = c
    for tri in itertools.combinations(range(n), 3):
        mc.add_triplet(*tri)
    s.build_engine()
    s.engine.compute_pass("anisotropic")
    prim, cost = ilp_round(s.engine)
    assert cost == pytest.approx(_multicut_brute(costs, n), abs=1e-6)
    assert s.engine.check_primal_consistency(prim)


def test_multicut_lp_relaxation_bounds_engine():
    s, mc, _ = _multicut_instance(seed=5)
    s.build_engine()
    for _ in range(6):
        s.engine.compute_pass("anisotropic")
    lp = solve_lp_relaxation(s.engine)
    assert s.engine.lower_bound() <= lp + 1e-6
    text = export_lp_text(s.engine)
    assert text.startswith("Minimize") and "Subject To" in text


def test_multicut_combilp_certifies_optimum():
    """combiLP certifies a multicut optimum MP rounding need not reach: K5,
    complete triangulation, so the decomposition's integral optimum IS the
    multicut optimum."""
    rng = np.random.default_rng(7)
    n = 5
    s = Solver(visitor=StandardVisitor(max_iter=10), device="cpu")
    mc = s.add_constructor(MulticutConstructor)
    costs = {}
    for i in range(n):
        for j in range(i + 1, n):
            c = float(rng.normal())
            mc.add_edge(i, j, c)
            costs[(i, j)] = c
    for tri in itertools.combinations(range(n), 3):
        mc.add_triplet(*tri)
    lb = s.solve()
    prim, obj = combi_lp(s.engine)
    assert prim is not None
    assert obj == pytest.approx(_multicut_brute(costs, n), abs=1e-5)
    assert obj >= lb - 1e-6


def _tomography_chain(seed=0, nv=5, L=3):
    rng = np.random.default_rng(seed)
    s = Solver(visitor=StandardVisitor(max_iter=8), device="cpu")
    dt = s.add_constructor(DiscreteTomographyConstructor)
    un = rng.normal(size=(nv, L))
    pw = rng.normal(size=(nv - 1, L, L)) * 0.5
    for v in range(nv):
        dt.add_unary_factor(un[v])
        if v:
            dt.add_pairwise_factor(v - 1, v, pw[v - 1])
    smax = (L - 1) * nv
    pc = 0.7 * np.abs(np.arange(smax + 1) - 4.0)
    dt.add_projection(range(nv), pc)
    return s, dt, un, pw, pc


def _tomography_brute(un, pw, pc):
    nv, L = un.shape
    best = np.inf
    for x in itertools.product(range(L), repeat=nv):
        c = sum(un[v][x[v]] for v in range(nv))
        c += sum(pw[v][x[v], x[v + 1]] for v in range(nv - 1))
        c += pc[sum(x)]
        best = min(best, c)
    return best


def test_tomography_ilp_round_matches_brute_force():
    s, dt, un, pw, pc = _tomography_chain(seed=2)
    s.build_engine()
    s.engine.compute_pass("anisotropic")
    prim, cost = ilp_round(s.engine)
    assert prim is not None
    assert cost == pytest.approx(_tomography_brute(un, pw, pc), abs=1e-6)
    assert s.engine.check_primal_consistency(prim)


def test_tomography_lp_export_cross_check():
    """.lp export cross-checks a tomography chain: the LP relaxation with
    the arithmetic counting encoding lies between the engine bound and the
    ILP."""
    s, dt, un, pw, pc = _tomography_chain(seed=9)
    lb = s.solve()
    lp = solve_lp_relaxation(s.engine)
    _, ilp = ilp_round(s.engine)
    assert lb <= lp + 1e-6
    assert lp <= ilp + 1e-6
    text = export_lp_text(s.engine)
    assert "Subject To" in text


def test_graph_matching_ilp():
    """Equality-message (both-sides) graph matching through the ILP."""
    rng = np.random.default_rng(4)
    n = 3
    assignments = [(i, j, float(rng.normal()))
                   for i in range(n) for j in range(n)]
    inp = GraphMatchingInput(n, n, assignments, [])
    best = min(sum(assignments[i * n + p[i]][2] for i in range(n))
               for p in itertools.permutations(range(n)))
    # unmatched nodes cost 0, so also allow partial matchings in the oracle
    s = Solver(visitor=StandardVisitor(max_iter=10), device="cpu")
    gm = s.add_constructor(GraphMatchingConstructor, construction="both")
    gm.construct(inp)
    s.build_engine()
    s.engine.compute_pass("anisotropic")
    prim, cost = ilp_round(s.engine)
    assert prim is not None
    assert cost <= best + 1e-6          # partial matching may be cheaper
    assert s.engine.check_primal_consistency(prim)
