"""The port's exact oracles (lp_mp_tpu_torch.io.ilp, lp_mp_tpu_torch.combilp)
and ``Solver(exact_rounding=...)``, against the JAX package's, on the CPU
in float64.

- Parity: on every model family of tests/test_torch_lp_export.py, with the
  port's state carried into a JAX engine, ``ilp_round``, a conditioned
  subset solve and ``combi_lp`` give the JAX package's labelling, and
  objectives within 1e-9.
- The content-keyed ``lp_fix`` cache: two labellings in one mutated dict;
  the port's second solve conditions on the second labelling, while the
  JAX package's identity-keyed cache reads the first one's rows.
- The 6 tests of tests/test_ilp_combilp.py and
  ``test_wheel_lp_export_and_exact_oracle`` of
  tests/test_odd_wheels_general.py, on the port.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lp_mp_tpu import combilp as jcombilp
from lp_mp_tpu.io import ilp as jilp
from lp_mp_tpu_torch import (Direction, Engine, MrfConstructor, MulticutConstructor, Solver,
                             StandardTighteningVisitor, StandardVisitor, combi_lp,
                             engine_state_to_numpy, ilp_round, solve_ilp, solve_lp_relaxation)
from lp_mp_tpu_torch.combilp import _fatten
from lp_mp_tpu_torch.io.ilp import IncrementalIlp
from lp_mp_tpu_torch.models.mrf import mrf_labeling
from tests.test_torch_lp_export import FAMILIES, JAX, PORT

OBJ_TOL = 1e-9
NEG_POTTS = np.array([[1.0, 0.0], [0.0, 1.0]])
POS_POTTS = np.array([[0.0, 1.0], [1.0, 0.0]])
# tomography_inf has a non-finite objective, which HiGHS refuses
ORACLE_FAMILIES = [f for f in FAMILIES if f != "tomography_inf"]


def jax_tree(host, like):
    """Host arrays as JAX arrays in the dtypes of ``like``'s blocks."""
    return {n: {k: jnp.asarray(v, dtype=like[n][k].dtype) for k, v in b.items()}
            for n, b in host.items()}


def jax_numpy(tree):
    return {n: {k: np.asarray(v) for k, v in b.items()} for n, b in tree.items()}


def carried_with_primal(recipe, passes=3):
    """Port engine after ``passes`` passes and one rounding pass, a rounded
    primal (the constructor's own rounding where it has one: GAEC for the
    multicut, whose message-passing rounding may cut one edge of a
    triangle, which no triplet configuration holds), and a JAX engine and
    primal holding the same values."""
    sp, sj = recipe(PORT), recipe(JAX)
    sp.build_engine()
    sj.build_engine()
    pe, je = sp.engine, sj.engine
    for _ in range(passes):
        pe.compute_pass("anisotropic")
    prim = pe.compute_pass_and_primal("damped_uniform", Direction.forward)
    ctors = [c for c in sp.constructors if hasattr(c, "compute_primal")]
    if ctors:
        prim = ctors[0].compute_primal(pe)
    je.state = jax_tree(engine_state_to_numpy(pe.state), je.state)
    jprim = jax_tree(engine_state_to_numpy(prim), je.init_primal())
    return pe, prim, je, jprim


def assert_same_primal(p, j):
    hp, hj = engine_state_to_numpy(p), jax_numpy(j)
    assert hp.keys() == hj.keys()
    for n in hp:
        assert hp[n].keys() == hj[n].keys()
        for k in hp[n]:
            np.testing.assert_array_equal(hp[n][k], hj[n][k], err_msg=f"{n}.{k}")


@pytest.mark.parametrize("family", ORACLE_FAMILIES)
def test_oracles_match_jax(family):
    pe, prim, je, jprim = carried_with_primal(FAMILIES[family])
    p, c = ilp_round(pe)
    jp, jc = jilp.ilp_round(je)
    assert p is not None and jp is not None
    assert abs(c - jc) <= OBJ_TOL
    assert_same_primal(p, jp)
    assert c <= pe.evaluate_primal(prim) + OBJ_TOL
    for k, v in p[next(iter(p))].items():
        assert v.dtype == prim[next(iter(p))][k].dtype

    mask = np.zeros(pe.n_factors, dtype=bool)
    mask[: pe.n_factors // 2] = True
    p, c = solve_ilp(pe, subset=mask, fixed_prim=prim)
    jp, jc = jilp.solve_ilp(je, subset=mask, fixed_prim=jprim)
    assert (p is None) == (jp is None)
    assert c == jc or abs(c - jc) <= OBJ_TOL
    if p is not None:
        assert_same_primal(p, jp)

    p, c = combi_lp(pe, prim=prim)
    jp, jc = jcombilp.combi_lp(je, prim=jprim)
    assert abs(c - jc) <= OBJ_TOL
    assert_same_primal(p, jp)


def attract_chain(device="cpu"):
    """x0 - x1 - x2, two labels, agreement costs 0, disagreement 5: the
    middle label follows a fixed border labelling."""
    s = Solver(visitor=StandardVisitor(max_iter=2), device=device)
    mrf = s.add_constructor(MrfConstructor, pairwise_rep="dense")
    for u in ([0.0, 0.1], [0.0, 0.0], [0.2, 0.0]):
        mrf.add_unary_factor(np.asarray(u))
    mrf.add_pairwise_factor(0, 1, 5.0 * (1.0 - np.eye(2)))
    mrf.add_pairwise_factor(1, 2, 5.0 * (1.0 - np.eye(2)))
    s.build_engine()
    return s


def test_fixed_cache_follows_content_not_identity():
    """One dict, two labellings of the border: the second solve must
    condition on the second (fresh solve: middle label 1, cost 0.1), not on
    cached rows of the first.  The JAX package's cache, keyed by
    ``id(fixed_prim)``, reads the stale rows: its middle label stays 0,
    its pairwise labels disagree with the new border, and its cost is
    +inf."""
    from lp_mp_tpu import Solver as JSolver
    from lp_mp_tpu.models.mrf import MrfConstructor as JMrf

    e = attract_chain().engine
    mask = np.array([False, True, False, True, True])        # x1 and both pairs inside
    fixed = e.init_primal()
    fixed["unary_simplex"]["x"] = torch.tensor([0, 0, 0], dtype=torch.int32)
    inc = IncrementalIlp(e)
    p1, c1 = inc.solve(subset=mask, fixed_prim=fixed)
    fixed["unary_simplex"]["x"] = torch.tensor([1, 1, 1], dtype=torch.int32)
    p2, c2 = inc.solve(subset=mask, fixed_prim=fixed)
    pf, cf = IncrementalIlp(e).solve(subset=mask, fixed_prim=fixed)
    assert c1 == pytest.approx(0.2, abs=1e-12)
    assert c2 == pytest.approx(0.1, abs=1e-12) and c2 == cf
    assert p2["unary_simplex"]["x"].tolist() == [1, 1, 1]
    assert p2["pairwise_simplex"]["x1"].tolist() == [1, 1]

    js = JSolver(visitor=None, use_jit=False, pass_style="unrolled")
    jm = js.add_constructor(JMrf, pairwise_rep="dense")
    for u in ([0.0, 0.1], [0.0, 0.0], [0.2, 0.0]):
        jm.add_unary_factor(np.asarray(u))
    jm.add_pairwise_factor(0, 1, 5.0 * (1.0 - np.eye(2)))
    jm.add_pairwise_factor(1, 2, 5.0 * (1.0 - np.eye(2)))
    js.build_engine()
    jfixed = js.engine.init_primal()
    jfixed["unary_simplex"]["x"] = jnp.asarray([0, 0, 0], dtype=jnp.int32)
    jinc = jilp.IncrementalIlp(js.engine)
    _, jc1 = jinc.solve(subset=mask, fixed_prim=jfixed)
    jfixed["unary_simplex"]["x"] = jnp.asarray([1, 1, 1], dtype=jnp.int32)
    jp2, jc2 = jinc.solve(subset=mask, fixed_prim=jfixed)
    assert jc1 == pytest.approx(c1, abs=1e-12)
    assert np.asarray(jp2["unary_simplex"]["x"]).tolist() == [1, 0, 1]
    assert jc2 == np.inf


# ---------------------------------------------------------------------------
# tests/test_ilp_combilp.py on the port
# ---------------------------------------------------------------------------
def _random_mrf(mrf, n_vars=6, n_labels=3, seed=0, p_edge=0.6):
    rng = np.random.default_rng(seed)
    unaries, edges = [], {}
    for _ in range(n_vars):
        u = rng.normal(size=n_labels)
        unaries.append(u)
        mrf.add_unary_factor(u)
    for i in range(n_vars):
        for j in range(i + 1, n_vars):
            if rng.random() < p_edge:
                m = rng.normal(size=(n_labels, n_labels))
                edges[(i, j)] = m
                mrf.add_pairwise_factor(i, j, m)
    return unaries, edges


def _brute_force(unaries, edges):
    n = len(unaries)
    L = len(unaries[0])
    best = np.inf
    for x in itertools.product(range(L), repeat=n):
        c = sum(unaries[i][x[i]] for i in range(n))
        c += sum(m[x[i], x[j]] for (i, j), m in edges.items())
        best = min(best, c)
    return best


def test_ilp_round_matches_brute_force():
    s = Solver(visitor=StandardVisitor(max_iter=5), device="cpu")
    mrf = s.add_constructor(MrfConstructor, pairwise_rep="dense")
    unaries, edges = _random_mrf(mrf, seed=1)
    s.build_engine()
    s.engine.compute_pass("anisotropic")
    prim, cost = ilp_round(s.engine)
    assert prim is not None
    assert cost == pytest.approx(_brute_force(unaries, edges), abs=1e-6)
    # objective is invariant under reparametrization: engine agrees
    assert s.engine.evaluate_primal(prim) == pytest.approx(cost, abs=1e-9)


def test_ilp_closes_gap_mp_rounding_cannot():
    # frustrated triangle, no tightening: lb = 0, optimum = 1; the ilp
    # solve certifies the optimum once tightening lifts the bound
    # (graphical_model.cpp:277-302 analogue)
    s = Solver(visitor=StandardTighteningVisitor(
        max_iter=60, tighten=True, tighten_iteration=5, tighten_interval=10,
        tighten_constraints_max=2,
        tighten_reparametrization="damped_uniform"),
        exact_rounding="ilp", device="cpu")
    mrf = s.add_constructor(MrfConstructor, pairwise_rep="dense")
    for _ in range(3):
        mrf.add_unary_factor(np.zeros(2))
    mrf.add_pairwise_factor(0, 1, NEG_POTTS)
    mrf.add_pairwise_factor(0, 2, POS_POTTS)
    mrf.add_pairwise_factor(1, 2, POS_POTTS)
    lb = s.solve()
    assert lb == pytest.approx(1.0, abs=1e-6)
    assert s.primal_cost() == pytest.approx(1.0, abs=1e-6)
    assert s.primal_cost() <= lb + 1e-6  # duality gap closed


def test_combilp_with_absorbed_triplets_closes_gap():
    """Solver(exact_rounding="combilp") after tightening triplets went into
    the aux passes: the engine is rebuilt with them folded in and combiLP
    rounds on the rebuilt engine, closing the gap at 1.0.  The JAX package
    hands the old engine's primal to the rebuilt one and fails with a
    KeyError on the folded-in ternary type."""
    from lp_mp_tpu import Solver as JSolver
    from lp_mp_tpu import StandardTighteningVisitor as JTighten
    from lp_mp_tpu.models.mrf import MrfConstructor as JMrf

    def frustrated(S, V, M, **kw):
        s = S(visitor=V(max_iter=60, tighten=True, tighten_iteration=5, tighten_interval=10,
                        tighten_constraints_max=2, tighten_reparametrization="damped_uniform"),
              exact_rounding="combilp", **kw)
        mrf = s.add_constructor(M, pairwise_rep="dense")
        for _ in range(3):
            mrf.add_unary_factor(np.zeros(2))
        mrf.add_pairwise_factor(0, 1, NEG_POTTS)
        mrf.add_pairwise_factor(0, 2, POS_POTTS)
        mrf.add_pairwise_factor(1, 2, POS_POTTS)
        return s

    s = frustrated(Solver, StandardTighteningVisitor, MrfConstructor, device="cpu")
    lb = s.solve()
    assert s.n_engine_builds >= 2 and not s.aux
    assert lb == pytest.approx(1.0, abs=1e-6)
    assert s.primal_cost() == pytest.approx(1.0, abs=1e-6)
    js = frustrated(JSolver, JTighten, JMrf, use_jit=False, pass_style="unrolled")
    with pytest.raises(KeyError, match="ternary_simplex"):
        js.solve()


def test_subset_ilp_conditioning():
    s = Solver(visitor=StandardVisitor(max_iter=20), device="cpu")
    mrf = s.add_constructor(MrfConstructor, pairwise_rep="dense")
    _random_mrf(mrf, n_vars=5, seed=3)
    s.build_engine()
    for _ in range(10):
        s.engine.compute_pass("anisotropic")
    prim = s.engine.compute_pass_and_primal("damped_uniform", Direction.forward)
    base = s.engine.evaluate_primal(prim)
    assert np.isfinite(base)
    # re-optimize only half the factors, conditioned on the rest
    n = s.engine.graph.n_factors
    mask = np.zeros(n, dtype=bool)
    mask[: n // 2] = True
    sub, cost = solve_ilp(s.engine, subset=mask, fixed_prim=prim)
    assert sub is not None
    assert np.isfinite(cost)
    assert cost <= base + 1e-9  # conditioned exact solve can only improve
    assert s.engine.check_primal_consistency(sub)


def test_combilp_reaches_optimum():
    s = Solver(visitor=StandardVisitor(max_iter=20), device="cpu")
    mrf = s.add_constructor(MrfConstructor, pairwise_rep="dense")
    unaries, edges = _random_mrf(mrf, n_vars=6, seed=7)
    s.build_engine()
    for _ in range(15):
        s.engine.compute_pass("anisotropic")
    prim, cost = combi_lp(s.engine, max_rounds=10)
    assert prim is not None
    assert s.engine.check_primal_consistency(prim)
    assert cost == pytest.approx(_brute_force(unaries, edges), abs=1e-6)


def test_combilp_through_solver():
    s = Solver(visitor=StandardVisitor(max_iter=30), exact_rounding="combilp", device="cpu")
    mrf = s.add_constructor(MrfConstructor, pairwise_rep="dense")
    unaries, edges = _random_mrf(mrf, n_vars=5, n_labels=2, seed=11)
    s.solve()
    assert s.primal_cost() == pytest.approx(_brute_force(unaries, edges), abs=1e-6)
    lab = mrf_labeling(mrf, s.engine, s.best_primal)
    assert lab.shape == (5,)


def test_incremental_ilp_matches_one_shot_and_reuses_model():
    """IncrementalIlp: growing the region flips bounds on the persistent
    model; every round must match the one-shot conditioned solve, and the
    constraint system must be built only once."""
    s = Solver(visitor=StandardVisitor(max_iter=8), device="cpu")
    mrf = s.add_constructor(MrfConstructor)
    _random_mrf(mrf, n_vars=8, n_labels=3, seed=3, p_edge=0.5)
    eng = Engine(s.graph, schedule_mode="wavefront", device="cpu")
    for _ in range(4):
        eng.compute_pass("anisotropic")
    prim = eng.compute_pass_and_primal("damped_uniform", Direction.forward)

    inc = IncrementalIlp(eng)
    A_id = id(inc.A)
    n = eng.graph.n_factors
    mask = np.zeros(n, dtype=bool)
    mask[:3] = True
    for _ in range(3):
        p_inc, c_inc = inc.solve(subset=mask, fixed_prim=prim)
        p_one, c_one = solve_ilp(eng, subset=mask, fixed_prim=prim)
        assert (p_inc is None) == (p_one is None)
        if p_inc is not None:
            assert abs(c_inc - c_one) < 1e-9, (c_inc, c_one)
        # grow one hop like combiLP._fatten
        mask = _fatten(eng, mask)
    # full-graph round == exact optimum == plain ilp_round
    p_full, c_full = inc.solve(subset=np.ones(n, dtype=bool))
    p_ref, c_ref = ilp_round(eng)
    assert abs(c_full - c_ref) < 1e-9
    assert id(inc.A) == A_id, "constraint system must not be rebuilt"


# ---------------------------------------------------------------------------
# tests/test_odd_wheels_general.py::test_wheel_lp_export_and_exact_oracle
# ---------------------------------------------------------------------------
def test_wheel_lp_export_and_exact_oracle():
    """The wheel-k lp_vars/lp_coupling hooks feed the LP/ILP oracles: the
    LP relaxation upper-bounds the DBCA bound and the exact ILP recovers
    the integral optimum -2 through the wheel-augmented graph (W5: hub 0,
    rim 1..5, attractive spokes +1, repulsive rim -1)."""
    s = Solver(device="cpu")
    mc = s.add_constructor(MulticutConstructor)
    rim = [1, 2, 3, 4, 5]
    for v in rim:
        mc.add_edge(0, v, 1.0)
    for i in range(5):
        mc.add_edge(rim[i], rim[(i + 1) % 5], -1.0)
    mc.add_odd_wheel_k(0, (1, 2, 3, 4, 5))
    eng = Engine(s.graph, device="cpu")
    for _ in range(100):
        eng.compute_pass("anisotropic")
    lb = eng.lower_bound()
    lp = solve_lp_relaxation(eng)
    assert lp >= lb - 1e-4, (lb, lp)
    prim, obj = ilp_round(eng)
    assert prim is not None and obj == pytest.approx(-2.0, abs=1e-5)
    assert eng.check_primal_consistency(prim)
