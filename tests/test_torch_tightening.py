"""MRF tightening in the port against the JAX package, on the CPU in float64.

Mirrors tests/test_tightening.py (explicit and searched triplets close a
frustrated triangle to lb 1.0), tests/test_cycle_separation.py (the
k-projection graph and the odd-cycle search close chordless frustrated
cycles through ``Solver.solve()`` alone) and the MRF half of
tests/test_aux_tighten.py (absorbed triplets need no engine rebuild, fold
back into a rebuilt engine with the bound kept, 200 triplets on a 100x100
grid in at most 2 builds).  Parity with the JAX package: the same triangle
scores, projection graphs, cycles and triplet sets; the aux pass's state
after the same absorbed triplets and passes to 1e-9; ``Solver.solve()``
with tightening on a real-valued 8x8 8-connected grid (distinct scores, so
float ulps pick no other triplet) with the same triplets, bounds to 1e-9
and equal primals; and a JAX solver's state (engine and absorbed triplets)
carried into the port through ``convert``, where both go on alike.
The JAX side runs eagerly (``use_jit=False, pass_style="unrolled"``).
"""
import numpy as np
import pytest
import torch

from lp_mp_tpu import Solver as JSolver, StandardTighteningVisitor as JTVisitor
from lp_mp_tpu import StandardVisitor as JVisitor
from lp_mp_tpu.aux_tighten import absorbable as j_absorbable
from lp_mp_tpu.config import Direction as JDirection
from lp_mp_tpu.models import cycle_separation as jcs
from lp_mp_tpu.models import tightening as jtight
from lp_mp_tpu.models.mrf import MrfConstructor as JMrf, mrf_labeling as j_mrf_labeling
from lp_mp_tpu_torch import (Direction, MrfConstructor, Solver, StandardTighteningVisitor, StandardVisitor,
                             aux_state_from_numpy, aux_state_to_numpy, engine_state_from_numpy,
                             engine_state_to_numpy)
from lp_mp_tpu_torch.aux_tighten import absorbable
from lp_mp_tpu_torch.models import cycle_separation as pcs
from lp_mp_tpu_torch.models import tightening as ptight
from lp_mp_tpu_torch.models.mrf import mrf_labeling
from tests.test_torch_engine import assert_trees_close, jax_numpy

NEG_POTTS = np.array([[1.0, 0.0], [0.0, 1.0]])
POS_POTTS = np.array([[0.0, 1.0], [1.0, 0.0]])
NEG_POTTS_23 = np.array([[1.0, 0.0, 2.0], [0.0, 1.0, 2.0]])
POS_POTTS_24 = np.array([[0.0, 1.0, 2.0, 2.0], [1.0, 0.0, 2.0, 2.0]])
POS_POTTS_34 = np.array([[0.0, 1.0, 2.0, 2.0],
                         [1.0, 0.0, 2.0, 2.0],
                         [2.0, 2.0, 2.0, 2.0]])
LB_TOL, STATE_TOL = 1e-9, 1e-9


def j_solver(visitor, **kw):
    return JSolver(visitor=visitor, use_jit=False, pass_style="unrolled", **kw)


def binary_triangle(mrf):
    for _ in range(3):
        mrf.add_unary_factor(np.zeros(2))
    mrf.add_pairwise_factor(0, 1, NEG_POTTS)
    mrf.add_pairwise_factor(0, 2, POS_POTTS)
    mrf.add_pairwise_factor(1, 2, POS_POTTS)


def multilabel_triangle(mrf):
    mrf.add_unary_factor(np.zeros(2))
    mrf.add_unary_factor(np.zeros(3))
    mrf.add_unary_factor(np.zeros(4))
    mrf.add_pairwise_factor(0, 1, NEG_POTTS_23)
    mrf.add_pairwise_factor(0, 2, POS_POTTS_24)
    mrf.add_pairwise_factor(1, 2, POS_POTTS_34)


def frustrated_cycle(mrf, n):
    for _ in range(n):
        mrf.add_unary_factor(np.zeros(2))
    mrf.add_pairwise_factor(0, 1, NEG_POTTS)
    for i in range(1, n - 1):
        mrf.add_pairwise_factor(i, i + 1, POS_POTTS)
    mrf.add_pairwise_factor(0, n - 1, POS_POTTS)


def disagree_3cycle(mrf):
    for _ in range(3):
        mrf.add_unary_factor(np.zeros(2))
    for i, j in ((0, 1), (1, 2), (0, 2)):
        mrf.add_pairwise_factor(i, j, NEG_POTTS)


def frustrated_grid(mrf, H, W, rng):
    """tests/test_aux_tighten.py:14-36: binary grid with diagonal chords and
    random +-1 couplings (tie-rich)."""
    n = lambda i, j: i * W + j                                            # noqa: E731
    for i in range(H):
        for j in range(W):
            mrf.add_unary_factor(rng.uniform(-0.2, 0.2, size=2))
    anti = np.array([[0.0, 1.0], [1.0, 0.0]])
    ferro = 1.0 - anti
    for i in range(H):
        for j in range(W):
            if j + 1 < W:
                mrf.add_pairwise_factor(n(i, j), n(i, j + 1), anti if rng.rand() < 0.5 else ferro)
            if i + 1 < H:
                mrf.add_pairwise_factor(n(i, j), n(i + 1, j), anti if rng.rand() < 0.5 else ferro)
            if i + 1 < H and j + 1 < W:
                mrf.add_pairwise_factor(n(i, j), n(i + 1, j + 1),
                                        anti if rng.rand() < 0.5 else ferro)


def real_grid8(mrf, H=8, W=8, L=2, seed=11):
    """8-connected grid with normal unaries and normal dense pairwise
    matrices: distinct triangle scores."""
    rng = np.random.default_rng(seed)
    mrf.add_unary_factors(rng.normal(size=(H * W, L)) * 0.5)
    idx = np.arange(H * W).reshape(H, W)
    pairs = np.sort(np.concatenate([
        np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], axis=1),
        np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], axis=1),
        np.stack([idx[:-1, :-1].ravel(), idx[1:, 1:].ravel()], axis=1),
        np.stack([idx[:-1, 1:].ravel(), idx[1:, :-1].ravel()], axis=1)]), axis=1)
    mrf.add_pairwise_factors(pairs, rng.normal(size=(len(pairs), L, L)))


def tightening_visitor(cls, **kw):
    args = dict(max_iter=150, tighten=True, tighten_iteration=5, tighten_interval=10,
                tighten_constraints_max=4, tighten_reparametrization="damped_uniform")
    args.update(kw)
    return cls(**args)


# ---------------------------------------------------------------------------
# tests/test_tightening.py
# ---------------------------------------------------------------------------
def test_frustrated_triangle_without_tightening():
    s = Solver(visitor=StandardVisitor(max_iter=30), device="cpu")
    binary_triangle(s.add_constructor(MrfConstructor, pairwise_rep="dense"))
    assert abs(s.solve()) <= 1e-8


@pytest.mark.parametrize("build", [binary_triangle, multilabel_triangle],
                         ids=["binary", "multilabel"])
def test_explicit_triplet_closes_triangle(build):
    lbs = []
    for S, M, kw in ((Solver, MrfConstructor, dict(device="cpu")),
                     (JSolver, JMrf, dict(use_jit=False, pass_style="unrolled"))):
        V = StandardVisitor if S is Solver else JVisitor
        s = S(visitor=V(max_iter=100), **kw)
        mrf = s.add_constructor(M, pairwise_rep="dense")
        build(mrf)
        mrf.add_tightening_triplet(0, 1, 2)
        lbs.append(s.solve())
    assert abs(lbs[0] - 1.0) <= 1e-8, lbs
    assert abs(lbs[0] - lbs[1]) <= LB_TOL


def test_triplet_search():
    s = Solver(visitor=tightening_visitor(StandardTighteningVisitor, max_iter=100,
                                          tighten_constraints_max=1), device="cpu")
    mrf = s.add_constructor(MrfConstructor, pairwise_rep="dense")
    multilabel_triangle(mrf)
    lb = s.solve()
    assert abs(lb - 1.0) <= 1e-8, lb
    assert len(mrf.triplets) == 1


def twin_grid8_engines(passes=3):
    """The real-valued 8x8 grid in both packages after ``passes`` passes."""
    out = []
    for S, M, kw in ((JSolver, JMrf, dict(use_jit=False, pass_style="unrolled")),
                     (Solver, MrfConstructor, dict(device="cpu"))):
        s = S(**kw)
        mrf = s.add_constructor(M, pairwise_rep="dense")
        real_grid8(mrf, L=3)
        e = s.build_engine()
        for _ in range(passes):
            e.compute_pass("anisotropic")
        out.append((s, mrf, e))
    return out


def test_triplet_scores_and_search_match_jax():
    (sj, mj, ej), (sp, mp, ep) = twin_grid8_engines()
    tri = ptight.triangle_candidates(mp)
    assert tri == jtight.triangle_candidates(mj) and len(tri) == 2 * 49 * 2
    sc_p = ptight._batched_scores(mp, ep, tri)
    np.testing.assert_allclose(sc_p, jtight._batched_scores(mj, ej, tri), rtol=0, atol=1e-12)
    for t in tri[:7]:
        assert ptight.triplet_score(mp, ep, *t) == pytest.approx(sc_p[tri.index(t)], abs=1e-12)
        assert abs(ptight.triplet_score(mp, ep, *t) - jtight.triplet_score(mj, ej, *t)) < 1e-12
    top = np.sort(sc_p)[::-1][:10]
    assert top[-1] > 1e-8 and len(np.unique(top)) == 10    # no tie for the search to break
    assert ptight.triplet_search(mp, ep, 9) == jtight.triplet_search(mj, ej, 9) == 9
    assert list(mp.triplets) == list(mj.triplets)


# ---------------------------------------------------------------------------
# tests/test_cycle_separation.py
# ---------------------------------------------------------------------------
def test_projection_graph_signs():
    s = Solver(visitor=tightening_visitor(StandardTighteningVisitor), device="cpu")
    mrf = s.add_constructor(MrfConstructor, pairwise_rep="dense")
    frustrated_cycle(mrf, 4)
    s.build_engine()
    edges = pcs.k_projection_graph(mrf, s.engine)
    assert len(edges) == 16
    by_edge = {}
    for w, p, (i, _), (j, _) in edges:
        assert w == pytest.approx(1.0)
        by_edge.setdefault((i, j), set()).add(p)
    assert by_edge[(0, 1)] == {0, 1}
    assert by_edge[(1, 2)] == {0, 1}


def test_search_finds_odd_cycle():
    s = Solver(visitor=tightening_visitor(StandardTighteningVisitor), device="cpu")
    mrf = s.add_constructor(MrfConstructor, pairwise_rep="dense")
    frustrated_cycle(mrf, 4)
    s.build_engine()
    for _ in range(20):
        s.engine.compute_pass("damped_uniform")
    assert abs(s.engine.lower_bound()) <= 1e-8
    assert pcs.find_violated_cycles(mrf, s.engine), "no violated cycle found"
    assert pcs.cycle_search(mrf, s.engine, max_constraints=8) >= 2
    assert len(mrf.triplets) >= 2


@pytest.mark.parametrize("n", [4, 5])
def test_frustrated_cycle_closed_by_solve(n):
    """graphical_model.cpp:232-246: lb 0 -> 1.0 through Solve() alone."""
    s = Solver(visitor=tightening_visitor(StandardTighteningVisitor), device="cpu")
    mrf = s.add_constructor(MrfConstructor, pairwise_rep="dense")
    frustrated_cycle(mrf, n)
    lb = s.solve()
    assert abs(lb - 1.0) <= 1e-6, lb
    assert len(mrf.triplets) >= n - 2


def test_no_false_positives_on_consistent_cycle():
    s = Solver(visitor=tightening_visitor(StandardTighteningVisitor), device="cpu")
    mrf = s.add_constructor(MrfConstructor, pairwise_rep="dense")
    for _ in range(4):
        mrf.add_unary_factor(np.zeros(2))
    for i in range(3):
        mrf.add_pairwise_factor(i, i + 1, POS_POTTS)
    mrf.add_pairwise_factor(0, 3, POS_POTTS)
    s.build_engine()
    for _ in range(10):
        s.engine.compute_pass("damped_uniform")
    assert pcs.find_violated_cycles(mrf, s.engine) == []


def test_projection_graph_and_cycles_match_jax():
    (sj, mj, ej), (sp, mp, ep) = twin_grid8_engines(passes=2)
    gj, gp = jcs.k_projection_graph(mj, ej), pcs.k_projection_graph(mp, ep)
    assert len(gj) == len(gp) > 0
    for a, b in zip(gj, gp):
        assert a[1:] == b[1:]
        assert abs(a[0] - b[0]) < 1e-12
    assert pcs.find_violated_cycles(mp, ep) == jcs.find_violated_cycles(mj, ej)
    assert pcs.cycle_search(mp, ep, 6) == jcs.cycle_search(mj, ej, 6)
    assert list(mp.triplets) == list(mj.triplets)
    assert list(mp.pairwise) == list(mj.pairwise)     # the same chords, in order


# ---------------------------------------------------------------------------
# tests/test_aux_tighten.py, MRF half
# ---------------------------------------------------------------------------
def absorb_rounds(s, mrf, rounds, per_round, passes, search=ptight.triplet_search):
    """Tighten rounds by hand through the absorb path; returns the bounds."""
    lbs = [s.engine.lower_bound() + s.aux.lower_bound()]
    for _ in range(rounds):
        added = search(mrf, s.engine, max_constraints=per_round)
        if added == 0:
            break
        n0 = s.graph.n_factors - added
        m0 = len(s.graph.messages) - 3 * added
        items = absorbable(s.graph, s.engine, n0, m0)
        assert items is not None
        for fid, data, rows in items:
            s.aux.mrf.add(s.engine, fid, data, rows)
        for _ in range(passes):
            s.engine.compute_pass("anisotropic")
            s.aux.run(s.engine)
        lbs.append(s.engine.lower_bound() + s.aux.lower_bound())
    return lbs


def test_tighten_rounds_do_not_rebuild_engine():
    rng = np.random.RandomState(0)
    s = Solver(visitor=StandardVisitor(max_iter=5), device="cpu")
    mrf = s.add_constructor(MrfConstructor, pairwise_rep="dense")
    frustrated_grid(mrf, 6, 6, rng)
    s.solve()
    assert s.n_engine_builds == 1
    lbs = absorb_rounds(s, mrf, rounds=10, per_round=3, passes=5)
    assert all(b >= a - 1e-6 for a, b in zip(lbs, lbs[1:])), lbs
    assert s.n_engine_builds == 1
    assert s.aux.n > 0
    assert lbs[-1] > lbs[0] + 1e-6


def test_aux_path_matches_rebuild_fixed_point():
    vis = StandardTighteningVisitor(max_iter=60, tighten=True, tighten_iteration=3,
                                    tighten_interval=5, tighten_constraints_max=5)
    s = Solver(visitor=vis, device="cpu")
    disagree_3cycle(s.add_constructor(MrfConstructor, pairwise_rep="dense"))
    lb = s.solve()
    assert abs(lb - 1.0) < 1e-5, lb
    assert s.n_engine_builds == 1
    assert s.aux.n == 1
    assert s.primal_cost() >= lb - 1e-6


def test_aux_fold_into_rebuild_keeps_bound():
    vis = StandardTighteningVisitor(max_iter=40, tighten=True, tighten_iteration=3,
                                    tighten_interval=5, tighten_constraints_max=5)
    s = Solver(visitor=vis, device="cpu")
    disagree_3cycle(s.add_constructor(MrfConstructor, pairwise_rep="dense"))
    lb = s.solve()
    assert s.aux.n == 1
    lb_aux = s.engine.lower_bound() + s.aux.lower_bound()
    s.build_engine()
    assert s.aux.n == 0 and s.aux.mrf.c is None
    assert abs(s.engine.lower_bound() - lb_aux) < LB_TOL      # float64: the same bound
    assert s.engine.lower_bound() >= lb - 1e-5


def test_aux_tighten_100x100_no_rebuilds():
    """>= 10 tighten rounds on a 100x100 frustrated grid with at most 2
    engine builds, monotone bound, batched triplet separation."""
    rng = np.random.default_rng(0)
    H = W = 100
    s = Solver(visitor=StandardVisitor(max_iter=5), schedule_mode="coloring", device="cpu")
    mrf = s.add_constructor(MrfConstructor, pairwise_rep="dense")
    mrf.add_unary_factors(rng.uniform(-0.2, 0.2, size=(H * W, 2)))
    idx = np.arange(H * W).reshape(H, W)
    pairs = np.concatenate([
        np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], axis=1),
        np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], axis=1),
        np.stack([idx[:-1, :-1].ravel(), idx[1:, 1:].ravel()], axis=1)])
    anti = np.array([[0.0, 1.0], [1.0, 0.0]])
    pick = rng.random(len(pairs)) < 0.5
    mrf.add_pairwise_factors(pairs, np.where(pick[:, None, None], anti, 1.0 - anti))
    s.solve()
    lbs = absorb_rounds(s, mrf, rounds=10, per_round=20, passes=3)
    assert len(lbs) == 11
    assert all(b >= a - 1e-6 for a, b in zip(lbs, lbs[1:])), lbs
    assert s.n_engine_builds <= 2
    assert s.aux.n == 200
    assert lbs[-1] > lbs[0] + 100.0


def test_aux_pass_matches_jax():
    """The same triplets absorbed on the same engine state: engine and aux
    states after each round agree to 1e-9, through ``convert``."""
    (sj, mj, ej), (sp, mp, ep) = twin_grid8_engines()
    for r in range(2):
        added = [jtight.triplet_search(mj, ej, 5), ptight.triplet_search(mp, ep, 5)]
        assert added[0] == added[1] > 0 and list(mj.triplets) == list(mp.triplets)
        for s, absorb, e in ((sj, j_absorbable, ej), (sp, absorbable, ep)):
            n0 = s.graph.n_factors - added[0]
            items = absorb(s.graph, e, n0, len(s.graph.messages) - 3 * added[0])
            for fid, data, rows in items:
                s.aux.mrf.add(e, fid, data, rows)
            for _ in range(2):
                e.compute_pass("anisotropic")
                s.aux.run(e)
        assert abs(ej.lower_bound() + sj.aux.lower_bound()
                   - ep.lower_bound() - sp.aux.lower_bound()) < LB_TOL
        assert_trees_close(jax_numpy(ej.state), engine_state_to_numpy(ep.state), STATE_TOL)
        aj, ap = aux_state_to_numpy(sj.aux), aux_state_to_numpy(sp.aux)
        for k in ("cap", "n", "fids", "dims"):
            assert aj["mrf"][k] == ap["mrf"][k], k
        for k in ("c", "lidx", "active", "w_recv"):
            np.testing.assert_allclose(ap["mrf"][k], aj["mrf"][k], rtol=0, atol=STATE_TOL,
                                       err_msg=k)
    assert sp.aux.mrf.cap == 16 and sp.aux.n == 10     # 8 -> 16 on the second round
    pj = ej.compute_pass_and_primal("anisotropic", JDirection.forward)
    pp = ep.compute_pass_and_primal("anisotropic", Direction.forward)
    assert abs(sj.aux.evaluate_primal(ej, pj) - sp.aux.evaluate_primal(ep, pp)) < LB_TOL


def test_aux_state_round_trip():
    """``aux_state_to_numpy`` -> ``aux_state_from_numpy`` gives a pass with
    the same state, which runs on as the original does."""
    (sj, mj, ej), (sp, mp, ep) = twin_grid8_engines()
    added = ptight.triplet_search(mp, ep, 11)
    items = absorbable(sp.graph, ep, sp.graph.n_factors - added,
                       len(sp.graph.messages) - 3 * added)
    for fid, data, rows in items:
        sp.aux.mrf.add(ep, fid, data, rows)
    st = aux_state_to_numpy(sp.aux)
    assert st["mrf"]["cap"] == 16 and st["mrf"]["n"] == 11 and st["mc"]["n"] == 0
    twin = aux_state_from_numpy(st)
    st2 = aux_state_to_numpy(twin)
    for k in ("cap", "n", "fids", "dims"):
        assert st2["mrf"][k] == st["mrf"][k]
    for k in ("c", "lidx", "active", "w_recv"):
        np.testing.assert_array_equal(st2["mrf"][k], st["mrf"][k])
    assert twin.mrf.lidx.dtype == torch.int64
    state0 = ep.get_state()
    sp.aux.run(ep)
    a = (ep.lower_bound(), sp.aux.lower_bound())
    ep.set_state(state0)
    twin.run(ep)
    assert (ep.lower_bound(), twin.lower_bound()) == a


# ---------------------------------------------------------------------------
# Solver.solve() with tightening, end to end
# ---------------------------------------------------------------------------
def grid8_solvers(max_iter=24):
    kw = dict(max_iter=max_iter, tighten=True, tighten_iteration=4, tighten_interval=8,
              tighten_constraints_max=6, primal_computation_interval=4)
    logs = ([], [])
    sj = j_solver(JTVisitor(log_fn=logs[0].append, **kw))
    sp = Solver(visitor=StandardTighteningVisitor(log_fn=logs[1].append, **kw), device="cpu")
    ctors = [s.add_constructor(M, pairwise_rep="dense") for s, M in ((sj, JMrf), (sp, MrfConstructor))]
    for c in ctors:
        real_grid8(c)
    return (sj, sp), ctors, logs


def test_solver_tightening_matches_jax():
    (sj, sp), (cj, cp), (lj, lp) = grid8_solvers()
    lb_j, lb_p = sj.solve(), sp.solve()
    assert len(cp.triplets) > 0 and list(cp.triplets) == list(cj.triplets)
    assert list(cp.pairwise) == list(cj.pairwise)
    assert sp.n_engine_builds == sj.n_engine_builds and sp.aux.n == sj.aux.n > 0
    assert abs(lb_j - lb_p) < LB_TOL
    assert len(lj) == len(lp)
    for a, b in zip(lj, lp):
        assert abs(a["lower_bound"] - b["lower_bound"]) < LB_TOL, a["iteration"]
    assert np.isfinite(sp.primal_cost())
    assert abs(sj.primal_cost() - sp.primal_cost()) < LB_TOL
    np.testing.assert_array_equal(mrf_labeling(cp, sp.engine, sp.best_primal),
                                  j_mrf_labeling(cj, sj.engine, sj.best_primal))


def test_solver_state_carried_from_jax_through_convert():
    """A JAX solver tightens; its engine state and absorbed triplets go into
    a port solver over the same graph through ``convert``; both then run the
    same passes and rounds and stay together."""
    (sj, sp), (cj, cp), _ = grid8_solvers(max_iter=12)
    sj.solve()
    assert sj.aux.n > 0
    # replay the JAX constructor's additions; build where the JAX engine was built
    real_n = sj.engine.n_factors
    for t in cj.triplets:
        if sp.graph.n_factors == real_n and sp.engine is None:
            sp.build_engine()
        cp.add_tightening_triplet(*t)
    if sp.engine is None:
        sp.build_engine()
    assert sp.graph.n_factors == sj.graph.n_factors and sp.engine.n_factors == real_n
    sp.engine.set_state(engine_state_from_numpy(jax_numpy(sj.engine.state)))
    sp.aux = aux_state_from_numpy(aux_state_to_numpy(sj.aux))
    assert abs(sj.engine.lower_bound() + sj.aux.lower_bound()
               - sp.engine.lower_bound() - sp.aux.lower_bound()) < 1e-12
    for _ in range(3):
        for s in (sj, sp):
            s.engine.compute_pass("anisotropic")
            s.aux.run(s.engine)
        assert abs(sj.engine.lower_bound() + sj.aux.lower_bound()
                   - sp.engine.lower_bound() - sp.aux.lower_bound()) < LB_TOL
    assert sj.tighten(4) == sp.tighten(4)
    assert list(cp.triplets) == list(cj.triplets) and sp.aux.n == sj.aux.n
    for s in (sj, sp):
        s.build_engine()                       # fold the absorbed triplets back
    assert_trees_close(jax_numpy(sj.engine.state), engine_state_to_numpy(sp.engine.state), STATE_TOL)
