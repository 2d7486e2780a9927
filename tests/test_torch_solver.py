"""The port's Solver, visitors, UAI reader and host schedule against the JAX
package's, on the CPU in float64.

- ``Solver`` + ``StandardVisitor`` end to end: equal ``lower_bound()``,
  ``primal_cost()`` and per-iteration visitor records, for mp and restricted
  rounding, and the dual carry-over of ``build_engine`` after the graph
  grows.
- The UAI chain of tests/test_uai.py: lb 0.564 and labeling [0, 0, 2].
- The copied ``schedule.py`` and ``graph.py``: the same orders, phases and
  weights as arrays.
- What is not ported yet (trees, exact rounding) raises
  ``NotImplementedError``; the visitor's tighten control tightens.
"""
import numpy as np
import pytest
import torch

import lp_mp_tpu.schedule as jsched
from lp_mp_tpu import Solver as JSolver, StandardVisitor as JVisitor
from lp_mp_tpu.io.uai import parse_uai as j_parse_uai
from lp_mp_tpu.models.mrf import MrfConstructor as JMrf, mrf_labeling as j_mrf_labeling
from lp_mp_tpu_torch import (MrfConstructor, Solver, StandardTighteningVisitor,
                             StandardVisitor, config, native)
from lp_mp_tpu_torch import schedule as psched
from lp_mp_tpu_torch.io.uai import parse_and_build, parse_uai
from lp_mp_tpu_torch.models.mrf import mrf_labeling
from tests.test_torch_engine import (assert_trees_close, engine_state_to_numpy, frustrated_potts_grid,
                                     jax_numpy, random_mrf, twin_graphs)
from tests.test_uai import UAI_TEST_INPUT

MODES = ["anisotropic", "anisotropic2", "uniform", "damped_uniform", "mixed"]


def twin_solvers(recipe, visitor_kw, **kw):
    """JAX and port Solvers over the same recipe, each with a visitor that
    logs its per-iteration records."""
    build, ctor_kw = recipe
    logs = ([], [])
    sj = JSolver(visitor=JVisitor(log_fn=logs[0].append, **visitor_kw), use_jit=False,
                 pass_style="unrolled", **kw)
    sp = Solver(visitor=StandardVisitor(log_fn=logs[1].append, **visitor_kw), device="cpu",
                **kw)
    ctors = [s.add_constructor(M, **ctor_kw) for s, M in ((sj, JMrf), (sp, MrfConstructor))]
    for s, c in zip((sj, sp), ctors):
        build(s.graph, c)
    return (sj, sp), ctors, logs


def assert_logs_match(lj, lp):
    assert len(lj) == len(lp)
    for a, b in zip(lj, lp):
        assert a["iteration"] == b["iteration"]
        for k in ("lower_bound", "upper_bound"):
            assert (a[k] is None) == (b[k] is None), k
            if a[k] is not None and np.isfinite(a[k]):
                assert abs(a[k] - b[k]) < 1e-10, (a["iteration"], k)


# ---------------------------------------------------------------------------
# Solver end to end
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("rounding", ["mp", "restricted"])
@pytest.mark.parametrize("recipe", [random_mrf(21, n=8, extra_edges=4),
                                    frustrated_potts_grid(4, 4, 3, seed=1)],
                         ids=["random_mrf", "potts_grid"])
def test_solver_matches_jax(recipe, rounding):
    (sj, sp), (cj, cp), (lj, lp) = twin_solvers(
        recipe, dict(max_iter=9, primal_computation_interval=3), rounding=rounding)
    lb_j, lb_p = sj.solve(), sp.solve()
    assert abs(lb_j - lb_p) < 1e-10
    assert abs(sj.lower_bound() - sp.lower_bound()) < 1e-10
    assert np.isfinite(sp.primal_cost())
    assert abs(sj.primal_cost() - sp.primal_cost()) < 1e-10
    assert sp.primal_cost() >= sp.lower_bound() - 1e-9
    assert_logs_match(lj, lp)
    np.testing.assert_array_equal(mrf_labeling(cp, sp.engine, sp.best_primal),
                                  j_mrf_labeling(cj, sj.engine, sj.best_primal))


@pytest.mark.parametrize("smode", ["wavefront", "coloring"])
def test_solver_rebuild_carries_duals_like_jax(smode):
    """build_engine after the graph grew: old rows are a prefix of the new
    blocks, the old engine's state stays as it was, and both packages go on
    alike (solver.py:91-98 of the JAX package)."""
    (sj, sp), (cj, cp), _ = twin_solvers(random_mrf(4, n=6, extra_edges=2),
                                         dict(max_iter=4), schedule_mode=smode)
    sj.solve()
    sp.solve()
    old = sp.engine
    before = engine_state_to_numpy(old.state)
    rng = np.random.default_rng(9)
    u, m = rng.normal(size=3), rng.normal(size=(cp._n_labels(0), 3))
    for c in (cj, cp):
        c.add_unary_factor(u)
        c.add_pairwise_factor(0, 6, m)
    sj.build_engine()
    sp.build_engine()
    assert sp.n_engine_builds == sj.n_engine_builds == 2
    assert_trees_close(jax_numpy(sj.engine.state), engine_state_to_numpy(sp.engine.state))
    assert_trees_close(before, engine_state_to_numpy(old.state), atol=0.0)
    for _ in range(2):
        sj.engine.compute_pass("anisotropic")
        sp.engine.compute_pass("anisotropic")
    assert abs(sj.engine.lower_bound() - sp.engine.lower_bound()) < 1e-10


def test_solver_rebuild_leaves_graph_costs_intact():
    """The carry-over writes into the new engine's own blocks, never into a
    graph's batch payloads: a fresh engine over the grown graph starts from
    the original costs, as the JAX package's does."""
    from lp_mp_tpu.engine import Engine as JEngine
    from lp_mp_tpu_torch import Engine
    (sj, sp), (cj, cp), _ = twin_solvers(frustrated_potts_grid(3, 3, 3, seed=2), dict(max_iter=4))
    sj.solve()
    sp.solve()
    for c in (cj, cp):
        c.add_pairwise_factor(0, 8, np.ones((3, 3)))
    sj.build_engine()
    sp.build_engine()
    fresh_j = JEngine(sj.graph, use_jit=False, pass_style="unrolled")
    fresh_p = Engine(sp.graph, device="cpu")
    assert_trees_close(jax_numpy(fresh_j.state), engine_state_to_numpy(fresh_p.state), atol=0.0)
    assert abs(fresh_j.lower_bound() - fresh_p.lower_bound()) < 1e-10


def test_solver_device_and_dtype():
    s = Solver(visitor=StandardVisitor(max_iter=3), dtype=torch.float32, device="cpu")
    mrf = s.add_constructor(MrfConstructor)
    mrf.add_unary_factors(np.random.default_rng(0).normal(size=(5, 3)))
    mrf.add_pairwise_factors(np.array([[0, 1], [1, 2], [3, 4]]),
                             np.random.default_rng(1).normal(size=(3, 3, 3)))
    lb = s.solve()
    assert s.device == torch.device("cpu")
    assert s.engine.state["unary_simplex"]["c"].dtype == torch.float32
    assert np.isfinite(lb) and lb <= s.primal_cost() + 1e-5


def test_visitor_prints_iterations_at_diagnostics_verbosity(capsys):
    s = Solver(visitor=StandardVisitor(max_iter=3), device="cpu")
    parse_and_build(UAI_TEST_INPUT, s.add_constructor(MrfConstructor))
    old = config.verbosity
    config.verbosity = 1
    try:
        s.solve()
    finally:
        config.verbosity = old
    out = capsys.readouterr().out
    assert "iteration = 0, lower bound = " in out and "final lower bound = " in out


# ---------------------------------------------------------------------------
# UAI (tests/test_uai.py)
# ---------------------------------------------------------------------------
def test_parse_uai_matches_jax():
    pj, pp = j_parse_uai(UAI_TEST_INPUT), parse_uai(UAI_TEST_INPUT)
    assert pp["cardinalities"] == pj["cardinalities"] == [2, 2, 3]
    assert pp["scopes"] == pj["scopes"]
    for a, b in zip(pj["tables"], pp["tables"]):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="MARKOV"):
        parse_uai("BAYES 1 2")


def _solve_uai(schedule_mode):
    s = Solver(visitor=StandardVisitor(
        max_iter=100, standard_reparametrization="anisotropic",
        rounding_reparametrization="anisotropic", lower_bound_computation_interval=1,
        primal_computation_interval=5), schedule_mode=schedule_mode, device="cpu")
    mrf = s.add_constructor(MrfConstructor, pairwise_rep="dense")
    parse_and_build(UAI_TEST_INPUT, mrf)
    return s, mrf, s.solve()


@pytest.mark.parametrize("smode", ["sequential", "wavefront", "coloring"])
def test_uai_chain_lower_bound_0564(smode):
    s, mrf, lb = _solve_uai(smode)
    assert abs(lb - 0.564) < 1e-8
    assert abs(s.primal_cost() - 0.564) < 1e-8
    assert mrf_labeling(mrf, s.engine, s.best_primal).tolist() == [0, 0, 2]


# ---------------------------------------------------------------------------
# the copied host schedule (schedule.py, graph.py)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("recipe", [random_mrf(8, n=12, extra_edges=7),
                                    random_mrf(2, n=10, extra_edges=5, rep="potts")],
                         ids=["dense", "potts"])
def test_schedule_and_graph_copies_match_jax(recipe):
    (gj, _), (gp, _) = twin_graphs(recipe)
    n = gp.n_factors
    assert n == gj.n_factors and len(gp.messages) == len(gj.messages)
    dj, dp = gj.message_descs(), gp.message_descs()
    assert [(d.left, d.right, d.schedule.value) for d in dj] == \
        [(d.left, d.right, d.schedule.value) for d in dp]
    np.testing.assert_array_equal(gp.forward_relations.arrays()[0], gj.forward_relations.arrays()[0])
    order = psched.toposort(n, gp.forward_relations)
    assert order == jsched.toposort(n, gj.forward_relations)
    upd_p = psched.factor_updated_mask(n, dp)
    np.testing.assert_array_equal(upd_p, jsched.factor_updated_mask(n, dj))
    for a, b in zip(psched.adjacency_csr(n, dp), jsched.adjacency_csr(n, dj)):
        np.testing.assert_array_equal(a, b)
    assert psched.coloring_order(n, dp, upd_p) == jsched.coloring_order(n, dj, upd_p)
    assert psched.levelize(order, n, dp, upd_p) == jsched.levelize(order, n, dj, upd_p)
    typed = [(d.schedule, np.array([d.left]), np.array([d.right]), np.array([i]))
             for i, d in enumerate(dp)]
    typed_j = [(dj[i].schedule,) + t[1:] for i, t in enumerate(typed)]
    for mode in MODES:
        for a, b in ((psched.compute_weights(psched.ReparametrizationMode(mode), order, n, dp, upd_p),
                      jsched.compute_weights(jsched.ReparametrizationMode(mode), order, n, dj, upd_p)),
                     (psched.compute_weights_arrays(mode, order, n, typed, len(dp), upd_p),
                      jsched.compute_weights_arrays(mode, order, n, typed_j, len(dj), upd_p))):
            for k in ("omega_left", "omega_right", "recv_left", "recv_right"):
                np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=f"{mode} {k}")
            assert psched.omega_valid(a, n, dp)


def test_native_library_has_its_own_cache(monkeypatch, tmp_path):
    """The port builds csrc/lpmp_host.cpp into its own cache directory; its
    levelize and colouring agree with the pure-Python fallbacks."""
    monkeypatch.setenv("LPMP_TORCH_NATIVE_CACHE", str(tmp_path))
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", False)
    lib = native.get_lib()
    if lib is None:
        pytest.skip("no g++ to build csrc/lpmp_host.cpp")
    assert (tmp_path / "liblpmp_host.so").exists()
    (_, _), (g, _) = twin_graphs(random_mrf(8, n=12, extra_edges=7))
    n, descs = g.n_factors, g.message_descs()
    upd = psched.factor_updated_mask(n, descs)
    order = psched.toposort(n, g.forward_relations)
    with_lib = (psched.coloring_order(n, descs, upd), psched.levelize(order, n, descs, upd))
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_TRIED", True)
    assert native.get_lib() is None
    assert with_lib == (psched.coloring_order(n, descs, upd), psched.levelize(order, n, descs, upd))


# ---------------------------------------------------------------------------
# not ported yet: each names its item of queue 1 in ROADMAP.md
# ---------------------------------------------------------------------------
def test_unported_features_raise():
    with pytest.raises(NotImplementedError, match="item 8"):
        Solver(tree_decomposition=[[0]], device="cpu")
    with pytest.raises(NotImplementedError, match="item 9"):
        Solver(exact_rounding="ilp", device="cpu")
    # tightening is ported: on the UAI chain (no triangle, no cycle) it adds nothing
    s = Solver(device="cpu")
    mrf = s.add_constructor(MrfConstructor)
    parse_and_build(UAI_TEST_INPUT, mrf)
    assert mrf.tighten(s.build_engine(), 5) == 0
    assert s.tighten(5) == 0 and s.n_engine_builds == 1 and not s.aux


def test_tightening_visitor_control_raises():
    """The visitor's tighten control no longer raises: it runs
    ``Solver.tighten`` every iteration, which on the chain adds nothing, so
    the solve ends as the untightened one does (lb 0.564)."""
    s = Solver(visitor=StandardTighteningVisitor(max_iter=10, tighten=True, tighten_iteration=1,
                                                 tighten_interval=1), device="cpu")
    mrf = s.add_constructor(MrfConstructor)
    parse_and_build(UAI_TEST_INPUT, mrf)
    assert abs(s.solve() - 0.564) < 1e-8
    assert not mrf.triplets and s.n_engine_builds == 1
