"""The port's generic engine (lp_mp_tpu_torch.engine) against the JAX Engine.

The same graphs, built from a numpy seed through both packages'
``MrfConstructor``, go through both engines on the CPU in float64.  Lower
bounds agree to 1e-10 and states (read through
``convert.engine_state_to_numpy``) to 1e-9, for every schedule mode,
reparametrization mode and update mode, and for mp and restricted
rounding, whose primals are equal.  The JAX engines run eagerly with the
unrolled pass (``use_jit=False, pass_style="unrolled"``): the same
op order as the port's eager pass, without compile time for these small
graphs.  (The order matters for ``update_mode="adaptive"``: its reweighting
switches on whether a send improves the bound at all, so rounding noise at
zero improvement can change the weights; eager JAX and the port agree to
1e-10, jitted JAX differs from both by 0.03 on the padded Potts instance.)
The port's engine is also held against the port's ``GridPottsModel``, as
tests/test_grid.py holds the JAX engine against the JAX grid model.
"""
import numpy as np
import pytest
import torch

from lp_mp_tpu.config import Direction as JDirection
from lp_mp_tpu.engine import Engine as JEngine
from lp_mp_tpu.graph import FactorGraph as JGraph
from lp_mp_tpu.models.mrf import MrfConstructor as JMrf
from lp_mp_tpu_torch import (Direction, Engine, FactorGraph, GridPottsModel, MrfConstructor,
                             engine_state_from_numpy, engine_state_to_numpy, random_grid)
from lp_mp_tpu_torch.models.grid_potts import grid_potts_edges

MODES = ["anisotropic", "anisotropic2", "uniform", "damped_uniform", "mixed"]
LB_TOL, STATE_TOL = 1e-10, 1e-9


# ---------------------------------------------------------------------------
# instances, as recipes run on both packages' constructors
# ---------------------------------------------------------------------------
def random_mrf(seed, n=8, extra_edges=4, maxL=4, rep="dense"):
    """tests/test_engine_parity.py:16-36: mixed label counts (padding)."""
    def build(g, mrf):
        rng = np.random.default_rng(seed)
        Ls = rng.integers(2, maxL + 1, size=n)
        if rep == "potts":
            Ls[:] = Ls[0]
        for i in range(n):
            mrf.add_unary_factor(rng.normal(size=Ls[i]))
        edges = {(i, i + 1) for i in range(n - 1)}
        while len(edges) < n - 1 + extra_edges:
            i, j = sorted(rng.integers(0, n, size=2))
            if i != j:
                edges.add((i, j))
        for (i, j) in sorted(edges):
            if rep == "potts":
                m = rng.normal() * (1 - np.eye(Ls[i]))
            else:
                m = rng.normal(size=(Ls[i], Ls[j]))
            mrf.add_pairwise_factor(i, j, m)
    return build, {"pairwise_rep": rep}


def small_grid(h=3, w=3, L=3, seed=0, potts=False, partition=False):
    """tests/test_repam_types.py:16-33 (+ its two partition blocks)."""
    def build(g, mrf):
        rng = np.random.default_rng(seed)
        for _ in range(h * w):
            mrf.add_unary_factor(rng.normal(size=L))
        for r in range(h):
            for c in range(w):
                i = r * w + c
                if c + 1 < w:
                    m = rng.normal(size=(L, L)) if not potts else 0.5 * (1 - np.eye(L))
                    mrf.add_pairwise_factor(i, i + 1, m)
                if r + 1 < h:
                    m = rng.normal(size=(L, L)) if not potts else 0.5 * (1 - np.eye(L))
                    mrf.add_pairwise_factor(i, i + w, m)
        if partition:
            us = mrf.unaries
            for a, b in zip(us[:4], us[1:5]):
                g.put_in_same_partition(a, b)
            for a, b in zip(us[5:], us[6:]):
                g.put_in_same_partition(a, b)
    return build, {"pairwise_rep": "potts" if potts else "dense"}


def chain(n=6, L=3, seed=5):
    def build(g, mrf):
        rng = np.random.default_rng(seed)
        for _ in range(n):
            mrf.add_unary_factor(rng.normal(size=L))
        for i in range(n - 1):
            mrf.add_pairwise_factor(i, i + 1, rng.normal(size=(L, L)))
    return build, {"pairwise_rep": "dense"}


def frustrated_potts_grid(h, w, L, seed):
    """Batch-built mixed-sign Potts grid (tests/test_restricted_rounding.py:28-41)."""
    def build(g, mrf):
        rng = np.random.default_rng(seed)
        mrf.add_unary_factors(rng.normal(size=(h * w, L)) * 0.1)
        idx = np.arange(h * w).reshape(h, w)
        pairs = np.concatenate([
            np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], axis=1),
            np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], axis=1)])
        diffs = rng.choice([-1.0, 1.0], size=len(pairs)) * rng.uniform(0.5, 1.5, size=len(pairs))
        mrf.add_potts_factors(pairs, L, diffs)
    return build, {}


def twin_graphs(recipe):
    """(JAX graph, JAX constructor), (port graph, port constructor)."""
    build, kw = recipe
    out = []
    for G, M in ((JGraph, JMrf), (FactorGraph, MrfConstructor)):
        g = G()
        mrf = M(g, **kw)
        build(g, mrf)
        out.append((g, mrf))
    return out


def twin_engines(recipe, **kw):
    (gj, _), (gp, _) = twin_graphs(recipe)
    return (JEngine(gj, use_jit=False, pass_style="unrolled", **kw),
            Engine(gp, device="cpu", **kw))


def jax_numpy(tree):
    return {n: {k: np.asarray(v) for k, v in b.items()} for n, b in tree.items()}


def assert_trees_close(a, b, atol=STATE_TOL):
    assert a.keys() == b.keys()
    for n in a:
        assert a[n].keys() == b[n].keys(), n
        for k in a[n]:
            x, y = np.asarray(a[n][k]), np.asarray(b[n][k])
            assert x.shape == y.shape, (n, k)
            if np.issubdtype(x.dtype, np.floating):
                np.testing.assert_allclose(x, y, rtol=0, atol=atol, err_msg=f"{n}.{k}")
            else:
                np.testing.assert_array_equal(x, y, err_msg=f"{n}.{k}")


def assert_engines_match(je, pe):
    assert abs(je.lower_bound() - pe.lower_bound()) < LB_TOL
    assert_trees_close(jax_numpy(je.state), engine_state_to_numpy(pe.state))


def jdir(d):
    return JDirection.forward if d == Direction.forward else JDirection.backward


# ---------------------------------------------------------------------------
# structure and dtypes
# ---------------------------------------------------------------------------
def test_built_blocks_match_jax_and_keep_integer_lanes():
    je, pe = twin_engines(random_mrf(42))
    assert_engines_match(je, pe)
    assert pe.state["unary_simplex"]["c"].dtype == torch.float64
    assert pe.state["unary_simplex"]["nl"].dtype == torch.int32
    assert pe.state["pairwise_simplex"]["n1"].dtype == torch.int32
    assert float(pe.state["unary_simplex"]["c"].max()) == 1e20    # padded lanes
    for d in (Direction.forward, Direction.backward):
        assert je.phases[jdir(d)] == pe.phases[d]
        assert list(je.orders[jdir(d)]) == list(pe.orders[d])


@pytest.mark.parametrize("shape", [(7, 4), (7, 3, 3), (7, 2, 1, 5), (7, 1)])
def test_flat_row_gather_equals_row_gather(shape):
    """The element gather that narrow rows take on CUDA returns t[idx]."""
    from lp_mp_tpu_torch.engine import _flat_rows
    t = torch.arange(int(np.prod(shape)), dtype=torch.float64).reshape(shape)
    idx = torch.tensor([6, 0, 0, 3, 6, 1])
    assert torch.equal(_flat_rows(t, idx), t[idx])
    assert _flat_rows(t, idx[:0]).shape == (0,) + shape[1:]


def test_float32_engine_keeps_pad_lanes():
    """PAD_COST = 1e20 is finite in float32; mask_pad's PAD_COST/2 test keeps
    padded lanes out of every update."""
    (_, _), (gp, _) = twin_graphs(random_mrf(42))
    e = Engine(gp, dtype=torch.float32, device="cpu")
    pad = e.state["unary_simplex"]["c"] >= 1e19
    assert pad.any()
    for _ in range(3):
        e.compute_pass("anisotropic")
    c = e.state["unary_simplex"]["c"]
    assert torch.equal(c[pad], torch.full_like(c[pad], 1e20))
    assert torch.isfinite(c[~pad]).all() and (c[~pad].abs() < 1e3).all()


# ---------------------------------------------------------------------------
# schedules and reparametrization modes
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("rep", ["dense", "potts"])
@pytest.mark.parametrize("smode", ["sequential", "wavefront", "coloring"])
def test_schedule_modes_match_jax(smode, rep):
    je, pe = twin_engines(random_mrf(7, n=10, extra_edges=6, rep=rep), schedule_mode=smode)
    for _ in range(3):
        je.compute_pass("anisotropic")
        pe.compute_pass("anisotropic")
        assert abs(je.lower_bound() - pe.lower_bound()) < LB_TOL
    assert_engines_match(je, pe)


@pytest.mark.parametrize("rep", ["dense", "potts"])
@pytest.mark.parametrize("mode", MODES)
def test_reparametrization_modes_match_jax(mode, rep):
    """Mirrors tests/test_engine_parity.py:46-70."""
    je, pe = twin_engines(random_mrf(42, rep=rep))
    lb = pe.lower_bound()
    for _ in range(3):
        je.compute_pass(mode)
        pe.compute_pass(mode)
        assert pe.lower_bound() >= lb - 1e-9
        lb = pe.lower_bound()
    assert_engines_match(je, pe)


@pytest.mark.parametrize("rep", ["dense", "potts"])
def test_wavefront_equals_sequential(rep):
    (_, _), (g, _) = twin_graphs(random_mrf(42, rep=rep))
    seq = Engine(g, schedule_mode="sequential", device="cpu")
    wav = Engine(g, schedule_mode="wavefront", device="cpu")
    for _ in range(3):
        seq.compute_pass("anisotropic")
        wav.compute_pass("anisotropic")
    assert_trees_close(engine_state_to_numpy(seq.state), engine_state_to_numpy(wav.state))


def test_auto_schedule_mode_threshold():
    (_, _), (g, _) = twin_graphs(chain(n=6))
    assert Engine(g, schedule_mode="auto", device="cpu").schedule_mode == "wavefront"
    h = FactorGraph()
    MrfConstructor(h).add_unary_factors(np.zeros((50_001, 2)))
    assert Engine(h, schedule_mode="auto", device="cpu").schedule_mode == "coloring"


# ---------------------------------------------------------------------------
# update modes (tests/test_repam_types.py:36-64)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("update_mode",
                         ["residual", "adaptive", "partition", "overlapping_partition"])
def test_update_modes_match_jax(update_mode):
    partition = update_mode in ("partition", "overlapping_partition")
    je, pe = twin_engines(small_grid(partition=partition), update_mode=update_mode,
                          inner_iteration=2)
    prev = pe.lower_bound()
    for _ in range(3):
        je.compute_pass("anisotropic")
        pe.compute_pass("anisotropic")
        assert abs(je.lower_bound() - pe.lower_bound()) < LB_TOL
        assert pe.lower_bound() >= prev - 1e-9
        prev = pe.lower_bound()
    assert_engines_match(je, pe)


@pytest.mark.parametrize("update_mode", ["residual", "adaptive"])
def test_update_modes_match_jax_on_padded_potts(update_mode):
    je, pe = twin_engines(random_mrf(3, n=9, extra_edges=5, rep="potts"), update_mode=update_mode)
    for _ in range(3):
        je.compute_pass("damped_uniform")
        pe.compute_pass("damped_uniform")
    assert_engines_match(je, pe)


# ---------------------------------------------------------------------------
# rounding (tests/test_restricted_rounding.py:105-137)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("recipe", [frustrated_potts_grid(4, 4, 3, seed=3),
                                    random_mrf(11, n=8, extra_edges=3)],
                         ids=["potts_grid", "random_mrf"])
@pytest.mark.parametrize("restricted", [False, True])
def test_compute_pass_and_primal_matches_jax(restricted, recipe):
    je, pe = twin_engines(recipe)
    for _ in range(2):
        je.compute_pass("anisotropic")
        pe.compute_pass("anisotropic")
    for d in (Direction.forward, Direction.backward):
        pj = je.compute_pass_and_primal("damped_uniform", jdir(d), restricted=restricted)
        pp = pe.compute_pass_and_primal("damped_uniform", d, restricted=restricted)
        assert_trees_close(jax_numpy(pj), engine_state_to_numpy(pp))
        assert_engines_match(je, pe)
        assert pe.check_primal_consistency(pp) == je.check_primal_consistency(pj)
        assert abs(je.evaluate_primal(pj) - pe.evaluate_primal(pp)) < LB_TOL
        np.testing.assert_allclose(pe.per_factor_primal_cost(pp),
                                   je.per_factor_primal_cost(pj), rtol=0, atol=1e-10)


def test_restricted_pass_leaves_dual_trajectory_unchanged():
    (_, _), (g, _) = twin_graphs(frustrated_potts_grid(4, 4, 3, seed=3))
    a, b = Engine(g, device="cpu"), Engine(g, device="cpu")
    for _ in range(2):
        pa = a.compute_pass_and_primal("damped_uniform", Direction.forward)
        pb = b.compute_pass_and_primal("damped_uniform", Direction.forward, restricted=True)
    for name in a.state:
        for k in a.state[name]:
            assert torch.equal(a.state[name][k], b.state[name][k])
    assert a.check_primal_consistency(pa) and b.check_primal_consistency(pb)
    assert np.isfinite(b.evaluate_primal(pb))


def test_primal_argmin_ties_break_like_jax():
    """All-zero costs: every argmin is a tie, broken at the first index."""
    def build(g, mrf):
        for _ in range(4):
            mrf.add_unary_factor(np.zeros(3))
        for i in range(3):
            mrf.add_pairwise_factor(i, i + 1, np.zeros((3, 3)))
    je, pe = twin_engines((build, {"pairwise_rep": "dense"}))
    pj = je.compute_pass_and_primal("damped_uniform", JDirection.forward)
    pp = pe.compute_pass_and_primal("damped_uniform", Direction.forward)
    assert_trees_close(jax_numpy(pj), engine_state_to_numpy(pp))
    assert (pp["unary_simplex"]["x"] == 0).all()


# ---------------------------------------------------------------------------
# inconsistent regions and invariants
# ---------------------------------------------------------------------------
def frustrated_cycle():
    def build(g, mrf):
        for _ in range(4):
            mrf.add_unary_factor(np.zeros(2))
        eq = np.array([[0.0, 1.0], [1.0, 0.0]])
        ne = np.array([[1.0, 0.0], [0.0, 1.0]])
        for (i, j), m in (((0, 1), eq), ((1, 2), eq), ((2, 3), eq), ((0, 3), ne)):
            mrf.add_pairwise_factor(i, j, m)
    return build, {"pairwise_rep": "dense"}


@pytest.mark.parametrize("recipe,passes,expect_any",
                         [(chain(), 10, False), (frustrated_cycle(), 20, True)],
                         ids=["chain", "frustrated_cycle"])
def test_inconsistent_mask_matches_jax(recipe, passes, expect_any):
    """Mirrors tests/test_repam_types.py:87-130."""
    je, pe = twin_engines(recipe)
    for _ in range(passes):
        je.compute_pass("anisotropic")
        pe.compute_pass("anisotropic")
    pj = je.compute_pass_and_primal("damped_uniform", JDirection.forward)
    pp = pe.compute_pass_and_primal("damped_uniform", Direction.forward)
    for rounds in (1, 3):
        mj = je.get_inconsistent_mask(pj, no_fatten_rounds=rounds)
        mp = pe.get_inconsistent_mask(pp, no_fatten_rounds=rounds)
        np.testing.assert_array_equal(mp, mj)
        assert mp.any() == expect_any
    np.testing.assert_allclose(pe.per_factor_lower_bound(), je.per_factor_lower_bound(),
                               rtol=0, atol=1e-10)


def test_total_cost_invariant():
    """Reparametrization is zero-sum (tests/test_engine_parity.py:96)."""
    je, pe = twin_engines(random_mrf(13, n=6, extra_edges=2))
    pp = pe.compute_pass_and_primal("damped_uniform", Direction.forward)
    pj = je.compute_pass_and_primal("damped_uniform", JDirection.forward)
    cost0 = pe.evaluate_primal(pp)
    for _ in range(4):
        pe.compute_pass("anisotropic")
        je.compute_pass("anisotropic")
    assert abs(cost0 - pe.evaluate_primal(pp)) < 1e-8
    assert abs(je.evaluate_primal(pj) - pe.evaluate_primal(pp)) < LB_TOL


def test_state_round_trip_through_numpy():
    """A JAX engine's state, carried into the port, continues identically;
    get_state is a snapshot that later passes leave alone."""
    je, pe = twin_engines(random_mrf(5, rep="potts"))
    for _ in range(2):
        je.compute_pass("anisotropic")
    pe.set_state(engine_state_from_numpy(jax_numpy(je.state)))
    assert_engines_match(je, pe)
    snap = pe.get_state()
    je.compute_pass("uniform")
    pe.compute_pass("uniform")
    assert_engines_match(je, pe)
    assert not torch.equal(snap["unary_simplex"]["c"], pe.state["unary_simplex"]["c"])
    back = engine_state_from_numpy(engine_state_to_numpy(snap), dtype=torch.float32)
    assert back["unary_simplex"]["c"].dtype == torch.float32
    assert back["unary_simplex"]["nl"].dtype == torch.int32


# ---------------------------------------------------------------------------
# the generic engine against the port's grid model (tests/test_grid.py:34-45)
# ---------------------------------------------------------------------------
def generic_grid_engine(u, hc, vc, batch):
    H, W, L = u.shape
    g = FactorGraph()
    mrf = MrfConstructor(g, pairwise_rep="potts")
    if batch:
        mrf.add_unary_factors(u.reshape(H * W, L))
        pairs, diffs = grid_potts_edges(hc, vc)
        mrf.add_potts_factors(pairs, L, diffs)
    else:
        for r in range(H):
            for c in range(W):
                mrf.add_unary_factor(u[r, c])
        for r in range(H):
            for c in range(W):
                if c + 1 < W:
                    mrf.add_pairwise_factor(r * W + c, r * W + c + 1, hc[r, c] * (1 - np.eye(L)))
                if r + 1 < H:
                    mrf.add_pairwise_factor(r * W + c, (r + 1) * W + c, vc[r, c] * (1 - np.eye(L)))
    return Engine(g, schedule_mode="coloring", device="cpu")


@pytest.mark.parametrize("H,W,batch", [(4, 4, False), (16, 16, True)], ids=["4x4_items", "16x16_batch"])
@pytest.mark.parametrize("mode", ["anisotropic", "uniform", "damped_uniform"])
def test_generic_engine_matches_grid_model(mode, H, W, batch):
    u, hc, vc = random_grid(H, W, 3, seed=5)
    grid = GridPottsModel(u, hc, vc, device="cpu")
    eng = generic_grid_engine(u, hc, vc, batch)
    assert len(eng.phases[Direction.forward]) == 2         # red/black
    for _ in range(4):
        grid.iterate(mode)
        eng.compute_pass(mode)
        assert abs(grid.lower_bound() - eng.lower_bound()) < 1e-10
    # the engine's blocks hold the grid model's dense state, row for row
    L = u.shape[2]
    np.testing.assert_allclose(eng.state["unary_simplex"]["c"].numpy(),
                               grid.state["u"].numpy().reshape(L, -1).T, rtol=0, atol=1e-10)


def test_grid_edges_follow_item_order():
    u, hc, vc = random_grid(3, 4, 2, seed=1)
    pairs, diffs = grid_potts_edges(hc, vc)
    expect = []
    for r in range(3):
        for c in range(4):
            if c + 1 < 4:
                expect.append((r * 4 + c, r * 4 + c + 1, hc[r, c]))
            if r + 1 < 3:
                expect.append((r * 4 + c, (r + 1) * 4 + c, vc[r, c]))
    assert [(int(i), int(j), float(d)) for (i, j), d in zip(pairs, diffs)] == \
        [(i, j, float(d)) for i, j, d in expect]


# ---------------------------------------------------------------------------
# batch construction (tests/test_scan_pass.py:64-125, the non-scan part)
# ---------------------------------------------------------------------------
def _grid_pairs(H, W):
    idx = np.arange(H * W).reshape(H, W)
    return np.concatenate([
        np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], axis=1),
        np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], axis=1)])


@pytest.mark.parametrize("potts", [True, False])
def test_batch_construction_equals_item_construction(potts):
    from lp_mp_tpu import Solver as JSolver, StandardVisitor as JVisitor
    from lp_mp_tpu_torch import Solver, StandardVisitor
    from lp_mp_tpu_torch.models.mrf import mrf_labeling
    rng = np.random.default_rng(5)
    H, W, L = 5, 4, 3
    un = rng.normal(size=(H * W, L))
    pairs = _grid_pairs(H, W)
    diffs = rng.uniform(0.2, 1.0, size=len(pairs))
    dense = rng.normal(size=(len(pairs), L, L))

    def batch(s, ctor_cls):
        c = s.add_constructor(ctor_cls)
        c.add_unary_factors(un)
        if potts:
            c.add_potts_factors(pairs, L, diffs)
        else:
            c.add_pairwise_factors(pairs, dense)
        return c

    s_b = Solver(visitor=StandardVisitor(max_iter=10), device="cpu")
    c_b = batch(s_b, MrfConstructor)
    s_i = Solver(visitor=StandardVisitor(max_iter=10), device="cpu")
    c_i = s_i.add_constructor(MrfConstructor, pairwise_rep="potts" if potts else "dense")
    for u in un:
        c_i.add_unary_factor(u)
    for k, (i, j) in enumerate(pairs):
        c_i.add_pairwise_factor(int(i), int(j), diffs[k] * (1.0 - np.eye(L)) if potts else dense[k])
    s_j = JSolver(visitor=JVisitor(max_iter=10), use_jit=False, pass_style="unrolled")
    batch(s_j, JMrf)

    lb_b, lb_i, lb_j = s_b.solve(), s_i.solve(), s_j.solve()
    assert abs(lb_b - lb_i) < 1e-9 and abs(lb_b - lb_j) < LB_TOL
    assert abs(s_b.primal_cost() - s_i.primal_cost()) < 1e-9
    assert abs(s_b.primal_cost() - s_j.primal_cost()) < LB_TOL
    # batch constructor keeps working per-item views
    assert len(c_b.unaries) == H * W
    assert set(map(tuple, pairs.tolist())) == set(c_b.pairwise)
    assert mrf_labeling(c_b, s_b.engine, s_b.best_primal).shape == (H * W,)


def test_mixed_item_then_batch_construction():
    """Interleaving per-item and batch adds yields one consistent graph."""
    def build(g, c):
        rng = np.random.default_rng(9)
        L = 3
        c.add_unary_factor(rng.normal(size=L))
        c.add_unary_factors(rng.normal(size=(4, L)))
        c.add_unary_factor(rng.normal(size=L))
        c.add_pairwise_factor(0, 1, rng.normal(size=(L, L)))
        c.add_potts_factors(np.array([[1, 2], [3, 4]]), L, np.array([0.5, 0.7]))
        c.add_pairwise_factor(4, 5, rng.normal(size=(L, L)))
    je, pe = twin_engines((build, {}))
    for _ in range(3):
        je.compute_pass("anisotropic")
        pe.compute_pass("anisotropic")
    assert_engines_match(je, pe)
    pp = pe.compute_pass_and_primal("damped_uniform", Direction.forward)
    assert np.isfinite(pe.evaluate_primal(pp)) and pe.lower_bound() <= pe.evaluate_primal(pp) + 1e-9
