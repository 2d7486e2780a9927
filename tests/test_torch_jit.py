"""The port's captured execution (``lp_mp_tpu_torch.capture``, ``use_jit``)
on the CPU, where the same buffer logic runs around direct calls.

(a) Capturability: every function the port captures runs once in float64
    under a dispatch mode that fails on the operations a CUDA graph cannot
    hold (a sync with the host or a copy of host data: ``.item()``,
    ``nonzero``, ``unique``, ``masked_select``, ``torch.tensor`` of host
    values, boolean indexing), for every model family and entry point.
(b) Parity: ``use_jit=True`` against ``use_jit=False``, bit-equal states,
    bounds and primals after 5 passes in every update mode, for the primal
    and restricted passes, the sharded engine, both grid models and the
    trees.
(c) The port's ``Solver(use_jit=True)`` against the JAX package's
    ``Solver(use_jit=True)`` on small instances, bounds within 1e-9; the
    adaptive update mode against the JAX package's eager engine (rounding
    noise at zero improvement switches its weights, ROADMAP queue 3).
(d) Ownership: the state lives in fixed buffers that each pass
    overwrites; ``get_state``, ``set_state``, ``snapshot``/``restore``,
    ``Solver.build_engine`` and ``AuxPasses.fold_into`` keep their promises.
Every entry point is built on the CPU (``device="cpu"``, ``devices=["cpu"] * k``).
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from lp_mp_tpu import Solver as JSolver, StandardTighteningVisitor as JTVisitor
from lp_mp_tpu import StandardVisitor as JVisitor
from lp_mp_tpu.models.graph_matching import GraphMatchingConstructor as JGM
from lp_mp_tpu.models.mrf import MrfConstructor as JMrf
from lp_mp_tpu.models.multicut import MulticutConstructor as JMulticut
from lp_mp_tpu.models.tomography import DiscreteTomographyConstructor as JDT
from lp_mp_tpu_torch import (ChainDecomposition, Direction, DiscreteTomographyConstructor,
                             Engine, FactorGraph, GeneralTreeDecomposition,
                             GraphMatchingConstructor, GridPottsModel, MrfConstructor,
                             MulticutConstructor, ShardedEngine, ShardedGridPotts, Solver,
                             StandardTighteningVisitor, StandardVisitor, random_grid, restore,
                             snapshot)
from lp_mp_tpu_torch import capture
from lp_mp_tpu_torch.convert import engine_state_to_numpy
from lp_mp_tpu_torch.factors.simplex import UNARY_SIMPLEX
from lp_mp_tpu_torch.messages.vector_equality import VECTOR_EQUALITY
from lp_mp_tpu_torch.trees import chain_tree_messages
from lp_mp_tpu_torch.trees_general import TreeSpec
from tests.test_torch_engine import chain, random_mrf, small_grid, twin_graphs
from tests.test_torch_graph_matching import random_instance
from tests.test_torch_tightening import absorb_rounds, real_grid8
from tests.test_torch_trees_general import mixed_star, potts_chain
from tests.test_torch_vector_equality import ring

UPDATE_MODES = ["shared", "residual", "adaptive", "partition", "overlapping_partition"]
POTTS = 1.0 - np.eye(3)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------
class HostSync(AssertionError):
    pass


class NoHostSync(TorchDispatchMode):
    """Fails on every operation that would break a CUDA graph capture."""

    FORBIDDEN = ("aten::_local_scalar_dense", "aten::nonzero", "aten::masked_select",
                 "aten::lift_fresh", "aten::_unique", "aten::unique")
    INDEXING = ("aten::index", "aten::index_put", "aten::index_put_", "aten::_index_put_impl_")

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.name().split(".")[0]
        if name.startswith(self.FORBIDDEN):
            raise HostSync(f"{name} inside a captured function")
        if name in self.INDEXING and any(
                isinstance(t, torch.Tensor) and t.dtype == torch.bool for t in args[1]):
            raise HostSync(f"{name} with a boolean index inside a captured function")
        return func(*args, **(kwargs or {}))


@pytest.fixture
def guarded(monkeypatch):
    """Every function captured from here on runs under ``NoHostSync``, after
    one unguarded warm-up call, as a capture on the card follows its warm-up
    (lazy uploads and caches happen there); returns the list of the
    captured functions' names, one per call."""
    seen = []
    init = capture.Graphed.__init__

    def guarded_init(self, owner, fn, name, donate=()):
        warm = set()

        def run(*args, **static):
            seen.append(name)
            key = tuple(sorted(static.items()))
            if key not in warm:
                warm.add(key)
                fn(*args, **static)
            with NoHostSync():
                return fn(*args, **static)
        init(self, owner, run, name, donate)
    monkeypatch.setattr(capture.Graphed, "__init__", guarded_init)
    return seen


def port_graph(recipe):
    return twin_graphs(recipe)[1]


def states_equal(a, b):
    """Bit-equal trees of tensors (dicts and lists)."""
    la, sa = capture.flatten(a)
    lb, sb = capture.flatten(b)
    return sa == sb and all(x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def numpy_tree(state):
    return {n: {k: v.clone() for k, v in b.items()} for n, b in state.items()}


def run_engine(e, n=5, mode="anisotropic"):
    for _ in range(n):
        e.compute_pass(mode)
    return e


def tightened_multicut(S, M, **kw):
    """A 5-cycle with a chord, its two triangles as triplets, and an odd
    3-wheel on top (every multicut factor and message type)."""
    s = S(**kw)
    mc = s.add_constructor(M)
    rng = np.random.default_rng(7)
    pairs = [(0, 1), (1, 2), (2, 3), (3, 4), (0, 4), (0, 2), (0, 3), (1, 3)]
    mc.add_edges(np.asarray(pairs), rng.normal(size=len(pairs)) - 0.3)
    mc.add_triplet(0, 1, 2)
    mc.add_triplet(0, 2, 3)
    mc.add_odd_3_wheel(0, 1, 2, 3)
    return s, mc


# ---------------------------------------------------------------------------
# the wrapper itself
# ---------------------------------------------------------------------------
def test_wrapper_buffers_copies_and_records():
    jit = capture.Graphs("cpu", name="t")
    calls = []

    def step(state, k):
        calls.append(k)
        return {"x": state["x"] * 2 + k}, state["x"].sum()

    g = jit.jit(step, "step", donate=(0,))
    x0 = torch.arange(3.0)
    new, total = g({"x": x0}, k=1)
    assert torch.equal(x0, torch.arange(3.0))               # the caller's tensor is not written
    assert jit.owns(new["x"]) and float(total) == 3.0
    buf = new["x"]
    new2, _ = g(new, k=1)                                    # the buffer itself: no copy in
    assert new2["x"] is buf and torch.equal(buf, torch.tensor([3.0, 7.0, 11.0]))
    total.add_(100.0)                                         # outputs are the caller's own
    _, total3 = g({"x": torch.zeros(3)}, k=1)                 # another tensor: copied in
    assert float(total3) == 0.0 and torch.equal(buf, torch.ones(3))
    g({"x": torch.zeros(3)}, k=2)                             # a static argument is a new key
    g({"x": torch.zeros(4)}, k=1)                             # so is a shape
    st = jit.stats()
    assert (st["graphs"], st["captures"], st["replays"]) == (3, 3, 5)
    assert calls == [1, 1, 1, 2, 1]
    jit.reset()
    assert jit.stats()["graphs"] == 0 and not jit.owns(buf)

    bad = jit.jit(lambda s: ({"x": s["x"][:2]}, None), "bad", donate=(0,))
    with pytest.raises(ValueError, match="bad"):
        bad({"x": torch.zeros(3)})
    off = capture.Graphs("cpu", enabled=False)
    x = torch.zeros(2)
    assert off.jit(lambda t: (t + 1, None), "f", donate=(0,))(x)[0] is not x
    assert off.adopt({"x": x})["x"] is x and not off.owns(x)


def test_assign_copies_into_owned_buffers():
    jit = capture.Graphs("cpu")
    cur = jit.adopt({"a": {"c": torch.zeros(2), "n": torch.zeros(2, dtype=torch.int32)}})
    buf = cur["a"]["c"]
    new = jit.assign(cur, {"a": {"c": torch.ones(2), "n": torch.ones(2, dtype=torch.int64)}})
    assert new["a"]["c"] is buf and torch.equal(buf, torch.ones(2))
    assert new["a"]["n"].dtype == torch.int64              # another dtype is taken as it is


# ---------------------------------------------------------------------------
# (a) capturability
# ---------------------------------------------------------------------------
def engine_calls(e, primal=True):
    for mode in ("anisotropic", "uniform"):
        e.compute_pass(mode)
    if primal:
        for d in Direction:
            p = e.compute_pass_and_primal("damped_uniform", d)
            p = e.compute_pass_and_primal("damped_uniform", d, restricted=True)
        e.evaluate_primal(p)
        e.check_primal_consistency(p)
    e.lower_bound()


@pytest.mark.parametrize("update_mode", UPDATE_MODES)
def test_engine_functions_capturable(guarded, update_mode):
    recipes = [small_grid(3, 3, 3, seed=1, partition=True),
               small_grid(3, 3, 3, seed=2, potts=True, partition=True)]
    if update_mode == "shared":
        recipes.append(random_mrf(4, rep="potts"))
    for recipe in recipes:
        engine_calls(Engine(port_graph(recipe)[0], update_mode=update_mode, device="cpu"))
    kinds = {"primal pass", "restricted pass", "lower bound", "evaluate_primal",
             "primal consistency"}
    if update_mode in ("partition", "overlapping_partition"):
        kinds.add("sub-pass")
    if update_mode != "partition":        # a partition pass is its sub-passes only
        kinds.add("dual pass")
    assert all(any(k in name for name in guarded) for k in kinds), set(guarded)


def test_model_family_functions_capturable(guarded):
    s, _ = tightened_multicut(Solver, MulticutConstructor, device="cpu")
    s.build_engine()
    engine_calls(s.engine)
    s = Solver(device="cpu")                     # W5 and its odd 5-wheel factor
    mc = s.add_constructor(MulticutConstructor)
    rim = [1, 2, 3, 4, 5]
    for i, v in enumerate(rim):
        mc.add_edge(0, v, 1.0)
        mc.add_edge(v, rim[(i + 1) % 5], -1.0)
    mc.add_odd_wheel_k(0, rim)
    s.build_engine()
    engine_calls(s.engine)
    assert any(name.startswith("multicut_wheel") for name in s.engine.state)
    s = Solver(visitor=StandardVisitor(max_iter=4, primal_computation_interval=2),
               device="cpu")
    s.add_constructor(GraphMatchingConstructor, construction="both").construct(
        random_instance(1))
    s.solve()
    engine_calls(s.engine)
    s = Solver(visitor=StandardVisitor(max_iter=4, primal_computation_interval=2),
               device="cpu")
    dt = s.add_constructor(DiscreteTomographyConstructor)
    rng = np.random.default_rng(2)
    for _ in range(4):
        dt.add_unary_factor(rng.normal(size=3))
    for i in range(3):
        dt.add_pairwise_factor(i, i + 1, 0.4 * POTTS)
    dt.add_projection(list(range(4)), rng.normal(size=9))
    s.solve()
    engine_calls(s.engine)
    engine_calls(Engine(ring(FactorGraph, UNARY_SIMPLEX, VECTOR_EQUALITY), device="cpu"))
    assert len({n for n in guarded if "dual pass" in n}) >= 2


def test_aux_and_sharded_functions_capturable(guarded):
    # multicut triplets on a complete graph's edges: absorbed by the aux pass
    s = Solver(device="cpu")
    mc = s.add_constructor(MulticutConstructor)
    rng = np.random.default_rng(21)
    pairs = np.asarray([(i, j) for i in range(5) for j in range(i + 1, 5)])
    mc.add_edges(pairs, rng.normal(size=len(pairs)))
    s.build_engine()
    run_engine(s.engine, 5)
    n0, m0 = s.graph.n_factors, len(s.graph.messages)
    assert mc.tighten_cycles(s.engine, max_constraints=10)
    assert s.aux.absorb(s.graph, s.engine, n0, m0)
    for _ in range(3):
        s.engine.compute_pass("anisotropic")
        s.aux.run(s.engine)
    s.aux.lower_bound()
    s.register_primal(mc.compute_primal(s.engine))
    # MRF triplets on an 8-connected grid's pairwise factors, by hand
    s2 = Solver(visitor=StandardVisitor(max_iter=3, primal_computation_interval=2),
                device="cpu")
    mrf = s2.add_constructor(MrfConstructor, pairwise_rep="dense")
    real_grid8(mrf, H=4, W=4)
    s2.solve()
    absorb_rounds(s2, mrf, rounds=2, per_round=3, passes=2)
    s2.aux.evaluate_primal(s2.engine, s2.engine.compute_pass_and_primal(
        "anisotropic", Direction.forward))
    assert s.aux.mc.n > 0 and s2.aux.mrf.n > 0 and s2.n_engine_builds == 1
    for t in ("multicut_triplet", "ternary_simplex"):
        for f in ("cluster update", "evaluate_primal", "lower bound"):
            assert f"aux {t}: {f}" in guarded, (t, f)

    g, _ = port_graph(small_grid(3, 3, 3, seed=3))
    e = ShardedEngine(g, devices=["cpu"] * 2)
    e.compute_pass("anisotropic")
    p = e.compute_pass_and_primal("damped_uniform", Direction.forward)
    e.lower_bound()
    e.evaluate_primal(p)
    assert {"ShardedEngine: dual pass forward anisotropic", "ShardedEngine: lower bound",
            "ShardedEngine: primal pass forward damped_uniform"} <= set(guarded)


def test_tree_and_grid_functions_capturable(guarded):
    g, mrf = port_graph(small_grid(3, 4, 3, seed=5))
    dec = ChainDecomposition.from_mrf(mrf, device="cpu")
    dec.subgradient_ascent(n_iter=3)
    dec.fw_map(n_outer=1, n_inner=2)
    for inst in (mixed_star, potts_chain):
        gg, trees = inst()[:2]
        GeneralTreeDecomposition(gg, trees, device="cpu").subgradient_ascent(n_iter=2)
    u, hc, vc = random_grid(5, 6, 3, seed=1)
    m = GridPottsModel(u, hc, vc, device="cpu")
    m.iterate("uniform")
    for kernel in ("torch", "cuda"):
        m.run_fast(3, kernel=kernel)
    m.lower_bound()
    m.round_primal()
    sm = ShardedGridPotts(u, hc, vc, devices=["cpu"] * 2)
    sm.run_fast(3)
    sm.run_fast(1, "damped_uniform")
    sm.iterate()
    sm.lower_bound()
    sm.round_primal()
    names = set(guarded)
    for want in ("ChainDecomposition: solve", "ChainDecomposition: project",
                 "GeneralTreeDecomposition: solve", "GridPottsModel: iterate",
                 "GridPottsModel: run_fast", "GridPottsModel: lower bound",
                 "GridPottsModel: round_primal", "ShardedGridPotts: lower bound",
                 "ShardedGridPotts: round_primal", "ShardedGridPotts: sweep round_update_sharded",
                 "ShardedGridPotts: sweep phase_update_sharded_ref"):
        assert any(n.startswith(want) for n in names), want


# ---------------------------------------------------------------------------
# (b) use_jit=True against use_jit=False, bit for bit
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("update_mode", UPDATE_MODES)
def test_engine_parity_every_update_mode(update_mode):
    recipe = small_grid(3, 3, 3, seed=8, partition=True)
    on, off = (Engine(port_graph(recipe)[0], update_mode=update_mode, device="cpu",
                      use_jit=j) for j in (True, False))
    for e in (on, off):
        run_engine(e, 5)
    assert states_equal(on.state, off.state)
    assert on.lower_bound() == off.lower_bound()
    for restricted in (False, True):
        for d in Direction:
            pa = on.compute_pass_and_primal("damped_uniform", d, restricted=restricted)
            pb = off.compute_pass_and_primal("damped_uniform", d, restricted=restricted)
            assert states_equal(pa, pb) and states_equal(on.state, off.state)
            assert on.evaluate_primal(pa) == off.evaluate_primal(pb)
    assert on.jit.stats()["captures"] > 0 and off.jit.stats()["captures"] == 0


def test_sharded_and_tree_parity():
    g = [port_graph(small_grid(3, 4, 3, seed=9))[0] for _ in range(2)]
    on, off = (ShardedEngine(gg, devices=["cpu"] * 2, use_jit=j) for gg, j in zip(g, (True, False)))
    for e in (on, off):
        run_engine(e, 5)
    assert states_equal(on.state, off.state) and on.lower_bound() == off.lower_bound()
    assert states_equal(on.compute_pass_and_primal("damped_uniform", Direction.backward),
                        off.compute_pass_and_primal("damped_uniform", Direction.backward))

    mrfs = [port_graph(small_grid(3, 4, 3, seed=10))[1] for _ in range(2)]
    a, b = (ChainDecomposition.from_mrf(m, device="cpu", use_jit=j)
            for m, j in zip(mrfs, (True, False)))
    ra, rb = a.subgradient_ascent(n_iter=5), b.subgradient_ascent(n_iter=5)
    assert ra[0] == rb[0] and ra[2] == rb[2] and torch.equal(ra[1], rb[1])
    fa, fb = a.fw_map(n_outer=2, n_inner=2), b.fw_map(n_outer=2, n_inner=2)
    assert fa[2] == fb[2]
    da, db = (GeneralTreeDecomposition(*mixed_star()[:2], device="cpu", use_jit=j)
              for j in (True, False))
    sa, sb = da.subgradient_ascent(n_iter=4), db.subgradient_ascent(n_iter=4)
    assert sa[2] == sb[2]
    assert states_equal(da.solve(sa[1])[1:], db.solve(sb[1])[1:])


def test_grid_model_parity():
    u, hc, vc = random_grid(6, 7, 3, seed=2)
    for kernel in ("torch", "cuda"):
        on, off = (GridPottsModel(u, hc, vc, device="cpu", use_jit=j) for j in (True, False))
        for m in (on, off):
            m.iterate("anisotropic", n=2).run_fast(5, kernel=kernel)
            m.run_fast(2, "damped_uniform", kernel=kernel)
        assert states_equal(on.state, off.state) and on.lower_bound() == off.lower_bound()
        xa, ua = on.round_primal()
        xb, ub = off.round_primal()
        assert ua == ub and np.array_equal(xa, xb) and states_equal(on.state, off.state)
    on, off = (ShardedGridPotts(u, hc, vc, devices=["cpu"] * 3, use_jit=j) for j in (True, False))
    for m in (on, off):
        m.run_fast(5).run_fast(1, "uniform").iterate()
    assert states_equal(on.windows, off.windows) and on.lower_bound() == off.lower_bound()
    (xa, ua), (xb, ub) = on.round_primal(), off.round_primal()
    assert ua == ub and np.array_equal(xa, xb)


# ---------------------------------------------------------------------------
# (c) the port's Solver(use_jit=True) against the JAX package's
# ---------------------------------------------------------------------------
def jax_and_port(S_kw, build, jax_jit=True):
    """(JAX solver, port solver) over ``build(solver, package)``."""
    out = []
    for pkg in ("jax", "port"):
        if pkg == "jax":
            kw = dict(use_jit=True) if jax_jit else dict(use_jit=False, pass_style="unrolled")
            s = JSolver(visitor=S_kw["visitor"][0](**S_kw["vkw"]), **kw, **S_kw.get("kw", {}))
        else:
            s = Solver(visitor=S_kw["visitor"][1](**S_kw["vkw"]), device="cpu", use_jit=True,
                       **S_kw.get("kw", {}))
        build(s, pkg)
        out.append(s)
    return out


def assert_bounds(sj, sp, tol=1e-9):
    lj, lp = sj.solve(), sp.solve()
    assert abs(lj - lp) <= tol * max(1.0, abs(lj)), (lj, lp)
    assert abs(sj.primal_cost() - sp.primal_cost()) <= tol * max(1.0, abs(sj.primal_cost()))


def test_solver_matches_jitted_jax_mrf_and_multicut():
    def mrf(s, pkg):
        build, kw = random_mrf(21, n=8, extra_edges=4)
        build(s.graph, s.add_constructor(JMrf if pkg == "jax" else MrfConstructor, **kw))
    plain = dict(visitor=(JVisitor, StandardVisitor),
                 vkw=dict(max_iter=6, primal_computation_interval=3))
    assert_bounds(*jax_and_port(plain, mrf))

    def multicut(s, pkg):
        mc = s.add_constructor(JMulticut if pkg == "jax" else MulticutConstructor)
        rng = np.random.default_rng(4)          # tests/test_torch_multicut.py's 5 x 5 grid
        idx = np.arange(25).reshape(5, 5)
        pairs = np.concatenate([np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], axis=1),
                                np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], axis=1)])
        mc.add_edges(pairs, rng.normal(loc=0.4, size=len(pairs)))
    tight = dict(visitor=(JTVisitor, StandardTighteningVisitor),
                 vkw=dict(max_iter=6, tighten=True, tighten_iteration=3, tighten_interval=5,
                          tighten_constraints_max=20, primal_computation_interval=4))
    sj, sp = jax_and_port(tight, multicut)
    assert_bounds(sj, sp)
    assert sp.n_captures > 0 and len(sp.graph.factors) > 65       # triplets were added


def test_solver_matches_jitted_jax_qap_and_tomography():
    def qap(s, pkg):
        s.add_constructor(JGM if pkg == "jax" else GraphMatchingConstructor,
                          construction="left").construct(random_instance(2))
    kw = dict(visitor=(JVisitor, StandardVisitor), vkw=dict(max_iter=6),
              kw=dict(schedule_mode="auto"))
    assert_bounds(*jax_and_port(kw, qap))

    def tomo(s, pkg):
        dt = s.add_constructor(JDT if pkg == "jax" else DiscreteTomographyConstructor)
        rng = np.random.default_rng(3)
        for _ in range(4):
            dt.add_unary_factor(rng.normal(size=3))
        for i in range(3):
            dt.add_pairwise_factor(i, i + 1, 0.4 * POTTS)
        dt.add_projection(list(range(4)), rng.normal(size=9) * 2.0)
    assert_bounds(*jax_and_port(kw, tomo))


def test_solver_adaptive_matches_eager_jax():
    def mrf(s, pkg):
        build, kw = chain(n=6, L=3, seed=5)
        build(s.graph, s.add_constructor(JMrf if pkg == "jax" else MrfConstructor, **kw))
    kw = dict(visitor=(JVisitor, StandardVisitor), vkw=dict(max_iter=5),
              kw=dict(reparametrization_type="adaptive"))
    assert_bounds(*jax_and_port(kw, mrf, jax_jit=False))


# ---------------------------------------------------------------------------
# (d) ownership under use_jit=True
# ---------------------------------------------------------------------------
def test_state_ownership():
    recipe = small_grid(3, 3, 3, seed=11)
    e = run_engine(Engine(port_graph(recipe)[0], device="cpu"), 2)
    ref = run_engine(Engine(port_graph(recipe)[0], device="cpu", use_jit=False), 2)
    buf = e.state["unary_simplex"]["c"]
    snap = e.get_state()
    kept = numpy_tree(snap)
    run_engine(e, 3)
    assert e.state["unary_simplex"]["c"] is buf            # passes write the buffers in place
    assert states_equal(snap, kept)                        # a handed-out state stays intact
    e.set_state(snap)
    assert e.state["unary_simplex"]["c"] is buf and states_equal(e.state, kept)
    run_engine(e, 3)
    run_engine(ref, 3)
    assert states_equal(snap, kept) and states_equal(e.state, ref.state)
    s = snapshot(e)
    lb = e.lower_bound()
    run_engine(e, 2)
    restore(e, s)
    assert e.lower_bound() == lb and e.state["unary_simplex"]["c"] is buf
    restore(e, s)                                           # the snapshot stays usable
    assert e.lower_bound() == lb
    e.state = {n: dict(b) for n, b in kept.items()}        # a rebinding is copied in
    run_engine(e, 1)
    assert states_equal(kept, numpy_tree(snap)) and e.state["unary_simplex"]["c"] is buf


def test_solver_rebuild_and_fold_into_under_jit():
    def solver(use_jit):
        s = Solver(device="cpu", use_jit=use_jit)
        mc = s.add_constructor(MulticutConstructor)
        rng = np.random.default_rng(22)
        pairs = np.asarray([(i, j) for i in range(6) for j in range(i + 1, 6)])
        mc.add_edges(pairs, rng.normal(size=len(pairs)))
        s.build_engine()
        n0, m0 = s.graph.n_factors, len(s.graph.messages)
        for t in ((0, 1, 2), (2, 3, 4)):
            mc.add_triplet(*t)
        assert s.aux.absorb(s.graph, s.engine, n0, m0)
        for _ in range(5):
            s.engine.compute_pass("anisotropic")
            s.aux.run(s.engine)
        return s
    on, off = solver(True), solver(False)
    assert on.engine.lower_bound() + on.aux.lower_bound() == \
        off.engine.lower_bound() + off.aux.lower_bound()
    old = on.engine
    before = engine_state_to_numpy(old.state)
    captures = on.n_captures
    for s in (on, off):
        s.build_engine()                                    # folds the absorbed triplets
        assert not bool(s.aux) and s.n_engine_builds == 2
    after = engine_state_to_numpy(old.state)
    assert all(np.array_equal(before[n][k], after[n][k]) for n in before for k in before[n])
    assert states_equal(on.engine.state, off.engine.state)
    for s in (on, off):
        run_engine(s.engine, 3)
    assert states_equal(on.engine.state, off.engine.state)
    assert on.n_captures > captures and on.capture_seconds == 0.0   # no CUDA capture here
    assert off.n_captures == 0


def test_tree_solver_under_jit():
    def solver(use_jit):
        g, mrf = port_graph(small_grid(3, 4, 3, seed=12))
        s = Solver(visitor=StandardVisitor(max_iter=6, primal_computation_interval=2),
                   device="cpu", use_jit=use_jit)
        s.graph, s.constructors = g, [mrf]
        dec = ChainDecomposition.from_mrf(mrf, device="cpu")
        s.tree_decomposition = [TreeSpec(m) for m in chain_tree_messages(g, mrf, dec.chains)]
        s.tree_decomposition_begin = 3
        return s
    on, off = solver(True), solver(False)
    assert on.solve() == off.solve()
    assert on.primal_cost() == off.primal_cost()
    assert states_equal(on.engine.state, off.engine.state)


def test_sharded_kernels_write_into_out():
    """The sharded wrappers write into given output windows (ShardedGridPotts'
    sweeps swap two window sets that way) and return them."""
    from lp_mp_tpu_torch.kernel_check import random_dense_state
    from lp_mp_tpu_torch.ops.grid_kernels import phase_update_sharded, round_update_sharded
    from lp_mp_tpu_torch.parallel.grid import RowShards
    state, hc, vc = random_dense_state(9, 7, 3, seed=4, dtype=torch.float64)
    lay = RowShards(9, 7, ["cpu"] * 2)
    w, c = lay.split(state), lay.split_costs(hc, vc)
    args = (w[1], lay.slabs(w)[1], c[1]["hc"], c[1]["vc"], lay.slabs(c)[1], lay.row0[1], 9, 7)
    for kern, params in ((phase_update_sharded, (1, 1, 0.0)), (round_update_sharded, (2,))):
        out = {k: torch.full_like(v, float("nan")) for k, v in w[1].items()}
        got = kern(*args, *params, out=out)
        assert got is out and states_equal(out, kern(*args, *params))
