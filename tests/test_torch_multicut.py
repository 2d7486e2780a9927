"""The multicut model family in the port against the JAX package, on the CPU
in float64.

Mirrors tests/test_multicut.py (factor bounds, BFS paths, graph
enumeration, cycle tightening, GAEC), tests/test_odd_wheels_general.py
(all but the LP-export test, whose oracles are not ported: wheel configs
against partition enumeration, bounds and marginals against brute force,
the W5 instance through separation and through ``Solver``) and the
multicut half of tests/test_aux_tighten.py (absorbed triplets need no
rebuild; fold-into keeps the bound).  Parity with the JAX package: every
batched function of every multicut factor and message type (bounds,
marginals, restricted marginals, scatters with duplicate indices, primal
propagation and consistency) to 1e-12 absolute and 1e-14 relative on
seeded random inputs (restricted marginals to 1e-14 * RESTRICT_BIG); the aux
multicut pass after the same absorbed triplets; and ``Solver.solve()``
with cycle tightening and GAEC rounding on a real-valued grid, with the
same triplets, bounds to 1e-9 and equal primals.  The JAX side runs
eagerly (``use_jit=False, pass_style="unrolled"``).
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lp_mp_tpu.factors.multicut as jf
import lp_mp_tpu.messages.multicut as jm
import lp_mp_tpu_torch.factors.multicut as pf
import lp_mp_tpu_torch.messages.multicut as pm
from lp_mp_tpu import Solver as JSolver, StandardTighteningVisitor as JTVisitor
from lp_mp_tpu.models.multicut import MulticutConstructor as JMulticut
from lp_mp_tpu.utils.graphs import Graph as JGraph, bfs_path as j_bfs_path
from lp_mp_tpu_torch import (Engine, MulticutConstructor, Solver, StandardTighteningVisitor,
                             aux_state_from_numpy, aux_state_to_numpy, engine_state_to_numpy,
                             native)
from lp_mp_tpu_torch.registry import RESTRICT_BIG
from lp_mp_tpu_torch.utils.graphs import Graph, bfs_path
from lp_mp_tpu_torch.utils.union_find import UnionFind
from tests.test_torch_engine import assert_trees_close, jax_numpy

# absolute, plus 1e-14 relative: restricted marginals carry RESTRICT_BIG
# (1e9) terms, summed in another order by the wheel's matmul and einsum;
# where two such sums cancel, the result is held to 1e-14 * RESTRICT_BIG
TOL, REL, LB_TOL = 1e-12, 1e-14, 1e-9
RESTRICTED_TOL = 1e-14 * RESTRICT_BIG


def t64(a):
    return torch.from_numpy(np.array(a))


def close(j, p, tol=TOL):
    j, p = np.asarray(j), p.detach().cpu().numpy()
    assert j.shape == p.shape
    if np.issubdtype(j.dtype, np.floating):
        np.testing.assert_allclose(p, j, rtol=REL, atol=tol)
    else:
        np.testing.assert_array_equal(p, j)


def close_tree(j, p):
    assert j.keys() == p.keys()
    for k in j:
        close(j[k], p[k])


# ---------------------------------------------------------------------------
# factor and message types against the JAX ones
# ---------------------------------------------------------------------------
def _wheel_pair(k):
    return jf.wheel_k_type(k), pf.wheel_k_type(k)


FACTORS = {"edge": (jf.MULTICUT_EDGE, pf.MULTICUT_EDGE),
           "triplet": (jf.MULTICUT_TRIPLET, pf.MULTICUT_TRIPLET),
           "odd_wheel": (jf.MULTICUT_ODD_WHEEL, pf.MULTICUT_ODD_WHEEL),
           "wheel_k3": _wheel_pair(3), "wheel_k5": _wheel_pair(5)}
MESSAGES = {f"edge_triplet_{s}": (getattr(jm, f"MULTICUT_EDGE_TRIPLET_{s}"),
                                  getattr(pm, f"MULTICUT_EDGE_TRIPLET_{s}")) for s in range(3)}
MESSAGES.update({f"edge_wheel_{s}": (jm.MULTICUT_EDGE_WHEEL[s], pm.MULTICUT_EDGE_WHEEL[s])
                 for s in range(6)})
for _k in (3, 5):
    MESSAGES[f"edge_wheel_k{_k}"] = (jm.wheel_k_message(_k), pm.wheel_k_message(_k))
    MESSAGES[f"triplet_wheel_k{_k}"] = (jm.triplet_wheel_k_message(_k),
                                        pm.triplet_wheel_k_message(_k))


def kind_of(ftype):
    name = ftype.name
    if name.startswith("multicut_wheel_k"):
        return "wheel_k" + name[len("multicut_wheel_k"):]
    return name[len("multicut_"):]


def random_block(rng, kind, F):
    if kind == "edge":
        return {"c": rng.normal(size=F)}
    if kind == "triplet":
        return {"c": rng.normal(size=(F, 4))}
    if kind == "odd_wheel":
        return {"c": rng.normal(size=(F, 14))}
    k = int(kind[len("wheel_k"):])
    return {"sp": rng.normal(size=(F, k)), "rim": rng.normal(size=(F, k)),
            "tri": rng.normal(size=(F, k, 4)) * 0.5}


def random_primal(rng, kind, F):
    """Bits in {-1, 0, 1}; half the rows a valid configuration."""
    def bits(valid_rows, S):
        e = rng.integers(-1, 2, size=(F, S))
        pick = rng.integers(0, len(valid_rows), size=F)
        half = rng.random(F) < 0.5
        e[half] = valid_rows[pick[half]]
        return e.astype(np.int32)
    if kind == "edge":
        return {"x": rng.integers(-1, 2, size=F).astype(np.int32)}
    if kind == "triplet":
        e = bits(np.vstack([np.zeros((1, 3), np.int32), jf.TRIPLET_PATTERNS]), 3)
        return {f"e{s + 1}": e[:, s] for s in range(3)}
    if kind == "odd_wheel":
        e = bits(np.vstack([np.zeros((1, 6), np.int32), jf.ODD_WHEEL_PATTERNS]), 6)
        return {f"e{s + 1}": e[:, s] for s in range(6)}
    k = int(kind[len("wheel_k"):])
    return {"e": bits(jf._wheel_cut_configs(k), 2 * k)}


def twin(block):
    return {k: jnp.asarray(v) for k, v in block.items()}, {k: t64(v) for k, v in block.items()}


def test_tables_match_jax():
    np.testing.assert_array_equal(pf.TRIPLET_PATTERNS, jf.TRIPLET_PATTERNS)
    np.testing.assert_array_equal(pf.ODD_WHEEL_PATTERNS, jf.ODD_WHEEL_PATTERNS)
    for k in (3, 5, 7):
        for a, b in zip(pf._wheel_tables(k), jf._wheel_tables(k)):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(pf._wheel_cut_configs(k), jf._wheel_cut_configs(k))
        assert pf.wheel_k_type(k) is pf.wheel_k_type(k)                 # one type per k
        assert pm.wheel_k_message(k).right_type is pf.wheel_k_type(k)


@pytest.mark.parametrize("fkind", list(FACTORS))
def test_factor_type_matches_jax(fkind):
    rng = np.random.default_rng(7)
    jt, pt = FACTORS[fkind]
    items = [0.5 * i for i in range(6)] if fkind == "edge" else [None] * 6
    built, jbuilt = pt.build(items), jt.build(items)
    assert built.keys() == jbuilt.keys()
    for k in built:
        np.testing.assert_array_equal(built[k], jbuilt[k])
    jb, pb = twin(random_block(rng, fkind, 9))
    close(jt.lower_bound(jb), pt.lower_bound(pb))
    close(jt.dual_vector(jb), pt.dual_vector(pb))
    close_tree(jt.init_primal(jb), pt.init_primal(pb))
    jp, pp = twin(random_primal(rng, fkind, 9))
    close_tree(jt.compute_primal(jb, jp), pt.compute_primal(pb, pp))
    ev = pt.evaluate_primal(pb, pp)
    close(jt.evaluate_primal(jb, jp), ev)
    assert torch.isfinite(ev).any() and torch.isinf(ev).any()
    if fkind.startswith("wheel"):
        close(jt.slot_marginals(jb), pt.slot_marginals(pb))
        close(jt.tri_marginals(jb), pt.tri_marginals(pb))


def message_data(rng, name, M):
    """Per-message static data as (JAX int32, port int64)."""
    if name.startswith("edge_wheel_k"):
        k = int(name[len("edge_wheel_k"):])
        d = {"slot": rng.integers(0, 2 * k, size=M)}
    elif name.startswith("triplet_wheel_k"):
        k = int(name[len("triplet_wheel_k"):])
        pw = np.stack([rng.permutation(4) for _ in range(M)])
        d = {"slot": rng.integers(0, k, size=M), "pw": pw, "pt": np.argsort(pw, axis=1),
             "eperm": np.stack([rng.permutation(2 * k)[:3] for _ in range(M)])}
    else:
        return {}, {}
    return ({k: jnp.asarray(v.astype(np.int32)) for k, v in d.items()},
            {k: t64(v.astype(np.int64)) for k, v in d.items()})


def message_case(name, seed, M=11, F=5):
    rng = np.random.default_rng(seed)
    jmt, pmt = MESSAGES[name]
    lk, rk = kind_of(pmt.left_type), kind_of(pmt.right_type)
    c = {"mt": (jmt, pmt)}
    c["l"] = twin(random_block(rng, lk, M))
    c["r"] = twin(random_block(rng, rk, M))
    c["L"] = twin(random_block(rng, lk, F))
    c["R"] = twin(random_block(rng, rk, F))
    c["lx"] = twin(random_primal(rng, lk, M))
    c["rx"] = twin(random_primal(rng, rk, M))
    c["LX"] = twin(random_primal(rng, lk, F))
    c["RX"] = twin(random_primal(rng, rk, F))
    c["data"] = message_data(rng, name, M)
    idx = rng.integers(0, F, size=M)
    idx[:3] = idx[0]                                        # duplicates accumulate
    c["idx"] = (jnp.asarray(idx), t64(idx))
    return c


@pytest.mark.parametrize("name", list(MESSAGES))
def test_marginals_match_jax(name):
    c = message_case(name, 0)
    (jmt, pmt), (dj, dp) = c["mt"], c["data"]
    close(jmt.marginal_left(c["l"][0], dj), pmt.marginal_left(c["l"][1], dp))
    close(jmt.marginal_right(c["r"][0], dj), pmt.marginal_right(c["r"][1], dp))
    close(jmt.restricted_marginal_left(c["l"][0], c["lx"][0], dj),
          pmt.restricted_marginal_left(c["l"][1], c["lx"][1], dp), RESTRICTED_TOL)
    close(jmt.restricted_marginal_right(c["r"][0], c["rx"][0], dj),
          pmt.restricted_marginal_right(c["r"][1], c["rx"][1], dp), RESTRICTED_TOL)


@pytest.mark.parametrize("name", list(MESSAGES))
def test_repams_match_jax(name):
    """Scatters with duplicate indices; the input blocks are left alone."""
    c = message_case(name, 1)
    (jmt, pmt), (dj, dp) = c["mt"], c["data"]
    before = {k: v.clone() for k, v in c["L"][1].items()}
    for jd, pd in ((jmt.marginal_right(c["r"][0], dj), pmt.marginal_right(c["r"][1], dp)),
                   (jmt.marginal_left(c["l"][0], dj), pmt.marginal_left(c["l"][1], dp))):
        close_tree(jmt.repam_left(c["L"][0], c["idx"][0], jd, dj),
                   pmt.repam_left(c["L"][1], c["idx"][1], pd, dp))
        close_tree(jmt.repam_right(c["R"][0], c["idx"][0], -jd, dj),
                   pmt.repam_right(c["R"][1], c["idx"][1], -pd, dp))
    for k in before:
        assert torch.equal(before[k], c["L"][1][k])


@pytest.mark.parametrize("name", list(MESSAGES))
def test_primal_propagation_and_consistency_match_jax(name):
    """Writes go to distinct rows (``ridx`` a permutation, ``lidx``
    distinct), where the scatter order cannot matter."""
    rng = np.random.default_rng(2)
    c = message_case(name, 2, M=5, F=5)
    (jmt, pmt) = c["mt"]
    dj, dp = c["data"]
    lidx, ridx = rng.permutation(5), rng.permutation(5)
    if name.startswith("triplet_wheel_k"):           # distinct wheel slots within each wheel
        k = pmt.k
        for key in ("eperm",):
            e = np.stack([rng.permutation(2 * k)[:3] for _ in range(5)])
            dj, dp = {**dj, key: jnp.asarray(e.astype(np.int32))}, {**dp, key: t64(e)}
    aj = (c["LX"][0], c["RX"][0], jnp.asarray(lidx), jnp.asarray(ridx), dj)
    ap = (c["LX"][1], c["RX"][1], t64(lidx), t64(ridx), dp)
    close_tree(jmt.propagate_primal_l2r(*aj), pmt.propagate_primal_l2r(*ap))
    close_tree(jmt.propagate_primal_r2l(*aj), pmt.propagate_primal_r2l(*ap))
    close(jmt.consistent(*aj), pmt.consistent(*ap))


# ---------------------------------------------------------------------------
# tests/test_multicut.py
# ---------------------------------------------------------------------------
def test_edge_factor_lower_bound():
    for c, lb in ((1.0, 0.0), (-1.0, -1.0)):
        b = {k: t64(v) for k, v in pf.MULTICUT_EDGE.build([c]).items()}
        assert float(pf.MULTICUT_EDGE.lower_bound(b)[0]) == lb


def test_triplet_factor_lower_bound():
    assert pf.MULTICUT_TRIPLET.build([None])["c"].shape == (1, 4)
    for c, lb in (([1.0, 2.0, 3.3, 1.5], 0.0), ([1.0, -0.5, -0.3, 1.5], -0.5)):
        assert float(pf.MULTICUT_TRIPLET.lower_bound({"c": t64([c])})[0]) == lb


def test_bfs_path_thresholds():
    edges = [(0, 1, 1.0), (1, 2, 2.0), (2, 3, 2.0), (3, 0, 2.0)]
    g, gj = Graph(4, edges), JGraph(4, edges)
    bn, path = bfs_path(g, 0, 2)
    assert len(path) == 3
    bn, path = bfs_path(g, 0, 1, threshold=0.5)
    assert len(path) == 2 and bn == 1.0
    bn, path = bfs_path(g, 0, 1, threshold=1.5)
    assert len(path) == 4 and bn == 2.0
    for t in (-np.inf, 0.5, 1.5, 2.5):
        assert bfs_path(g, 0, 2, threshold=t) == j_bfs_path(gj, 0, 2, threshold=t)


def test_graph_enumeration_and_contraction():
    edges = [(0, 1, 1), (1, 2, 1), (2, 3, 1), (3, 0, 1), (0, 2, 1)]
    g, gj = Graph(4, edges), JGraph(4, edges)
    assert len(g.triangles()) == 2 and g.triangles() == gj.triangles()
    assert len(g.quadrangles()) == 1 and g.quadrangles() == gj.quadrangles()
    gc = g.contract([(0, 1)])
    assert gc.n == 3 and gc.edges == gj.contract([(0, 1)]).edges
    uf = UnionFind(5)
    uf.merge(0, 3)
    uf.merge(3, 4)
    assert uf.find(4) == uf.find(0) != uf.find(1)


def solve_multicut(edges, tighten=True, max_iter=60):
    vis = StandardTighteningVisitor(
        max_iter=max_iter, tighten=tighten, tighten_iteration=3, tighten_interval=5,
        tighten_constraints_max=10, standard_reparametrization="anisotropic",
        rounding_reparametrization="damped_uniform", primal_computation_interval=10 ** 9)
    s = Solver(visitor=vis, device="cpu")
    mc = s.add_constructor(MulticutConstructor)
    for i, j, w in edges:
        mc.add_edge(i, j, w)
    return s, mc, s.solve()


def test_triangle_negative_edge():
    edges = [(0, 1, -1.0), (1, 2, 1.0), (0, 2, 1.0)]
    s, mc, lb0 = solve_multicut(edges, tighten=False, max_iter=10)
    assert abs(lb0 + 1.0) < 1e-6
    s, mc, lb = solve_multicut(edges)
    assert abs(lb) < 1e-6, lb
    assert len(mc.triplets) == 1
    labels, cut, cost = mc.round_gaec()
    assert abs(cost) < 1e-9


def test_frustrated_four_cycle():
    s, mc, lb = solve_multicut([(0, 1, -1.0), (1, 2, 1.0), (2, 3, 1.0), (0, 3, 1.0)])
    assert abs(lb) < 1e-6, lb
    prim = mc.compute_primal(s.engine)
    assert prim["multicut_edge"]["x"].dtype == torch.int32
    assert abs(s.engine.evaluate_primal(prim)) < 1e-6


def test_gaec_merges_attractive():
    mc = Solver(device="cpu").add_constructor(MulticutConstructor)
    mc.add_edge(0, 1, 5.0)
    mc.add_edge(1, 2, 5.0)
    mc.add_edge(0, 2, -1.0)
    labels, cut, cost = mc.round_gaec()
    assert labels[0] == labels[1] == labels[2]
    assert cost == 0.0


def test_multicut_random_monotone():
    rng = np.random.default_rng(0)
    s = Solver(device="cpu")
    mc = s.add_constructor(MulticutConstructor)
    n = 8
    for i in range(n):
        for j in range(i + 1, n):
            if rng.random() < 0.5:
                mc.add_edge(i, j, float(rng.normal()))
    e = s.build_engine()
    lb = e.lower_bound()
    for _ in range(5):
        e.compute_pass("anisotropic")
        lb2 = e.lower_bound()
        assert lb2 >= lb - 1e-9
        lb = lb2
    if mc.tighten(e, 5):
        e = s.build_engine()
        assert e.lower_bound() >= lb - 1e-6
        for _ in range(10):
            e.compute_pass("anisotropic")
        assert e.lower_bound() >= lb - 1e-6


def test_odd_wheel_factor_exact():
    assert pf.ODD_WHEEL_PATTERNS.shape == (14, 6)
    c = np.random.default_rng(1).normal(size=(1, 14))
    lb = float(pf.MULTICUT_ODD_WHEEL.lower_bound({"c": t64(c)})[0])
    assert abs(lb - min(0.0, c.min())) < 1e-12


def test_odd_wheel_closes_k4_gap():
    edges = [(0, 1, -3.2), (0, 2, 4.5), (0, 3, -2.8), (1, 2, 3.8), (1, 3, -4.2), (2, 3, 2.8)]
    opt, tri_lp = -4.2, -4.65
    best = min(sum(w for (i, j, w) in edges if lbl[i] != lbl[j])
               for lbl in itertools.product(range(4), repeat=4))
    assert abs(best - opt) < 1e-9
    s, mc, lb = solve_multicut(edges, max_iter=200)
    assert len(mc.odd_wheels) >= 1, "odd-wheel separation did not fire"
    assert opt - 1e-4 <= lb <= opt + 1e-6
    assert lb > tri_lp + 0.2
    assert abs(s.engine.evaluate_primal(mc.compute_primal(s.engine)) - opt) < 1e-6


@pytest.mark.parametrize("with_native", [True, False], ids=["native", "python"])
def test_gaec_incremental_matches_bruteforce_small(with_native, monkeypatch):
    """GAEC (native, and the pure-Python heap) = exhaustive greedy."""
    if not with_native:
        monkeypatch.setattr(native, "_LIB", None)
        monkeypatch.setattr(native, "_TRIED", True)
    elif native.get_lib() is None:
        pytest.skip("no g++ to build csrc/lpmp_host.cpp")
    rng = np.random.default_rng(2)
    for trial in range(10):
        n = 7
        mc = Solver(device="cpu").add_constructor(MulticutConstructor)
        for i in range(n):
            for j in range(i + 1, n):
                if rng.random() < 0.7:
                    mc.add_edge(i, j, float(np.round(rng.normal(), 3)))
        labels, cut, cost = mc.round_gaec()
        comp = {i: {i} for i in range(n)}
        agg = dict(mc.edge_cost)
        while True:
            pos = [(w, e) for e, w in agg.items() if w > 0]
            if not pos:
                break
            _, (a, b) = max(pos)
            comp[a] |= comp.pop(b)
            nxt = {}
            for (u, v), w in agg.items():
                uu, vv = (a if u == b else u), (a if v == b else v)
                if uu != vv:
                    key = (min(uu, vv), max(uu, vv))
                    nxt[key] = nxt.get(key, 0.0) + w
            agg = nxt
        lab = np.zeros(n, dtype=int)
        for ci, members in enumerate(comp.values()):
            lab[list(members)] = ci
        ref = sum(w for (i, j), w in mc.edge_cost.items() if lab[i] != lab[j])
        assert abs(cost - ref) < 1e-9, (trial, cost, ref)


# ---------------------------------------------------------------------------
# tests/test_odd_wheels_general.py (without the LP-export test)
# ---------------------------------------------------------------------------
def relaxed_configs(k):
    A, forced_cut, both_one, free = pf._wheel_tables(k)
    out = set()
    for p in range(A.shape[0]):
        fidx = np.nonzero(free[p])[0]
        base = forced_cut[p].astype(np.int64)
        for bits in itertools.product((0, 1), repeat=len(fidx)):
            rim = base.copy()
            rim[fidx] = bits
            out.add(tuple(1 - A[p]) + tuple(rim))
    return np.array(sorted(out), dtype=np.int64)


def config_vals(sp, rim, tri, R):
    k = sp.shape[1]
    vals = np.concatenate([sp, rim], axis=1) @ R.T
    for ci, row in enumerate(R.astype(np.int64)):
        for i in range(k):
            bits = (row[i], row[(i + 1) % k], row[k + i])
            if any(bits):
                r = int(np.nonzero((pf.TRIPLET_PATTERNS == np.asarray(bits)).all(axis=1))[0][0])
                vals[:, ci] += tri[:, i, r]
    return vals


def test_wheel_configs_match_partition_enumeration():
    k = 5
    edges = [(0, i + 1) for i in range(k)] + [(i + 1, (i + 1) % k + 1) for i in range(k)]
    seen = set()
    for lbl in itertools.product(range(k + 1), repeat=k):
        full = (0,) + lbl
        seen.add(tuple(int(full[a] != full[b]) for a, b in edges))
    assert {tuple(r) for r in pf.wheel_k_type(k).configs()} == seen


def test_wheel_bound_and_marginals_match_bruteforce():
    k = 5
    wt = pf.wheel_k_type(k)
    rng = np.random.default_rng(0)
    sp, rim, tri = rng.normal(size=(7, k)), rng.normal(size=(7, k)), rng.normal(size=(7, k, 4)) * 0.5
    costs = {"sp": t64(sp), "rim": t64(rim), "tri": t64(tri)}
    R = relaxed_configs(k).astype(np.float64)
    vals = config_vals(sp, rim, tri, R)
    np.testing.assert_allclose(wt.lower_bound(costs).numpy(), vals.min(axis=1), atol=1e-12)
    marg = wt.slot_marginals(costs).numpy()
    for s in range(2 * k):
        np.testing.assert_allclose(marg[:, s], vals[:, R[:, s] == 1].min(axis=1)
                                   - vals[:, R[:, s] == 0].min(axis=1), atol=1e-12)
    tm = wt.tri_marginals(costs).numpy()
    Ri = R.astype(np.int64)
    for i in range(k):
        bits_all = np.stack([Ri[:, i], Ri[:, (i + 1) % k], Ri[:, k + i]], axis=1)
        unc = vals[:, (bits_all == 0).all(axis=1)].min(axis=1)
        for r in range(4):
            sel = (bits_all == pf.TRIPLET_PATTERNS[r]).all(axis=1)
            np.testing.assert_allclose(tm[:, i, r], vals[:, sel].min(axis=1) - unc, atol=1e-12)
    sv = config_vals(sp, rim, tri, wt.configs().astype(np.float64))
    assert (sv.min(axis=1) >= vals.min(axis=1) - 1e-9).all()


def w5_solver():
    """W5: hub 0, rim 1..5; attractive spokes (+1), repulsive rim (-1):
    integral optimum -2, cycle relaxation -2.5."""
    s = Solver(device="cpu")
    mc = s.add_constructor(MulticutConstructor)
    rim = [1, 2, 3, 4, 5]
    for v in rim:
        mc.add_edge(0, v, 1.0)
    for i in range(5):
        mc.add_edge(rim[i], rim[(i + 1) % 5], -1.0)
    return s, mc


def converge(s, iters):
    eng = Engine(s.graph, device="cpu")
    for _ in range(iters):
        eng.compute_pass("anisotropic")
    return eng


def test_w5_cycle_and_k4_stall_wheel5_improves():
    s, mc = w5_solver()
    eng = converge(s, 200)
    assert eng.lower_bound() == pytest.approx(-5.0, abs=1e-4)
    while mc.tighten_cycles(eng, 10) > 0:
        eng = converge(s, 400)
    assert len(mc.triplets) == 5
    assert mc.tighten_odd_wheels(eng, 10) == 0
    lb_stalled = eng.lower_bound()
    assert lb_stalled == pytest.approx(-2.5, abs=0.05)
    assert mc.tighten_wheels_general(eng, max_constraints=4) >= 1
    assert any(len(rim) == 5 and center == 0 for (center, *_), (_, rim) in mc.wheels_k.items())
    eng3 = Engine(s.graph, device="cpu")
    for name, block in eng.state.items():
        for key, v in block.items():
            eng3.state[name][key][tuple(slice(0, d) for d in v.shape)] = v
    for _ in range(600):
        eng3.compute_pass("anisotropic")
    lb_wheel = eng3.lower_bound()
    assert lb_wheel > lb_stalled + 0.2, (lb_stalled, lb_wheel)
    assert lb_wheel <= -2.0 + 1e-5


def test_w5_through_solver_tighten():
    s, mc = w5_solver()
    s.visitor = StandardTighteningVisitor(max_iter=300, tighten=True, tighten_iteration=30,
                                          tighten_interval=30, tighten_constraints_max=10)
    lb = s.solve()
    assert any(len(rim) == 5 for _, (_, rim) in mc.wheels_k.items())
    assert lb > -2.3, lb
    assert s.primal_cost() == pytest.approx(-2.0, abs=1e-3)
    assert s.primal_cost() >= lb - 1e-4


def test_wheel_primal_validity():
    k = 5
    wt = pf.wheel_k_type(k)
    rng = np.random.default_rng(2)
    sp, rim = rng.normal(size=(1, k)), rng.normal(size=(1, k))
    costs = {"sp": t64(sp), "rim": t64(rim), "tri": torch.zeros((1, k, 4), dtype=torch.float64)}
    e = torch.zeros((1, 2 * k), dtype=torch.int32)
    assert float(wt.evaluate_primal(costs, {"e": e})[0]) == pytest.approx(0.0)
    e[0, :k] = 1
    e[0, k] = 1
    assert np.isinf(float(wt.evaluate_primal(costs, {"e": e})[0]))
    e = torch.ones((1, 2 * k), dtype=torch.int32)
    assert float(wt.evaluate_primal(costs, {"e": e})[0]) == pytest.approx(sp.sum() + rim.sum())


# ---------------------------------------------------------------------------
# tests/test_aux_tighten.py, multicut half, and parity of the aux pass
# ---------------------------------------------------------------------------
def complete_graph(n, seed):
    rng = np.random.default_rng(seed)
    pairs = np.asarray([(i, j) for i in range(n) for j in range(i + 1, n)])
    return pairs, rng.normal(size=len(pairs))


def test_multicut_triplet_absorb_no_rebuild():
    pairs, costs = complete_graph(5, 21)

    def mc_cost(lab):
        return sum(c for (i, j), c in zip(pairs, costs) if lab[i] != lab[j])
    opt = min(mc_cost(lab) for lab in itertools.product(range(5), repeat=5))

    s = Solver(device="cpu")
    mc = s.add_constructor(MulticutConstructor)
    mc.add_edges(pairs, costs)
    s.build_engine()
    for _ in range(5):
        s.engine.compute_pass("anisotropic")
    lb = s.engine.lower_bound()
    for _ in range(4):
        n0, m0 = s.graph.n_factors, len(s.graph.messages)
        if not mc.tighten_cycles(s.engine, max_constraints=10):
            break
        assert s.aux.absorb(s.graph, s.engine, n0, m0)
        for _ in range(5):
            s.engine.compute_pass("anisotropic")
            s.aux.run(s.engine)
        lb2 = s.engine.lower_bound() + s.aux.lower_bound()
        assert lb2 >= lb - 1e-6
        lb = lb2
    assert s.n_engine_builds == 1
    assert s.aux.mc.n > 0

    s2 = Solver(visitor=StandardTighteningVisitor(
        max_iter=80, tighten=True, tighten_iteration=5, tighten_interval=10,
        tighten_constraints_max=40), device="cpu")
    mc2 = s2.add_constructor(MulticutConstructor)
    mc2.add_edges(pairs, costs)
    lb = s2.solve()
    ub = s2.primal_cost()
    assert lb <= opt + 1e-6 and np.isfinite(ub) and ub >= opt - 1e-9
    assert abs(lb - opt) < 1e-4 and abs(ub - opt) < 1e-4


def absorbed_pair(n=6, seed=22, triplets=((0, 1, 2), (2, 3, 4))):
    """Both packages' solvers over one complete graph with ``triplets``
    absorbed and 5 passes run."""
    pairs, costs = complete_graph(n, seed)
    out = []
    for S, M, kw in ((JSolver, JMulticut, dict(use_jit=False, pass_style="unrolled")),
                     (Solver, MulticutConstructor, dict(device="cpu"))):
        s = S(**kw)
        mc = s.add_constructor(M)
        mc.add_edges(pairs, costs)
        s.build_engine()
        n0, m0 = s.graph.n_factors, len(s.graph.messages)
        for t in triplets:
            mc.add_triplet(*t)
        assert s.aux.absorb(s.graph, s.engine, n0, m0)
        for _ in range(5):
            s.engine.compute_pass("anisotropic")
            s.aux.run(s.engine)
        out.append((s, mc))
    return out


def test_multicut_absorb_fold_into_rebuild():
    (_, _), (s, mc) = absorbed_pair()
    lb_before = s.engine.lower_bound() + s.aux.lower_bound()
    s.build_engine()
    assert not bool(s.aux)
    assert abs(s.engine.lower_bound() - lb_before) < LB_TOL


def test_multicut_aux_pass_matches_jax_and_round_trips():
    tris = [(0, 1, 2), (2, 3, 4), (0, 2, 4), (1, 3, 5), (0, 4, 5), (1, 2, 3), (2, 4, 5),
            (0, 1, 5), (0, 3, 4)]                               # 9 > 8: the bucket grows
    (sj, mj), (sp, mp) = absorbed_pair(triplets=tris)
    assert abs(sj.engine.lower_bound() + sj.aux.lower_bound()
               - sp.engine.lower_bound() - sp.aux.lower_bound()) < LB_TOL
    assert_trees_close(jax_numpy(sj.engine.state), engine_state_to_numpy(sp.engine.state))
    aj, ap = aux_state_to_numpy(sj.aux), aux_state_to_numpy(sp.aux)
    assert ap["mc"]["cap"] == aj["mc"]["cap"] == 16 and ap["mc"]["n"] == 9
    assert ap["mc"]["fids"] == aj["mc"]["fids"]
    for k in ("c", "lidx", "active", "w_recv"):
        np.testing.assert_allclose(ap["mc"][k], aj["mc"][k], rtol=0, atol=LB_TOL, err_msg=k)
    pj, pp = mj.compute_primal(sj.engine), mp.compute_primal(sp.engine)
    assert abs(sj.aux.evaluate_primal(sj.engine, pj) - sp.aux.evaluate_primal(sp.engine, pp)) \
        < LB_TOL
    twin = aux_state_from_numpy(aj)
    assert twin.mc.n == 9 and twin.mc._lidx_host == sp.aux.mc._lidx_host
    assert twin.lower_bound() == pytest.approx(sp.aux.lower_bound(), abs=LB_TOL)
    sj.build_engine()
    sp.build_engine()
    assert_trees_close(jax_numpy(sj.engine.state), engine_state_to_numpy(sp.engine.state))


# ---------------------------------------------------------------------------
# Solver.solve() with cycle tightening and GAEC, against the JAX package
# ---------------------------------------------------------------------------
def test_solver_multicut_tightening_matches_jax():
    rng = np.random.default_rng(4)
    H = W = 5
    idx = np.arange(H * W).reshape(H, W)
    pairs = np.concatenate([np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], axis=1),
                            np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], axis=1)])
    costs = rng.normal(loc=0.4, size=len(pairs))
    kw = dict(max_iter=10, tighten=True, tighten_iteration=3, tighten_interval=5,
              tighten_constraints_max=20, primal_computation_interval=4)
    logs = ([], [])
    sj = JSolver(visitor=JTVisitor(log_fn=logs[0].append, **kw), use_jit=False,
                 pass_style="unrolled")
    sp = Solver(visitor=StandardTighteningVisitor(log_fn=logs[1].append, **kw), device="cpu")
    cj, cp = sj.add_constructor(JMulticut), sp.add_constructor(MulticutConstructor)
    for c in (cj, cp):
        c.add_edges(pairs, costs)
    lb_j, lb_p = sj.solve(), sp.solve()
    assert len(cp.triplets) > 0 and list(cp.triplets) == list(cj.triplets)
    assert list(cp.edges) == list(cj.edges)
    assert sp.n_engine_builds == sj.n_engine_builds == 2           # odd wheels rebuild
    assert list(cp.odd_wheels) == list(cj.odd_wheels)
    assert sp.aux.n == sj.aux.n
    assert abs(lb_j - lb_p) < LB_TOL
    for a, b in zip(logs[0], logs[1]):
        assert abs(a["lower_bound"] - b["lower_bound"]) < LB_TOL, a["iteration"]
    assert np.isfinite(sp.primal_cost()) and sp.primal_cost() >= lb_p - 1e-9
    assert abs(sj.primal_cost() - sp.primal_cost()) < LB_TOL
    # the same cut of the original edges (the engines' first rows); the best
    # primal may come from engines of different builds on a float tie
    np.testing.assert_array_equal(sp.best_primal["multicut_edge"]["x"][:len(pairs)].numpy(),
                                  np.asarray(sj.best_primal["multicut_edge"]["x"])[:len(pairs)])
    assert cp.round_gaec()[2] == cj.round_gaec()[2]
