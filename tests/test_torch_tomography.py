"""Discrete tomography in the port against the JAX package, on the CPU in
float64 (mirrors tests/test_minconv.py and tests/test_tomography.py).

- ``min_conv``, ``arg_min_conv`` and ``min_corr``: equal to the JAX
  package's and to naive oracles.
- The counting chain (``factors/counting.py``): bound, padding, restricted
  primal, evaluation and dual vector, equal to the JAX package's on random
  reparametrized blocks with +inf lanes.
- ``UnaryCountingMessage``: per-message and block marginals, restricted
  marginals, repams, propagation and ``consistent`` against the JAX ones;
  the block marginal within 1e-12 of the per-message one.
- End to end against brute force, the reference-style instance, the
  monotone relaxed (coloring) schedule, the 1/k receive scales of the
  slot-disjoint type against the JAX engine's, no NaN in any state after
  passes over a padded multi-size block, ``tomography_10x32`` of bench.py
  through ``Solver`` (fewer iterations: the JAX side runs eagerly), and a
  JAX engine's state carried into the port.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lp_mp_tpu.factors.counting as jcount
import lp_mp_tpu.messages.counting as jmsg
import lp_mp_tpu.ops.minconv as jminconv
from chip_smoke import tomography_chains
from lp_mp_tpu import Solver as JSolver, StandardVisitor as JVisitor
from lp_mp_tpu.config import Direction as JDirection
from lp_mp_tpu.engine import Engine as JEngine
from lp_mp_tpu.graph import FactorGraph as JGraph
from lp_mp_tpu.models.tomography import DiscreteTomographyConstructor as JDT
from lp_mp_tpu_torch import (DiscreteTomographyConstructor, Direction, Engine, FactorGraph,
                             Solver, StandardVisitor, engine_state_from_numpy)
from lp_mp_tpu_torch.convert import engine_state_to_numpy
from lp_mp_tpu_torch.factors.counting import COUNTING_CHAIN, min_corr
from lp_mp_tpu_torch.messages.counting import UNARY_COUNTING
from lp_mp_tpu_torch.ops.minconv import arg_min_conv, min_conv
from tests.test_minconv import naive_min_conv
from tests.test_tomography import POTTS, brute_force
from tests.test_torch_engine import assert_trees_close, jax_numpy

LB_REL = 1e-9


def exact(j, p):
    j, p = np.asarray(j), p.detach().cpu().numpy()
    assert j.shape == p.shape, (j.shape, p.shape)
    np.testing.assert_array_equal(p, j)


def t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# tests/test_minconv.py
# ---------------------------------------------------------------------------
def test_min_conv_artificial_input():
    # test/min_conv.cpp:27-41
    a = np.array([0.1, 0.2, 0.05, 1.0])
    b = a[::-1].copy()
    got = min_conv(t(a), t(b), 7)
    exact(jminconv.min_conv(jnp.asarray(a), jnp.asarray(b), 7), got)
    np.testing.assert_allclose(got.numpy(), naive_min_conv(a, b, 7))


@pytest.mark.parametrize("seed", range(5))
def test_min_conv_random_parity(seed):
    rng = np.random.default_rng(seed)
    n, m = rng.integers(1, 12, size=2)
    a, b = rng.normal(size=n), rng.normal(size=m)
    S = int(rng.integers(1, n + m + 2))
    got = min_conv(t(a), t(b), S)
    exact(jminconv.min_conv(jnp.asarray(a), jnp.asarray(b), S), got)
    np.testing.assert_allclose(got.numpy(), naive_min_conv(a, b, S), rtol=1e-12)
    vals, arg = arg_min_conv(t(a), t(b), S)
    jv, ja = jminconv.arg_min_conv(jnp.asarray(a), jnp.asarray(b), S)
    exact(jv, vals)
    exact(ja, arg)


def test_arg_min_conv_consistent_and_ties():
    rng = np.random.default_rng(7)
    a, b = rng.normal(size=6), rng.normal(size=4)
    vals, arg = arg_min_conv(t(a), t(b), 9)
    for s in range(9):
        if np.isfinite(float(vals[s])):
            i = int(arg[s])
            assert 0 <= s - i < len(b)
            assert float(vals[s]) == pytest.approx(a[i] + b[s - i])
    # integer costs tie everywhere: the first minimum (smallest j) wins, as
    # in jnp.argmin, which the primal backtrack relies on
    a, b = rng.integers(0, 2, size=(3, 7)).astype(float), rng.integers(0, 2, size=(3, 3)).astype(float)
    for out in (4, 9, 12):
        jv, ja = jminconv.arg_min_conv(jnp.asarray(a), jnp.asarray(b), out)
        vals, arg = arg_min_conv(t(a), t(b), out)
        exact(jv, vals)
        exact(ja, arg)


def test_min_conv_batched():
    rng = np.random.default_rng(3)
    a, b = rng.normal(size=(4, 5)), rng.normal(size=(4, 3))
    got = min_conv(t(a), t(b), 7)
    exact(jminconv.min_conv(jnp.asarray(a), jnp.asarray(b), 7), got)
    for f in range(4):
        np.testing.assert_allclose(got[f].numpy(), naive_min_conv(a[f], b[f], 7))
    out = torch.empty(4, 7, dtype=torch.float64)
    min_conv(t(a), t(b), 7, out=out)
    assert torch.equal(out, got)


@pytest.mark.parametrize("shape", [((8,), (3,), 8), ((2, 5), (2, 7), 3), ((3, 4), (3, 2), 9)])
def test_min_corr(shape):
    rng = np.random.default_rng(5)
    bs, ls, out = shape
    b, lam = rng.normal(size=bs), rng.normal(size=ls)
    lam[..., -1] = np.inf
    got = min_corr(t(b), t(lam), out)
    exact(jcount.min_corr(jnp.asarray(b), jnp.asarray(lam), out), got)
    b1, l1 = b.reshape(-1, bs[-1])[0], lam.reshape(-1, ls[-1])[0]
    want = np.full(out, np.inf)
    for s in range(out):
        for l in range(len(l1)):
            if s + l < len(b1):
                want[s] = min(want[s], l1[l] + b1[s + l])
    np.testing.assert_allclose(got.reshape(-1, out)[0].numpy(), want)


# ---------------------------------------------------------------------------
# the counting chain factor
# ---------------------------------------------------------------------------
def twin_chain(instances, rng=None):
    """The block both packages build (asserted equal; nv/nl int64 in the
    port), as (jax, torch); with ``rng``, valid lanes get random
    reparametrized values and the +inf lanes stay."""
    jb, pb = jcount.COUNTING_CHAIN.build(instances), COUNTING_CHAIN.build(instances)
    assert jb.keys() == pb.keys()
    for k in jb:
        np.testing.assert_array_equal(np.asarray(jb[k]), pb[k])
    assert pb["nv"].dtype == pb["nl"].dtype == np.int64 and pb["lam"].dtype == np.float64
    if rng is not None:
        lam = pb["lam"]
        pb["lam"] = np.where(np.isfinite(lam), lam + rng.normal(size=lam.shape), lam)
    return ({k: jnp.asarray(v) for k, v in pb.items()}, {k: t(v) for k, v in pb.items()})


def test_counting_chain_lower_bound():
    # one chain factor, no MRF: bound = min over labelings of proj cost
    pc = np.array([10.0, 10.0, 0.0, 100.0, 7.0])
    jb, pb = twin_chain([(3, 3, pc)])
    lb = COUNTING_CHAIN.lower_bound(pb)
    exact(jcount.COUNTING_CHAIN.lower_bound(jb), lb)
    assert float(lb[0]) == pytest.approx(0.0)


def test_counting_chain_padding():
    # two factors of different sizes in one block
    jb, pb = twin_chain([(1, 2, np.array([1.0, 0.5])), (3, 2, np.array([3.0, 2.0, 0.25, 9.0]))])
    lb = COUNTING_CHAIN.lower_bound(pb)
    exact(jcount.COUNTING_CHAIN.lower_bound(jb), lb)
    assert lb.tolist() == pytest.approx([0.5, 0.25])


def test_counting_chain_compute_primal_restricted():
    pc = np.array([10.0, 10.0, 0.0, 100.0])
    jb, pb = twin_chain([(3, 3, pc)])
    prim = COUNTING_CHAIN.init_primal(pb)
    assert prim["x"].dtype == torch.int32 and prim["x"].tolist() == [[-1, -1, -1]]
    # fix var 0 = 2: best completion is sum 2 -> vars 1,2 = 0
    prim["x"][0, 0] = 2
    out = COUNTING_CHAIN.compute_primal(pb, prim)
    exact(jcount.COUNTING_CHAIN.compute_primal(jb, {"x": jnp.asarray(prim["x"].numpy())})["x"],
          out["x"])
    x = out["x"][0].tolist()
    assert x[0] == 2 and x[1] + x[2] + 2 == 2
    assert float(COUNTING_CHAIN.evaluate_primal(pb, out)[0]) == pytest.approx(0.0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_counting_chain_functions_match_jax(seed):
    """Random reparametrized block of chains with 1..6 variables, 2..3
    labels and cost vectors of several lengths (+inf padding throughout)."""
    rng = np.random.default_rng(seed)
    inst = []
    for _ in range(5):
        nv, nl = int(rng.integers(1, 7)), int(rng.integers(2, 4))
        inst.append((nv, nl, rng.normal(size=int(rng.integers(2, nv * (nl - 1) + 2)))))
    jb, pb = twin_chain(inst, rng)
    F, V, L = pb["lam"].shape
    exact(jcount.COUNTING_CHAIN.lower_bound(jb), COUNTING_CHAIN.lower_bound(pb))
    exact(jcount.COUNTING_CHAIN.dual_vector(jb), COUNTING_CHAIN.dual_vector(pb))
    x = rng.integers(-1, 2, size=(F, V)).astype(np.int32)
    x[rng.random((F, V)) < 0.5] = -1
    jp = jcount.COUNTING_CHAIN.compute_primal(jb, {"x": jnp.asarray(x)})
    pp = COUNTING_CHAIN.compute_primal(pb, {"x": t(x)})
    exact(jp["x"], pp["x"])
    for prim in ({"x": t(x)}, pp):
        np.testing.assert_allclose(
            COUNTING_CHAIN.evaluate_primal(pb, prim).numpy(),
            np.asarray(jcount.COUNTING_CHAIN.evaluate_primal(jb, {"x": jnp.asarray(prim["x"].numpy())})),
            rtol=1e-15, atol=0)


# ---------------------------------------------------------------------------
# UnaryCountingMessage, function by function
# ---------------------------------------------------------------------------
def test_counting_message_functions_match_jax():
    rng = np.random.default_rng(4)
    inst = [(4, 3, rng.normal(size=9)), (2, 2, rng.normal(size=3)), (5, 3, rng.normal(size=7))]
    jb, pb = twin_chain(inst, rng)
    C, V, L = pb["lam"].shape
    ridx = np.array([f for f, (nv, _, _) in enumerate(inst) for _ in range(nv)])
    pos = [k for nv, _, _ in inst for k in range(nv)]
    jd, pd = jmsg.UNARY_COUNTING.build(pos), UNARY_COUNTING.build(pos)
    exact(jd["pos"], t(pd["pos"]))
    assert pd["pos"].dtype == np.int64
    jd, pd = {"pos": jnp.asarray(jd["pos"])}, {"pos": t(pd["pos"])}
    jr, pr = jnp.asarray(ridx), t(ridx)
    jm, pm = jmsg.UNARY_COUNTING, UNARY_COUNTING
    M = len(ridx)

    def g(block, idx):
        return {k: v[idx] for k, v in block.items()}

    close = dict(rtol=0, atol=1e-12)
    per_msg = pm.marginal_right(g(pb, pr), pd)
    block = pm.marginal_right_block(pb, pd, pr)
    assert torch.isfinite(per_msg).all() and torch.isfinite(block).all()
    np.testing.assert_allclose(per_msg.numpy(), np.asarray(jm.marginal_right(g(jb, jr), jd)), **close)
    np.testing.assert_allclose(block.numpy(), np.asarray(jm.marginal_right_block(jb, jd, jr)), **close)
    np.testing.assert_allclose(block.numpy(), per_msg.numpy(), **close)

    x = rng.integers(-1, 3, size=(C, V)).astype(np.int32)
    np.testing.assert_allclose(
        pm.restricted_marginal_right(g(pb, pr), {"x": t(x)[pr]}, pd).numpy(),
        np.asarray(jm.restricted_marginal_right(g(jb, jr), {"x": jnp.asarray(x)[jr]}, jd)), **close)

    # the unary side: [M', Lu] costs with PAD_COST lanes
    from lp_mp_tpu.factors.simplex import UNARY_SIMPLEX as JU
    from lp_mp_tpu_torch.factors.simplex import UNARY_SIMPLEX as PU
    vecs = [rng.normal(size=int(n)) for n in rng.integers(2, 4, size=M)]
    ju, pu = JU.build(vecs), PU.build(vecs)
    ju, pu = {k: jnp.asarray(v) for k, v in ju.items()}, {k: t(v) for k, v in pu.items()}
    lidx = rng.permutation(M)
    jl, pl = jnp.asarray(lidx), t(lidx)
    exact(jm.marginal_left(g(ju, jl), jd), pm.marginal_left(g(pu, pl), pd))
    xu = rng.integers(-1, 3, size=M).astype(np.int32)
    exact(jm.restricted_marginal_left(g(ju, jl), {"x": jnp.asarray(xu)[jl]}, jd),
          pm.restricted_marginal_left(g(pu, pl), {"x": t(xu)[pl]}, pd))

    delta = rng.normal(size=(M, L))
    before = pb["lam"].clone()
    exact(jm.repam_right(jb, jr, jnp.asarray(delta), jd)["lam"],
          pm.repam_right(pb, pr, t(delta), pd)["lam"])
    assert torch.equal(pb["lam"], before)                    # out of place
    exact(jm.repam_left(ju, jl, jnp.asarray(delta), jd)["c"],
          pm.repam_left(pu, pl, t(delta), pd)["c"])

    for _ in range(3):
        xl = rng.integers(-1, 3, size=M).astype(np.int32)
        xr = rng.integers(-1, 3, size=(C, V)).astype(np.int32)
        jlp, jrp = {"x": jnp.asarray(xl)}, {"x": jnp.asarray(xr)}
        plp, prp = {"x": t(xl)}, {"x": t(xr)}
        exact(jm.consistent(jlp, jrp, jl, jr, jd), pm.consistent(plp, prp, pl, pr, pd))
        exact(jm.propagate_primal_l2r(jlp, jrp, jl, jr, jd)["x"],
              pm.propagate_primal_l2r(plp, prp, pl, pr, pd)["x"])
        exact(jm.propagate_primal_r2l(jlp, jrp, jl, jr, jd)["x"],
              pm.propagate_primal_r2l(plp, prp, pl, pr, pd)["x"])


# ---------------------------------------------------------------------------
# tests/test_tomography.py, end to end
# ---------------------------------------------------------------------------
def dt_solver(unaries, pairwise, projections, max_iter):
    s = Solver(visitor=StandardVisitor(max_iter=max_iter), device="cpu")
    dt = s.add_constructor(DiscreteTomographyConstructor)
    for u in unaries:
        dt.add_unary_factor(u)
    for (i, j), m in pairwise.items():
        dt.add_pairwise_factor(i, j, m)
    for vars_, pc in projections:
        dt.add_projection(vars_, pc)
    return s, dt


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_end_to_end_chain(seed):
    """Chain MRF with Potts + one projection; lb <= opt, primal >= opt."""
    rng = np.random.default_rng(seed)
    n, L = 4, 3
    unaries = [rng.normal(size=L) for _ in range(n)]
    pairwise = {(i, i + 1): 0.4 * POTTS for i in range(n - 1)}
    projections = [(list(range(n)), rng.normal(size=2 * n + 1) * 2.0)]
    opt = brute_force(unaries, pairwise, projections)
    s, dt = dt_solver(unaries, pairwise, projections, 50)
    lb = s.solve()
    ub = s.primal_cost()
    assert lb <= opt + 1e-6 and ub >= opt - 1e-9
    # chain + single projection is solved exactly by DBCA here
    assert lb == pytest.approx(opt, abs=1e-4)
    assert ub == pytest.approx(opt, abs=1e-4)
    x = dt.labeling(s.engine, s.best_primal)
    assert x.shape == (n,) and x.dtype == np.int64


def test_reference_style_instance():
    """4 variables, 3 labels, projection cost {10,10,0,100,...} forcing the
    ray sum to 2 (test/discrete_tomography.cpp:35-38 shapes)."""
    n = 4
    unaries = [np.zeros(3) for _ in range(n)]
    pairwise = {(i, i + 1): POTTS for i in range(n - 1)}
    pc = np.array([10.0, 10, 0, 100, 100, 100, 100, 100, 100])
    opt = brute_force(unaries, pairwise, [(list(range(n)), pc)])
    s, _ = dt_solver(unaries, pairwise, [(list(range(n)), pc)], 60)
    lb = s.solve()
    assert lb <= opt + 1e-6
    assert opt - 1e-9 <= s.primal_cost() < np.inf


def build_chains(DT, graph, n_chains, nv, L, seed, sizes=None):
    """tests/test_tomography.py:121-138 (bench.py:474-505 shape): chains of
    nv variables (or ``sizes``), L labels, 0.3-scaled normal pairwise, a
    V-shaped projection cost around a random target sum."""
    rng = np.random.default_rng(seed)
    dt = DT(graph)
    v = 0
    for c in range(n_chains):
        first = v
        for q in range(sizes[c] if sizes else nv):
            dt.add_unary_factor(rng.normal(size=L))
            if q:
                dt.add_pairwise_factor(v - 1, v, rng.normal(size=(L, L)) * 0.3)
            v += 1
        smax = (L - 1) * (v - first)
        dt.add_projection(range(first, v), 0.05 * np.abs(np.arange(smax + 1)
                                                         - int(rng.integers(0, smax))))
    return dt


def twin_engines(n_chains, nv, L, seed, sizes=None, **kw):
    gj, gp = JGraph(), FactorGraph()
    build_chains(JDT, gj, n_chains, nv, L, seed, sizes)
    build_chains(DiscreteTomographyConstructor, gp, n_chains, nv, L, seed, sizes)
    return (JEngine(gj, use_jit=False, pass_style="unrolled", **kw), Engine(gp, device="cpu", **kw))


def test_block_marginal_matches_per_message():
    """registry marginal_right_block hook == per-message _chain_marginal on a
    reparametrized state (the hook dedups the V-fold DP recomputation)."""
    je, e = twin_engines(3, 8, 3, 11, schedule_mode="wavefront")
    for _ in range(2):
        e.compute_pass("anisotropic")
    blk = e.msgs["unary_counting"]
    mt = blk.mtype
    chain = e.state["counting_chain"]
    got = mt.marginal_right_block(chain, blk.data, blk.ridx)
    want = mt.marginal_right({k: v[blk.ridx] for k, v in chain.items()}, blk.data)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-12)


def test_relaxed_schedule_monotone_and_converges():
    """slot_disjoint counting messages let whole rays share a phase
    (coloring gives 2-3 phases instead of one per ray variable); the 1/k
    simultaneous-receive scaling keeps the bound monotone and reaches the
    strict sequential-order bound."""
    g_strict, g_rel = FactorGraph(), FactorGraph()
    build_chains(DiscreteTomographyConstructor, g_strict, 4, 10, 3, 13)
    build_chains(DiscreteTomographyConstructor, g_rel, 4, 10, 3, 13)
    e_strict = Engine(g_strict, schedule_mode="wavefront", device="cpu")
    e_rel = Engine(g_rel, schedule_mode="auto", device="cpu")
    assert e_rel.schedule_mode == "coloring"
    assert len(e_rel.plans[Direction.forward]) <= 4
    prev = -np.inf
    for _ in range(60):
        e_rel.compute_pass("anisotropic")
        lb = e_rel.lower_bound()
        assert lb >= prev - 1e-6
        prev = lb
    for _ in range(30):
        e_strict.compute_pass("anisotropic")
    assert e_rel.lower_bound() >= e_strict.lower_bound() - 0.05


def test_recv_scales_match_jax():
    """The 1/k scale per message of the slot-disjoint type, per direction,
    equals the JAX engine's; on the coloring schedule some k exceed 1."""
    je, pe = twin_engines(4, 10, 3, 13, schedule_mode="auto")
    assert pe.schedule_mode == je.schedule_mode == "coloring"
    for d, jd in ((Direction.forward, JDirection.forward), (Direction.backward, JDirection.backward)):
        js, ps = je._recv_scales(je.plans[jd]), pe._recv_scales(pe._dev_plans[d])
        assert js.keys() == ps.keys() == {"unary_counting"}
        np.testing.assert_array_equal(ps["unary_counting"].numpy(),
                                      np.asarray(js["unary_counting"]))
        assert ps["unary_counting"].min() < 1.0


def padded_chains(DT, g):
    """Chains of 1, 3 and 6 variables with 3 labels and one of 3 variables
    with 2, all projections added in a row, so the engine builds them as
    one block padded with real +inf (variables past nv, labels past nl, sums
    past the cost vector)."""
    rng = np.random.default_rng(21)
    dt = DT(g)
    rays, v = [], 0
    for n, L in ((1, 3), (3, 3), (6, 3), (3, 2)):
        for q in range(n):
            dt.add_unary_factor(rng.normal(size=L))
            if q:
                dt.add_pairwise_factor(v - 1, v, rng.normal(size=(L, L)) * 0.3)
            v += 1
        rays.append((range(v - n, v), rng.normal(size=(L - 1) * n + 1)))
    for vars_, pc in rays:
        dt.add_projection(vars_, pc)


@pytest.mark.parametrize("smode", ["wavefront", "coloring"])
def test_padded_block_passes_stay_finite_and_match_jax(smode):
    """After every pass over the padded block no state holds a NaN, and the
    bounds and states equal the JAX engine's."""
    gj, gp = JGraph(), FactorGraph()
    padded_chains(JDT, gj)
    padded_chains(DiscreteTomographyConstructor, gp)
    je = JEngine(gj, schedule_mode=smode, use_jit=False, pass_style="unrolled")
    pe = Engine(gp, schedule_mode=smode, device="cpu")
    chain = pe.state["counting_chain"]
    assert chain["lam"].shape == (4, 6, 3) and torch.isinf(chain["lam"]).any() \
        and torch.isinf(chain["proj"]).any()
    for _ in range(4):
        je.compute_pass("anisotropic")
        pe.compute_pass("anisotropic")
        for name, block in pe.state.items():
            for k, v in block.items():
                assert not (v.is_floating_point() and torch.isnan(v).any()), (name, k)
    assert np.isfinite(pe.lower_bound())
    assert abs(je.lower_bound() - pe.lower_bound()) <= LB_REL * abs(je.lower_bound())
    assert_trees_close(jax_numpy(je.state), engine_state_to_numpy(pe.state))


def test_tomography_10x32_solver_matches_jax():
    sj = JSolver(visitor=JVisitor(max_iter=12), schedule_mode="auto", use_jit=False,
                 pass_style="unrolled")
    sp = Solver(visitor=StandardVisitor(max_iter=12), schedule_mode="auto", device="cpu")
    dj, dp = sj.add_constructor(JDT), sp.add_constructor(DiscreteTomographyConstructor)
    for dt in (dj, dp):
        tomography_chains(dt, 10, 32, 3, seed=10)
    lb_j, lb_p = sj.solve(), sp.solve()
    assert sp.engine.schedule_mode == "coloring"
    assert abs(lb_j - lb_p) <= LB_REL * abs(lb_j), (lb_j, lb_p)
    assert sp.primal_cost() == pytest.approx(sj.primal_cost(), rel=1e-12)
    np.testing.assert_array_equal(dp.labeling(sp.engine, sp.best_primal),
                                  dj.labeling(sj.engine, sj.best_primal))


def test_projections_of_two_lengths_between_other_factors():
    """Rays of 6, 4 and 2 pixels, each projection added right after its
    pixels, so the chain factors come in three item chunks.  The port
    builds them as one block (padded variables forced to label 0): its
    bound is finite and equals the bound with the projections added in a
    row, and both give one ILP optimum.  The JAX package builds each chunk
    alone and pads the short chains' variables with PAD_COST: its bound is
    6e20 (ROADMAP.md queue 3)."""
    from lp_mp_tpu_torch import ilp_round

    je, pe = twin_engines(3, 6, 3, 5, sizes=[6, 4, 2])
    assert je.lower_bound() == pytest.approx(6e20, rel=1e-12)
    g = FactorGraph()
    rng = np.random.default_rng(5)
    dt, v, rays = DiscreteTomographyConstructor(g), 0, []
    for n in (6, 4, 2):
        for q in range(n):
            dt.add_unary_factor(rng.normal(size=3))
            if q:
                dt.add_pairwise_factor(v - 1, v, rng.normal(size=(3, 3)) * 0.3)
            v += 1
        rays.append((range(v - n, v), 0.05 * np.abs(np.arange(2 * n + 1)
                                                     - int(rng.integers(0, 2 * n)))))
    for vars_, pc in rays:
        dt.add_projection(vars_, pc)
    ref = Engine(g, device="cpu")
    assert abs(pe.lower_bound() - ref.lower_bound()) <= 1e-12
    chain = pe.state["counting_chain"]
    assert chain["lam"].shape == (3, 6, 3)
    assert (chain["lam"][2, 2:, 0] == 0).all() and torch.isinf(chain["lam"][2, 2:, 1:]).all()
    _, opt = ilp_round(pe)
    _, opt_ref = ilp_round(ref)
    assert abs(opt - opt_ref) <= 1e-9
    for _ in range(10):
        pe.compute_pass("anisotropic")
    assert np.isfinite(pe.lower_bound()) and pe.lower_bound() <= opt + 1e-9


def test_counting_state_carried_from_jax():
    """A JAX engine's state after 3 passes, carried into the port (int32
    nv/nl become int64, +inf lanes stay), then 3 more passes on each."""
    je, pe = twin_engines(3, 6, 3, 5, sizes=[6, 4, 2], schedule_mode="auto")
    for _ in range(3):
        je.compute_pass("anisotropic")
    carried = engine_state_from_numpy(jax_numpy(je.state))
    assert np.asarray(je.state["counting_chain"]["nv"]).dtype == np.int32
    assert carried["counting_chain"]["nv"].dtype == carried["counting_chain"]["nl"].dtype \
        == torch.int64 == pe.state["counting_chain"]["nv"].dtype
    assert carried["unary_simplex"]["nl"].dtype == pe.state["unary_simplex"]["nl"].dtype
    pe.set_state(carried)
    for _ in range(3):
        je.compute_pass("anisotropic")
        pe.compute_pass("anisotropic")
    assert abs(je.lower_bound() - pe.lower_bound()) <= LB_REL * abs(je.lower_bound())
    assert_trees_close(jax_numpy(je.state), engine_state_to_numpy(pe.state))
