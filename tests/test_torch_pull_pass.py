"""The port's pull pass (``Engine(pull=True)``, lp_mp_tpu_torch.engine_pull)
against the port's scatter pass and against the JAX package's pull pass.

Mirrors tests/test_pull_pass.py case by case (the MRF cases potts x
schedule x mode, with triplets, the multicut with wheels, QAP, counting
not supported, a monotone bound).  Each case runs on the CPU in float64 and
is held against two references after the same passes: the port's scatter
engine and the JAX package's ``Engine(pull=True, use_jit=False)`` on the
same graph, states within 1e-9 and bounds within 1e-9.  On grids whose
slots are all strided the JAX engine runs jitted: its eager pull pass
aborts the process there with a corrupted heap (jax 0.9.0 on the CPU;
ROADMAP.md queue 3).  Then: ``pull=True``
refuses what it cannot serve (a residual update mode, a model without
hooks) instead of running scatter, ``pull="auto"`` runs the scatter pass,
``use_jit=True`` is bit-equal to ``use_jit=False``, a state carried into the
JAX pull engine and back gives the same next pass, and a slot-disjoint
type with pull hooks keeps the engine's 1/k receive scale (the JAX
package's ``fold_weights`` drops it and drains k-fold mass).
"""
import numpy as np
import pytest
import torch

from lp_mp_tpu import Solver as JSolver
from lp_mp_tpu.engine import Engine as JEngine
from lp_mp_tpu.factors.simplex import UNARY_SIMPLEX as J_UNARY
from lp_mp_tpu.graph import FactorGraph as JGraph
from lp_mp_tpu.io.torresani import GraphMatchingInput as JGMInput
from lp_mp_tpu.messages.vector_equality import VECTOR_EQUALITY as JVEQ
from lp_mp_tpu.messages.vector_equality import VectorEqualityMessage as JVectorEquality
from lp_mp_tpu.models.graph_matching import GraphMatchingConstructor as JGM
from lp_mp_tpu.models.mrf import MrfConstructor as JMrf
from lp_mp_tpu.models.multicut import MulticutConstructor as JMulticut
from lp_mp_tpu.models.tomography import DiscreteTomographyConstructor as JDT
from lp_mp_tpu_torch import (Direction, DiscreteTomographyConstructor, Engine, FactorGraph,
                             GraphMatchingConstructor, GraphMatchingInput, MrfConstructor,
                             MulticutConstructor, Solver, engine_state_from_numpy,
                             engine_state_to_numpy)
from lp_mp_tpu_torch.factors.simplex import UNARY_SIMPLEX
from lp_mp_tpu_torch.messages.vector_equality import VECTOR_EQUALITY, VectorEqualityMessage
from tests.test_torch_engine import assert_trees_close, jax_numpy
from tests.test_torch_engine_pull import grid_recipe, qap_input

TOL = 1e-9
PASSES = 4


def twin(build):
    """(JAX graph, port graph) from ``build(G, package)``."""
    return build(JGraph, "jax"), build(FactorGraph, "port")


def mrf_build(recipe):
    def build(G, pkg):
        g = G()
        recipe((JMrf if pkg == "jax" else MrfConstructor)(g))
        return g
    return build


def run(e, mode="anisotropic", n=PASSES):
    for _ in range(n):
        e.compute_pass(mode)
    return e


def check_case(build, smode="coloring", mode="anisotropic", n=PASSES, jax_jit=False):
    """The port's pull engine against its scatter engine and against the
    JAX package's pull engine (eager unless ``jax_jit``), after ``n``
    passes of ``mode``."""
    gj, gp = twin(build)
    pull = run(Engine(gp, schedule_mode=smode, device="cpu", pull=True), mode, n)
    scatter = run(Engine(gp, schedule_mode=smode, device="cpu"), mode, n)
    jpull = run(JEngine(gj, schedule_mode=smode, use_jit=jax_jit, pull=True), mode, n)
    assert pull.pull and not scatter.pull
    got = engine_state_to_numpy(pull.state)
    assert_trees_close(engine_state_to_numpy(scatter.state), got, atol=TOL)
    assert_trees_close(jax_numpy(jpull.state), got, atol=TOL)
    assert abs(pull.lower_bound() - scatter.lower_bound()) < TOL
    assert abs(pull.lower_bound() - jpull.lower_bound()) < TOL
    return pull


@pytest.mark.parametrize("potts", [True, False])
@pytest.mark.parametrize("schedule", ["coloring", "wavefront"])
@pytest.mark.parametrize("mode", ["anisotropic", "uniform", "damped_uniform"])
def test_pull_matches_scatter_mrf(potts, schedule, mode):
    check_case(mrf_build(grid_recipe(8, 8, potts=potts)), schedule, mode)


@pytest.mark.parametrize("potts", [True, False])
def test_pull_matches_scatter_strided_grid(potts):
    """A grid large enough that every slot fits a strided pattern (the
    8x8 grid's slots fall back to gathers), incl. the (-1, 15, 16) receive
    sheet whose first lane reads row -1."""
    from lp_mp_tpu_torch.engine_pull import pull_stats
    e = check_case(mrf_build(grid_recipe(16, 16, L=4, potts=potts)), jax_jit=True)
    stats = pull_stats(e)
    assert all(v["strided"] == v["slots"] for v in stats.values()), stats


def triplet_build(G, pkg):
    """Dense pairwise + tightening triplets: pairwise_triplet messages."""
    rng = np.random.default_rng(9)
    g = G()
    m = (JMrf if pkg == "jax" else MrfConstructor)(g)
    m.add_unary_factors(rng.normal(size=(6, 3)))
    for (i, j) in ((0, 1), (1, 2), (0, 2), (2, 3), (3, 4), (2, 4), (4, 5)):
        m.add_pairwise_factor(i, j, rng.normal(size=(3, 3)))
    m.add_tightening_triplet(0, 1, 2)
    m.add_tightening_triplet(2, 3, 4)
    return g


def test_pull_matches_scatter_with_triplets():
    check_case(triplet_build)


def test_pull_matches_scatter_multicut_with_wheels():
    """tests/test_pull_pass.py's instance: a random graph on 12 nodes, one
    separation round of at most 10 constraints on each package's engine."""
    def build(G, pkg):
        rng = np.random.default_rng(3)
        s = JSolver() if pkg == "jax" else Solver(device="cpu")
        mc = s.add_constructor(JMulticut if pkg == "jax" else MulticutConstructor)
        n = 12
        pairs = np.asarray([(i, j) for i in range(n) for j in range(i + 1, n)
                            if rng.random() < 0.5])
        mc.add_edges(pairs, rng.normal(size=len(pairs)))
        eng0 = (JEngine(s.graph, schedule_mode="coloring", use_jit=False) if pkg == "jax"
                else Engine(s.graph, schedule_mode="coloring", device="cpu"))
        mc.tighten(eng0, max_constraints=10)
        return s.graph
    gj, gp = twin(build)
    assert gj.n_factors == gp.n_factors and len(gj.messages) == len(gp.messages)
    check_case(build)


def test_pull_matches_scatter_multicut_wheel_k():
    """Triplets, an odd 3-wheel and an odd 5-wheel: every multicut message
    type's hooks (edge-triplet, edge-K4-wheel, edge-wheel-k, triplet-wheel-k)."""
    def build(G, pkg):
        rng = np.random.default_rng(7)
        g = G()
        mc = (JMulticut if pkg == "jax" else MulticutConstructor)(g)
        rim = [1, 2, 3, 4, 5]
        pairs = [(0, v) for v in rim] + [(v, rim[(i + 1) % 5]) for i, v in enumerate(rim)]
        pairs += [(1, 3), (2, 4), (5, 6), (6, 1)]
        mc.add_edges(np.asarray(pairs), rng.normal(size=len(pairs)) - 0.2)
        mc.add_triplet(0, 1, 2)
        mc.add_triplet(1, 2, 3)
        mc.add_odd_3_wheel(0, 1, 2, 3)
        mc.add_odd_wheel_k(0, rim)
        return g
    e = check_case(build)
    assert any(n.startswith("multicut_triplet_wheel_k") for n in e.msgs)


def test_pull_matches_scatter_qap():
    n, assignments, edges = qap_input()

    def build(G, pkg):
        g = G()
        C, Inp = (JGM, JGMInput) if pkg == "jax" else (GraphMatchingConstructor,
                                                        GraphMatchingInput)
        C(g, construction="left").construct(Inp(n, n, assignments, edges))
        return g
    check_case(build)


def tomography_graphs():
    """tests/test_pull_pass.py:test_counting_not_pull_supported's chain."""
    def build(G, pkg):
        rng = np.random.default_rng(5)
        s = JSolver() if pkg == "jax" else Solver(device="cpu")
        dt = s.add_constructor(JDT if pkg == "jax" else DiscreteTomographyConstructor)
        for q in range(6):
            dt.add_unary_factor(rng.normal(size=3))
            if q:
                dt.add_pairwise_factor(q - 1, q, rng.normal(size=(3, 3)) * 0.3)
        dt.add_projection(range(6), 0.05 * np.abs(np.arange(13) - 5.0))
        return s.graph
    return twin(build)


def test_counting_not_pull_supported():
    """Counting messages have no pull hooks: ``pull=True`` raises and names
    them, ``pull="auto"`` runs the scatter pass, monotone, equal to the
    default engine's."""
    _, g = tomography_graphs()
    with pytest.raises(ValueError, match="hooks.*unary_counting"):
        Engine(g, schedule_mode="coloring", device="cpu", pull=True)
    e = Engine(g, schedule_mode="coloring", device="cpu", pull="auto")
    assert not e._pull_supported(e.plans[Direction.forward]) and not e.pull
    ref = Engine(g, schedule_mode="coloring", device="cpu")
    lb0 = e.lower_bound()
    e.compute_pass("anisotropic")
    ref.compute_pass("anisotropic")
    assert e.lower_bound() >= lb0 - 1e-6
    assert e.lower_bound() == ref.lower_bound()


def test_pull_monotone_lb():
    _, g = twin(mrf_build(grid_recipe(10, 10, seed=11)))
    e = Engine(g, schedule_mode="coloring", device="cpu", pull=True)
    prev = e.lower_bound()
    for _ in range(8):
        e.compute_pass("anisotropic")
        cur = e.lower_bound()
        assert cur >= prev - 1e-9
        prev = cur


@pytest.mark.parametrize("update_mode", ["residual", "adaptive", "partition"])
def test_pull_requires_shared_update_mode(update_mode):
    _, g = twin(mrf_build(grid_recipe(4, 4)))
    with pytest.raises(ValueError, match="update_mode='shared'"):
        Engine(g, device="cpu", update_mode=update_mode, pull=True)
    with pytest.raises(ValueError, match="True, False or 'auto'"):
        Engine(g, device="cpu", pull="yes")


def test_captured_pull_is_bit_equal_to_eager():
    """``use_jit=True`` (the buffers and direct calls of capture.py on the
    CPU) against ``use_jit=False``; primal and restricted passes stay on the
    scatter path and agree too."""
    _, g = twin(mrf_build(grid_recipe(16, 16, L=4)))
    es = [Engine(g, schedule_mode="coloring", device="cpu", pull=True, use_jit=j)
          for j in (False, True)]
    for e in es:
        run(e, "anisotropic", 3)
        run(e, "damped_uniform", 2)
    a, b = (engine_state_to_numpy(e.state) for e in es)
    for t in a:
        for k in a[t]:
            assert np.array_equal(a[t][k], b[t][k]), (t, k)
    assert es[0].lower_bound() == es[1].lower_bound()
    for d in Direction:
        p0, p1 = (e.compute_pass_and_primal("damped_uniform", d) for e in es)
        assert all(torch.equal(p0[t][k], p1[t][k]) for t in p0 for k in p0[t])


def test_state_carried_through_the_jax_pull_engine():
    """The port's state after two passes goes into the JAX pull engine
    (``convert``) and back: the next pass of each gives the same state."""
    gj, gp = twin(mrf_build(grid_recipe(16, 16, L=4)))
    pe = run(Engine(gp, schedule_mode="coloring", device="cpu", pull=True), n=2)
    je = JEngine(gj, schedule_mode="coloring", pull=True)
    # copies: on the CPU the arrays would share the port's state buffers,
    # which its next pass overwrites (capture.py, "Ownership")
    je.set_state({t: {k: v.copy() for k, v in blk.items()}
                  for t, blk in engine_state_to_numpy(pe.state).items()})
    back = Engine(gp, schedule_mode="coloring", device="cpu", pull=True)
    back.set_state(engine_state_from_numpy(jax_numpy(je.state)))
    for e in (pe, je, back):
        e.compute_pass("anisotropic")
    got = engine_state_to_numpy(pe.state)
    assert_trees_close(jax_numpy(je.state), got, atol=TOL)
    assert_trees_close(engine_state_to_numpy(back.state), got, atol=0.0)


class DisjointVectorEquality(VectorEqualityMessage):
    """A slot-disjoint type with pull hooks: leaves that receive from one
    hub in one phase get the engine's 1/k receive scale."""
    name = "vector_equality_disjoint"
    slot_disjoint = True


class JDisjointVectorEquality(JVectorEquality):
    name = "vector_equality_disjoint"
    slot_disjoint = True


def star(G, U, M, VEQ, k=5, seed=2):
    """k leaves on one hub (type ``M``), each leaf also tied to a private
    unary (``VEQ``), so a leaf sends back only part of what it received."""
    rng = np.random.default_rng(seed)
    g = G()
    hub = g.add_factor(U, rng.normal(size=4) * 3.0)
    for _ in range(k):
        leaf = g.add_factor(U, rng.normal(size=4))
        g.add_message(M, leaf, hub)
        g.add_message(VEQ, leaf, g.add_factor(U, rng.normal(size=4)))
    return g


def test_slot_disjoint_receives_keep_the_recv_scale():
    """Five leaves receive from one hub in the one phase of a slot-disjoint
    star.  The port's pull pass folds the 1/5 receive scale into its lane
    weights and follows its scatter pass; the JAX package's pull pass moves
    five full receives out of the hub in one phase (its ``fold_weights``
    ignores ``_recv_scales``) and leaves the scatter pass."""
    M = DisjointVectorEquality()
    gp = star(FactorGraph, UNARY_SIMPLEX, M, VECTOR_EQUALITY)
    pull = Engine(gp, schedule_mode="coloring", device="cpu", pull=True)
    scatter = Engine(gp, schedule_mode="coloring", device="cpu")
    assert len(pull.phases[Direction.forward]) == 1
    for _ in range(3):
        pull.compute_pass("uniform")
        scatter.compute_pass("uniform")
        assert_trees_close(engine_state_to_numpy(scatter.state),
                           engine_state_to_numpy(pull.state), atol=TOL)
        assert abs(pull.lower_bound() - scatter.lower_bound()) < TOL

    gj = star(JGraph, J_UNARY, JDisjointVectorEquality(), JVEQ)
    jpull = JEngine(gj, schedule_mode="coloring", use_jit=False, pull=True)
    jscatter = JEngine(gj, schedule_mode="coloring", use_jit=False, pass_style="unrolled")
    jpull.compute_pass("uniform")
    jscatter.compute_pass("uniform")
    p = jax_numpy(jpull.state)["unary_simplex"]["c"]
    s = jax_numpy(jscatter.state)["unary_simplex"]["c"]
    assert np.abs(p - s).max() > 1e-3                  # the reference's fault shows
