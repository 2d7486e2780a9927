"""The port's structured pull pass primitives (lp_mp_tpu_torch.engine_pull)
against brute force and against the JAX package's (lp_mp_tpu.engine_pull).

Mirrors tests/test_engine_pull.py case by case: the strided read and
in-place accumulation match brute-force gather/scatter for every pattern
regime (T > P, T == P, T < P overlapping, T == 0 broadcast, negative base,
out-of-range trimming), and fit/decompose recover the maps real model
builders produce.  Then the same numpy inputs go through both packages'
functions (equal in float64, patterns equal), and ``pull_stats`` of the
port's ``Engine`` equals the JAX package's (slots, patterns, lane ranges)
on Potts grids under coloring and wavefront, a chain, a small QAP and a
multicut with triplets and a wheel.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lp_mp_tpu import engine_pull as jpull
from lp_mp_tpu.config import Direction as JDirection
from lp_mp_tpu.engine import Engine as JEngine
from lp_mp_tpu.graph import FactorGraph as JGraph
from lp_mp_tpu.io.torresani import GraphMatchingInput as JGMInput
from lp_mp_tpu.models.graph_matching import GraphMatchingConstructor as JGM
from lp_mp_tpu.models.mrf import MrfConstructor as JMrf
from lp_mp_tpu.models.multicut import MulticutConstructor as JMulticut
from lp_mp_tpu_torch import (Direction, Engine, FactorGraph, GraphMatchingConstructor,
                             GraphMatchingInput, MrfConstructor, MulticutConstructor,
                             random_grid)
from lp_mp_tpu_torch.models.grid_potts import grid_potts_edges
from lp_mp_tpu_torch.engine_pull import (Strided, _pieces, decompose,
                                         fit_pattern, pull_stats, strided_accumulate,
                                         strided_accumulate_into, strided_read)


def brute_read(src, pat, n_lanes):
    b, T, P = pat.b, pat.T, pat.P
    out = np.zeros((n_lanes,) + src.shape[1:], src.dtype)
    for u in range(n_lanes):
        r = b + (u // P) * T + (u % P)
        if 0 <= r < src.shape[0]:
            out[u] = src[r]
    return out


def brute_acc(contrib, pat, n_rows):
    b, T, P = pat.b, pat.T, pat.P
    out = np.zeros((n_rows,) + contrib.shape[1:], contrib.dtype)
    for u in range(contrib.shape[0]):
        r = b + (u // P) * T + (u % P)
        if 0 <= r < n_rows:
            out[r] += contrib[u]
    return out


def rows_of(pat, n_lanes):
    u = np.arange(n_lanes)
    return pat.b + (u // pat.P) * pat.T + (u % pat.P)


PATTERNS = [
    Strided(0, 100, 100),      # identity blocks
    Strided(7, 100, 100),      # constant offset
    Strided(-3, 100, 100),     # negative base
    Strided(0, 100, 99),       # T > P (grid send)
    Strided(-1, 99, 100),      # T < P overlapping (grid recv)
    Strided(5, 40, 100),       # T << P, 3 residue chunks per add
    Strided(2, 0, 37),         # broadcast
    Strided(950, 100, 100),    # reads past the end (trim)
]


@pytest.mark.parametrize("pat", PATTERNS)
@pytest.mark.parametrize("tail", [(), (4,)])
def test_strided_read_matches_bruteforce(pat, tail):
    rng = np.random.default_rng(0)
    src = rng.normal(size=(1000,) + tail)
    for n_lanes in (1, 50, 997, 1003):
        got = strided_read(torch.from_numpy(src), pat, n_lanes).numpy()
        want = brute_read(src, pat, n_lanes)
        # the port zeroes lanes whose pattern row is out of range (the JAX
        # package leaves garbage there): every lane is comparable
        assert np.array_equal(got, want), (pat, n_lanes)


@pytest.mark.parametrize("pat", PATTERNS)
@pytest.mark.parametrize("tail", [(), (3,)])
def test_strided_accumulate_matches_bruteforce(pat, tail):
    rng = np.random.default_rng(1)
    for n_lanes in (1, 64, 997):
        contrib = rng.normal(size=(n_lanes,) + tail)
        # zero lanes whose target row is out of range (caller contract)
        r = rows_of(pat, n_lanes)
        contrib[(r < 0) | (r >= 800)] = 0.0
        got = strided_accumulate(torch.from_numpy(contrib), pat, 800).numpy()
        want = brute_acc(contrib, pat, 800)
        assert np.allclose(got, want, atol=1e-12), (pat, n_lanes)


def test_accumulate_into_is_in_place_and_keeps_other_rows():
    acc = torch.arange(12.0).reshape(6, 2)
    before = acc.clone()
    contrib = torch.ones(4, 2)
    out = strided_accumulate_into(acc, contrib, Strided(-1, 3, 2))   # rows -1, 0, 2, 3
    assert out is acc
    want = before.clone()
    want[[0, 2, 3]] += 1.0
    assert torch.equal(acc, want)


def test_fit_pattern_regimes():
    u = np.arange(1000)
    for pat in PATTERNS[:6]:
        f = rows_of(pat, 1000)
        valid = f >= 0
        got = fit_pattern(f * valid, valid)
        assert got is not None
        assert np.array_equal(
            got.b + (u[valid] // got.P) * got.T + (u[valid] % got.P),
            f[valid]), (pat, got)


def test_fit_pattern_irregular_returns_none():
    rng = np.random.default_rng(2)
    f = rng.integers(0, 1000, size=500)
    valid = np.ones(500, dtype=bool)
    assert fit_pattern(f, valid) is None


def mixed_grid_sheets(H=50, W=50):
    """Single-chunk grid build: slot 0 of the unary-side recv op holds the
    H-edge sheet on most lanes and the V-edge sheet on the last column."""
    EH = H * (W - 1)
    f = np.zeros(H * W, dtype=np.int64)
    valid = np.zeros(H * W, dtype=bool)
    for r in range(H):
        for c in range(W):
            u = r * W + c
            if c < W - 1:                  # H edge (r, c)-(r, c+1)
                f[u] = r * (W - 1) + c
                valid[u] = True
            elif r < H - 1:                # V edge fills the rank-0 slot
                f[u] = EH + r * W + c
                valid[u] = True
    return f, valid


def test_decompose_mixed_grid_sheets():
    """decompose must explain every lane with strided sheets (no fallback)."""
    H = W = 50
    f, valid = mixed_grid_sheets(H, W)
    sheets = decompose(f, valid, row_cap=10 * H * W)
    assert all(pat is not None for pat, _ in sheets), sheets
    covered = np.zeros(H * W, dtype=bool)
    for pat, m in sheets:
        u = np.nonzero(m)[0]
        assert np.array_equal(
            pat.b + (u // pat.P) * pat.T + (u % pat.P), f[u])
        assert not (covered & m).any()
        covered |= m
    assert np.array_equal(covered, valid)


def test_decompose_random_falls_back():
    rng = np.random.default_rng(3)
    f = rng.integers(0, 5000, size=2000)
    valid = np.ones(2000, dtype=bool)
    sheets = decompose(f, valid, row_cap=50000)
    covered = np.zeros(2000, dtype=bool)
    for pat, m in sheets:
        covered |= m
    assert covered.all()
    assert any(pat is None for pat, m in sheets)  # gather sheet remains


# ---------------------------------------------------------------------------
# pieces: views that stay inside both blocks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pat", PATTERNS)
def test_pieces_cover_lanes_inside_both_blocks(pat):
    """Every lane with an in-range row is covered exactly once; every lane
    of a piece lies inside the receiver span and reads a row inside the
    sender block (the (-1, 99, 100) grid-receive pattern's lane 0 reads row
    -1 and must stay out)."""
    n_lanes, n_rows = 1003, 1000
    r = rows_of(pat, n_lanes)
    lanes = np.nonzero((r >= 0) & (r < n_rows))[0]
    pieces = _pieces(pat, lanes, n_rows, n_lanes)
    seen = np.zeros(n_lanes, dtype=int)
    for p in pieces:
        u = p.lanes(pat.P)
        assert (u >= 0).all() and (u < n_lanes).all()
        rows = rows_of(pat, n_lanes + pat.P)[u]
        assert (rows >= 0).all() and (rows < n_rows).all(), (pat, p)
        seen[u] += 1
    assert (seen[lanes] == 1).all() and seen.max() == 1


def test_pieces_split_off_every_block_that_leaves_the_sender_block():
    """Period 10, stride 1, lanes (k, r) with k + r < 15 (rows k + r of a
    15-row block): blocks 6-14 reach row 15 at residue 9, so each becomes a
    one-block piece of its own and the rectangle keeps blocks 0-5."""
    pat = Strided(0, 1, 10)
    lanes = np.asarray([k * 10 + r for k in range(20) for r in range(10) if k + r < 15])
    pieces = _pieces(pat, lanes, 15, 200)
    assert sorted((p.k0, p.nb) for p in pieces) == [(0, 6)] + [(k, 1) for k in range(6, 15)]
    seen = np.concatenate([p.lanes(10) for p in pieces])
    assert np.array_equal(np.sort(seen), lanes)
    assert (rows_of(pat, 200)[seen] < 15).all()


# ---------------------------------------------------------------------------
# the same numpy inputs through both packages
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("pat", PATTERNS)
def test_read_and_accumulate_equal_the_jax_package(pat):
    rng = np.random.default_rng(4)
    jpat = jpull.Strided(pat.b, pat.T, pat.P)
    src = rng.normal(size=(1000, 3))
    for n_lanes in (50, 997, 1003):
        r = rows_of(pat, n_lanes)
        ok = (r >= 0) & (r < 1000)
        got = strided_read(torch.from_numpy(src), pat, n_lanes).numpy()
        want = np.asarray(jpull.strided_read(jnp.asarray(src), jpat, n_lanes))
        assert np.array_equal(got[ok], want[ok]), (pat, n_lanes)
        contrib = rng.normal(size=(n_lanes, 3))
        contrib[~((r >= 0) & (r < 800))] = 0.0
        got = strided_accumulate(torch.from_numpy(contrib), pat, 800).numpy()
        want = np.asarray(jpull.strided_accumulate(jnp.asarray(contrib), jpat, 800))
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_fit_and_decompose_equal_the_jax_package():
    rng = np.random.default_rng(5)
    u = np.arange(1000)
    cases = []
    for pat in PATTERNS:
        f = rows_of(pat, 1000)
        cases.append((f * (f >= 0), f >= 0))
    cases.append(mixed_grid_sheets(40, 30))
    cases.append((rng.integers(0, 5000, size=2000), np.ones(2000, dtype=bool)))
    f = np.where(u % 7 == 3, rng.integers(0, 900, size=1000), 2 * u)
    cases.append((f, rng.random(1000) < 0.8))

    def tup(p):
        return None if p is None else dataclasses.astuple(p)

    for f, valid in cases:
        assert tup(fit_pattern(f, valid)) == tup(jpull.fit_pattern(f, valid))
        got = decompose(f, valid, row_cap=50_000)
        want = jpull.decompose(f, valid, row_cap=50_000)
        assert [tup(p) for p, _ in got] == [tup(p) for p, _ in want]
        for (_, m1), (_, m2) in zip(got, want):
            assert np.array_equal(m1, m2)


# ---------------------------------------------------------------------------
# pull_stats: the same slots on the same graphs
# ---------------------------------------------------------------------------
def grid_recipe(H, W, L=3, seed=5, potts=True):
    def build(mrf):
        rng = np.random.default_rng(seed)
        mrf.add_unary_factors(rng.normal(size=(H * W, L)))
        idx = np.arange(H * W).reshape(H, W)
        pairs = np.concatenate([
            np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], axis=1),
            np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], axis=1)])
        if potts:
            mrf.add_potts_factors(pairs, L, rng.uniform(0.5, 1.5, size=len(pairs)))
        else:
            mrf.add_pairwise_factors(pairs, rng.normal(size=(len(pairs), L, L)))
    return build


def chain_recipe(n=40, L=3, seed=6):
    def build(mrf):
        rng = np.random.default_rng(seed)
        mrf.add_unary_factors(rng.normal(size=(n, L)))
        mrf.add_pairwise_factors(np.stack([np.arange(n - 1), np.arange(1, n)], axis=1),
                                 rng.normal(size=(n - 1, L, L)))
    return build


def mrf_graphs(build):
    out = []
    for G, M in ((JGraph, JMrf), (FactorGraph, MrfConstructor)):
        g = G()
        build(M(g))
        out.append(g)
    return out


def qap_input(n=6, n_edges=40, seed=4):
    """tests/test_pull_pass.py:test_pull_matches_scatter_qap's instance."""
    rng = np.random.default_rng(seed)
    assignments = [(i, j, float(rng.normal())) for i in range(n) for j in range(n)]
    aid = {(i, j): k for k, (i, j, _) in enumerate(assignments)}
    edges = []
    for _ in range(n_edges):
        i1, i2 = rng.choice(n, 2, replace=False)
        j1, j2 = rng.choice(n, 2, replace=False)
        if j1 != j2:
            edges.append((aid[(i1, j1)], aid[(i2, j2)], float(rng.normal() * 0.3)))
    return n, assignments, edges


def qap_graphs():
    n, assignments, edges = qap_input()
    out = []
    for G, C, Inp in ((JGraph, JGM, JGMInput), (FactorGraph, GraphMatchingConstructor,
                                                GraphMatchingInput)):
        g = G()
        C(g, construction="left").construct(Inp(n, n, assignments, edges))
        out.append(g)
    return out


def multicut_graphs():
    """A 4x4 grid multicut with two triplets and an odd 3-wheel."""
    rng = np.random.default_rng(8)
    idx = np.arange(16).reshape(4, 4)
    pairs = np.concatenate([
        np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], axis=1),
        np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], axis=1),
        np.stack([idx[:-1, :-1].ravel(), idx[1:, 1:].ravel()], axis=1)])
    costs = rng.normal(size=len(pairs))
    out = []
    for G, M in ((JGraph, JMulticut), (FactorGraph, MulticutConstructor)):
        g = G()
        mc = M(g)
        mc.add_edges(pairs, costs)
        mc.add_triplet(0, 1, 5)
        mc.add_triplet(5, 6, 10)
        mc.add_odd_3_wheel(5, 0, 1, 4)
        out.append(g)
    return out


def percell_recipe(H, W, L=4, seed=1):
    """The grid in the per-cell order of ``grid_potts_edges`` (each cell's
    horizontal pair, then its vertical one), as chip_smoke.py's engine grid:
    a cell's pair ids step by 2 along a row, which no strided pattern fits."""
    def build(mrf):
        u, hc, vc = random_grid(H, W, L, seed=seed)
        mrf.add_unary_factors(u.reshape(H * W, L))
        pairs, diffs = grid_potts_edges(hc, vc)
        mrf.add_potts_factors(pairs, L, diffs)
    return build


STATS_CASES = {
    "percell30x20_coloring": (lambda: mrf_graphs(percell_recipe(30, 20)), "coloring"),
    "potts8_coloring": (lambda: mrf_graphs(grid_recipe(8, 8)), "coloring"),
    "potts8_wavefront": (lambda: mrf_graphs(grid_recipe(8, 8)), "wavefront"),
    "potts24_coloring": (lambda: mrf_graphs(grid_recipe(24, 24)), "coloring"),
    "dense20x17_wavefront": (lambda: mrf_graphs(grid_recipe(20, 17, potts=False)), "wavefront"),
    "chain_coloring": (lambda: mrf_graphs(chain_recipe()), "coloring"),
    "chain_wavefront": (lambda: mrf_graphs(chain_recipe()), "wavefront"),
    "qap_coloring": (qap_graphs, "coloring"),
    "multicut_coloring": (multicut_graphs, "coloring"),
}


@pytest.mark.parametrize("case", list(STATS_CASES))
def test_pull_stats_equal_the_jax_package(case):
    make, smode = STATS_CASES[case]
    gj, gp = make()
    je = JEngine(gj, schedule_mode=smode, use_jit=False, pass_style="unrolled")
    pe = Engine(gp, schedule_mode=smode, device="cpu")
    for d, jd in ((Direction.forward, JDirection.forward),
                  (Direction.backward, JDirection.backward)):
        assert pe.phases[d] == je.phases[jd]
        got, want = pull_stats(pe, d), jpull.pull_stats(je, jd)
        assert got == want, (case, d)
    if case == "potts24_coloring":          # the strided case: no fallback slot
        assert all(v["strided"] == v["slots"] for v in got.values())
    if case == "percell30x20_coloring":     # per-cell order: every slot gathers
        assert not any(v["strided"] for v in got.values())
    pull = Engine(gp, schedule_mode=smode, device="cpu", pull=True)
    assert all(pull_stats(pull, d) == pull_stats(pe, d) for d in Direction)
