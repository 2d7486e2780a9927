"""The generic engine on the card (float32) against the same engine on the
CPU (float64).

Marked ``gpu``: where no CUDA device is present every test skips with a
reason.  On a machine with an NVIDIA GPU run ``python -m pytest --noconftest
tests/test_torch_engine_cuda.py`` (the conftest imports JAX, which this file
does not need).  ``index_add`` on CUDA sums duplicate indices with float
atomics in a varying order, so the bounds are held within 1e-5 relative, not
bit for bit.
"""
import numpy as np
import pytest
import torch

from lp_mp_tpu_torch import Direction, Engine, FactorGraph, MrfConstructor, random_grid
from lp_mp_tpu_torch.models.grid_potts import grid_potts_edges

pytestmark = pytest.mark.gpu

REL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def random_mrf_graph(seed=42, n=12, extra_edges=6, maxL=4):
    """Mixed label counts, so padded lanes take part."""
    rng = np.random.default_rng(seed)
    g = FactorGraph()
    mrf = MrfConstructor(g, pairwise_rep="dense")
    Ls = rng.integers(2, maxL + 1, size=n)
    for i in range(n):
        mrf.add_unary_factor(rng.normal(size=Ls[i]))
    edges = {(i, i + 1) for i in range(n - 1)}
    while len(edges) < n - 1 + extra_edges:
        i, j = sorted(rng.integers(0, n, size=2))
        if i != j:
            edges.add((i, j))
    for i, j in sorted(edges):
        mrf.add_pairwise_factor(int(i), int(j), rng.normal(size=(Ls[i], Ls[j])))
    return g


def grid_graph(H=32, W=32, L=4, seed=1):
    u, hc, vc = random_grid(H, W, L, seed=seed)
    g = FactorGraph()
    mrf = MrfConstructor(g)
    mrf.add_unary_factors(u.reshape(H * W, L))
    pairs, diffs = grid_potts_edges(hc, vc)
    mrf.add_potts_factors(pairs, L, diffs)
    return g


def rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


@pytest.mark.parametrize("graph,smode", [(random_mrf_graph, "wavefront"),
                                         (grid_graph, "coloring")],
                         ids=["random_mrf", "grid32"])
@pytest.mark.parametrize("mode", ["anisotropic", "damped_uniform"])
def test_cuda_engine_matches_cpu_float64(cuda, graph, smode, mode):
    g = graph()
    ec = Engine(g, schedule_mode=smode, device="cpu")
    eg = Engine(g, schedule_mode=smode, device=cuda)
    assert eg.dtype == torch.float32 and ec.dtype == torch.float64
    assert eg.state["unary_simplex"]["c"].is_cuda
    for _ in range(10):
        ec.compute_pass(mode)
        eg.compute_pass(mode)
        assert rel(eg.lower_bound(), ec.lower_bound()) <= REL
    pg = eg.compute_pass_and_primal("damped_uniform", Direction.forward)
    assert eg.check_primal_consistency(pg)
    ub = eg.evaluate_primal(pg)
    assert np.isfinite(ub) and ub >= eg.lower_bound() - REL * abs(eg.lower_bound())


@pytest.mark.parametrize("shape", [(1000, 4), (1000, 8, 8), (1000, 2), (1000, 16)])
def test_cuda_row_gather_matches_indexing(cuda, shape):
    from lp_mp_tpu_torch.engine import _gather
    t = torch.randn(shape, device=cuda)
    n = torch.arange(1000, device=cuda, dtype=torch.int32)
    idx = torch.randint(0, 1000, (3000,), device=cuda)
    out = _gather({"c": t, "n": n}, idx)
    assert torch.equal(out["c"], t[idx]) and torch.equal(out["n"], n[idx])


def test_cuda_restricted_rounding_is_feasible(cuda):
    eg = Engine(grid_graph(16, 16, 3, seed=4), schedule_mode="coloring", device=cuda)
    for _ in range(5):
        eg.compute_pass("anisotropic")
    for d in (Direction.forward, Direction.backward):
        p = eg.compute_pass_and_primal("damped_uniform", d, restricted=True)
        assert eg.check_primal_consistency(p)
        assert np.isfinite(eg.evaluate_primal(p))
