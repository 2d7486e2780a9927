"""Tightening on the card (float32) against the same runs on the CPU.

Marked ``gpu``: where no CUDA device is present every test skips with a
reason.  On a machine with an NVIDIA GPU run ``python -m pytest --noconftest
tests/test_torch_tightening_cuda.py`` (the conftest imports JAX, which this
file does not need).  The frustrated 3-cycle and 4-cycle close to lb 1.0
on the card, through the absorbing aux pass and through cycle separation;
a 40x40 multicut ``Solver`` run with cycle tightening and GAEC rounding
ends within 1e-5 relative of the same run on the CPU in float32.
"""
import numpy as np
import pytest
import torch

from lp_mp_tpu_torch import (MrfConstructor, MulticutConstructor, Solver,
                             StandardTighteningVisitor)

pytestmark = pytest.mark.gpu

NEG_POTTS = np.array([[1.0, 0.0], [0.0, 1.0]])
POS_POTTS = 1.0 - NEG_POTTS


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def frustrated_cycle_solver(n, device):
    s = Solver(visitor=StandardTighteningVisitor(
        max_iter=150, tighten=True, tighten_iteration=5, tighten_interval=10,
        tighten_constraints_max=4, tighten_reparametrization="damped_uniform"),
        device=device, dtype=torch.float32)
    mrf = s.add_constructor(MrfConstructor, pairwise_rep="dense")
    for _ in range(n):
        mrf.add_unary_factor(np.zeros(2))
    mrf.add_pairwise_factor(0, 1, NEG_POTTS)
    for i in range(1, n - 1):
        mrf.add_pairwise_factor(i, i + 1, POS_POTTS)
    mrf.add_pairwise_factor(0, n - 1, POS_POTTS)
    return s, mrf


@pytest.mark.parametrize("n", [3, 4])
def test_frustrated_cycle_closes_on_cuda(cuda, n):
    s, mrf = frustrated_cycle_solver(n, cuda)
    lb = s.solve()
    assert s.engine.state["pairwise_simplex"]["c"].is_cuda
    assert abs(lb - 1.0) <= 1e-5, lb
    assert len(mrf.triplets) >= n - 2
    if n == 3:                                  # the triangle's triplet is absorbed
        assert s.aux.n == 1 and s.n_engine_builds == 1 and s.aux.mrf.c.is_cuda
    assert s.primal_cost() >= lb - 1e-5


def grid40_multicut(device):
    rng = np.random.default_rng(8)
    idx = np.arange(40 * 40).reshape(40, 40)
    pairs = np.concatenate([np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], axis=1),
                            np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], axis=1)])
    costs = rng.normal(loc=0.4, scale=1.0, size=len(pairs))
    s = Solver(visitor=StandardTighteningVisitor(
        max_iter=40, tighten=True, tighten_iteration=10, tighten_interval=20,
        tighten_slope=0.05, tighten_constraints_max=600), schedule_mode="auto",
        device=device, dtype=torch.float32)
    mc = s.add_constructor(MulticutConstructor)
    mc.add_edges(pairs, costs)
    return s, mc


def test_multicut_grid40_solver_matches_cpu(cuda):
    (sg, mg), (sc, mcpu) = grid40_multicut(cuda), grid40_multicut("cpu")
    lb_g, lb_c = sg.solve(), sc.solve()
    assert sg.engine.state["multicut_edge"]["c"].is_cuda
    assert len(mg.triplets) > 0
    assert abs(lb_g - lb_c) <= 1e-5 * abs(lb_c), (lb_g, lb_c)
    assert np.isfinite(sg.primal_cost())
    assert abs(sg.primal_cost() - sc.primal_cost()) <= 1e-5 * abs(sc.primal_cost())
    assert sg.primal_cost() >= lb_g - 1e-5 * abs(lb_g)
