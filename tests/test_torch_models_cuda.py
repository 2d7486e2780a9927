"""Graph matching and tomography on the card (float32) against the port's
own CPU float64 runs.

Marked ``gpu``: where no CUDA device is present every test skips with a
reason.  On a machine with an NVIDIA GPU run ``python -m pytest --noconftest
tests/test_torch_models_cuda.py`` (the conftest imports JAX, which this file
does not need).  ``tomography_10x32`` and ``qap_16x16`` of bench.py, built
by ``chip_smoke.py``'s ``tomography_chains`` and ``qap_input``, go through ``Solver`` with ``StandardVisitor(max_iter=60)`` and
``schedule_mode="auto"`` on both devices: the card's bound within 1e-4
relative of the CPU's; tomography closes its gap to 1e-4 |lb|, and the
matching's gap stays within 1e-3 of the CPU's (float32 may break ties in
another order, so the matching itself is not held).
"""
import numpy as np
import pytest
import torch

from chip_smoke import qap_input, tomography_chains
from lp_mp_tpu_torch import (DiscreteTomographyConstructor, GraphMatchingConstructor, Solver,
                             StandardVisitor)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def solver(device):
    dtype = torch.float32 if torch.device(device).type == "cuda" else torch.float64
    return Solver(visitor=StandardVisitor(max_iter=60), schedule_mode="auto", device=device,
                  dtype=dtype)


def tomography_10x32(device):
    s = solver(device)
    tomography_chains(s.add_constructor(DiscreteTomographyConstructor), 10, 32, 3, seed=10)
    return s


def qap_16x16(device):
    s = solver(device)
    s.add_constructor(GraphMatchingConstructor, construction="left").construct(
        qap_input(16, 600, seed=9))
    return s


def gap(s):
    return (s.primal_cost() - s.lower_bound()) / max(1.0, abs(s.primal_cost()))


def test_tomography_10x32_on_cuda_matches_cpu(cuda):
    sg, sc = tomography_10x32(cuda), tomography_10x32("cpu")
    lb_g, lb_c = sg.solve(), sc.solve()
    assert sg.engine.state["counting_chain"]["lam"].is_cuda
    assert sg.engine.schedule_mode == sc.engine.schedule_mode == "coloring"
    assert abs(lb_g - lb_c) <= 1e-4 * abs(lb_c), (lb_g, lb_c)
    assert sg.primal_cost() - lb_g <= 1e-4 * abs(lb_g)


def test_qap_16x16_on_cuda_matches_cpu(cuda):
    sg, sc = qap_16x16(cuda), qap_16x16("cpu")
    lb_g, lb_c = sg.solve(), sc.solve()
    assert sg.engine.state["pairwise_simplex"]["c"].is_cuda
    assert abs(lb_g - lb_c) <= 1e-4 * abs(lb_c), (lb_g, lb_c)
    assert np.isfinite(sg.primal_cost()) and sg.primal_cost() >= lb_g
    assert gap(sg) <= gap(sc) + 1e-3, (gap(sg), gap(sc))
