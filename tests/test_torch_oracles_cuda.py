"""The exact oracles, checkpoints and the command line on the card (float32)
against the port's own CPU float64 runs.

Marked ``gpu``: where no CUDA device is present every test skips with a
reason.  On a machine with an NVIDIA GPU run ``python -m pytest --noconftest
tests/test_torch_oracles_cuda.py`` (the conftest imports JAX, which this
file does not need).  The card's costs are float32 cast to float64, so
HiGHS may pick another optimum on a tie: the card is held to the CPU's
costs, never to its labellings.
"""
import numpy as np
import pytest
import torch

from lp_mp_tpu_torch import (MrfConstructor, Solver, StandardVisitor, combi_lp, ilp_round,
                             load_checkpoint, restore, save_checkpoint, snapshot,
                             solve_lp_relaxation)
from lp_mp_tpu_torch.cli import main

pytestmark = pytest.mark.gpu

# the chain of tests/test_cli_and_db.py with its 1e10 entries at 5.0: float32
# spaces numbers near 1e10 by 1024, which would swamp the bounds' difference
UAI_CHAIN = ("MARKOV\n3\n2 2 3\n5\n1 0\n1 1\n1 2\n2 0 1\n2 1 2\n\n2\n 0.436 0.564\n\n"
             "2\n 0.128 0.872\n\n3\n 0.920 0.080 0.222\n\n4\n 5.0 0.872\n 0.920 0.080\n\n"
             "6\n 5.0 0.333 0.457\n 0.811 0.000 0.189\n")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def random_mrf(device, n=6, L=3, seed=1, max_iter=10):
    """A random loopy MRF (edges with probability 0.6), float32 on the
    card and float64 on the CPU."""
    dtype = torch.float32 if torch.device(device).type == "cuda" else torch.float64
    s = Solver(visitor=StandardVisitor(max_iter=max_iter), device=device, dtype=dtype)
    mrf = s.add_constructor(MrfConstructor, pairwise_rep="dense")
    rng = np.random.default_rng(seed)
    for _ in range(n):
        mrf.add_unary_factor(rng.normal(size=L))
    for i in range(n):
        for j in range(i + 1, n):
            if rng.random() < 0.6:
                mrf.add_pairwise_factor(i, j, rng.normal(size=(L, L)))
    return s


def test_exact_oracles_on_cuda_match_cpu(cuda):
    out = {}
    for dev in (cuda, "cpu"):
        s = random_mrf(dev)
        s.build_engine()
        for _ in range(5):
            s.engine.compute_pass("anisotropic")
        prim, cost = ilp_round(s.engine)
        assert prim["unary_simplex"]["x"].device.type == torch.device(dev).type
        assert prim["unary_simplex"]["x"].dtype == torch.int32
        _, ccost = combi_lp(s.engine)
        out[str(dev)] = (cost, ccost, solve_lp_relaxation(s.engine), s.engine.lower_bound())
    (c_g, cc_g, lp_g, lb_g), (c_c, cc_c, lp_c, _) = out[str(cuda)], out["cpu"]
    assert abs(c_g - c_c) <= 1e-5 * max(1.0, abs(c_c)), (c_g, c_c)
    assert abs(cc_g - c_c) <= 1e-5 * max(1.0, abs(c_c)), (cc_g, c_c)
    assert abs(lp_g - lp_c) <= 1e-5 * max(1.0, abs(lp_c)), (lp_g, lp_c)
    assert lb_g <= lp_g + 1e-4 * max(1.0, abs(lp_g))


def test_ilp_rounding_solver_on_cuda(cuda):
    s = random_mrf(cuda, max_iter=20)
    s.exact_rounding = "ilp"
    lb = s.solve()
    ref = random_mrf("cpu")
    ref.build_engine()
    _, opt = ilp_round(ref.engine)
    assert abs(s.primal_cost() - opt) <= 1e-5 * max(1.0, abs(opt))
    assert lb <= s.primal_cost() + 1e-4


def test_checkpoint_round_trip_on_cuda(cuda, tmp_path):
    s = random_mrf(cuda)
    lb = s.solve()
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, s.engine, best_primal=s.best_primal,
                    best_primal_cost=s.best_primal_cost, iteration=10)
    s2 = random_mrf(cuda)
    s2.build_engine()
    prim, cost, it = load_checkpoint(path, s2.engine)
    assert it == 10 and cost == s.best_primal_cost
    assert s2.engine.state["unary_simplex"]["c"].is_cuda
    assert s2.engine.state["unary_simplex"]["c"].dtype == torch.float32
    assert s2.engine.lower_bound() == lb
    assert s2.engine.evaluate_primal(prim) == pytest.approx(cost, rel=1e-6)
    snap = snapshot(s2.engine)
    s2.engine.compute_pass("anisotropic")
    restore(s2.engine, snap)
    assert s2.engine.lower_bound() == lb


def test_cli_on_cuda_matches_cpu(cuda, tmp_path, capsys):
    inp = tmp_path / "chain.uai"
    inp.write_text(UAI_CHAIN)
    got = {}
    for dev in ("cuda", "cpu"):
        assert main(["mrf", str(inp), "--maxIter", "20", "-v", "0", "--device", dev]) == 0
        lines = capsys.readouterr().out.splitlines()
        got[dev] = [float(line.split(":")[1]) for line in lines
                    if line.startswith(("lower", "upper"))]
    for a, b in zip(got["cuda"], got["cpu"]):
        assert abs(a - b) <= 1e-4 * max(1.0, abs(b)), (got["cuda"], got["cpu"])
