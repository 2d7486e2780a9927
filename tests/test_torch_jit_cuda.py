"""Captured execution (``use_jit``) on the card: a replayed CUDA graph
against the eager pass, a host sync under capture, launch counts through
replays, and one graph launch per pass.

Marked ``gpu``: where no CUDA device is present every test skips with a
reason.  On a machine with an NVIDIA GPU run ``python -m pytest --noconftest
tests/test_torch_jit_cuda.py`` (the conftest imports JAX, which this file
does not need).  ``index_add`` on CUDA sums duplicate indices with float
atomics in a varying order, so states agree within 1e-5 (1 + max|x|) and
bounds within 1e-5 relative, not bit for bit.
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lp_mp_tpu_torch import (Direction, Engine, FactorGraph, GridPottsModel, MrfConstructor,
                             ShardedGridPotts, random_grid)
from lp_mp_tpu_torch.capture import Graphs
from lp_mp_tpu_torch.models.grid_potts import grid_potts_edges
from lp_mp_tpu_torch.ops.grid_kernels import launch_counts, reset_launch_counts

pytestmark = pytest.mark.gpu

TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def grid_graph(H=32, W=32, L=4, seed=1):
    u, hc, vc = random_grid(H, W, L, seed=seed)
    g = FactorGraph()
    mrf = MrfConstructor(g)
    mrf.add_unary_factors(u.reshape(H * W, L))
    pairs, diffs = grid_potts_edges(hc, vc)
    mrf.add_potts_factors(pairs, L, diffs)
    return g


def state_err(a, b):
    err, scale = 0.0, 0.0
    for n in a:
        for k, v in a[n].items():
            if v.is_floating_point():
                err = max(err, float((v - b[n][k]).abs().max()))
                scale = max(scale, float(b[n][k].abs().max()))
    return err, 1.0 + scale


def test_replay_matches_eager_pass(cuda):
    on = Engine(grid_graph(), schedule_mode="coloring", device=cuda)
    off = Engine(grid_graph(), schedule_mode="coloring", device=cuda, use_jit=False)
    for e in (on, off):
        for _ in range(10):
            e.compute_pass("anisotropic")
    err, scale = state_err(on.state, off.state)
    assert err <= TOL * scale, err
    a, b = on.lower_bound(), off.lower_bound()
    assert abs(a - b) <= TOL * abs(b)
    pa = on.compute_pass_and_primal("damped_uniform", Direction.forward)
    pb = off.compute_pass_and_primal("damped_uniform", Direction.forward)
    assert np.isfinite(on.evaluate_primal(pa)) and np.isfinite(off.evaluate_primal(pb))
    st = on.jit.stats()
    assert st["captures"] >= 4 and st["replays"] >= 20 and st["pool_mb"] > 0


def test_host_sync_under_capture_raises(cuda):
    jit = Graphs(cuda, name="t")
    g = jit.jit(lambda x: x * float(x.sum()), "reads a scalar on the host")
    with pytest.raises(RuntimeError, match="reads a scalar on the host"):
        g(torch.ones(4, device=cuda))
    ok = jit.jit(lambda x: x * 2.0, "doubles")
    assert torch.equal(ok(torch.ones(4, device=cuda)), torch.full((4,), 2.0, device=cuda))


def test_launch_counts_through_replays(cuda):
    u, hc, vc = random_grid(40, 50, 4, seed=2)
    m = GridPottsModel(u, hc, vc, device=cuda)
    reset_launch_counts()
    m.run_fast(4, kernel="cuda")             # warm-up (3 launches) and one replay (3)
    assert launch_counts()["phase_update"] == 2 and launch_counts()["round_update"] == 4
    m.run_fast(4, kernel="cuda")
    assert launch_counts()["phase_update"] == 3 and launch_counts()["round_update"] == 6
    sm = ShardedGridPotts(u, hc, vc, devices=[cuda] * 2)
    reset_launch_counts()
    for _ in range(2):
        sm.run_fast(4)
    # one graph per sweep and window set, each warmed up once: the prologue
    # from either set (each call flips the set: 3 sweeps), the 2-round sweep
    # from either set
    assert launch_counts()["phase_update_sharded"] == 2 * (2 + 2)
    assert launch_counts()["round_update_sharded"] == 2 * (4 + 2)
    ref = GridPottsModel(u, hc, vc, device=cuda, use_jit=False)
    ref.run_fast(4, kernel="cuda").run_fast(4, kernel="cuda")
    for k, v in sm.dense_state().items():
        assert torch.equal(m.state[k], ref.state[k]), k      # the same launches, replayed
        assert float((v - ref.state[k]).abs().max()) <= TOL * (1 + float(ref.state[k].abs().max()))


def test_one_pass_is_one_graph_launch(cuda):
    e = Engine(grid_graph(), schedule_mode="coloring", device=cuda)
    e.compute_forward_pass("anisotropic")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        e.compute_forward_pass("anisotropic")
        torch.cuda.synchronize()
    names = [ev.name for ev in prof.events()]
    assert names.count("cudaGraphLaunch") == 1, sorted(set(names))
    assert not any(n in ("cudaLaunchKernel", "cudaLaunchKernelExC") for n in names), \
        sorted(set(names))


def test_capture_after_reset(cuda):
    """An owner whose graphs were all dropped (the aux passes' growth) captures
    again, into a new pool."""
    jit = Graphs(cuda, name="t")
    g = jit.jit(lambda x: x + 1.0, "adds one")
    g(torch.ones(3, device=cuda))
    jit.reset()
    assert torch.equal(g(torch.ones(3, device=cuda)), torch.full((3,), 2.0, device=cuda))
    assert torch.equal(g(torch.ones(5, device=cuda)), torch.full((5,), 2.0, device=cuda))
    assert jit.stats()["captures"] == 3
