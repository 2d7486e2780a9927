"""Port GridPottsModel (lp_mp_tpu_torch) vs the JAX package's GridPottsModel.

Same numpy instances (``random_grid`` is the same generator in both) through
both models on the CPU.  float64: the plain paths must agree to 1e-10 on
the bound and 1e-12 on the state, as tests/test_grid.py holds the grid model
to the generic engine.  float32: the kernel path (``kernel="cuda"``, which
on CPU tensors runs the kernels' plain versions) against JAX's Pallas path
in interpret mode, to 5e-5 as tests/test_pallas_grid.py:102-118.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from lp_mp_tpu.models.grid_potts import GridPottsModel as JaxGrid
from lp_mp_tpu_torch import (GridPottsModel, grid_state_from_numpy, random_grid,
                             real_dtype, set_dtype)
from lp_mp_tpu_torch.models.grid_potts import random_grid as port_random_grid

MODES = ["anisotropic", "uniform", "damped_uniform"]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def jax_state(m):
    return {k: np.asarray(v) for k, v in m.state.items()}


def port_state(m):
    return {k: v.cpu().numpy() for k, v in m.state.items()}


def assert_states_close(a, b, atol):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=atol, err_msg=k)


def twins(H, W, L, seed, dtype=torch.float64):
    u, hc, vc = random_grid(H, W, L, seed=seed)
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    return JaxGrid(u, hc, vc, dtype=np_dtype), GridPottsModel(u, hc, vc, dtype=dtype, device="cpu")


def test_random_grid_is_the_jax_generator():
    from lp_mp_tpu.models.grid_potts import random_grid as jax_random_grid
    for a, b in zip(port_random_grid(7, 5, 3, seed=11, potts_scale=2.0),
                    jax_random_grid(7, 5, 3, seed=11, potts_scale=2.0)):
        np.testing.assert_array_equal(a, b)


def test_initial_state_and_bound_match_jax():
    jm, pm = twins(6, 7, 3, seed=1)
    assert_states_close(jax_state(jm), port_state(pm), atol=0.0)
    assert abs(jm.lower_bound() - pm.lower_bound()) < 1e-10


@pytest.mark.parametrize("mode", MODES)
def test_iterate_matches_jax(mode):
    jm, pm = twins(6, 7, 3, seed=5)
    for _ in range(4):
        jm.iterate(mode)
        pm.iterate(mode)
        assert abs(jm.lower_bound() - pm.lower_bound()) < 1e-10
    assert_states_close(jax_state(jm), port_state(pm), atol=1e-12)


@pytest.mark.parametrize("mode", MODES)
def test_run_fast_torch_matches_jax_xla(mode):
    jm, pm = twins(7, 6, 3, seed=12)
    jm.run_fast(5, mode=mode, kernel="xla")
    pm.run_fast(5, mode=mode, kernel="torch")
    assert abs(jm.lower_bound() - pm.lower_bound()) < 1e-10
    assert_states_close(jax_state(jm), port_state(pm), atol=1e-12)


@pytest.mark.parametrize("mode", MODES)
def test_round_primal_matches_jax(mode):
    jm, pm = twins(6, 6, 3, seed=13)
    jm.iterate("anisotropic", n=3)
    pm.iterate("anisotropic", n=3)
    xj, ubj = jm.round_primal(mode)
    xp, ubp = pm.round_primal(mode)
    np.testing.assert_array_equal(xp, xj)
    assert xp.dtype == np.int32
    assert abs(ubj - ubp) < 1e-10
    assert_states_close(jax_state(jm), port_state(pm), atol=1e-12)


@pytest.mark.parametrize("mode", MODES)
def test_run_fast_kernel_path_matches_pallas_interpret(mode):
    """kernel="cuda" on CPU tensors runs the kernels' plain versions through
    the fused schedule; JAX runs its Pallas kernels in interpret mode."""
    jm, pm = twins(9, 11, 3, seed=42, dtype=torch.float32)
    jm.run_fast(3, mode=mode, kernel="pallas", interpret=True)
    pm.run_fast(3, mode=mode, kernel="cuda")
    assert_states_close(jax_state(jm), port_state(pm), atol=5e-5)
    assert abs(jm.lower_bound() - pm.lower_bound()) < 1e-3


@pytest.mark.parametrize("mode", MODES)
def test_kernel_path_matches_torch_path(mode):
    """Same fused schedule through the kernel wrappers and the plain path:
    the same ops in the same order, so equal in float64."""
    u, hc, vc = random_grid(8, 9, 4, seed=21)
    a = GridPottsModel(u, hc, vc, device="cpu").run_fast(5, mode, kernel="cuda")
    b = GridPottsModel(u, hc, vc, device="cpu").run_fast(5, mode, kernel="torch")
    assert_states_close(port_state(a), port_state(b), atol=1e-12)


def test_monotone_and_gap():
    # mirrors tests/test_grid.py::test_grid_monotone_and_gap
    u, hc, vc = random_grid(8, 8, 3, seed=6)
    grid = GridPottsModel(u, hc, vc, device="cpu")
    lbs = [grid.lower_bound()]
    for _ in range(30):
        grid.iterate("anisotropic")
        lbs.append(grid.lower_bound())
    assert all(b >= a - 1e-9 for a, b in zip(lbs, lbs[1:]))
    jm = JaxGrid(u, hc, vc)
    jm.iterate("anisotropic", n=30)
    assert abs(jm.lower_bound() - lbs[-1]) < 1e-10
    x, ub = grid.round_primal("damped_uniform")
    assert ub >= lbs[-1] - 1e-9
    assert x.shape == (8, 8)


@pytest.mark.parametrize("kernel", ["torch", "cuda"])
def test_run_fast_matches_iterate_anisotropic(kernel):
    # mirrors tests/test_grid.py::test_run_fast_matches_iterate_anisotropic
    u, hc, vc = random_grid(6, 6, 3, seed=7)
    a = GridPottsModel(u, hc, vc, device="cpu").iterate("anisotropic", n=20)
    b = GridPottsModel(u, hc, vc, device="cpu").run_fast(20, "anisotropic", kernel=kernel)
    assert abs(a.lower_bound() - b.lower_bound()) < 1e-5


@pytest.mark.parametrize("kernel", ["torch", "cuda"])
def test_run_fast_uniform_exact_two_labels(kernel):
    # mirrors tests/test_grid.py::test_run_fast_uniform_exact (L=2)
    u, hc, vc = random_grid(5, 5, 2, seed=8)
    a = GridPottsModel(u, hc, vc, device="cpu").iterate("damped_uniform", n=7)
    b = GridPottsModel(u, hc, vc, device="cpu").run_fast(7, "damped_uniform", kernel=kernel)
    assert abs(a.lower_bound() - b.lower_bound()) < 1e-9
    jm = JaxGrid(u, hc, vc)
    jm.run_fast(7, "damped_uniform")
    assert abs(jm.lower_bound() - b.lower_bound()) < 1e-10


@pytest.mark.parametrize("kernel", ["torch", "cuda"])
def test_single_label_edge_case(kernel):
    # mirrors tests/test_grid.py::test_single_label_edge_cases (L=1)
    u, hc, vc = random_grid(3, 3, 1, seed=9)
    grid = GridPottsModel(u, hc, vc, device="cpu").iterate("anisotropic", n=2)
    assert abs(grid.lower_bound() - u.sum()) < 1e-4   # diff never paid
    fast = GridPottsModel(u, hc, vc, device="cpu").run_fast(2, kernel=kernel)
    assert abs(fast.lower_bound() - u.sum()) < 1e-4
    jm = JaxGrid(u, hc, vc)
    jm.iterate("anisotropic", n=2)
    assert abs(jm.lower_bound() - grid.lower_bound()) < 1e-10


@pytest.mark.parametrize("kernel", ["torch", "cuda"])
def test_state_carried_across_from_jax(kernel):
    u, hc, vc = random_grid(7, 8, 3, seed=3)
    jm = JaxGrid(u, hc, vc)
    jm.iterate("anisotropic", n=5)
    pm = GridPottsModel(u, hc, vc, device="cpu").load_state(
        grid_state_from_numpy(jax_state(jm), device="cpu", dtype=torch.float64))
    assert_states_close(jax_state(jm), port_state(pm), atol=0.0)
    jm.run_fast(5, kernel="xla")
    pm.run_fast(5, kernel=kernel)
    assert abs(jm.lower_bound() - pm.lower_bound()) < 1e-10
    assert_states_close(jax_state(jm), port_state(pm), atol=1e-12)


def test_load_state_checks_shapes():
    pm = GridPottsModel(*random_grid(4, 5, 2, seed=0), device="cpu")
    bad = {k: v.clone() for k, v in pm.state.items()}
    bad["vm1"] = bad["hm1"]
    with pytest.raises(ValueError, match="vm1"):
        pm.load_state(bad)
    with pytest.raises(KeyError):
        grid_state_from_numpy({"u": np.zeros((2, 4, 5))})


def test_model_rejects_bad_input():
    u, hc, vc = random_grid(4, 5, 2, seed=0)
    with pytest.raises(ValueError, match="cost shapes"):
        GridPottsModel(u, vc, hc, device="cpu")
    with pytest.raises(ValueError, match="kernel"):
        GridPottsModel(u, hc, vc, device="cpu").run_fast(1, kernel="pallas")
    with pytest.raises(NotImplementedError):
        GridPottsModel(u, hc, vc, device="cpu").run_fast(1, mode="mixed")


def test_dtype_policy():
    assert real_dtype("cpu") == torch.float64
    assert real_dtype("cuda") == torch.float32
    assert GridPottsModel(*random_grid(3, 4, 2), device="cpu").state["u"].dtype == torch.float64
    set_dtype(torch.float32)
    try:
        assert real_dtype("cpu") == torch.float32
    finally:
        set_dtype(None)
    assert real_dtype("cpu") == torch.float64


def test_port_imports_no_jax():
    code = ("import sys; import lp_mp_tpu_torch, lp_mp_tpu_torch.kernel_check, "
            "lp_mp_tpu_torch.parallel, lp_mp_tpu_torch.engine, lp_mp_tpu_torch.solver, "
            "lp_mp_tpu_torch.visitors, lp_mp_tpu_torch.graph, lp_mp_tpu_torch.schedule, "
            "lp_mp_tpu_torch.registry, lp_mp_tpu_torch.native, lp_mp_tpu_torch.factors.simplex, "
            "lp_mp_tpu_torch.factors.potts, lp_mp_tpu_torch.messages.simplex_marginalization, "
            "lp_mp_tpu_torch.messages.pairwise_triplet, lp_mp_tpu_torch.models.mrf, "
            "lp_mp_tpu_torch.io.uai, lp_mp_tpu_torch.aux_tighten, lp_mp_tpu_torch.factors.multicut, "
            "lp_mp_tpu_torch.messages.multicut, lp_mp_tpu_torch.models.multicut, "
            "lp_mp_tpu_torch.models.tightening, lp_mp_tpu_torch.models.cycle_separation, "
            "lp_mp_tpu_torch.utils.graphs, lp_mp_tpu_torch.utils.union_find, "
            "lp_mp_tpu_torch.io.torresani, lp_mp_tpu_torch.utils.mincostflow, "
            "lp_mp_tpu_torch.utils.maxflow, lp_mp_tpu_torch.messages.equality, "
            "lp_mp_tpu_torch.models.graph_matching, lp_mp_tpu_torch.ops.minconv, "
            "lp_mp_tpu_torch.factors.counting, lp_mp_tpu_torch.messages.counting, "
            "lp_mp_tpu_torch.models.tomography, lp_mp_tpu_torch.parallel.generic, "
            "lp_mp_tpu_torch.messages.vector_equality, lp_mp_tpu_torch.trees, "
            "lp_mp_tpu_torch.trees_general, lp_mp_tpu_torch.io.lp_export, "
            "lp_mp_tpu_torch.io.ilp, lp_mp_tpu_torch.combilp, lp_mp_tpu_torch.checkpoint, "
            "lp_mp_tpu_torch.visitors_db, lp_mp_tpu_torch.cli, lp_mp_tpu_torch.__main__, "
            "lp_mp_tpu_torch.capture, lp_mp_tpu_torch.engine_pull, "
            "chip_smoke; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'lp_mp_tpu')]; "
            "assert not bad, bad")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr

