"""The port's checkpoints (lp_mp_tpu_torch.checkpoint) on the CPU in
float64: the 2 tests of tests/test_checkpoint.py; a checkpoint written by
either package loads into the other's engine over the same model (an MRF
and a tomography model, whose counting chain carries integer lanes) with
the same bound (1e-12) and primal cost; and a snapshot is a copy, not a
view: a pass leaves it as it was, and restoring it brings the bound back
exactly, twice.
"""
import numpy as np
import pytest
import torch

from lp_mp_tpu import checkpoint as jckpt
from lp_mp_tpu_torch import (MrfConstructor, Solver, StandardVisitor, engine_state_to_numpy,
                             load_checkpoint, restore, save_checkpoint, snapshot)
from tests.test_torch_ilp_combilp import carried_with_primal
from tests.test_torch_lp_export import JAX, PORT, mrf_dense, tomography


def _solver(seed=0):
    rng = np.random.default_rng(seed)
    s = Solver(visitor=StandardVisitor(max_iter=10), device="cpu")
    mrf = s.add_constructor(MrfConstructor, pairwise_rep="dense")
    for _ in range(4):
        mrf.add_unary_factor(rng.normal(size=3))
    for i in range(3):
        mrf.add_pairwise_factor(i, i + 1, rng.normal(size=(3, 3)))
    return s


def test_snapshot_restore_inmemory():
    s = _solver()
    s.build_engine()
    snap = snapshot(s.engine)
    lb0 = s.engine.lower_bound()
    s.engine.compute_pass("anisotropic")
    assert s.engine.lower_bound() >= lb0 - 1e-12
    restore(s.engine, snap)
    assert s.engine.lower_bound() == pytest.approx(lb0, abs=1e-12)


def test_disk_roundtrip(tmp_path):
    s = _solver()
    lb = s.solve()
    path = str(tmp_path / "ckpt.npz")
    save_checkpoint(path, s.engine, best_primal=s.best_primal,
                    best_primal_cost=s.best_primal_cost, iteration=10)

    s2 = _solver()
    s2.build_engine()
    prim, cost, it = load_checkpoint(path, s2.engine)
    assert it == 10
    assert cost == pytest.approx(s.best_primal_cost)
    assert s2.engine.lower_bound() == pytest.approx(lb, abs=1e-12)
    assert s2.engine.evaluate_primal(prim) == pytest.approx(cost, abs=1e-9)


def test_snapshot_survives_a_pass():
    s = mrf_dense(PORT)
    s.build_engine()
    s.engine.compute_pass("anisotropic")
    snap = snapshot(s.engine)
    before = engine_state_to_numpy(snap)
    lb0 = s.engine.lower_bound()
    for _ in range(2):
        s.engine.compute_pass("anisotropic")
        moved = engine_state_to_numpy(s.engine.state)
        assert any(not np.array_equal(moved[n][k], before[n][k]) for n in before for k in before[n])
        after = engine_state_to_numpy(snap)
        for n in before:
            for k in before[n]:
                np.testing.assert_array_equal(after[n][k], before[n][k])
        restore(s.engine, snap)
        assert s.engine.lower_bound() == lb0
    assert all(v.data_ptr() != w.data_ptr() for n in snap
               for v, w in zip(snap[n].values(), s.engine.state[n].values()))


RECIPES = {"mrf": mrf_dense, "tomography": tomography}


@pytest.mark.parametrize("recipe", RECIPES)
def test_jax_checkpoint_loads_into_port(recipe, tmp_path):
    # the JAX engine holds a reparametrized state and a rounded primal
    # (carried from the port: an eager JAX solve would take seconds)
    _, _, je, jprim = carried_with_primal(RECIPES[recipe])
    lb, jcost = je.lower_bound(), je.evaluate_primal(jprim)
    path = str(tmp_path / "jax.npz")
    jckpt.save_checkpoint(path, je, best_primal=jprim, best_primal_cost=jcost, iteration=7)
    sp = RECIPES[recipe](PORT)
    sp.build_engine()
    prim, cost, it = load_checkpoint(path, sp.engine)
    assert it == 7 and cost == jcost
    assert abs(sp.engine.lower_bound() - lb) <= 1e-12
    assert abs(sp.engine.evaluate_primal(prim) - cost) <= 1e-9
    for block in sp.engine.state.values():
        for v in block.values():
            assert v.device == torch.device("cpu")
            assert v.dtype != torch.float32
    if recipe == "tomography":
        assert sp.engine.state["counting_chain"]["nv"].dtype == torch.int64


@pytest.mark.parametrize("recipe", RECIPES)
def test_port_checkpoint_loads_into_jax(recipe, tmp_path):
    sp = RECIPES[recipe](PORT)
    lb = sp.solve()
    path = str(tmp_path / "port.npz")
    save_checkpoint(path, sp.engine, best_primal=sp.best_primal,
                    best_primal_cost=sp.best_primal_cost, iteration=5)
    sj = RECIPES[recipe](JAX)
    sj.build_engine()
    prim, cost, it = jckpt.load_checkpoint(path, sj.engine)
    assert it == 5 and cost == sp.best_primal_cost
    assert abs(sj.engine.lower_bound() - lb) <= 1e-12
    assert abs(sj.engine.evaluate_primal(prim) - cost) <= 1e-9
    with np.load(path) as z:
        assert {k.split("/")[0] for k in z.files} == {"state", "primal", "meta"}
        if recipe == "tomography":
            assert z["state/counting_chain/nv"].dtype == np.int32
