"""Port ShardedGridPotts (lp_mp_tpu_torch.parallel) vs the JAX package's, and
vs the port's dense GridPottsModel.

The JAX model runs on the conftest's 8 virtual CPU devices, the port's on
``["cpu"] * n``; both get the same numpy instance.  Against JAX (mirroring
tests/test_parallel.py): float64 iterate and rounding to 1e-12 on the state
and 1e-10 on the bounds; the fused ``run_fast`` in float32 against JAX's
``run_fast(kernel="pallas", interpret=True)``, which runs the JAX K3/K4 in
interpret mode, to 1e-4, the tolerance JAX holds its own sharded path to.
Against the port's dense model the coordinate updates are the same
operations in the same order, so the states are equal exactly; only the
order of the bound's sums differs (1e-12 relative).
"""
import jax
import numpy as np
import pytest
import torch

from lp_mp_tpu.models.grid_potts import random_grid
from lp_mp_tpu.parallel.grid import ShardedGridPotts as JaxSharded
from lp_mp_tpu_torch import (GridPottsModel, ShardedGridPotts, grid_state_from_numpy,
                             sharded_state_from_jax)
from lp_mp_tpu_torch.ops.grid_kernels import SLAB, STATE_KEYS
from lp_mp_tpu_torch.parallel.grid import RowShards, mode_phases

MODES = ["anisotropic", "uniform", "damped_uniform"]
H, W, L = 11, 7, 3      # tests/test_parallel.py's grid


def twins(n, seed=3, shape=(H, W, L), dtype=torch.float64):
    u, hc, vc = random_grid(*shape, seed=seed)
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    jm = JaxSharded(u, hc, vc, devices=jax.devices()[:n], dtype=np_dtype)
    pm = ShardedGridPotts(u, hc, vc, devices=["cpu"] * n, dtype=dtype)
    return jm, pm


def jax_dense(jm):
    return dict(zip(STATE_KEYS, (np.asarray(a) for a in jm.dense_state())))


def numpy_state(state):
    return {k: v.cpu().numpy() for k, v in state.items()}


def assert_states_close(a, b, atol):
    for k in STATE_KEYS:
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=atol, err_msg=k)


def assert_states_equal(a, b):
    for k in STATE_KEYS:
        assert torch.equal(a[k], b[k]), (k, float((a[k] - b[k]).abs().max()))


# -- port vs JAX -------------------------------------------------------------
@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
@pytest.mark.parametrize("mode", MODES)
def test_iterate_matches_jax(n_shards, mode):
    jm, pm = twins(n_shards)
    jm.iterate(mode, n=3)
    pm.iterate(mode, n=3)
    assert_states_close(jax_dense(jm), numpy_state(pm.dense_state()), atol=1e-12)
    assert abs(jm.lower_bound() - pm.lower_bound()) < 1e-10


@pytest.mark.parametrize("n_shards", [2, 8])
def test_round_primal_matches_jax(n_shards):
    jm, pm = twins(n_shards, seed=5)
    jm.iterate("anisotropic", n=4)
    pm.iterate("anisotropic", n=4)
    xj, ubj = jm.round_primal()
    xp, ubp = pm.round_primal()
    np.testing.assert_array_equal(xp, xj)
    assert xp.dtype == np.int32 and xp.shape == (H, W)
    assert abs(ubj - ubp) < 1e-10
    assert_states_close(jax_dense(jm), numpy_state(pm.dense_state()), atol=1e-12)


def test_monotone_lb_8_shards():
    _, pm = twins(8, seed=7)
    lbs = []
    for _ in range(6):
        pm.iterate("anisotropic", n=1)
        lbs.append(pm.lower_bound())
    assert all(b >= a - 1e-9 for a, b in zip(lbs, lbs[1:]))
    _, ub = pm.round_primal()
    assert ub >= lbs[-1] - 1e-9


@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
def test_run_fast_matches_jax_pallas_interpret(n_shards):
    """The fused schedule: the port's sharded kernels' plain versions (CPU
    tensors) against JAX's K3/K4 in interpret mode."""
    jm, pm = twins(n_shards, seed=11, shape=(21, 13, 3), dtype=torch.float32)
    jm.run_fast(4, kernel="pallas", interpret=True)
    pm.run_fast(4)
    assert_states_close(jax_dense(jm), numpy_state(pm.dense_state()), atol=1e-4)


@pytest.mark.parametrize("mode", ["uniform", "damped_uniform"])
def test_run_fast_uniform_matches_jax_pallas_interpret(mode):
    jm, pm = twins(4, seed=12, shape=(17, 9, 2), dtype=torch.float32)
    jm.run_fast(3, mode, kernel="pallas", interpret=True)
    pm.run_fast(3, mode)
    assert_states_close(jax_dense(jm), numpy_state(pm.dense_state()), atol=1e-4)


@pytest.mark.parametrize("n_shards", [2, 4])
def test_state_carried_across_from_jax(n_shards):
    """A live JAX sharded state, after 3 iterations, loaded into the port:
    equal at once, and equal after one more iteration on each side."""
    jm, pm = twins(n_shards, seed=4)
    jm.iterate("anisotropic", n=3)
    mask = {k: np.asarray(v) for k, v in jm.state.items()}
    pm.load_state(sharded_state_from_jax(mask, jm.geom))
    assert_states_close(jax_dense(jm), numpy_state(pm.dense_state()), atol=0.0)
    jm.iterate("anisotropic", n=1)
    pm.iterate("anisotropic", n=1)
    assert_states_close(jax_dense(jm), numpy_state(pm.dense_state()), atol=1e-12)
    assert abs(jm.lower_bound() - pm.lower_bound()) < 1e-10


def test_sharded_state_from_jax_checks_its_input():
    jm, _ = twins(2)
    mask = {k: np.asarray(v) for k, v in jm.state.items()}
    with pytest.raises(KeyError):
        sharded_state_from_jax({"u": mask["u"]}, jm.geom)
    with pytest.raises(ValueError, match="geom"):
        sharded_state_from_jax({**mask, "vm2": mask["vm2"][:, 1:]}, jm.geom)


# -- port sharded vs port dense ---------------------------------------------
# (H, W, L, n): H not divisible by n, shards thinner than the slab (so the
# last shards hold inert rows or are wholly inert), L = 1 and L = 2
SHAPES = [(11, 7, 3, 1), (11, 7, 3, 2), (11, 7, 3, 8), (13, 6, 2, 3), (9, 11, 1, 4),
          (20, 5, 4, 3)]
SHAPE_IDS = [f"{h}x{w}x{l}-n{n}" for h, w, l, n in SHAPES]


def dense_and_sharded(shape, dtype, seed=21):
    h, w, l, n = shape
    u, hc, vc = random_grid(h, w, l, seed=seed)
    return (GridPottsModel(u, hc, vc, dtype=dtype, device="cpu"),
            ShardedGridPotts(u, hc, vc, devices=["cpu"] * n, dtype=dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("mode", MODES)
def test_run_fast_equals_dense_kernel_path(shape, dtype, mode):
    dm, sm = dense_and_sharded(shape, dtype)
    dm.run_fast(5, mode, kernel="cuda")
    sm.run_fast(5, mode)
    assert_states_equal(sm.dense_state(), dm.state)
    assert sm.lower_bound() == pytest.approx(dm.lower_bound(), rel=1e-12, abs=1e-12)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_iterate_equals_dense(shape, dtype):
    dm, sm = dense_and_sharded(shape, dtype, seed=22)
    for mode in MODES:
        dm.iterate(mode, n=2)
        sm.iterate(mode, n=2)
        assert_states_equal(sm.dense_state(), dm.state)
        assert sm.lower_bound() == pytest.approx(dm.lower_bound(), rel=1e-12, abs=1e-12)


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("mode", MODES)
def test_round_primal_equals_dense(shape, mode):
    dm, sm = dense_and_sharded(shape, torch.float64, seed=23)
    dm.iterate("anisotropic", n=3)
    sm.iterate("anisotropic", n=3)
    xd, ubd = dm.round_primal(mode)
    xs, ubs = sm.round_primal(mode)
    np.testing.assert_array_equal(xs, xd)
    assert ubs == pytest.approx(ubd, rel=1e-12)
    assert_states_equal(sm.dense_state(), dm.state)


def test_inert_rows_and_absent_slots_stay_zero():
    """H = 11 over 8 shards of 4 rows: row 11 and shards 3-7 are inert."""
    _, sm = dense_and_sharded((11, 7, 3, 8), torch.float64)
    assert sm.layout.Hl == SLAB and sm.layout.row0 == [4 * i for i in range(8)]
    sm.run_fast(3).iterate("uniform", n=1).round_primal()
    g = torch.cat([torch.arange(r, r + SLAB) for r in sm.layout.row0])
    for k in STATE_KEYS:
        full = torch.cat([w[k] for w in sm.windows], dim=1)
        assert full[:, g >= 11].abs().max() == 0, k
        assert full[:, g < 11].abs().max() > 0, k
    full = {k: torch.cat([w[k] for w in sm.windows], dim=1) for k in ("vm1", "vm2")}
    assert full["vm1"][:, 10].abs().max() == 0       # no edge below the last row
    assert full["vm2"][:, 0].abs().max() == 0        # no edge above the first


@pytest.mark.parametrize("H_,n", [(11, 1), (11, 3), (11, 8), (4, 2), (1, 2), (30, 4)])
def test_layout_round_trips(H_, n):
    W_, L_ = 5, 2
    lay = RowShards(H_, W_, ["cpu"] * n)
    assert lay.Hl >= SLAB and lay.n * lay.Hl >= H_
    rng = np.random.default_rng(H_ + n)
    dense = {"u": rng.normal(size=(L_, H_, W_)),
             "hm1": rng.normal(size=(L_, H_, W_ - 1)), "hm2": rng.normal(size=(L_, H_, W_ - 1)),
             "vm1": rng.normal(size=(L_, H_ - 1, W_)), "vm2": rng.normal(size=(L_, H_ - 1, W_))}
    dense = grid_state_from_numpy(dense)
    windows = lay.split(dense)
    assert all(w["u"].shape == (L_, lay.Hl, W_) and w["vm2"].shape == (L_, lay.Hl, W_)
               for w in windows)
    assert_states_equal(lay.join(windows), dense)
    slabs = lay.slabs(windows)
    for i, s in enumerate(slabs):
        top, bot = s["vm1"]
        assert top.shape == bot.shape == (L_, SLAB, W_)
        if i:
            assert torch.equal(top, windows[i - 1]["vm1"][:, -SLAB:])
        else:
            assert top.abs().max() == 0


def test_mode_phases_match_the_jax_package():
    from lp_mp_tpu.parallel.grid import mode_phases as jax_mode_phases
    for mode in MODES + ["anisotropic2"]:
        assert mode_phases(mode) == jax_mode_phases(mode)
    with pytest.raises(NotImplementedError):
        mode_phases("mixed")


def test_model_rejects_bad_input():
    u, hc, vc = random_grid(6, 5, 2, seed=0)
    with pytest.raises(ValueError, match="cost shapes"):
        ShardedGridPotts(u, vc, hc, devices=["cpu"])
    with pytest.raises(ValueError, match="at least one device"):
        ShardedGridPotts(u, hc, vc, devices=[])
    with pytest.raises(TypeError, match="float32 or float64"):
        ShardedGridPotts(u, hc, vc, devices=["cpu"], dtype=torch.float16)
    sm = ShardedGridPotts(u, hc, vc, devices=["cpu"] * 2)
    with pytest.raises(NotImplementedError):
        sm.run_fast(1, mode="mixed")
    bad = {k: v.clone() for k, v in sm.dense_state().items()}
    bad["vm1"] = bad["hm1"]
    with pytest.raises(ValueError, match="vm1"):
        sm.load_state(bad)
    assert sm.dtype == torch.float64 and sm.devices == [torch.device("cpu")] * 2
