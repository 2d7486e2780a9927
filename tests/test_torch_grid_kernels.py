"""Port grid kernels' plain versions vs the Pallas kernels (interpret mode).

``phase_update_ref`` and ``round_update_ref`` (lp_mp_tpu_torch.ops.grid_kernels)
get the same float32 inputs as the JAX package's ``phase_update_v2`` (K2),
the v1 ``phase_update`` (K5) and ``round_update_v2`` (K1), run in Pallas
interpret mode on the CPU; ``phase_update_v1`` takes K5's int32[3]
parameters as they are.  The port works in the dense layout; the JAX
model's own ``_to_mask_form``/``_from_mask_form`` move the state between
the two.  Tolerance: 5e-5 absolute, for float32 evaluated in two different
orders (tests/test_pallas_grid.py:102-118).  The CUDA kernels themselves are
held against these plain versions on the card (test_torch_grid_cuda.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lp_mp_tpu.models.grid_potts import GridPottsModel as JaxGrid
from lp_mp_tpu.ops.pallas_grid import phase_update as jax_phase_update_v1
from lp_mp_tpu.ops.pallas_grid import phase_update_v2, round_update_v2
from lp_mp_tpu_torch.kernel_check import CHECK_SHAPES, PHASE_PARAMS, random_dense_state
from lp_mp_tpu_torch.ops import _cuda_build
from lp_mp_tpu_torch.ops import grid_kernels as gk

SHAPES = [(8, 8, 4), (16, 12, 3), (33, 33, 2), (9, 11, 1)]
ATOL = 5e-5


def mask_form_twin(state, hc, vc):
    """A JAX GridPottsModel on the same costs, with its Pallas geometry,
    its padded costs and the state in mask form."""
    unary = np.moveaxis(state["u"].numpy(), 0, -1)
    jm = JaxGrid(unary, hc.numpy(), vc.numpy(), dtype=np.float32)
    geom = jm._pallas_geom(tile_rows=8)
    hcp, vcp = jm._pallas_costs(geom)
    mask = jm._to_mask_form({k: jnp.asarray(v.numpy()) for k, v in state.items()}, geom)
    return jm, geom, hcp, vcp, mask


def assert_close(dense_jax, port, what):
    for k in gk.STATE_KEYS:
        np.testing.assert_allclose(np.asarray(dense_jax[k]), port[k].numpy(), rtol=0,
                                   atol=ATOL, err_msg=f"{what} {k}")


@pytest.mark.parametrize("H,W,L", SHAPES)
@pytest.mark.parametrize("params", PHASE_PARAMS)
def test_phase_update_ref_matches_pallas_v2(H, W, L, params):
    state, hc, vc = random_dense_state(H, W, L, seed=H * W + L)
    jm, geom, hcp, vcp, mask = mask_form_twin(state, hc, vc)
    out_j = phase_update_v2(mask, hcp, vcp, geom=geom, phase_params=params, interpret=True)
    assert_close(jm._from_mask_form(out_j, geom),
                 gk.phase_update_ref(state, hc, vc, *params), f"K2 {params}")


@pytest.mark.parametrize("H,W,L", SHAPES)
def test_phase_update_ref_matches_pallas_v1(H, W, L):
    """K5, the v1 kernel with run-time phase params (leave x10), chained
    through every phase tuple."""
    state, hc, vc = random_dense_state(H, W, L, seed=H + W + L)
    for rc, sc, leave in PHASE_PARAMS:
        jm, geom, hcp, vcp, mask = mask_form_twin(state, hc, vc)
        params = jnp.asarray([rc, sc, round(10 * leave)], jnp.int32)
        out_j = jax_phase_update_v1(params, mask, hcp, vcp, geom=geom, interpret=True)
        out_t = gk.phase_update_ref(state, hc, vc, rc, sc, leave)
        assert_close(jm._from_mask_form(out_j, geom), out_t, f"K5 {(rc, sc, leave)}")
        state = out_t


@pytest.mark.parametrize("H,W,L", SHAPES)
def test_phase_update_v1_matches_pallas_v1(H, W, L):
    """K5's contract on the port: ``phase_update_v1`` takes the v1 kernel's
    int32[3] params (leave x10) as they are and decodes them as the kernel
    does; chained through every phase tuple against the v1 kernel."""
    state, hc, vc = random_dense_state(H, W, L, seed=3 * H + W + L)
    for rc, sc, leave in PHASE_PARAMS:
        jm, geom, hcp, vcp, mask = mask_form_twin(state, hc, vc)
        params = np.asarray([rc, sc, round(10 * leave)], np.int32)
        out_j = jax_phase_update_v1(jnp.asarray(params), mask, hcp, vcp, geom=geom,
                                    interpret=True)
        out_t = gk.phase_update_v1(torch.from_numpy(params), state, hc, vc)
        assert_close(jm._from_mask_form(out_j, geom), out_t, f"K5 v1 contract {params}")
        state = out_t


@pytest.mark.parametrize("H,W,L", SHAPES)
@pytest.mark.parametrize("n_rounds", [1, 2])
def test_round_update_ref_matches_pallas(H, W, L, n_rounds):
    state, hc, vc = random_dense_state(H, W, L, seed=7 * H + W + L)
    jm, geom, hcp, vcp, mask = mask_form_twin(state, hc, vc)
    out_j = round_update_v2(mask, hcp, vcp, geom=geom, n_rounds=n_rounds, interpret=True)
    assert_close(jm._from_mask_form(out_j, geom),
                 gk.round_update_ref(state, hc, vc, n_rounds), f"K1 n_rounds={n_rounds}")


@pytest.mark.parametrize("H,W,L", SHAPES)
def test_wrappers_on_cpu_run_the_plain_version(H, W, L):
    gk.reset_launch_counts()
    state, hc, vc = random_dense_state(H, W, L, seed=1)
    for params in PHASE_PARAMS:
        out, ref = gk.phase_update(state, hc, vc, *params), gk.phase_update_ref(state, hc, vc, *params)
        for k in gk.STATE_KEYS:
            assert torch.equal(out[k], ref[k])
    for n_rounds in (1, 2):
        out, ref = gk.round_update(state, hc, vc, n_rounds), gk.round_update_ref(state, hc, vc, n_rounds)
        for k in gk.STATE_KEYS:
            assert torch.equal(out[k], ref[k])
    assert set(gk.launch_counts().values()) == {0}


def test_wrappers_refuse_what_no_route_takes():
    state, hc, vc = random_dense_state(5, 6, 2, seed=0)
    with pytest.raises(ValueError, match="colour code"):
        gk.phase_update(state, hc, vc, 3, 1, 0.0)
    with pytest.raises(ValueError, match="n_rounds"):
        gk.round_update(state, hc, vc, 3)
    meta = {k: v.to("meta") for k, v in state.items()}
    with pytest.raises(ValueError, match="cpu or cuda"):
        gk.phase_update(meta, hc.to("meta"), vc.to("meta"), 1, 1, 0.0)
    with pytest.raises(ValueError, match="several devices"):
        gk.round_update(meta, hc, vc, 1)


def test_check_shapes_cover_the_round_tiles():
    """kernel_check.CHECK_SHAPES, which chip_smoke.py and the gpu tests run on
    the card, keeps ragged shapes around the round kernel's tiles (12 x 56
    cells at L=4, n_rounds=2) and the main path's grid last."""
    assert CHECK_SHAPES[-1] == (1000, 1000, 4)
    small = CHECK_SHAPES[:-1]
    assert any(W % 4 and W % 56 and W > 56 for _, W, _ in small)   # ragged, not 16-byte rows
    assert any(H < 12 and W > 56 and L == 4 for H, W, L in small)   # below one tile's rows
    assert {1, 2} <= {W for _, W, _ in small}
    assert {1, 2} <= {H for H, _, _ in small}
    assert {1, gk.ROUND_MAX_LABELS} <= {L for _, _, L in small}
    assert all(L <= gk.ROUND_MAX_LABELS for _, _, L in CHECK_SHAPES)


def test_cuda_argument_checks():
    """The checks a CUDA launch runs first, exercised on CPU tensors."""
    state, hc, vc = random_dense_state(5, 6, 2, seed=0)
    assert gk._check_cuda_args(state, hc, vc) == (2, 5, 6)
    with pytest.raises(TypeError, match="float32"):
        gk._check_cuda_args({**state, "u": state["u"].double()}, hc, vc)
    with pytest.raises(ValueError, match="shape"):
        gk._check_cuda_args({**state, "hm1": state["hm2"][:, :, :-1]}, hc, vc)
    with pytest.raises(ValueError, match="contiguous"):
        gk._check_cuda_args(state, hc, vc.t().contiguous().t())


def test_failed_nvcc_raises_with_its_output(tmp_path, monkeypatch):
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'grid_potts.cu(1): error: boom' >&2\nexit 2\n")
    fake.chmod(0o755)
    monkeypatch.setattr(_cuda_build, "nvcc_path", lambda: str(fake))
    monkeypatch.setattr(_cuda_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="boom"):
        _cuda_build.build(force=True)
    assert not list((tmp_path / "build").glob("*.so"))


def test_missing_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(_cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _cuda_build.nvcc_path()


def test_failed_load_raises(tmp_path):
    bad = tmp_path / "not_a_library.so"
    bad.write_text("")
    with pytest.raises(RuntimeError, match="loading the grid kernel library"):
        _cuda_build.load(bad)
