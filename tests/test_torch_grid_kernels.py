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
from lp_mp_tpu_torch import tracing
from lp_mp_tpu_torch.kernel_check import (CHECK_SHAPES, PHASE_PARAMS, ROUND_GEOMETRIES,
                                          random_dense_state)
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
    before = tracing.counters()["launches"]
    state, hc, vc = random_dense_state(H, W, L, seed=1)
    for params in PHASE_PARAMS:
        out, ref = gk.phase_update(state, hc, vc, *params), gk.phase_update_ref(state, hc, vc, *params)
        for k in gk.STATE_KEYS:
            assert torch.equal(out[k], ref[k])
    for n_rounds in (1, 2):
        out, ref = gk.round_update(state, hc, vc, n_rounds), gk.round_update_ref(state, hc, vc, n_rounds)
        for k in gk.STATE_KEYS:
            assert torch.equal(out[k], ref[k])
    assert tracing.counters()["launches"] == before


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


def _kernel_constants():
    """The round kernel's integer constants, as csrc/grid_potts.cu sets them."""
    import re
    from pathlib import Path
    src = (Path(gk.__file__).parent.parent / "csrc" / "grid_potts.cu").read_text()
    return {k: int(v) for k, v in re.findall(r"constexpr int (k\w+) = (\d+);", src)}


def test_check_shapes_cover_the_round_tiles():
    """kernel_check.CHECK_SHAPES and ROUND_GEOMETRIES, which chip_smoke.py and
    the gpu tests run on the card, cross the round kernel's strips, segments
    and ring: the kernel's own geometry first, then segments of 3 rows
    (shorter than 2P at either n_rounds) in strips of 4 columns, then
    segments longer than any ring; ragged and odd widths, heights of at most
    2P, the label counts of every cell-update path, widths that take the
    16-byte copies at every label count that has them, and the main path's
    grid last."""
    assert CHECK_SHAPES[-1] == (1000, 1000, 4)
    assert ROUND_GEOMETRIES[0] == (0, 0)
    small = CHECK_SHAPES[:-1]
    short, tall = ROUND_GEOMETRIES[1], ROUND_GEOMETRIES[2]
    consts = _kernel_constants()
    for P in (2, 4):                                   # n_rounds 1 and 2
        assert short[0] < 2 * P
        ring = (2 * P + 1 + consts["kRoundMaxAhead"]) * consts["kRoundBand"]
        assert tall[0] + 2 * P > ring                  # the ring wraps
    rows, cols = short
    assert any(W % 4 and W % 56 and W > 56 for _, W, _ in small)   # ragged, not 16-byte rows
    assert any(W % 2 and W > cols for _, W, _ in small)             # odd widths
    assert any(W % cols and W > cols and H % rows and H > rows for H, W, _ in small)  # last partial
    assert any(H <= 4 and W > cols for H, W, _ in small)            # H <= 2P at n_rounds 1
    assert any(4 < H <= 8 and W > cols for H, W, _ in small)        # H <= 2P at n_rounds 2
    assert any(H > tall[0] for H, _, _ in small)
    assert {1, 2} <= {W for _, W, _ in small}
    assert {1, 2} <= {H for H, _, _ in small}
    assert {1, 5, 8, gk.ROUND_MAX_LABELS} <= {L for _, _, L in small}
    # the 16-byte copies of the W-wide arrays (W a multiple of 4, L <= 4), the
    # ring wrapping under them too
    assert {1, 2, 3, 4} <= {L for _, W, L in small if W % 4 == 0}
    assert any(W % 4 == 0 and H > tall[0] and L <= 4 for H, W, L in small)
    assert all(L <= gk.ROUND_MAX_LABELS for _, _, L in CHECK_SHAPES)


@pytest.mark.parametrize("H,W,L", CHECK_SHAPES[:-1])
def test_small_geometry_crosses_two_strips_and_two_segments(H, W, L):
    """Every small check shape wider than the short geometry's strips and
    taller than its segments crosses at least two of each (the grid's own
    one- and two-column and -row shapes cannot)."""
    rows, cols = ROUND_GEOMETRIES[1]
    strips, segments = -(-W // cols), -(-H // rows)
    assert strips >= 2 or W <= cols
    assert segments >= 2 or H <= rows
    assert (strips >= 2 and segments >= 2) or min(H, W) <= 2


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


ROUND_SHAPES = [(8, 8, 4), (9, 1, 3), (1, 60, 4), (7, 2, 4), (13, 57, 5)]


def seven_sums(s, hc, vc, x):
    """The rounding's cost as ``GridPottsModel._round_impl`` summed it before
    the rounding kernels: seven gathered float64 sums."""
    def pick(t, labels):
        return torch.gather(t, 0, labels[None])[0]

    f64 = torch.float64
    ub = torch.sum(pick(s["u"], x), dtype=f64)
    xl, xr = x[:, :-1], x[:, 1:]
    ub += torch.sum(pick(s["hm1"], xl), dtype=f64)
    ub += torch.sum(pick(s["hm2"], xr), dtype=f64)
    ub += torch.sum(torch.where(xl != xr, hc, torch.zeros_like(hc)), dtype=f64)
    xt, xb = x[:-1], x[1:]
    ub += torch.sum(pick(s["vm1"], xt), dtype=f64)
    ub += torch.sum(pick(s["vm2"], xb), dtype=f64)
    ub += torch.sum(torch.where(xt != xb, vc, torch.zeros_like(vc)), dtype=f64)
    return ub


@pytest.mark.parametrize("H,W,L", ROUND_SHAPES)
@pytest.mark.parametrize("mode", ["anisotropic", "uniform", "damped_uniform"])
@pytest.mark.parametrize("ties", [False, True], ids=["normal", "ties"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_rounding_wrappers_match_the_plain_rounding(H, W, L, mode, ties, dtype):
    """The rounding wrappers' plain versions (``round_phase_update``'s four
    phases of the mode, then ``primal_cost``) against the model's plain
    ``_round_impl`` on the same state: state, labels and cost exactly, and
    the cost equal to the seven sums the model took before the kernels."""
    from lp_mp_tpu_torch import GridPottsModel
    from lp_mp_tpu_torch.config import ReparametrizationMode
    from lp_mp_tpu_torch.models.grid_potts import phase_tuples
    mode = ReparametrizationMode.convert(mode)
    state, hc, vc = random_dense_state(H, W, L, seed=H * W + L, ties=ties, dtype=dtype)
    m = GridPottsModel(np.moveaxis(state["u"].numpy(), 0, -1), hc.numpy(), vc.numpy(),
                       device="cpu", dtype=dtype, use_jit=False).load_state(state)
    ref, (x, ub) = m._round_impl({k: v.clone() for k, v in state.items()}, m._mode_params(mode))
    before = tracing.counters()["launches"]
    labels = torch.zeros((H, W), dtype=torch.int32)
    s = state
    for p in phase_tuples(mode):
        s = gk.round_phase_update(s, m.hc, m.vc, *p, labels)
    cost = gk.primal_cost(s, m.hc, m.vc, labels)
    for k in gk.STATE_KEYS:
        assert torch.equal(s[k], ref[k]), k
    assert torch.equal(labels.long(), x)
    assert cost.dtype == torch.float64 and float(cost) == float(ub)
    assert float(ub) == float(seven_sums(ref, m.hc, m.vc, x))
    assert tracing.counters()["launches"] == before


def test_rounding_wrappers_refuse_what_no_route_takes():
    state, hc, vc = random_dense_state(5, 6, 2, seed=0)
    with pytest.raises(ValueError, match="int32"):
        gk.round_phase_update(state, hc, vc, 1, 1, 1.0, torch.zeros((5, 6), dtype=torch.int64))
    with pytest.raises(ValueError, match="int32"):
        gk.primal_cost(state, hc, vc, torch.zeros((5, 7), dtype=torch.int32))
    with pytest.raises(ValueError, match="colour code"):
        gk.round_phase_update(state, hc, vc, 3, 1, 1.0, torch.zeros((5, 6), dtype=torch.int32))
    with pytest.raises(ValueError, match="several devices"):
        gk.primal_cost(state, hc, vc, torch.zeros((5, 6), dtype=torch.int32).to("meta"))
    assert gk.cost_work_size(5, 6) == 2
    assert gk.cost_work_size(1000, 1000) == 1 + 977
    assert gk.cost_work_size(4000, 4000) == 1 + gk.COST_MAX_BLOCKS


BOUND_SHAPES = [(8, 8, 4), (9, 11, 1), (9, 1, 3), (1, 60, 4), (7, 2, 4), (13, 57, 5),
                (11, 37, 40)]


@pytest.mark.parametrize("H,W,L", BOUND_SHAPES)
@pytest.mark.parametrize("ties", [False, True], ids=["normal", "ties"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_lower_bound_wrapper_is_the_plain_bound(H, W, L, ties, dtype):
    """On CPU tensors ``lower_bound`` is ``lower_bound_ref``, the model's
    plain bound (``_lower_bound_impl``) bit for bit, with or without a work
    buffer, and launches nothing; a CPU model's ``lower_bound()`` gives the
    same value, captured or not."""
    from lp_mp_tpu_torch import GridPottsModel
    state, hc, vc = random_dense_state(H, W, L, seed=H + W + L, ties=ties, dtype=dtype)
    before = tracing.counters()["launches"]
    work = torch.empty(gk.bound_work_size(H, W), dtype=torch.float64)
    for use_jit in (True, False):
        m = GridPottsModel(np.moveaxis(state["u"].numpy(), 0, -1), hc.numpy(), vc.numpy(),
                           device="cpu", dtype=dtype, use_jit=use_jit).load_state(state)
        ref = m._lower_bound_impl(state)
        assert ref.dtype == torch.float64 and ref.ndim == 0
        for got in (gk.lower_bound(state, hc, vc), gk.lower_bound(state, hc, vc, work)):
            assert got.dtype == torch.float64 and float(got) == float(ref)
        assert m.lower_bound() == float(ref)
    assert tracing.counters()["launches"] == before


def test_lower_bound_plain_version_is_the_pre_kernel_arithmetic():
    """``lower_bound_ref`` sums what the model summed before the kernel: the
    cells' minima and ``_potts_min_pair`` of each direction, in float64."""
    state, hc, vc = random_dense_state(12, 9, 3, seed=4, ties=True)
    f64 = torch.float64
    want = torch.sum(torch.amin(state["u"], dim=0), dtype=f64)
    want += torch.sum(gk._potts_min_pair(state["hm1"], state["hm2"], hc), dtype=f64)
    want += torch.sum(gk._potts_min_pair(state["vm1"], state["vm2"], vc), dtype=f64)
    assert float(gk.lower_bound_ref(state, hc, vc)) == float(want)
    state["vm2"][1, 2, 3] = float("nan")
    assert np.isnan(float(gk.lower_bound(state, hc, vc)))


def _bad_bound_args(case):
    state, hc, vc = random_dense_state(5, 6, 2, seed=0)
    n = gk.bound_work_size(5, 6)
    work = torch.empty(n, dtype=torch.float64)
    if case == "work dtype":
        work = work.float()
    elif case == "work shape":
        work = torch.empty(n + 1, dtype=torch.float64)
    elif case == "work strided":
        work = torch.empty(2 * n, dtype=torch.float64)[::2]
    elif case == "slot shape":
        state = {**state, "hm1": state["hm1"][:, :, :-1]}
    elif case == "cost shape":
        hc = hc[:-1]
    elif case == "u rank":
        state = {**state, "u": state["u"][0]}
    elif case == "devices":
        work = work.to("meta")
    return state, hc, vc, work


@pytest.mark.parametrize("case,error", [
    ("work dtype", ValueError), ("work shape", ValueError), ("work strided", ValueError),
    ("slot shape", ValueError), ("cost shape", ValueError), ("u rank", ValueError),
    ("devices", ValueError)])
def test_lower_bound_refuses_bad_arguments_before_launching(case, error):
    """A bad work buffer, a state or cost of another shape than the grid's,
    or inputs on several devices are refused on the CPU route as on the
    card's, and nothing is counted."""
    before = tracing.counters()["launches"]
    state, hc, vc, work = _bad_bound_args(case)
    with pytest.raises(error):
        gk.lower_bound(state, hc, vc, work)
    assert tracing.counters()["launches"] == before


def test_bound_work_size():
    """One float64 for the bound, then one partial per block of 1024 cells,
    at most COST_MAX_BLOCKS blocks: the cost pass's blocks."""
    assert gk.bound_work_size(5, 6) == 2
    assert gk.bound_work_size(1000, 1000) == 1 + 977
    assert gk.bound_work_size(4000, 4000) == 1 + gk.COST_MAX_BLOCKS
    assert all(gk.bound_work_size(h, w) == gk.cost_work_size(h, w) for h, w, _ in CHECK_SHAPES)
