"""The CUDA grid kernels against their plain versions, on the card.

Marked ``gpu``: where no CUDA device is present every test skips with a
reason.  On a machine with an H100 run ``python -m pytest -m gpu
tests/test_torch_grid_cuda.py`` or ``python3 chip_smoke.py``, whose kernel
phase is the same shared helper (lp_mp_tpu_torch.kernel_check).
"""
from collections import Counter

import numpy as np
import pytest
import torch

import chip_smoke
from lp_mp_tpu_torch import GridPottsModel, random_grid, tracing
from lp_mp_tpu_torch.kernel_check import (CHECK_SHAPES, COST_RTOL, ROUND_GEOMETRIES, ROUND_MODES,
                                          RTOL, WIDE_LABEL_SHAPES, check_grid_kernels,
                                          check_lower_bound, check_phase_v1, check_replays,
                                          check_round_primal, random_dense_state)
from lp_mp_tpu_torch.ops import grid_kernels as gk

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def test_kernels_match_plain_versions(cuda):
    before = tracing.counters()["launches"]
    worst = check_grid_kernels(cuda, log=lambda line: None)
    assert set(worst) == {"phase_update", "round_update"}
    # per shape: two inputs, each through six phase launches and two round
    # launches at each geometry
    assert tracing.counters()["launches"] - before == Counter(
        phase_update=12 * len(CHECK_SHAPES),
        round_update=4 * len(ROUND_GEOMETRIES) * len(CHECK_SHAPES))


def test_cuda_tensors_never_fall_back(cuda):
    state, hc, vc = random_dense_state(8, 9, 3, seed=0, device=cuda, dtype=torch.float64)
    with pytest.raises(TypeError, match="float32"):
        gk.phase_update(state, hc, vc, 1, 1, 0.0)
    state32, hc32, vc32 = random_dense_state(8, 9, 3, seed=0, device=cuda)
    with pytest.raises(ValueError, match="several devices"):
        gk.round_update(state32, hc32.cpu(), vc32, 1)
    wide = {k: v.repeat(12, 1, 1) for k, v in state32.items()}      # L = 36
    with pytest.raises(ValueError, match="labels"):
        gk.round_update(wide, hc32, vc32, 2)


def test_phase_kernels_take_more_labels_than_the_round_kernels(cuda):
    before = tracing.counters()["launches"]
    check_grid_kernels(cuda, shapes=WIDE_LABEL_SHAPES, log=lambda line: None)
    check_phase_v1(cuda, shapes=WIDE_LABEL_SHAPES, log=lambda line: None)
    counts = tracing.counters()["launches"] - before
    # per shape: two inputs through six phases, no round (L > ROUND_MAX_LABELS), and six v1 phases
    assert counts["phase_update"] == 12 * len(WIDE_LABEL_SHAPES)
    assert counts["phase_update_v1"] == 6 * len(WIDE_LABEL_SHAPES)
    assert counts["round_update"] == 0


def test_every_phase_tuple_replays_from_a_graph(cuda):
    worst = check_replays(cuda, shape=(37, 70, 4), shards=4, log=lambda line: None)
    assert set(worst) == {"phase_update", "round_update", "phase_update_v1", "round_phase_update",
                          "primal_cost", "phase_update_sharded", "round_update_sharded"}


@pytest.mark.parametrize("mode", ["anisotropic", "uniform", "damped_uniform"])
def test_kernel_run_fast_matches_the_plain_path(cuda, mode):
    """run_fast(kernel="cuda") over calls of n = 0..3, captured and eager,
    against the plain path: captured and eager equal, the plain path within
    the kernels' tolerance, and no captured call ends in a state copy."""
    u, hc, vc = random_grid(50, 70, 4, seed=3)
    f32 = dict(device=cuda, dtype=torch.float32)
    graphed, eager = GridPottsModel(u, hc, vc, **f32), GridPottsModel(u, hc, vc, use_jit=False, **f32)
    plain = GridPottsModel(u, hc, vc, **f32)
    for n in (0, 1, 2, 3):
        graphed.run_fast(n, mode, kernel="cuda")
        eager.run_fast(n, mode, kernel="cuda")
        plain.run_fast(n, mode, kernel="torch")
    torch.cuda.synchronize()
    for k in gk.STATE_KEYS:
        assert torch.equal(graphed.state[k], eager.state[k]), k
        scale = 1.0 + float(plain.state[k].abs().max())
        assert float((graphed.state[k] - plain.state[k]).abs().max()) <= RTOL * scale, k
    recs = [r for r in graphed.jit.records if r.name.endswith("run_fast")]
    assert len(recs) == 4 and all(r.copies == 0 for r in recs)


def test_rounding_kernels_match_plain_versions(cuda):
    """Every check shape, the tuples of every mode, random and tied states:
    state bit-equal, labels equal, cost within COST_RTOL."""
    before = tracing.counters()["launches"]
    assert check_round_primal(cuda, log=lambda line: None) <= COST_RTOL
    counts = tracing.counters()["launches"] - before
    roundings = 2 * len(ROUND_MODES) * len(CHECK_SHAPES)
    assert counts["round_phase_update"] == 4 * roundings and counts["primal_cost"] == 2 * roundings


def rounding_model(cuda, ties, dtype=torch.float32, **kw):
    """A 50 x 70, L=4 model on the card with a state that has seen three
    uniform iterations, or (``ties``) a small-integer state."""
    u, hc, vc = random_grid(50, 70, 4, seed=5)
    m = GridPottsModel(u, hc, vc, device=cuda, dtype=dtype, **kw)
    if ties:
        state, hcs, vcs = random_dense_state(50, 70, 4, seed=5, ties=True, dtype=dtype)
        m = GridPottsModel(u, hcs.numpy(), vcs.numpy(), device=cuda, dtype=dtype, **kw)
        return m.load_state(state)
    return m.run_fast(3, "uniform", kernel="torch")


@pytest.mark.parametrize("use_jit", [True, False], ids=["captured", "eager"])
@pytest.mark.parametrize("ties", [False, True], ids=["normal", "ties"])
@pytest.mark.parametrize("mode", ROUND_MODES, ids=[m.value for m in ROUND_MODES])
def test_round_primal_kernels_match_the_plain_rounding(cuda, mode, ties, use_jit):
    """A float32 model on the card rounds through the kernels: the state it
    leaves is bit-equal to the plain ``_round_impl``'s on the same state,
    the labels equal (ties to the first minimum), the cost within COST_RTOL."""
    m = rounding_model(cuda, ties, use_jit=use_jit)
    before = {k: v.clone() for k, v in m.state.items()}
    ref, (x_ref, ub_ref) = m._round_impl(before, m._mode_params(mode))
    launched = tracing.counters()["launches"]
    x, ub = m.round_primal(mode)
    torch.cuda.synchronize()
    for k in gk.STATE_KEYS:
        assert torch.equal(m.state[k], ref[k]), k
    assert (x == x_ref.cpu().numpy()).all()
    assert abs(ub - float(ub_ref)) <= COST_RTOL * abs(float(ub_ref))
    assert (tracing.counters()["launches"] - launched)["round_phase_update"] >= 4


def test_round_primal_replays_give_the_same_cost(cuda):
    """Two replays of the captured rounding from one state give the same
    labels and the same cost bit for bit, and each replay counts its four
    phase launches and the cost pass's two kernels."""
    m = rounding_model(cuda, False)
    start = {k: v.clone() for k, v in m.state.items()}
    m.round_primal()                      # capture, with its warm-up
    before = tracing.counters()["launches"]
    got = []
    for _ in range(2):
        m.load_state(start)
        got.append(m.round_primal())
    (x1, ub1), (x2, ub2) = got
    assert (x1 == x2).all() and ub1 == ub2
    counts = tracing.counters()["launches"] - before
    assert counts["round_phase_update"] == 8 and counts["primal_cost"] == 4
    assert sum(counts.values()) == 12


def test_float64_model_rounds_on_the_plain_ops(cuda):
    """A float64 model on the card keeps the plain rounding: no kernel launches."""
    m = rounding_model(cuda, False, dtype=torch.float64)
    before = tracing.counters()["launches"]
    x, ub = m.round_primal()
    assert tracing.counters()["launches"] == before
    assert x.shape == (50, 70) and x.dtype == np.int32 and np.isfinite(ub)


def test_round_primal_matches_the_jax_package(cuda):
    """The float32 model on the card, through K2 and the rounding kernels,
    rounds as the JAX package does (its float32 run_fast and round_primal
    on the CPU, ``chip_smoke.JAX_ROUND``, which
    tests/test_torch_model_constants.py recomputes): the labels equal, the
    cost within ``ROUND_UB_RTOL`` (the JAX package sums it in float32)."""
    before = tracing.counters()["launches"]
    x, ub = chip_smoke.jax_round_case(cuda)
    assert chip_smoke.labels_digest(x) == chip_smoke.JAX_ROUND["digest"]
    assert ub == pytest.approx(chip_smoke.JAX_ROUND["ub"], rel=chip_smoke.ROUND_UB_RTOL)
    assert (tracing.counters()["launches"] - before)["round_phase_update"] >= 4


def test_primal_cost_of_a_label_out_of_range_is_nan(cuda):
    """The cost kernel reads no slot at a label outside [0, L): the cost is NaN."""
    state, hc, vc = random_dense_state(9, 11, 3, seed=2, device=cuda)
    labels = torch.zeros((9, 11), dtype=torch.int32, device=cuda)
    assert float(gk.primal_cost(state, hc, vc, labels)) == pytest.approx(
        float(gk.primal_cost_ref(state, hc, vc, labels)), rel=COST_RTOL)
    for bad in (3, -1):
        labels[4, 5] = bad
        assert np.isnan(float(gk.primal_cost(state, hc, vc, labels)))


def test_bound_kernel_matches_the_plain_bound(cuda):
    """Every check shape and the wide label counts, random and tied states:
    within COST_RTOL of ``lower_bound_ref``, bit-equal across launches and
    replays, NaN where the state holds one; the launches are the check's."""
    shapes = CHECK_SHAPES + WIDE_LABEL_SHAPES
    before = tracing.counters()["launches"]
    assert check_lower_bound(cuda, shapes=shapes, log=lambda line: None) <= COST_RTOL
    # per shape: per input two launches, two replays and one NaN per non-empty
    # array; one warm-up of the shape's capture
    calls = sum(2 * (4 + 1 + 2 * (W > 1) + 2 * (H > 1)) + 1 for H, W, _ in shapes)
    assert tracing.counters()["launches"] - before == Counter(lower_bound=2 * calls)


@pytest.mark.parametrize("use_jit", [True, False], ids=["captured", "eager"])
def test_float32_model_bounds_through_the_kernel(cuda, use_jit):
    """A float32 model on the card takes its bound from the kernel, two
    launches a bound: a captured bound replayed n times adds exactly 2n, and
    its value equals the eager model's and, within COST_RTOL, the plain
    bound's of the same state."""
    u, hc, vc = random_grid(50, 70, 4, seed=5)
    m = GridPottsModel(u, hc, vc, device=cuda, dtype=torch.float32, use_jit=use_jit)
    eager = GridPottsModel(u, hc, vc, device=cuda, dtype=torch.float32, use_jit=False)
    m.run_fast(3, "uniform", kernel="cuda")
    eager.run_fast(3, "uniform", kernel="cuda")
    first = m.lower_bound()          # the capture and its warm-up, where captured
    n = 5
    before = tracing.counters()["launches"]
    got = [m.lower_bound() for _ in range(n)]
    assert tracing.counters()["launches"] - before == Counter(lower_bound=2 * n)
    plain = float(m._lower_bound_impl(m.state))
    assert got == [first] * n and first == eager.lower_bound()
    assert abs(first - plain) <= COST_RTOL * abs(plain)


def test_float64_model_bounds_on_the_plain_ops(cuda):
    """A float64 model on the card keeps the plain bound: no kernel launches."""
    u, hc, vc = random_grid(50, 70, 4, seed=5)
    m = GridPottsModel(u, hc, vc, device=cuda, dtype=torch.float64).run_fast(
        3, "uniform", kernel="torch")
    before = tracing.counters()["launches"]
    lb = m.lower_bound()
    assert tracing.counters()["launches"] == before
    assert lb == float(m._lower_bound_impl(m.state))
