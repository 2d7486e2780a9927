"""The CUDA grid kernels against their plain versions, on the card.

Marked ``gpu``: where no CUDA device is present every test skips with a
reason.  On a machine with an H100 run ``python -m pytest -m gpu
tests/test_torch_grid_cuda.py`` or ``python3 chip_smoke.py``, whose kernel
phase is the same shared helper (lp_mp_tpu_torch.kernel_check).
"""
import numpy as np
import pytest
import torch

import chip_smoke
from lp_mp_tpu_torch import GridPottsModel, random_grid
from lp_mp_tpu_torch.kernel_check import (CHECK_SHAPES, COST_RTOL, ROUND_MODES, RTOL,
                                          WIDE_LABEL_SHAPES, check_grid_kernels, check_phase_v1,
                                          check_replays, check_round_primal, random_dense_state)
from lp_mp_tpu_torch.ops import grid_kernels as gk

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def test_kernels_match_plain_versions(cuda):
    gk.reset_launch_counts()
    worst = check_grid_kernels(cuda, log=lambda line: None)
    assert set(worst) == {"phase_update", "round_update"}
    # per shape: two inputs, each through six phase launches and two round launches
    expect = dict.fromkeys(gk.launch_counts(), 0)
    expect.update(phase_update=12 * len(CHECK_SHAPES), round_update=4 * len(CHECK_SHAPES))
    assert gk.launch_counts() == expect


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
    gk.reset_launch_counts()
    check_grid_kernels(cuda, shapes=WIDE_LABEL_SHAPES, log=lambda line: None)
    check_phase_v1(cuda, shapes=WIDE_LABEL_SHAPES, log=lambda line: None)
    counts = gk.launch_counts()
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
    gk.reset_launch_counts()
    assert check_round_primal(cuda, log=lambda line: None) <= COST_RTOL
    counts = gk.launch_counts()
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
    gk.reset_launch_counts()
    x, ub = m.round_primal(mode)
    torch.cuda.synchronize()
    for k in gk.STATE_KEYS:
        assert torch.equal(m.state[k], ref[k]), k
    assert (x == x_ref.cpu().numpy()).all()
    assert abs(ub - float(ub_ref)) <= COST_RTOL * abs(float(ub_ref))
    assert gk.launch_counts()["round_phase_update"] >= 4


def test_round_primal_replays_give_the_same_cost(cuda):
    """Two replays of the captured rounding from one state give the same
    labels and the same cost bit for bit, and each replay counts its four
    phase launches and the cost pass's two kernels."""
    m = rounding_model(cuda, False)
    start = {k: v.clone() for k, v in m.state.items()}
    m.round_primal()                      # capture, with its warm-up
    gk.reset_launch_counts()
    got = []
    for _ in range(2):
        m.load_state(start)
        got.append(m.round_primal())
    (x1, ub1), (x2, ub2) = got
    assert (x1 == x2).all() and ub1 == ub2
    counts = gk.launch_counts()
    assert counts["round_phase_update"] == 8 and counts["primal_cost"] == 4
    assert sum(counts.values()) == 12


def test_float64_model_rounds_on_the_plain_ops(cuda):
    """A float64 model on the card keeps the plain rounding: no kernel launches."""
    m = rounding_model(cuda, False, dtype=torch.float64)
    gk.reset_launch_counts()
    x, ub = m.round_primal()
    assert set(gk.launch_counts().values()) == {0}
    assert x.shape == (50, 70) and x.dtype == np.int32 and np.isfinite(ub)


def test_round_primal_matches_the_jax_package(cuda):
    """The float32 model on the card, through K2 and the rounding kernels,
    rounds as the JAX package does (its float32 run_fast and round_primal
    on the CPU, ``chip_smoke.JAX_ROUND``, which
    tests/test_torch_model_constants.py recomputes): the labels equal, the
    cost within ``ROUND_UB_RTOL`` (the JAX package sums it in float32)."""
    gk.reset_launch_counts()
    x, ub = chip_smoke.jax_round_case(cuda)
    assert chip_smoke.labels_digest(x) == chip_smoke.JAX_ROUND["digest"]
    assert ub == pytest.approx(chip_smoke.JAX_ROUND["ub"], rel=chip_smoke.ROUND_UB_RTOL)
    assert gk.launch_counts()["round_phase_update"] >= 4


def test_primal_cost_of_a_label_out_of_range_is_nan(cuda):
    """The cost kernel reads no slot at a label outside [0, L): the cost is NaN."""
    state, hc, vc = random_dense_state(9, 11, 3, seed=2, device=cuda)
    labels = torch.zeros((9, 11), dtype=torch.int32, device=cuda)
    assert float(gk.primal_cost(state, hc, vc, labels)) == pytest.approx(
        float(gk.primal_cost_ref(state, hc, vc, labels)), rel=COST_RTOL)
    for bad in (3, -1):
        labels[4, 5] = bad
        assert np.isnan(float(gk.primal_cost(state, hc, vc, labels)))
