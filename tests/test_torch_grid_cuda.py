"""The CUDA grid kernels against their plain versions, on the card.

Marked ``gpu``: where no CUDA device is present every test skips with a
reason.  On a machine with an H100 run ``python -m pytest -m gpu
tests/test_torch_grid_cuda.py`` or ``python3 chip_smoke.py``, whose kernel
phase is the same shared helper (lp_mp_tpu_torch.kernel_check).
"""
import pytest
import torch

from lp_mp_tpu_torch import GridPottsModel, random_grid
from lp_mp_tpu_torch.kernel_check import (CHECK_SHAPES, RTOL, WIDE_LABEL_SHAPES, check_grid_kernels,
                                          check_phase_v1, check_replays, random_dense_state)
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
    assert set(worst) == {"phase_update", "round_update", "phase_update_v1",
                          "phase_update_sharded", "round_update_sharded"}


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
