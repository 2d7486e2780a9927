"""The CUDA grid kernels against their plain versions, on the card.

Marked ``gpu``: where no CUDA device is present every test skips with a
reason.  On a machine with an H100 run ``python -m pytest -m gpu
tests/test_torch_grid_cuda.py`` or ``python3 chip_smoke.py``, whose kernel
phase is the same shared helper (lp_mp_tpu_torch.kernel_check).
"""
import pytest
import torch

from lp_mp_tpu_torch.kernel_check import CHECK_SHAPES, check_grid_kernels, random_dense_state
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
