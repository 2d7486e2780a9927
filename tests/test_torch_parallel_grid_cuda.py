"""The sharded CUDA grid kernels and ShardedGridPotts on the card.

Marked ``gpu``: where no CUDA device is present every test skips with a
reason.  On a machine with an H100 run ``python -m pytest --noconftest -p
no:cacheprovider tests/test_torch_parallel_grid_cuda.py`` or ``python3
chip_smoke.py``, whose sharded kernel phase is the same shared helper
(lp_mp_tpu_torch.kernel_check).
"""
import pytest
import torch

from lp_mp_tpu_torch import GridPottsModel, ShardedGridPotts, random_grid, tracing
from lp_mp_tpu_torch.kernel_check import (CHECK_SHAPES, PHASE_PARAMS, ROUND_GEOMETRIES, RTOL,
                                          SHARD_COUNTS, WIDE_LABEL_SHAPES, check_phase_v1,
                                          check_sharded_grid_kernels, random_dense_state)
from lp_mp_tpu_torch.ops import grid_kernels as gk
from lp_mp_tpu_torch.parallel.grid import RowShards

pytestmark = pytest.mark.gpu
SMALL_SHAPES = CHECK_SHAPES[:-1]      # all but the 1000 x 1000 grid


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    return torch.device("cuda")


def test_sharded_kernels_match_plain_versions(cuda):
    before = tracing.counters()["launches"]
    worst = check_sharded_grid_kernels(cuda, shapes=SMALL_SHAPES, log=lambda line: None)
    assert set(worst) == {"phase_update_sharded", "round_update_sharded"}
    shards = sum(SHARD_COUNTS)
    # per shape: two inputs, each through six phases and two rounds at each
    # geometry on every shard
    counts = tracing.counters()["launches"] - before
    assert counts["phase_update_sharded"] == 2 * 6 * shards * len(SMALL_SHAPES)
    assert counts["round_update_sharded"] == (2 * 2 * len(ROUND_GEOMETRIES) * shards
                                              * len(SMALL_SHAPES))


def test_phase_v1_matches_plain_version(cuda):
    before = tracing.counters()["launches"]
    check_phase_v1(cuda, shapes=SMALL_SHAPES, log=lambda line: None)
    counts = tracing.counters()["launches"] - before
    assert counts["phase_update_v1"] == len(PHASE_PARAMS) * len(SMALL_SHAPES)


@pytest.mark.parametrize("mode", ["anisotropic", "uniform", "damped_uniform"])
def test_four_shards_match_dense_kernel_path(cuda, mode):
    u, hc, vc = random_grid(64, 64, 4, seed=5)
    dense = GridPottsModel(u, hc, vc, device=cuda, dtype=torch.float32).run_fast(9, mode)
    before = tracing.counters()["launches"]
    sharded = ShardedGridPotts(u, hc, vc, devices=[cuda] * 4,
                               dtype=torch.float32).run_fast(9, mode)
    counts = tracing.counters()["launches"] - before
    # each sweep from one window set into the other is a captured graph
    # (use_jit) whose warm-up launches once: per shard, the schedule's
    # launches and one more per graph (anisotropic: the prologue, the
    # 2-round sweep from either set, the 1-round sweep; uniform: two phase
    # tuples from either set)
    if mode == "anisotropic":
        assert counts["phase_update_sharded"] == 4 * (1 + 1)
        assert counts["round_update_sharded"] == 4 * (5 + 3)
    else:
        assert counts["phase_update_sharded"] == 4 * (4 * 9 + 4)
    ds = sharded.dense_state()
    for k in gk.STATE_KEYS:
        assert torch.equal(ds[k], dense.state[k]), k
    assert sharded.lower_bound() == pytest.approx(dense.lower_bound(), rel=1e-12)


def test_sharded_cuda_tensors_never_fall_back(cuda):
    state, hc, vc = random_dense_state(12, 9, 3, seed=0, device=cuda)
    lay = RowShards(12, 9, [cuda] * 2)
    w, c = lay.split(state), lay.split_costs(hc, vc)
    s, cs = lay.slabs(w), lay.slabs(c)
    args = (w[1], s[1], c[1]["hc"], c[1]["vc"], cs[1], lay.row0[1], 12, 9)
    wide = {k: v.double() for k, v in w[1].items()}
    with pytest.raises(TypeError, match="float32"):
        gk.phase_update_sharded(wide, *args[1:], 1, 1, 0.0)
    with pytest.raises(ValueError, match="several devices"):
        gk.round_update_sharded(w[1], s[1], c[1]["hc"].cpu(), *args[3:], 1)
    out = gk.round_update_sharded(*args, 2)
    torch.cuda.synchronize()
    ref = gk.round_update_sharded_ref(*args, 2)
    for k in gk.STATE_KEYS:
        assert torch.equal(out[k], ref[k]), k


def test_sharded_phase_kernel_takes_more_labels_than_the_round_kernel(cuda):
    before = tracing.counters()["launches"]
    check_sharded_grid_kernels(cuda, shapes=WIDE_LABEL_SHAPES, log=lambda line: None)
    counts = tracing.counters()["launches"] - before
    # per shape: two inputs through six phases on every shard, no round
    assert counts["phase_update_sharded"] == 2 * 6 * sum(SHARD_COUNTS) * len(WIDE_LABEL_SHAPES)
    assert counts["round_update_sharded"] == 0


@pytest.mark.parametrize("mode", ["uniform", "damped_uniform"])
@pytest.mark.parametrize("shards", [1, 4])
def test_uniform_run_fast_matches_the_plain_sweeps(cuda, mode, shards):
    """The uniform schedules through the sharded phase kernel against
    ``iterate``, the same four phases per iteration in plain torch."""
    u, hc, vc = random_grid(45, 67, 4, seed=8)
    kw = dict(devices=[cuda] * shards, dtype=torch.float32)
    fast = ShardedGridPotts(u, hc, vc, **kw).run_fast(3, mode)
    plain = ShardedGridPotts(u, hc, vc, **kw).iterate(mode, n=3)
    a, b = fast.dense_state(), plain.dense_state()
    for k in gk.STATE_KEYS:
        scale = 1.0 + float(b[k].abs().max())
        assert float((a[k] - b[k]).abs().max()) <= RTOL * scale, k
