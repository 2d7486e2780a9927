"""The sharded grid kernels' plain versions and wrappers, on the CPU.

On every shard of a dense state, with slabs cut from it,
``phase_update_sharded_ref`` (every phase tuple) and
``round_update_sharded_ref`` (``n_rounds`` 1 and 2) must equal exactly the
matching window of ``phase_update_ref`` / ``round_update_ref`` on the whole
state: the same operations in the same order, only masked by the global
geometry.  That covers the first, middle and last shard, tie-rich inputs,
shards with inert rows and wholly inert shards.  The CUDA kernels are held
against these plain versions on the card (test_torch_parallel_grid_cuda.py).
"""
import pytest
import torch

from lp_mp_tpu_torch import tracing
from lp_mp_tpu_torch.kernel_check import PHASE_PARAMS, random_dense_state
from lp_mp_tpu_torch.ops import grid_kernels as gk
from lp_mp_tpu_torch.parallel.grid import RowShards

# (H, W, L, n): ragged windows; 11 rows over 4 shards of 4 leave an inert row
# and a wholly inert shard; W = 1 has no h-edges
SHAPES = [(11, 7, 3, 4), (13, 9, 2, 3), (9, 11, 1, 2), (16, 6, 4, 1), (10, 1, 2, 2)]
IDS = [f"{h}x{w}x{l}-n{n}" for h, w, l, n in SHAPES]


def sharded_inputs(H, W, L, n, seed, ties):
    state, hc, vc = random_dense_state(H, W, L, seed, ties, dtype=torch.float64)
    lay = RowShards(H, W, ["cpu"] * n)
    windows, costs = lay.split(state), lay.split_costs(hc, vc)
    args = [(w, s, c["hc"], c["vc"], cs, row0, H, W)
            for w, s, c, cs, row0 in zip(windows, lay.slabs(windows), costs, lay.slabs(costs),
                                         lay.row0)]
    return state, hc, vc, lay, args


def assert_windows_equal(outs, expected):
    for i, (out, want) in enumerate(zip(outs, expected)):
        for k in gk.STATE_KEYS:
            assert torch.equal(out[k], want[k]), (i, k, float((out[k] - want[k]).abs().max()))


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
@pytest.mark.parametrize("params", PHASE_PARAMS)
def test_phase_ref_equals_dense_window(shape, ties, params):
    state, hc, vc, lay, args = sharded_inputs(*shape, seed=sum(shape), ties=ties)
    outs = [gk.phase_update_sharded_ref(*a, *params) for a in args]
    assert_windows_equal(outs, lay.split(gk.phase_update_ref(state, hc, vc, *params)))


@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
@pytest.mark.parametrize("n_rounds", [1, 2])
def test_round_ref_equals_dense_window(shape, ties, n_rounds):
    state, hc, vc, lay, args = sharded_inputs(*shape, seed=2 * sum(shape), ties=ties)
    outs = [gk.round_update_sharded_ref(*a, n_rounds) for a in args]
    assert_windows_equal(outs, lay.split(gk.round_update_ref(state, hc, vc, n_rounds)))


def test_inert_rows_stay_zero():
    """Every output row past the grid, and every slot of an absent edge, is
    exactly 0 after a phase and after a round, on every shard."""
    H, W, L, n = 11, 7, 3, 4
    _, _, _, lay, args = sharded_inputs(H, W, L, n, seed=3, ties=False)
    for a in args:
        row0 = a[5]
        g = torch.arange(row0, row0 + lay.Hl)
        for out in (gk.phase_update_sharded_ref(*a, 1, 1, 1.0),
                    gk.round_update_sharded_ref(*a, 2)):
            for k in gk.STATE_KEYS:
                assert torch.count_nonzero(out[k][:, g >= H]) == 0, (row0, k)
            assert torch.count_nonzero(out["vm1"][:, g == H - 1]) == 0
            assert torch.count_nonzero(out["vm2"][:, g == 0]) == 0


def test_wrappers_on_cpu_run_the_plain_version():
    before = tracing.counters()["launches"]
    _, _, _, _, args = sharded_inputs(13, 9, 2, 3, seed=5, ties=True)
    for a in args:
        for params in PHASE_PARAMS:
            out = gk.phase_update_sharded(*a, *params)
            ref = gk.phase_update_sharded_ref(*a, *params)
            assert all(torch.equal(out[k], ref[k]) for k in gk.STATE_KEYS)
        for nr in (1, 2):
            out, ref = gk.round_update_sharded(*a, nr), gk.round_update_sharded_ref(*a, nr)
            assert all(torch.equal(out[k], ref[k]) for k in gk.STATE_KEYS)
    assert tracing.counters()["launches"] == before


def test_sharded_wrappers_refuse_what_no_route_takes():
    _, _, _, _, args = sharded_inputs(12, 6, 2, 2, seed=0, ties=False)
    w, s, hc, vc, cs, row0, H, W = args[1]
    with pytest.raises(ValueError, match="colour code"):
        gk.phase_update_sharded(*args[1], 3, 1, 0.0)
    with pytest.raises(ValueError, match="n_rounds"):
        gk.round_update_sharded(*args[1], 3)
    for bad in (-1, 1.5, True, None):
        with pytest.raises(ValueError, match="row0"):
            gk.round_update_sharded(w, s, hc, vc, cs, bad, H, W, 1)
    with pytest.raises(ValueError, match="several devices"):
        gk.phase_update_sharded(w, s, hc.to("meta"), vc, cs, row0, H, W, 1, 1, 0.0)
    short = {**s, "vm2": (s["vm2"][0][:, 1:], s["vm2"][1])}
    with pytest.raises(ValueError, match="vm2 top slab has shape"):
        gk.round_update_sharded(w, short, hc, vc, cs, row0, H, W, 2)
    with pytest.raises(ValueError, match="hc has shape"):
        gk.phase_update_sharded(w, s, hc[:, 1:], vc, cs, row0, H, W, 1, 1, 0.0)
    with pytest.raises(ValueError, match="H and W"):
        gk.phase_update_sharded(w, s, hc, vc, cs, row0, 0, W, 1, 1, 0.0)


def test_sharded_cuda_argument_checks():
    """The checks a CUDA launch runs first, exercised on CPU tensors."""
    _, _, _, _, args = sharded_inputs(12, 6, 2, 2, seed=0, ties=False)
    w, s, hc, vc, cs, row0, H, W = args[0]
    f32 = {k: v.float() for k, v in w.items()}
    s32 = {k: (t.float(), b.float()) for k, (t, b) in s.items()}
    c32 = {k: (t.float(), b.float()) for k, (t, b) in cs.items()}

    def check(window=f32, slabs=s32, hc_=hc.float(), vc_=vc.float(), cost_slabs=c32):
        named = gk._sharded_tensors(window, slabs, hc_, vc_, cost_slabs)
        return gk._check_sharded_args(named, row0, H, W, cuda=True)

    assert check() == (2, 6)
    with pytest.raises(TypeError, match="float32"):
        check(window={**f32, "u": w["u"]})
    with pytest.raises(ValueError, match="u must be contiguous"):
        check(window={**f32, "u": f32["u"].transpose(1, 2).contiguous().transpose(1, 2)})
    # a slab may be a view of a neighbour's window (its own label stride) ...
    view = torch.zeros(2, 6, 6)[:, -gk.SLAB:]
    assert not view.is_contiguous()
    assert check(slabs={**s32, "u": (view, s32["u"][1])}) == (2, 6)
    # ... but its rows must be contiguous
    cols = torch.zeros(2, 6, 8)[:, :gk.SLAB, :6]
    with pytest.raises(ValueError, match="u top slab must be contiguous within each label"):
        check(slabs={**s32, "u": (cols, s32["u"][1])})


def test_phase_update_v1_refuses_bad_params():
    state, hc, vc = random_dense_state(5, 6, 2, seed=0)
    for bad in (torch.tensor([1, 1, 0]), torch.tensor([1, 1], dtype=torch.int32), [1, 1, 0]):
        with pytest.raises(ValueError, match="int32 tensor of shape"):
            gk.phase_update_v1(bad, state, hc, vc)
    out = gk.phase_update_v1(torch.tensor([2, 2, 10], dtype=torch.int32), state, hc, vc)
    ref = gk.phase_update_ref(state, hc, vc, 2, 2, 1.0)
    assert all(torch.equal(out[k], ref[k]) for k in gk.STATE_KEYS)
