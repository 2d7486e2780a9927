"""The on-card kernel checks of ``lp_mp_tpu_torch.kernel_check``, run on the CPU.

``chip_smoke.py`` and the ``gpu`` tests run these checks on the card, where
each wrapper launches its CUDA kernel.  Here the wrappers take their plain
versions, so every comparison must come out exactly 0; what is tested is the
checks' own control flow: the shapes they cover, the phase-only path for
more labels than the round kernels take, and the replays of every phase
tuple from captured functions (direct calls on the CPU).
"""
import pytest
import torch

from lp_mp_tpu_torch import kernel_check as kc, tracing
from lp_mp_tpu_torch.ops import grid_kernels as gk


@pytest.fixture
def no_sync(monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)


def test_phase_block_is_the_kernels():
    """``PHASE_BLOCK`` is the phase kernel's block as the CUDA source sets it."""
    import re
    from pathlib import Path
    src = (Path(kc.__file__).parent / "csrc" / "grid_potts.cu").read_text()
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (kPhase\w+) = (\d+);", src)}
    assert kc.PHASE_BLOCK == (consts["kPhaseRows"], 2 * consts["kPhasePairs"])


def test_shapes_cover_the_phase_blocks():
    """Widths 1-3 columns either side of the phase kernel's 64-column block
    and of multiples of 4, heights that leave a partial 4-row block, and
    label counts above the round kernels' limit."""
    rows, cols = kc.PHASE_BLOCK
    widths = {W for _, W, _ in kc.CHECK_SHAPES}
    assert {cols + d for d in (-3, -2, -1, 1, 2, 3)} <= widths
    assert {2 * cols - 1, 2 * cols + 1} & widths
    assert any(H % rows and H > rows and W > cols for H, W, _ in kc.CHECK_SHAPES)
    assert all(L > gk.ROUND_MAX_LABELS for _, _, L in kc.WIDE_LABEL_SHAPES)
    assert any(W > 64 for _, W, _ in kc.WIDE_LABEL_SHAPES)


@pytest.mark.parametrize("shapes", [kc.WIDE_LABEL_SHAPES, ((10, 63, 4), (9, 65, 3))],
                         ids=["wide labels", "around a block"])
def test_checks_run_every_kernel_wrapper(no_sync, shapes):
    before = tracing.counters()["launches"]
    logs = []
    worst = kc.check_grid_kernels("cpu", shapes=shapes, log=logs.append)
    assert worst == {"phase_update": 0.0, "round_update": 0.0}
    assert kc.check_phase_v1("cpu", shapes=shapes, log=logs.append) == 0.0
    worst = kc.check_sharded_grid_kernels("cpu", shapes=shapes, shard_counts=(1, 3),
                                          log=logs.append)
    assert worst == {"phase_update_sharded": 0.0, "round_update_sharded": 0.0}
    rounds = [line for line in logs if "round_update" in line and "n_rounds" in line]
    if all(L > gk.ROUND_MAX_LABELS for _, _, L in shapes):
        assert not rounds           # the round kernels refuse these label counts
    else:
        assert len(rounds) == 2 * 2 * len(kc.ROUND_GEOMETRIES) * len(shapes)
    assert tracing.counters()["launches"] == before     # the CPU never launches


def test_replays_cover_every_phase_tuple(no_sync):
    logs = []
    worst = kc.check_replays("cpu", shape=(13, 66, 3), shards=3, log=logs.append)
    assert worst == dict.fromkeys(("phase_update", "round_update", "phase_update_v1",
                                   "round_phase_update", "primal_cost", "phase_update_sharded",
                                   "round_update_sharded"), 0.0)
    # one graph per phase tuple of each phase kernel, two of the v1 contract,
    # one per round kernel and geometry, one rounding per mode; two replays each
    n_graphs = 2 * len(kc.PHASE_PARAMS) + 2 + 2 * len(kc.ROUND_GEOMETRIES) + len(kc.ROUND_MODES)
    assert f"{n_graphs} graphs, {2 * n_graphs} replays" in logs[-1]


@pytest.mark.parametrize("shapes", [kc.WIDE_LABEL_SHAPES, ((10, 63, 4), (9, 1, 3), (1, 60, 4))],
                         ids=["wide labels", "edges of the grid"])
def test_round_primal_check_covers_every_mode(no_sync, shapes):
    """``check_round_primal`` holds the rounding wrappers against their plain
    versions in every mode, on random and on tied states, one log line per
    shape; on the CPU both sides are the plain version, so the cost's error
    is 0 and nothing launches."""
    before = tracing.counters()["launches"]
    logs = []
    assert kc.check_round_primal("cpu", shapes=shapes, log=logs.append) == 0.0
    assert len(logs) == len(shapes)
    assert all(f"{2 * len(kc.ROUND_MODES)} roundings" in line for line in logs)
    assert tracing.counters()["launches"] == before


def test_round_primal_check_catches_a_wrong_label(no_sync, monkeypatch):
    """A rounding phase that writes one wrong label fails the check."""
    real = gk.round_phase_update

    def wrong(*args, **kw):
        out = real(*args, **kw)
        labels = args[6]
        labels[0, 0] = (labels[0, 0] + 1) % args[0]["u"].shape[0]
        return out

    monkeypatch.setattr(kc, "round_phase_update", wrong)
    with pytest.raises(AssertionError, match="labels differ"):
        kc.check_round_primal("cpu", shapes=((6, 7, 3),), log=lambda line: None)


@pytest.mark.parametrize("shapes", [kc.WIDE_LABEL_SHAPES, ((10, 63, 4), (9, 1, 3), (1, 60, 4)),
                                    ((9, 11, 1), (23, 26, 8))],
                         ids=["wide labels", "edges of the grid", "one and eight labels"])
def test_lower_bound_check_covers_every_shape(no_sync, shapes):
    """``check_lower_bound`` holds the bound wrapper against its plain
    version on random and tied states, over launches and replays, with a
    NaN in each array, one log line per shape; on the CPU both sides are
    the plain version, so the error is 0 and nothing launches."""
    before = tracing.counters()["launches"]
    logs = []
    assert kc.check_lower_bound("cpu", shapes=shapes, log=logs.append) == 0.0
    assert len(logs) == len(shapes)
    assert all("bit-equal" in line and "NaN" in line for line in logs)
    assert tracing.counters()["launches"] == before


@pytest.mark.parametrize("fault", ["off by 1e-11", "drops NaN", "differs on replay"])
def test_lower_bound_check_catches_a_wrong_bound(no_sync, monkeypatch, fault):
    """A bound 1e-11 relative off, one that turns a NaN into a number, or
    one that changes between calls fails the check."""
    real = gk.lower_bound
    calls = []

    def wrong(state, hc, vc, work=None):
        out = real(state, hc, vc, work)
        calls.append(1)
        if fault == "off by 1e-11":
            return out * (1.0 + 1e-11)
        if fault == "drops NaN":
            return torch.nan_to_num(out)
        return out + (len(calls) % 2) * 1e-9 * out.abs()

    monkeypatch.setattr(kc, "lower_bound", wrong)
    match = {"off by 1e-11": "rel err", "drops NaN": "NaN", "differs on replay": "differ"}[fault]
    with pytest.raises(AssertionError, match=match):
        kc.check_lower_bound("cpu", shapes=((6, 7, 3),), log=lambda line: None)


def test_phase_bench_imports_no_jax():
    """The kernel timer stays free of JAX, and without a card its command
    exits non-zero before timing anything."""
    import subprocess
    import sys
    code = ("import sys, lp_mp_tpu_torch.phase_bench as pb; "
            "assert not any(m.split('.')[0] in ('jax', 'lp_mp_tpu') for m in sys.modules); "
            "assert pb.LAUNCHES == 20 and pb.MODES == ('anisotropic', 'uniform', 'damped_uniform')")
    subprocess.run([sys.executable, "-c", code], check=True)
    if not torch.cuda.is_available():
        run = subprocess.run([sys.executable, "-m", "lp_mp_tpu_torch.phase_bench"],
                             capture_output=True, text=True)
        assert run.returncode != 0 and "is_available() is false" in run.stderr


@pytest.mark.parametrize("params", kc.PHASE_PARAMS, ids=str)
@pytest.mark.parametrize("shards,k", [(1, 0), (4, 1), (4, 3)])
def test_phase_bound_counts_what_the_phase_reads(params, shards, k):
    """``phase_bench``'s bound of a phase launch counts the costs and slab
    rows that its plain version reads, and no other: shifting every cost
    and slab row the bound leaves out leaves the window's result as it was,
    and a receiving phase reads every row the bound counts."""
    from lp_mp_tpu_torch import phase_bench as pb
    from lp_mp_tpu_torch.parallel.grid import RowShards
    H, W, L = 17, 10, 3
    rc = params[0]
    state, hc, vc = kc.random_dense_state(H, W, L, seed=5)
    lay = RowShards(H, W, ["cpu"] * shards)
    wins, costs = lay.split(state), lay.split_costs(hc, vc)
    w, c, row0 = wins[k], costs[k], lay.row0[k]
    slabs, cslabs = lay.slabs(wins)[k], lay.slabs(costs)[k]
    rows = min(w["u"].shape[1], H - row0)
    need = pb.window_recv_only(slabs, c, cslabs, row0, rows, H)
    def key(t):
        return t.data_ptr(), tuple(t.shape)

    counted = {key(t) for t in need} if rc else set()

    def run(sl, cc, cs):
        return gk.phase_update_sharded_ref(w, sl, cc["hc"], cc["vc"], cs, row0, H, W, *params)

    def shifted(t):     # t plus 1000 in every row the bound leaves out
        if key(t) in counted:
            return t
        out = t + 1000.0
        for r in range(t.shape[-2]):
            if key(t[..., r:r + 1, :]) in counted:
                out[..., r:r + 1, :] = t[..., r:r + 1, :]
        return out

    base = run(slabs, c, cslabs)
    moved = run({a: tuple(map(shifted, p)) for a, p in slabs.items()},
                {a: shifted(t) for a, t in c.items()},
                {a: tuple(map(shifted, p)) for a, p in cslabs.items()})
    assert all(torch.equal(base[n], moved[n]) for n in gk.STATE_KEYS)
    in_bytes, out_bytes = pb.phase_bytes(list(w.values()), need, rc)
    assert out_bytes == pb.nbytes(w.values())
    assert in_bytes == out_bytes + (pb.nbytes(need) if rc else 0)
    if rc:      # an edge row of the window receives across every counted slab row
        assert len(need) == 2 + 2 * (row0 > 0) + (row0 + rows < H)
        for t in need[2:]:
            def grown(x, t=t):     # x less 1000 in the rows of t (a lower cost always counts)
                out = x.clone()
                for r in range(x.shape[-2]):
                    if key(x[..., r:r + 1, :]) == key(t):
                        out[..., r:r + 1, :] -= 1000.0
                return out
            res = run({a: tuple(map(grown, p)) for a, p in slabs.items()}, c,
                      {a: tuple(map(grown, p)) for a, p in cslabs.items()})
            assert any(not torch.equal(base[n], res[n]) for n in gk.STATE_KEYS)


@pytest.mark.parametrize("n_rounds", [1, 2])
@pytest.mark.parametrize("tile", kc.ROUND_GEOMETRIES, ids=str)
def test_round_geometries_take_the_plain_version_on_the_cpu(tile, n_rounds):
    """``round_at`` and ``round_sharded_at`` launch the round kernels at a
    geometry on the card; on the CPU they give the plain versions, which
    every geometry equals, and launch nothing."""
    from lp_mp_tpu_torch.parallel.grid import RowShards
    before = tracing.counters()["launches"]
    H, W, L = 13, 10, 3
    state, hc, vc = kc.random_dense_state(H, W, L, seed=2)
    out = kc.round_at(state, hc, vc, n_rounds, tile)
    ref = gk.round_update_ref(state, hc, vc, n_rounds)
    assert all(torch.equal(out[k], ref[k]) for k in gk.STATE_KEYS)
    lay = RowShards(H, W, ["cpu"] * 3)
    wins, costs = lay.split(state), lay.split_costs(hc, vc)
    slabs, cslabs = lay.slabs(wins), lay.slabs(costs)
    for k in range(3):
        args = (wins[k], slabs[k], costs[k]["hc"], costs[k]["vc"], cslabs[k], lay.row0[k], H, W,
                n_rounds)
        got, want = kc.round_sharded_at(*args, tile), gk.round_update_sharded_ref(*args)
        assert all(torch.equal(got[a], want[a]) for a in gk.STATE_KEYS)
    assert tracing.counters()["launches"] == before


@pytest.mark.parametrize("key", ["u", "hm1", "hm2", "vm1", "vm2"])
def test_round_kernels_are_held_bit_equal(key):
    """The round kernels' comparison is exact: one ulp in any state array
    fails it, though it lies far inside the tolerance the phase kernels
    are held to."""
    state, hc, vc = kc.random_dense_state(6, 7, 2, seed=3)
    ref = gk.round_update_ref(state, hc, vc, 2)
    out = {k: v.clone() for k, v in ref.items()}
    flat = out[key].view(-1)
    flat[0] = torch.nextafter(flat[0], torch.tensor(float("inf")))
    assert kc._compare("round_update", "one ulp", out, ref, lambda line: None) > 0.0
    with pytest.raises(AssertionError, match=f"{key} differs"):
        kc._compare("round_update", "one ulp", out, ref, lambda line: None, exact=True)
