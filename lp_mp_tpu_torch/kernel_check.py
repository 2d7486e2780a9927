"""Each grid kernel against its plain version, on the card.

Shared by ``chip_smoke.py`` (its kernel phases), ``tests/test_torch_grid_cuda.py``
and ``tests/test_torch_parallel_grid_cuda.py``.  Every launch is synchronised and
compared array by array with the plain torch version on the same inputs;
the tolerance is ``1e-5 * (1 + max|x|)`` per array, for float32 (the
kernels round each operation as the plain ops do, so the error is expected
to be 0, but the bound leaves room for a compiler that contracts an FMA).
The rounding kernels are held tighter (``check_round_primal``): state
bit-equal, labels equal, the cost within ``COST_RTOL``.
"""
from __future__ import annotations

import numpy as np
import torch

from .config import ReparametrizationMode
from .models.grid_potts import phase_tuples
from .ops.grid_kernels import (ROUND_MAX_LABELS, STATE_KEYS, cost_work_size, phase_update,
                               phase_update_ref, phase_update_sharded, phase_update_sharded_ref,
                               phase_update_v1, primal_cost, primal_cost_ref, round_phase_ref,
                               round_phase_update, round_update, round_update_ref,
                               round_update_sharded, round_update_sharded_ref)
from .parallel.grid import RowShards

# (H, W, L): ragged shapes around the round kernel's tiles (T_r x T_c cells
# written per block: 12 x 56 at L=4 and n_rounds=2, 17 x 56 at n_rounds=1,
# 56 x 56 at L=1, 13 x 24 at L=8, 14 x 8 at L=32), among them widths that are
# no multiple of 4 floats, heights below a tile, W and H of 1 and 2, L = 1
# and L = 32; then shapes around the phase kernel's blocks (PHASE_BLOCK):
# widths 1-3 columns either side of 64 and 128, heights that leave a partial
# block; last the main path's 1000 x 1000 grid with 4 labels
# (rows, columns) of the phase kernel's block: kPhaseRows rows of
# kPhasePairs pairs of cells in csrc/grid_potts.cu
PHASE_BLOCK = (4, 64)
CHECK_SHAPES = ((8, 8, 4), (33, 47, 3), (64, 40, 2), (9, 11, 1), (17, 130, 5),
                (13, 57, 4), (5, 117, 4), (41, 113, 4), (9, 1, 3), (7, 2, 4), (1, 60, 4),
                (2, 61, 2), (57, 59, 1), (23, 26, 8), (30, 21, 32),
                (10, 63, 4), (9, 65, 3), (23, 66, 4), (17, 62, 2), (6, 67, 5), (19, 129, 4),
                (1000, 1000, 4))
# more labels than the round kernels take (ROUND_MAX_LABELS): the phase
# kernels take one label at a time there, with the receiving cell's
# statistics in a pass of their own; the check skips the round kernels there
WIDE_LABEL_SHAPES = ((11, 37, 40), (6, 65, 33))
# (recv_color, send_color, leave): the phase tuples of
# tests/test_pallas_grid.py:91-92, whose leave values are x10 there
PHASE_PARAMS = ((2, 2, 0.0), (1, 1, 0.0), (0, 1, 0.0), (2, 0, 0.0),
                (1, 1, 1.0), (2, 2, 1.0))
RTOL = 1e-5
# the rounding's cost against its plain version: float64 sums in two orders
COST_RTOL = 1e-12
# the modes whose four phases the rounding runs (GridPottsModel.round_primal)
ROUND_MODES = (ReparametrizationMode.anisotropic, ReparametrizationMode.uniform,
               ReparametrizationMode.damped_uniform)
# shard counts of the sharded check: 3 leaves inert rows at the end of the
# last shard for most shapes
SHARD_COUNTS = (1, 2, 3, 4)


def random_dense_state(H, W, L, seed, ties=False, device="cpu", dtype=torch.float32):
    """(state, hc, vc) made with numpy from ``seed``.  ``ties`` draws small
    integers, so the min-except tie rule is exercised."""
    rng = np.random.default_rng(seed)
    if ties:
        def draw(shape, lo, hi):
            return rng.integers(lo, hi, size=shape).astype(np.float64)
        arrays = {"u": draw((L, H, W), -2, 3)}
        for k, shape in (("hm1", (L, H, W - 1)), ("hm2", (L, H, W - 1)),
                         ("vm1", (L, H - 1, W)), ("vm2", (L, H - 1, W))):
            arrays[k] = draw(shape, -1, 2)
        hc, vc = draw((H, W - 1), 0, 3), draw((H - 1, W), 0, 3)
    else:
        arrays = {"u": rng.normal(size=(L, H, W))}
        for k, shape in (("hm1", (L, H, W - 1)), ("hm2", (L, H, W - 1)),
                         ("vm1", (L, H - 1, W)), ("vm2", (L, H - 1, W))):
            arrays[k] = rng.normal(size=shape) * 0.1
        hc = np.abs(rng.normal(size=(H, W - 1)))
        vc = np.abs(rng.normal(size=(H - 1, W)))

    def t(a):
        return torch.as_tensor(a, dtype=dtype).to(device).contiguous()

    return {k: t(v) for k, v in arrays.items()}, t(hc), t(vc)


def _compare(name, label, out, ref, log):
    errs, worst = {}, 0.0
    for k in STATE_KEYS:
        if ref[k].numel() == 0:
            errs[k] = 0.0
            continue
        err = float((out[k] - ref[k]).abs().max())
        tol = RTOL * (1.0 + float(ref[k].abs().max()))
        if not err <= tol:      # also catches NaN
            raise AssertionError(f"{name} {label}: {k} max abs err {err:.3e} > tol {tol:.3e}")
        errs[k] = err
        worst = max(worst, err)
    log(f"check {name} {label} err " + " ".join(f"{k}={e:.1e}" for k, e in errs.items()))
    return worst


def check_grid_kernels(device="cuda", shapes=CHECK_SHAPES, seed=0, log=print):
    """Run every kernel launch at ``shapes`` against its plain version;
    raise AssertionError on the first disagreement.  Returns the max abs
    error per kernel wrapper name."""
    worst = {"phase_update": 0.0, "round_update": 0.0}
    for i, (H, W, L) in enumerate(shapes):
        for ties in (False, True):
            state, hc, vc = random_dense_state(H, W, L, seed + i, ties, device)
            tag = f"{H}x{W}x{L}{' ties' if ties else ''}"
            for p in PHASE_PARAMS:
                out = phase_update(state, hc, vc, *p)
                torch.cuda.synchronize()
                ref = phase_update_ref(state, hc, vc, *p)
                err = _compare("phase_update", f"{tag} {p}", out, ref, log)
                worst["phase_update"] = max(worst["phase_update"], err)
                state = ref     # chain the phases, so later launches start from rich state
            for n_rounds in (1, 2) if L <= ROUND_MAX_LABELS else ():
                out = round_update(state, hc, vc, n_rounds)
                torch.cuda.synchronize()
                ref = round_update_ref(state, hc, vc, n_rounds)
                err = _compare("round_update", f"{tag} n_rounds={n_rounds}", out, ref, log)
                worst["round_update"] = max(worst["round_update"], err)
                state = ref
    return worst


def check_phase_v1(device="cuda", shapes=CHECK_SHAPES, seed=0, log=print):
    """``phase_update_v1`` (the v1 kernel's int32[3] contract) over every
    phase tuple against its plain version.  Returns the max abs error."""
    worst = 0.0
    for i, (H, W, L) in enumerate(shapes):
        state, hc, vc = random_dense_state(H, W, L, seed + i, False, device)
        for rc, sc, leave in PHASE_PARAMS:
            params = torch.tensor([rc, sc, round(10 * leave)], dtype=torch.int32)
            out = phase_update_v1(params, state, hc, vc)
            torch.cuda.synchronize()
            ref = phase_update_ref(state, hc, vc, rc, sc, leave)
            worst = max(worst, _compare("phase_update_v1", f"{H}x{W}x{L} {params.tolist()}",
                                        out, ref, lambda line: None))
            state = ref
        log(f"check phase_update_v1 {H}x{W}x{L}: 6 launches, max abs err {worst:.1e}")
    return worst


def _check_round(tag, state, labels, cost, ref_state, ref_labels, ref_cost):
    """Raise AssertionError unless the rounding kernels' results equal the
    plain ones (the cost within ``COST_RTOL``); returns the cost's relative error."""
    for k in STATE_KEYS:
        if not torch.equal(state[k], ref_state[k]):
            err = float((state[k] - ref_state[k]).abs().max())
            raise AssertionError(f"round_phase_update {tag}: {k} differs (max abs {err:.3e})")
    if not torch.equal(labels, ref_labels.to(labels.dtype)):
        n = int((labels != ref_labels.to(labels.dtype)).sum())
        raise AssertionError(f"round_phase_update {tag}: {n} labels differ")
    a, b = float(cost), float(ref_cost)
    err = abs(a - b) / max(abs(b), 1e-300)
    if not err <= COST_RTOL:        # also catches NaN
        raise AssertionError(f"primal_cost {tag}: {a!r} against {b!r}, rel err {err:.3e}")
    return err


def check_round_primal(device="cuda", shapes=CHECK_SHAPES, seed=0, log=print):
    """The rounding kernels (``round_phase_update``'s four phases of each
    mode in ``ROUND_MODES``, then ``primal_cost``) against their plain
    versions at ``shapes``, on random states and on small-integer states
    (ties in the argmin, which must go to the first minimum).  After each
    phase the state must be bit-equal and the labels equal; the cost must
    lie within ``COST_RTOL``.  Raise AssertionError on the first
    disagreement; returns the largest relative error of the cost."""
    worst = 0.0
    for i, (H, W, L) in enumerate(shapes):
        errs = []
        for ties in (False, True):
            state, hc, vc = random_dense_state(H, W, L, seed + i, ties, device)
            for mode in ROUND_MODES:
                tag = f"{H}x{W}x{L}{' ties' if ties else ''} {mode.value}"
                labels = torch.zeros((H, W), dtype=torch.int32, device=device)
                ref_labels = labels.clone()
                s = ref = state
                for p in phase_tuples(mode):
                    s = round_phase_update(s, hc, vc, *p, labels)
                    torch.cuda.synchronize()
                    ref, ref_labels = round_phase_ref(ref, hc, vc, *p, ref_labels)
                    _check_round(f"{tag} {p}", s, labels, 0.0, ref, ref_labels, 0.0)
                cost = primal_cost(s, hc, vc, labels)
                torch.cuda.synchronize()
                errs.append(_check_round(tag, s, labels, cost, ref, ref_labels,
                                         primal_cost_ref(ref, hc, vc, ref_labels)))
        worst = max(worst, *errs)
        log(f"check round_primal {H}x{W}x{L}: {len(errs)} roundings of four phases, state "
            f"and labels equal, cost rel err {max(errs):.1e}")
    return worst


def check_sharded_grid_kernels(device="cuda", shapes=CHECK_SHAPES, shard_counts=SHARD_COUNTS,
                               seed=0, log=print):
    """Every sharded kernel launch on every shard, at ``shapes`` and
    ``shard_counts`` (all shards on ``device``), against its plain version on
    the same window and slabs: each ``PHASE_PARAMS`` phase, then
    ``n_rounds`` 1 and 2, chained.  Raise AssertionError on the first
    disagreement; return the max abs error per kernel wrapper name.  Logs
    one line per shape, input kind and shard count."""
    worst = {"phase_update_sharded": 0.0, "round_update_sharded": 0.0}
    for i, (H, W, L) in enumerate(shapes):
        steps = [(phase_update_sharded, phase_update_sharded_ref, p) for p in PHASE_PARAMS]
        if L <= ROUND_MAX_LABELS:
            steps += [(round_update_sharded, round_update_sharded_ref, (nr,)) for nr in (1, 2)]
        for ties in (False, True):
            state, hc, vc = random_dense_state(H, W, L, seed + i, ties, device)
            tag = f"{H}x{W}x{L}{' ties' if ties else ''}"
            for n in shard_counts:
                lay = RowShards(H, W, [device] * n)
                windows = lay.split(state)
                costs = lay.split_costs(hc, vc)
                cost_slabs = lay.slabs(costs)
                errs = {}
                for kern, ref_fn, params in steps:
                    slabs = lay.slabs(windows)
                    new = []
                    for k in range(n):
                        args = (windows[k], slabs[k], costs[k]["hc"], costs[k]["vc"],
                                cost_slabs[k], lay.row0[k], H, W, *params)
                        out = kern(*args)
                        torch.cuda.synchronize()
                        ref = ref_fn(*args)
                        label = f"{tag} shards={n} shard {k} row0={lay.row0[k]} {params}"
                        err = _compare(kern.__name__, label, out, ref, lambda line: None)
                        errs[kern.__name__] = max(errs.get(kern.__name__, 0.0), err)
                        new.append(ref)     # chain, so later launches start from rich state
                    windows = new
                for name, err in errs.items():
                    worst[name] = max(worst[name], err)
                log(f"check sharded {tag} shards={n} (Hl={lay.Hl}): {6 * n} phase and "
                    f"{(len(steps) - 6) * n} round launches, max abs err " +
                    " ".join(f"{k}={e:.1e}" for k, e in errs.items()))
    return worst


def check_replays(device="cuda", shape=CHECK_SHAPES[-1], shards=4, seed=0, log=print):
    """Every kernel captured in a CUDA graph (``capture.Graphs``) at
    ``shape`` (the main path's) and replayed on two inputs, each replay
    against the plain version on the same input: the phase kernels in every
    ``PHASE_PARAMS`` phase (the dense ones writing into given buffers, as
    ``GridPottsModel.run_fast`` does), the rounding kernels in the four
    phases and cost pass of each ``ROUND_MODES`` mode (the second input with
    ties; held as ``check_round_primal`` holds them), the sharded kernels
    over ``shards`` shards on ``device``, as ``ShardedGridPotts`` captures
    its sweeps.  Returns the max abs error per kernel wrapper name (the
    relative error for ``primal_cost``)."""
    from .capture import Graphs

    H, W, L = shape
    jit = Graphs(device, name="kernel check")
    lay = RowShards(H, W, [device] * shards)
    like, hc, vc = random_dense_state(H, W, L, seed, False, device)
    costs = lay.split_costs(hc, vc)
    cost_slabs = lay.slabs(costs)
    out = {k: torch.empty_like(v) for k, v in like.items()}

    def sweep(kern, params):
        def run(windows):
            slabs = lay.slabs(windows)
            return [kern(w, s, c["hc"], c["vc"], cs, r0, H, W, *params)
                    for w, s, c, cs, r0 in zip(windows, slabs, costs, cost_slabs, lay.row0)]
        return run

    def sweep_ref(ref_fn, params, windows):
        slabs = lay.slabs(windows)
        return [ref_fn(w, s, c["hc"], c["vc"], cs, r0, H, W, *params)
                for w, s, c, cs, r0 in zip(windows, slabs, costs, cost_slabs, lay.row0)]

    def v1(p):
        return torch.tensor([p[0], p[1], round(10 * p[2])], dtype=torch.int32)

    dense = [("phase_update", p, lambda s, p=p: phase_update(s, hc, vc, *p, out=out),
              lambda s, p=p: phase_update_ref(s, hc, vc, *p)) for p in PHASE_PARAMS]
    dense += [("round_update", (2,), lambda s: round_update(s, hc, vc, 2, out=out),
               lambda s: round_update_ref(s, hc, vc, 2))]
    dense += [("phase_update_v1", p, lambda s, p=p: phase_update_v1(v1(p), s, hc, vc),
               lambda s, p=p: phase_update_ref(s, hc, vc, *p)) for p in ((0, 1, 0.0), (2, 2, 1.0))]
    labels = torch.zeros((H, W), dtype=torch.int32, device=device)
    work = torch.empty(cost_work_size(H, W), dtype=torch.float64, device=device)

    def rounding(s, mode):
        for p in phase_tuples(mode):
            s = round_phase_update(s, hc, vc, *p, labels)
        return {**s, "labels": labels, "cost": primal_cost(s, hc, vc, labels, work)}

    def rounding_ref(s, mode):
        x = torch.zeros((H, W), dtype=torch.int32, device=device)
        for p in phase_tuples(mode):
            s, x = round_phase_ref(s, hc, vc, *p, x)
        return s, x, primal_cost_ref(s, hc, vc, x)

    sharded = [("phase_update_sharded", phase_update_sharded, phase_update_sharded_ref, p)
               for p in PHASE_PARAMS]
    sharded += [("round_update_sharded", round_update_sharded, round_update_sharded_ref, (2,))]
    worst = {}
    for name, params, kern, ref_fn in dense:
        g = jit.jit(lambda s, kern=kern: dict(kern(s)), f"{name}{params} replay")
        for k in range(2):
            state = random_dense_state(H, W, L, seed + 1 + k, False, device)[0]
            got = g(state)
            torch.cuda.synchronize()
            err = _compare(name, f"{H}x{W}x{L} {params} replay {k}", got, ref_fn(state),
                           lambda line: None)
            worst[name] = max(worst.get(name, 0.0), err)
    for mode in ROUND_MODES:
        g = jit.jit(lambda s, mode=mode: rounding(s, mode), f"round_primal {mode.value} replay")
        for k in range(2):
            state = random_dense_state(H, W, L, seed + 1 + k, k == 1, device)[0]
            got = g(state)
            torch.cuda.synchronize()
            err = _check_round(f"{H}x{W}x{L} {mode.value} replay {k}", got, got["labels"],
                               got["cost"], *rounding_ref(state, mode))
            worst["round_phase_update"] = 0.0
            worst["primal_cost"] = max(worst.get("primal_cost", 0.0), err)
    for name, kern, ref_fn, params in sharded:
        g = jit.jit(sweep(kern, params), f"{name}{params} sweep replay")
        for k in range(2):
            windows = lay.split(random_dense_state(H, W, L, seed + 1 + k, False, device)[0])
            outs = g(windows)
            torch.cuda.synchronize()
            for i, (got, ref) in enumerate(zip(outs, sweep_ref(ref_fn, params, windows))):
                err = _compare(name, f"{H}x{W}x{L} {params} shard {i} replay {k}", got, ref,
                               lambda line: None)
                worst[name] = max(worst.get(name, 0.0), err)
    st = jit.stats()
    log(f"check replays at {H}x{W}x{L} ({shards} shards for the sharded kernels): "
        f"{st['captures']} graphs, {st['replays']} replays, max abs err "
        + " ".join(f"{k}={e:.1e}" for k, e in worst.items()))
    return worst
