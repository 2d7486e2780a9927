"""The grid loop: solves of ``GridPottsModel`` as a user of the model writes them.

A solve starts from the instance's initial dual state (``load_state`` from
a snapshot) and runs chunks of the captured ``run_fast(chunk, mode)``, a
``lower_bound()`` after each chunk and a ``round_primal()`` every
``round_every`` chunks, until the rule of ``StandardVisitor`` ends it: the
relative gap at most ``gap``, the bound gaining less than ``stall`` of
itself over the last ``stall_chunks`` chunks, or ``max_iter`` iterations.
A solve that ended between roundings rounds once more, so each ends with a
rounding from its final state.  A pool of ``pool`` instances, from the
configuration's first ``pool`` ``instance_seeds``, is used in turn, in an
order drawn from ``--seed``: every seed gives the window the same work.

Traffic keys: chunk, mode, round_every, gap, stall, stall_chunks,
max_iter, pool, check_solves, limits.
"""
from __future__ import annotations

import gc
import math
import random
import time

import numpy as np

from ..window import Solve


def stop(lbs: list, best_ub: float, iters: int, t: dict) -> bool:
    """The loop's stopping rule after a chunk (``lbs``: the bound after
    each chunk so far)."""
    lb = lbs[-1]
    if math.isfinite(best_ub) and (best_ub - lb) / abs(best_ub) <= t["gap"]:
        return True
    n = t["stall_chunks"]
    if len(lbs) > n and lb - lbs[-1 - n] < t["stall"] * abs(lb):
        return True
    return iters >= t["max_iter"]


def solve_loop(model, t: dict, spans, ops: list) -> tuple:
    """One solve on ``model`` (its state already reset).  Appends what it
    ran to ``ops``; returns (iterations, final lb, best ub, best labels)."""
    lbs, best_ub, best_x, iters, chunks = [], math.inf, None, 0, 0
    rounded = False
    while True:
        model.run_fast(t["chunk"], t["mode"])
        ops.append(("fast", t["chunk"], t["mode"]))
        iters += t["chunk"]
        chunks += 1
        with spans("lb_sync"):
            lbs.append(model.lower_bound())
        ops.append(("lb",))
        rounded = chunks % t["round_every"] == 0
        if rounded:
            best_ub, best_x = _round(model, spans, ops, best_ub, best_x)
            iters += 1
        with spans("visitor"):
            done = stop(lbs, best_ub, chunks * t["chunk"], t)
        if done:
            break
    if not rounded:
        best_ub, best_x = _round(model, spans, ops, best_ub, best_x)
        iters += 1
    return iters, lbs[-1], best_ub, best_x


def _round(model, spans, ops, best_ub, best_x):
    with spans("rounding", sync=True):
        x, ub = model.round_primal()
    ops.append(("round",))
    if ub < best_ub:
        return ub, x
    return best_ub, best_x


class Runner:
    def __init__(self, ctx):
        import torch
        from lp_mp_tpu_torch.models.grid_potts import GridPottsModel
        from lp_mp_tpu_torch.ops import _cuda_build

        self.ctx, t = ctx, ctx.traffic
        if ctx.device.type == "cuda":
            with ctx.split("cuda_library"):
                _cuda_build.library()
        with ctx.split("instances"):
            self.instances = [ctx.generator.make(ctx.config, s)
                              for s in ctx.config["instance_seeds"][:t["pool"]]]
        self.order = list(range(len(self.instances)))
        random.Random(ctx.seed).shuffle(self.order)
        self.models, self.snaps = [], []
        with ctx.split("model_build"):
            for inst in self.instances:
                m = GridPottsModel(inst["unary"], inst["hc"], inst["vc"], device=ctx.device,
                                   dtype=torch.float32, use_jit=True)
                self.models.append(m)
                self.snaps.append({k: v.clone() for k, v in m.state.items()})
        # every call the window makes, captured here: a reset, one chunk, one
        # bound and one rounding per model
        with ctx.split("capture_and_warmup"):
            for m, snap in zip(self.models, self.snaps):
                m.load_state(snap)
                m.run_fast(t["chunk"], t["mode"])
                m.lower_bound()
                m.round_primal()
            ctx.sync()
        self.answers = {}

    def solve(self, k: int, record: bool = True) -> Solve:
        i = self.order[k % len(self.models)]
        m, spans = self.models[i], self.ctx.spans
        t0 = time.perf_counter()
        with spans("reset"):
            m.load_state(self.snaps[i])
        ops = []
        iters, lb, ub, x = solve_loop(m, self.ctx.traffic, spans, ops)
        end = time.perf_counter()
        ok = math.isfinite(lb) and math.isfinite(ub)
        if record:
            x = np.asarray(x)
            self.answers[k] = {"instance": i, "ops": ops, "lb": lb, "ub": ub,
                               "x": x.astype(np.uint8) if x.max() < 256 else x}
        return Solve(t0, end, iters, lb, ub, ok)

    def free(self) -> None:
        """Drop the program's models before the reference runs."""
        self.models, self.snaps = [], []
        gc.collect()

    def judge(self, sample: list, dtype=None) -> dict:
        """The reference's readings over the sampled solves."""
        from ..reference import potts_grid as ref
        return ref.judge_grid(self.instances, [self.answers[k] for k in sample],
                              self.ctx.device, dtype)
