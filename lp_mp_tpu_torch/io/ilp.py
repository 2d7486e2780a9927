"""Exact ILP oracle over the local polytope + subset solves; counterpart of
``lp_mp_tpu/io/ilp.py``.

Counterpart of the reference's DD_ILP/SAT bridge: ``LP_sat`` rounding
(solver.hxx:529-546, acceptance test/graphical_model.cpp:277-302: exact
rounding closes the duality gap MP rounding leaves open) and the exact
region solves of combiLP (combiLP.hxx:92-271) / partial_external_solver
(partial_external_solver.hxx:13-96).

Instead of a SAT encoding with incremental clauses, the (sub)problem is the
integral local polytope, the same constraint system
``io/lp_export.build_local_polytope`` produces from the per-type
``lp_vars``/``lp_coupling`` hooks, handed to HiGHS branch-and-bound
(scipy.optimize.milp).  Subset solves condition the border couplings on a
fixed outside labeling by fixing the outside variables (``FactorType.lp_fix``),
the conditioned analogue of the reference's border reparametrization.
Host-side; the state and each primal go to the host once per solve, and a
solved labeling comes back in the dtypes of the engine's own primal blocks.
"""
from __future__ import annotations

import hashlib

import numpy as np

from ..convert import engine_primal_from_numpy, engine_state_to_numpy
from .lp_export import _factor_tables, build_local_polytope, rows_to_csr


def primal_digest(host_prim: dict) -> str:
    """Digest of a host primal's content (type, key, dtype, shape, bytes)."""
    h = hashlib.sha256()
    for name in sorted(host_prim):
        for k in sorted(host_prim[name]):
            v = np.ascontiguousarray(host_prim[name][k])
            h.update(f"{name}/{k}/{v.dtype.str}/{v.shape}".encode())
            h.update(v.tobytes())
    return h.hexdigest()


class IncrementalIlp:
    """Persistent MILP over the integral local polytope with per-round
    bound flips (partial_external_solver.hxx:13-96 semantics): the
    constraint system is built ONCE; growing the exact region only (a)
    relaxes the grown factors' variables back to [0, 1] binaries and (b)
    re-selects the active rows (one sparse matvec) instead of re-deriving
    the whole model.

    Semantics match the one-shot conditioned solve exactly:
    - outside factors' variables are fixed (lb = ub = lp_fix value), which
      conditions every border row on the outside labeling, the same
      substitution the reference's border reparametrization performs;
    - rows touching no inside variable are dropped, NOT enforced: the
      outside labeling may be inconsistent (that is *why* combiLP runs) and
      the reference likewise never constrains the LP region against itself
      (combiLP.hxx:92-271 merges region labelings).
    """

    def __init__(self, engine):
        self.engine = engine
        self.tables = _factor_tables(engine)
        cost, rows, b, offsets = build_local_polytope(engine, self.tables)
        self.cost = np.asarray(cost, dtype=np.float64)
        self.b = np.asarray(b, dtype=np.float64)
        self.offsets = offsets
        nvar = len(cost)
        self.nvar = nvar
        self.nfac = len(self.tables)
        self.sizes = np.asarray([len(c) for (_, _, c, _, _) in self.tables])
        self.var_fid = np.repeat(np.arange(self.nfac), self.sizes)

        self.A = rows_to_csr(rows, nvar)
        self.A_pattern = self.A.copy()
        self.A_pattern.data = np.ones_like(self.A_pattern.data)
        self._fix_cache: dict[int, np.ndarray] = {}
        self._fix_cache_key = None

    def _fixed_vals(self, fids, host_prim):
        """lp_fix vectors for the given outside factors, cached per fid
        (the LP-region labeling is constant across combiLP rounds).  The
        cache is keyed on the labeling's content, so a new labeling in the
        same (reused or mutated) dict reads fresh rows."""
        key = primal_digest(host_prim)
        if self._fix_cache_key != key:
            self._fix_cache.clear()
            self._fix_cache_key = key
        out = {}
        for fid in fids:
            if fid not in self._fix_cache:
                ft, meta, _, _, _ = self.tables[fid]
                row = self.engine.f_local[fid]
                prim_row = {k: v[row] for k, v in host_prim[ft.name].items()}
                self._fix_cache[fid] = np.asarray(ft.lp_fix(prim_row, meta),
                                                  dtype=np.float64)
            out[fid] = self._fix_cache[fid]
        return out

    def invalidate_fixed(self):
        self._fix_cache.clear()

    def solve(self, subset=None, fixed_prim=None, time_limit=None):
        from scipy.optimize import Bounds, LinearConstraint, milp

        if subset is None:
            subset = np.ones(self.nfac, dtype=bool)
        subset = np.asarray(subset, dtype=bool)
        assert subset.any(), "empty ILP subset"
        if not subset.all():
            assert fixed_prim is not None, \
                "subset ILP solve requires fixed_prim for the border"
        host_prim = None if fixed_prim is None else engine_state_to_numpy(fixed_prim)

        var_inside = subset[self.var_fid]
        lo = np.zeros(self.nvar)
        hi = np.ones(self.nvar)
        if not subset.all():
            vals = self._fixed_vals(np.nonzero(~subset)[0], host_prim)
            for fid, v in vals.items():
                o = self.offsets[fid]
                lo[o:o + self.sizes[fid]] = v
                hi[o:o + self.sizes[fid]] = v

        # active rows = rows touching >= 1 inside variable (one spmv)
        act = (self.A_pattern @ var_inside.astype(np.float64)) > 0.5
        A = self.A[act]
        rhs = self.b[act]

        options = {}
        if time_limit is not None:
            options["time_limit"] = float(time_limit)
        res = milp(c=self.cost,
                   constraints=LinearConstraint(A, rhs, rhs),
                   integrality=np.ones(self.nvar),
                   bounds=Bounds(lo, hi), options=options)
        # accept time-limit incumbents: HiGHS returns the best feasible
        # integer solution found so far with success=False/status=1, which
        # is exactly what a time-boxed exact rounding oracle should use.
        # Other non-success statuses (infeasible=2, unbounded=3, numerical
        # failure=4) may still carry an x: reject those.
        if res.x is None or res.status not in (0, 1):
            return None, float("inf")

        x = np.round(res.x).astype(np.int64)
        own = self.engine.init_primal()
        base = host_prim if host_prim is not None else engine_state_to_numpy(own)
        prim = {name: {k: np.array(v) for k, v in blk.items()}
                for name, blk in base.items()}
        for fid in np.nonzero(subset)[0]:
            ft, meta, _, _, _ = self.tables[fid]
            row = self.engine.f_local[fid]
            o = self.offsets[fid]
            block = x[o: o + self.sizes[fid]]
            for key, lab in ft.lp_read(block, meta).items():
                prim[ft.name][key][row] = lab
        prim = engine_primal_from_numpy(prim, own)
        obj = self.engine.evaluate_primal(prim)
        return prim, float(obj)


def solve_ilp(engine, subset=None, fixed_prim=None, time_limit=None):
    """Exact MILP solve of the (subset of the) factor graph (one-shot
    convenience wrapper over IncrementalIlp; combiLP keeps the
    IncrementalIlp alive across region-growth rounds instead).

    subset: bool mask [n_factors] of factors to optimize (None = all).
    fixed_prim: primal dict fixing the factors OUTSIDE the subset; border
    coupling constraints are conditioned on it.

    Returns (prim, objective) where prim is a full primal dict of tensors
    (outside factors copied from fixed_prim) and objective is the total
    primal cost including engine.constant, or (None, inf) when infeasible.
    """
    return IncrementalIlp(engine).solve(subset=subset, fixed_prim=fixed_prim,
                                        time_limit=time_limit)


def ilp_round(engine, time_limit=None):
    """LP_sat-style exact primal rounding: solve the whole reparametrized
    problem as an ILP (solver.hxx:529-546 analogue; intended for small or
    tightened instances where MP rounding leaves a duality gap)."""
    return solve_ilp(engine, time_limit=time_limit)
