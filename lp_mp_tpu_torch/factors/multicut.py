"""Multicut factors, type-batched (counterpart of ``lp_mp_tpu/factors/multicut.py``).

Reference API (downstream ``solvers/multicut/multicut_factors_messages.hxx``,
pinned by test/multicut.cpp):

- ``multicut_edge_factor``: one cost theta_e; LowerBound = min(0, theta)
  (cut the edge or not).
- ``multicut_triplet_factor``: 4 costs for the non-trivial valid cut
  patterns of a triangle's edges (e12, e13, e23):

      index 0: (1, 1, 0)   index 1: (1, 0, 1)
      index 2: (0, 1, 1)   index 3: (1, 1, 1)

  (a triangle edge labeling is consistent iff not exactly one edge is cut);
  the all-uncut pattern is the implicit zero.  LowerBound = min(0, min c).

Blocks are built in float64 numpy; the engine casts them once to its device
and dtype.  The numpy pattern tables go to a device once per (device,
dtype), through ``device_table``.  The LP-export hooks (``lp_vars``,
``lp_fix``, ``lp_read``) work on host numpy rows.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

from ..config import PAD_COST
from ..registry import FactorType
from .simplex import BUILD_DTYPE, _inf_unless, _unset

# rows: cut patterns for (e12, e13, e23); column j = is edge j cut
TRIPLET_PATTERNS = np.array([[1, 1, 0],
                             [1, 0, 1],
                             [0, 1, 1],
                             [1, 1, 1]], dtype=np.int32)

_TABLES: dict = {}


def device_table(arr: np.ndarray, like: torch.Tensor, dtype=None) -> torch.Tensor:
    """``arr`` (a module constant or an attribute of a type singleton: it
    must live as long as the process) as a tensor on ``like``'s device,
    uploaded once per (device, dtype)."""
    key = (id(arr), like.device, dtype)
    t = _TABLES.get(key)
    if t is None:
        t = _TABLES[key] = torch.as_tensor(arr, device=like.device, dtype=dtype)
    return t


def _patterns_value(c: torch.Tensor, e: torch.Tensor, patterns: np.ndarray) -> torch.Tensor:
    """[F] cost of edge bits ``e`` [F, S] under pattern costs ``c`` [F, P]:
    the matching pattern's cost, 0 when all bits are 0, +inf when a bit is
    unset or the bits match no pattern."""
    pats = device_table(patterns, e, torch.int32)
    match = torch.all(e[:, None, :] == pats[None], dim=2)            # [F, P]
    is_zero = torch.all(e == 0, dim=1)
    valid = torch.all(e >= 0, dim=1) & (is_zero | torch.any(match, dim=1))
    val = torch.where(is_zero, torch.zeros_like(c[:, 0]),
                      torch.sum(torch.where(match, c, torch.zeros_like(c)), dim=1))
    return _inf_unless(valid, val)


def _patterns_lp_vars(state_row, patterns: np.ndarray):
    """LP block of a pattern-cost factor: variable 0 is the all-uncut
    configuration, variable 1 + r is pattern row r."""
    c = np.concatenate([[0.0], np.asarray(state_row["c"], dtype=np.float64)])
    return c, [{k: 1.0 for k in range(1 + patterns.shape[0])}], [1.0], None


def _patterns_lp_fix(prim_row, patterns: np.ndarray) -> np.ndarray:
    e = np.asarray([int(prim_row[f"e{s + 1}"]) for s in range(patterns.shape[1])])
    v = np.zeros(1 + patterns.shape[0])
    if not e.any():
        v[0] = 1.0
    else:
        v[1 + int(np.nonzero((patterns == e).all(axis=1))[0][0])] = 1.0
    return v


def _patterns_lp_read(values, patterns: np.ndarray) -> dict:
    k = int(np.argmax(values))
    e = np.zeros(patterns.shape[1], np.int64) if k == 0 else patterns[k - 1]
    return {f"e{s + 1}": int(e[s]) for s in range(patterns.shape[1])}


class MulticutEdgeType(FactorType):
    name = "multicut_edge"

    def build(self, instances):
        return {"c": np.asarray(list(instances), dtype=BUILD_DTYPE)}

    def build_block(self, batch):
        """batch = cost array [N]."""
        return {"c": np.ascontiguousarray(np.asarray(batch, dtype=BUILD_DTYPE))}

    def item_data(self, block, i):
        return float(block["c"][i])

    def lower_bound(self, costs):
        return torch.clamp(costs["c"], max=0.0)

    def init_primal(self, costs):
        c = costs["c"]
        return {"x": _unset(c.shape[0], c.device)}

    def compute_primal(self, costs, primal):
        x = primal["x"]
        am = (costs["c"] < 0).to(torch.int32)
        return {"x": torch.where(x < 0, am, x)}

    def evaluate_primal(self, costs, primal):
        x = primal["x"]
        c = costs["c"]
        return _inf_unless(x >= 0, c * x.to(c.dtype))

    def dual_vector(self, costs):
        return costs["c"][:, None]

    # -- constraint export: configs (uncut, cut) --------------------------
    def lp_vars(self, state_row, data):
        c = float(state_row["c"])
        return np.asarray([0.0, c]), [{0: 1.0, 1: 1.0}], [1.0], None

    def lp_fix(self, prim_row, meta):
        v = np.zeros(2)
        v[int(prim_row["x"])] = 1.0
        return v

    def lp_read(self, values, meta):
        return {"x": int(np.argmax(values))}


class MulticutTripletType(FactorType):
    name = "multicut_triplet"

    def build(self, instances):
        return {"c": np.zeros((len(list(instances)), 4), dtype=BUILD_DTYPE)}

    def lower_bound(self, costs):
        return torch.clamp(torch.amin(costs["c"], dim=1), max=0.0)

    def init_primal(self, costs):
        # cut bits of the three edges, -1 unset
        c = costs["c"]
        return {k: _unset(c.shape[0], c.device) for k in ("e1", "e2", "e3")}

    def evaluate_primal(self, costs, primal):
        # a triangle with exactly one cut edge matches no pattern: +inf
        e = torch.stack([primal["e1"], primal["e2"], primal["e3"]], dim=1)
        return _patterns_value(costs["c"], e, TRIPLET_PATTERNS)

    def dual_vector(self, costs):
        return costs["c"]

    # -- constraint export: 5 configs = all-uncut + TRIPLET_PATTERNS ------
    def lp_vars(self, state_row, data):
        return _patterns_lp_vars(state_row, TRIPLET_PATTERNS)

    def lp_fix(self, prim_row, meta):
        return _patterns_lp_fix(prim_row, TRIPLET_PATTERNS)

    def lp_read(self, values, meta):
        return _patterns_lp_read(values, TRIPLET_PATTERNS)


def _k4_cut_patterns() -> np.ndarray:
    """All non-trivial cut vectors of K4: one row per partition of 4 nodes
    (minus the single-block partition), columns ordered
    (01, 02, 03, 12, 13, 23).  14 rows."""
    edges = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]
    seen = set()
    for lbl in itertools.product(range(4), repeat=4):
        bits = tuple(int(lbl[i] != lbl[j]) for i, j in edges)
        if any(bits):
            seen.add(bits)
    return np.array(sorted(seen), dtype=np.int32)


# rows: valid cut patterns of the K4 wheel (center + 3-cycle); the implicit
# all-uncut pattern is the zero entry, as in the triplet factor
ODD_WHEEL_PATTERNS = _k4_cut_patterns()


class MulticutOddWheelType(FactorType):
    """Odd-3-wheel (K4) factor: exact min over the 15 partitions of its 4
    nodes.  Downstream ``multicut_odd_3_wheel_factor`` analogue — the
    tightening stage beyond cycle inequalities (odd wheel inequalities are
    facets of the multicut polytope that the cycle relaxation misses; a K4
    with a fractional triangle-LP vertex is the canonical witness)."""

    name = "multicut_odd_wheel"

    def build(self, instances):
        return {"c": np.zeros((len(list(instances)), ODD_WHEEL_PATTERNS.shape[0]),
                              dtype=BUILD_DTYPE)}

    def lower_bound(self, costs):
        return torch.clamp(torch.amin(costs["c"], dim=1), max=0.0)

    def init_primal(self, costs):
        c = costs["c"]
        return {f"e{s}": _unset(c.shape[0], c.device) for s in range(1, 7)}

    def evaluate_primal(self, costs, primal):
        e = torch.stack([primal[f"e{s}"] for s in range(1, 7)], dim=1)    # [F, 6]
        return _patterns_value(costs["c"], e, ODD_WHEEL_PATTERNS)

    def dual_vector(self, costs):
        return costs["c"]

    # -- constraint export: 15 configs = all-uncut + ODD_WHEEL_PATTERNS ---
    def lp_vars(self, state_row, data):
        return _patterns_lp_vars(state_row, ODD_WHEEL_PATTERNS)

    def lp_fix(self, prim_row, meta):
        return _patterns_lp_fix(prim_row, ODD_WHEEL_PATTERNS)

    def lp_read(self, values, meta):
        return _patterns_lp_read(values, ODD_WHEEL_PATTERNS)


def _wheel_tables(k: int):
    """Membership-pattern tables for an odd-k-wheel (hub + k-cycle rim).

    A partition of the wheel restricted to its 2k edges is determined by
    a_i = [rim node i in the hub's block] plus, for rim edges whose both
    endpoints have a=0, a free cut/uncut choice (two hub-less neighbors may
    or may not share a block).  Enumerating a in {0,1}^k is exact and O(2^k)
    — the replacement for Bell-number partition enumeration
    (ODD_WHEEL_PATTERNS does K4 explicitly; this scales to any odd k).

    Returns (A [P,k], forced_cut [P,k], both_one [P,k], free [P,k]) over the
    rim edges i -> (i, i+1 mod k).
    """
    P = 1 << k
    A = ((np.arange(P)[:, None] >> np.arange(k)[None, :]) & 1).astype(np.int32)
    An = np.roll(A, -1, axis=1)
    forced_cut = A != An
    both_one = (A == 1) & (An == 1)
    free = (A == 0) & (An == 0)
    return A, forced_cut, both_one, free


def _wheel_cut_configs(k: int) -> np.ndarray:
    """All valid cut vectors (spoke bits 0..k-1, rim bits k..2k-1) of the
    odd-k-wheel.  Derived from the membership patterns: spoke i cut iff
    a_i = 0; rim forced by (a_i, a_{i+1}); free 0-0 rim edges enumerate both
    choices; the all-a-zero patterns exclude exactly-one-rim-cut (that would
    cut an edge inside one block)."""
    A, forced_cut, both_one, free = _wheel_tables(k)
    seen = set()
    for p in range(A.shape[0]):
        spoke = tuple(1 - A[p])
        free_idx = np.nonzero(free[p])[0]
        base = forced_cut[p].astype(np.int64)
        for bits in itertools.product((0, 1), repeat=len(free_idx)):
            rim = base.copy()
            rim[free_idx] = bits
            if not A[p].any() and rim.sum() == 1:
                continue
            seen.add(spoke + tuple(rim))
    return np.array(sorted(seen), dtype=np.int32)


class MulticutWheelKType(FactorType):
    """General odd-k-wheel factor (hub + odd k-cycle rim, k >= 3): exact min
    over all partitions of its k+1 nodes via the membership-pattern DP of
    ``_wheel_tables``.  One batched type per k; state = reparametrization
    slots sp [F,k] (spokes, hub-v_i) and rim [F,k] (v_i-v_{i+1}).  Odd-wheel
    inequalities are multicut facets the cycle relaxation misses — the
    generalization of the K4 odd-3-wheel beyond 4-cliques (downstream
    odd_wheel separation surface).

    The dual reductions price each hub-less (0-0) rim edge's cut choice
    independently, which admits one family of invalid configs (all rim
    nodes hub-less with exactly ONE rim cut).  That only *enlarges* the
    factor's feasible set, so LowerBound stays a valid (marginally weaker)
    bound; evaluate_primal and ``configs`` enforce strict partition
    validity."""

    def __init__(self, k: int):
        assert k >= 3 and k % 2 == 1, "odd wheels require odd rim length"
        self.k = k
        self.name = f"multicut_wheel_k{k}"
        A, forced_cut, both_one, free = _wheel_tables(k)
        self._A = A
        self._forced_cut = forced_cut
        self._both_one = both_one
        self._free = free
        # hub-triangle pattern row under forced-cut membership: triangle i
        # bits are (spoke_i_cut, spoke_j_cut, 1) = (1,0,1) row 1 / (0,1,1)
        # row 2 of TRIPLET_PATTERNS
        si = 1 - A
        self._si = si
        # [P, k, 4] one-hot of the triangle slot a forced-cut rim edge prices
        self._oh_fc = np.eye(4)[np.where(si == 1, 1, 2)]
        # masks of the slot-marginal reductions: row 1 / row 2 hub patterns
        self._fc_s1 = forced_cut & (si == 1)
        self._fc_s0 = forced_cut & (si == 0)
        self._A0 = A == 0
        self._A1 = A == 1
        self._configs = None   # lazy table of strict configs

    def build(self, instances):
        n = len(list(instances))
        z = np.zeros((n, self.k), dtype=BUILD_DTYPE)
        # tri [F, k, 4]: reparametrization slots of the k hub triangles
        # (hub, v_i, v_{i+1}) over TRIPLET_PATTERNS in wheel edge order
        # (spoke_i, spoke_{i+1}, rim_i) — the triplet <-> wheel message
        # target (reference multicut_triplet_odd_3_wheel_message analogue)
        tri = np.zeros((n, self.k, 4), dtype=BUILD_DTYPE)
        return {"sp": z, "rim": z.copy(), "tri": tri}

    def item_data(self, block, i):
        return None

    # -- pattern costs -------------------------------------------------------
    def _free_choice(self, rim, tri):
        """[F, 1, k] cheaper price of a hub-less rim edge: uncut (triangle
        pattern (1,1,0)) vs cut (rim cost + pattern (1,1,1))."""
        tri0 = tri[:, :, 0][:, None, :]
        tri3 = tri[:, :, 3][:, None, :]
        return torch.minimum(rim[:, None, :] + tri3, tri0)

    def _pattern_costs(self, sp, rim, tri):
        """[F, 2^k] cost of every membership pattern (free rim edges take
        their cheaper choice, priced jointly with the triangle slots)."""
        A = device_table(self._A, sp, sp.dtype)
        fc = device_table(self._forced_cut, sp)
        fr = device_table(self._free, sp)
        base = sp @ (1.0 - A).T                                          # [F, P]
        oh_fc = device_table(self._oh_fc, sp, sp.dtype)                  # [P, k, 4]
        t_fc = torch.einsum("fkr,pkr->fpk", tri, oh_fc)                  # [F, P, k]
        zero = torch.zeros((), dtype=sp.dtype, device=sp.device)
        contr = torch.where(fc[None], rim[:, None, :] + t_fc,
                            torch.where(fr[None], self._free_choice(rim, tri), zero))
        return base + torch.sum(contr, dim=2)

    def lower_bound(self, costs):
        return torch.amin(self._pattern_costs(costs["sp"], costs["rim"], costs["tri"]), dim=1)

    def slot_marginals(self, costs):
        """[F, 2k] per-edge-slot marginal min(cost|cut) - min(cost|uncut);
        slots 0..k-1 = spokes, k..2k-1 = rim edges."""
        sp, rim, tri = costs["sp"], costs["rim"], costs["tri"]
        base = self._pattern_costs(sp, rim, tri)                         # [F, P]
        freec = self._free_choice(rim, tri)                              # [F, 1, k]
        big = torch.full((), PAD_COST, dtype=base.dtype, device=base.device)
        A0, A1 = device_table(self._A0, sp), device_table(self._A1, sp)
        fc_t = device_table(self._forced_cut, sp)
        bo_t = device_table(self._both_one, sp)
        fr_t = device_table(self._free, sp)
        outs = []
        for i in range(self.k):                                          # spokes
            cut = torch.amin(torch.where(A0[None, :, i], base, big), dim=1)
            unc = torch.amin(torch.where(A1[None, :, i], base, big), dim=1)
            outs.append(cut - unc)
        for i in range(self.k):                                          # rim edges
            fc, bo, fr = fc_t[None, :, i], bo_t[None, :, i], fr_t[None, :, i]
            ri = rim[:, i:i + 1]
            t0 = tri[:, i, 0][:, None]
            t3 = tri[:, i, 3][:, None]
            fi = freec[:, :, i]
            cut_v = torch.where(fc, base, torch.where(fr, base - fi + ri + t3, big))
            unc_v = torch.where(bo, base, torch.where(fr, base - fi + t0, big))
            outs.append(torch.amin(cut_v, dim=1) - torch.amin(unc_v, dim=1))
        return torch.stack(outs, dim=1)

    def tri_marginals(self, costs):
        """[F, k, 4] min-marginal of each hub triangle's pattern slots vs
        the all-uncut baseline, in wheel edge order (spoke_i, spoke_j,
        rim_i): m[i, r] = min(cost | triangle i realizes pattern r)
        - min(cost | triangle i uncut)."""
        sp, rim, tri = costs["sp"], costs["rim"], costs["tri"]
        base = self._pattern_costs(sp, rim, tri)                         # [F, P]
        freec = self._free_choice(rim, tri)
        big = torch.full((), PAD_COST, dtype=base.dtype, device=base.device)
        fr_t = device_table(self._free, sp)
        bo_t = device_table(self._both_one, sp)
        m1_t = device_table(self._fc_s1, sp)
        m2_t = device_table(self._fc_s0, sp)
        out = []
        for i in range(self.k):
            bo, fr = bo_t[None, :, i], fr_t[None, :, i]
            ri = rim[:, i:i + 1]
            t0 = tri[:, i, 0][:, None]
            t3 = tri[:, i, 3][:, None]
            fi = freec[:, :, i]
            base_unc = torch.amin(torch.where(bo, base, big), dim=1)
            rows = [
                # row 0 = (1,1,0): hub-less, rim uncut
                torch.amin(torch.where(fr, base - fi + t0, big), dim=1),
                # row 1 = (1,0,1): spoke_i cut, spoke_j uncut, rim cut
                torch.amin(torch.where(m1_t[None, :, i], base, big), dim=1),
                # row 2 = (0,1,1)
                torch.amin(torch.where(m2_t[None, :, i], base, big), dim=1),
                # row 3 = (1,1,1)
                torch.amin(torch.where(fr, base - fi + ri + t3, big), dim=1)]
            out.append(torch.stack(rows, dim=1) - base_unc[:, None])
        return torch.stack(out, dim=1)

    # -- primal --------------------------------------------------------------
    def init_primal(self, costs):
        sp = costs["sp"]
        return {"e": torch.full((sp.shape[0], 2 * self.k), -1, dtype=torch.int32,
                                device=sp.device)}

    def evaluate_primal(self, costs, primal):
        k = self.k
        e = primal["e"]
        sp_cut = e[:, :k]
        rim_cut = e[:, k:]
        a = 1 - sp_cut
        an = torch.roll(a, -1, dims=1)
        set_ok = torch.all(e >= 0, dim=1)
        # rim edge forced cut iff membership differs; forced uncut iff both 1
        ok = torch.all((a == an) | (rim_cut == 1), dim=1)
        ok &= torch.all(~((a == 1) & (an == 1)) | (rim_cut == 0), dim=1)
        # all-hubless rim: a single cut rim edge would split one block
        all_zero = torch.all(a == 0, dim=1)
        ok &= ~all_zero | (torch.sum(rim_cut, dim=1) != 1)
        dt = costs["sp"].dtype
        val = torch.sum(costs["sp"] * sp_cut.to(dt), dim=1) + \
            torch.sum(costs["rim"] * rim_cut.to(dt), dim=1)
        # hub-triangle slot costs under the realized triangle patterns
        tri = costs["tri"]
        bits = torch.stack([sp_cut, torch.roll(sp_cut, -1, dims=1), rim_cut], dim=2)  # [F, k, 3]
        pats = device_table(TRIPLET_PATTERNS, e, torch.int32)           # [4, 3]
        match = torch.all(bits[:, :, None, :] == pats[None, None], dim=3)
        val = val + torch.sum(torch.where(match, tri, torch.zeros_like(tri)), dim=(1, 2))
        return _inf_unless(set_ok & ok, val)

    def dual_vector(self, costs):
        sp = costs["sp"]
        return torch.cat([sp, costs["rim"], costs["tri"].reshape(sp.shape[0], -1)], dim=1)

    # -- constraint export ---------------------------------------------------
    def configs(self) -> np.ndarray:
        """The strict cut configurations (``_wheel_cut_configs``)."""
        if self._configs is None:
            self._configs = _wheel_cut_configs(self.k)
        return self._configs

    def lp_vars(self, state_row, data):
        cfg = self.configs().astype(np.float64)
        w = np.concatenate([np.asarray(state_row["sp"], dtype=np.float64),
                            np.asarray(state_row["rim"], dtype=np.float64)])
        c = cfg @ w
        # add hub-triangle slot costs per config
        tri = np.asarray(state_row["tri"], dtype=np.float64)   # [k, 4]
        k = self.k
        for j, row in enumerate(self.configs()):
            for i in range(k):
                bits = (row[i], row[(i + 1) % k], row[k + i])
                hit = np.nonzero((TRIPLET_PATTERNS ==
                                  np.asarray(bits)).all(axis=1))[0]
                if len(hit):
                    c[j] += tri[i, int(hit[0])]
        return c, [{j: 1.0 for j in range(len(c))}], [1.0], cfg

    def lp_fix(self, prim_row, meta):
        e = np.asarray(prim_row["e"], dtype=np.int32)
        v = np.zeros(meta.shape[0])
        hit = np.nonzero((meta == e).all(axis=1))[0]
        v[int(hit[0])] = 1.0
        return v

    def lp_read(self, values, meta):
        return {"e": meta[int(np.argmax(values))].astype(np.int64)}


MULTICUT_EDGE = MulticutEdgeType()
MULTICUT_TRIPLET = MulticutTripletType()
MULTICUT_ODD_WHEEL = MulticutOddWheelType()

_WHEEL_K_CACHE: dict[int, MulticutWheelKType] = {}


def wheel_k_type(k: int) -> MulticutWheelKType:
    """Singleton odd-k-wheel factor type per rim length, so the engine's
    type-keyed blocks group all wheels of one k."""
    if k not in _WHEEL_K_CACHE:
        _WHEEL_K_CACHE[k] = MulticutWheelKType(k)
    return _WHEEL_K_CACHE[k]
