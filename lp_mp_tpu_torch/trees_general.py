"""General tree decomposition over arbitrary factor and message types
(counterpart of ``lp_mp_tpu/trees_general.py``).

Counterpart of the reference's ``factor_tree`` / ``LP_with_trees``
(tree_decomposition.hxx:11-995) without the chain/MRF restriction of
``trees.ChainDecomposition``:

- a *tree* is any acyclic set of messages over the factor graph
  (``factor_tree::add_message(msg, Chirality)``, tree_decomposition.hxx:
  39-104: the chirality names the endpoint closer to the root);
- factors shared between trees are cloned with their dual state divided by
  multiplicity (``f->divide(n)``, tree_decomposition.hxx:797-826);
- clone consensus is enforced through Lagrange multipliers with the
  reference's index layouts (tree_decomposition.hxx:277-585): ``zero_sum``
  (copies sum to zero), ``star`` (hub collects +blocks, every other copy
  carries -block), ``fwmap`` (one shared block per factor, the consensus in
  the prox term as in BCFW-Bundle) and ``quadratic`` (one block per copy
  pair);
- ``LP_subgradient_ascent`` (tree_decomposition.hxx:998-1029) and the FW-MAP
  proximal bundle method (LP_FWMAP.hxx:10-139) optimize the decomposition
  dual.

Tree nodes live in the type-batched blocks of an ``Engine`` built over the
clone graph on the caller's device.  The upward sweep (``send_message_up``,
factors_messages.hxx:1553-1570) is a sequence of depth-levelled batched
marginal shifts (all messages whose child sits at depth d fire together);
the downward solution tracking (``track_solution_down``,
factors_messages.hxx:1573-1602) reuses the message types' batched
``propagate_primal_*``.  The JAX package jits the whole solve; here, with
``use_jit`` (the default), the solve runs through ``capture.Graphs``: one
CUDA graph on the card that holds every depth level's ops, a direct call
with the same buffer logic on the CPU (``load_duals`` drops the graph, whose
constants it replaces).  The inner engine runs eagerly (``use_jit=False``,
as in the JAX package): only its blocks and reductions are used.  Subgradients in dual coordinates are ``torch.autograd.grad``
of the (linear) primal evaluation with the dual blocks as leaves: the
generic ``FactorTypeAdapter::subgradient`` (LP_MP.h:78-79) for every factor
type at once.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .capture import Graphs
from .config import PAD_COST
from .engine import Engine, _gather
from .graph import FactorGraph, MessageRef


# ---------------------------------------------------------------------------
# helpers over dual-state dicts {type: {key: tensor}}
# ---------------------------------------------------------------------------
def _tmap(f, *trees):
    return {name: {k: f(*(t[name][k] for t in trees)) for k in trees[0][name]}
            for name in trees[0]}


def _tdot(a, b) -> torch.Tensor:
    return sum(torch.sum(a[name][k] * b[name][k]) for name in a for k in a[name])


def _is_dual(t: torch.Tensor) -> bool:
    return t.is_floating_point()


def _finite(c: torch.Tensor) -> torch.Tensor:
    """Mask PAD lanes to zero (for inner products with indicator vectors)."""
    return torch.where(c.abs() >= PAD_COST / 2, torch.zeros_like(c), c)


def _rows(t: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """[F] -> [F, 1, ...] to broadcast against ``v``."""
    return t.reshape((-1,) + (1,) * (v.ndim - 1))


def _segment_sum(v: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    out = torch.zeros((n,) + tuple(v.shape[1:]), dtype=v.dtype, device=v.device)
    return out.index_add_(0, seg, v)


def _fit(src: torch.Tensor, shape, fill: float) -> torch.Tensor:
    """``src`` [F, ...] padded with ``fill`` up to trailing ``shape``."""
    if tuple(src.shape[1:]) == tuple(shape):
        return src
    out = src.new_full((src.shape[0],) + tuple(shape), fill)
    out[(slice(None),) + tuple(slice(0, s) for s in src.shape[1:])] = src
    return out


@dataclasses.dataclass
class TreeSpec:
    """One tree: list of (message, parent_side) pairs, parent_side in
    {"left","right"} naming the endpoint closer to the root: the
    ``Chirality`` argument of ``factor_tree::add_message``
    (test/test_model.hxx:150-174)."""
    messages: list  # [(MessageRef | int, "left"|"right")]


class GeneralTreeDecomposition:
    """Lagrangean decomposition of a FactorGraph into arbitrary trees."""

    def __init__(self, graph: FactorGraph, trees: list, layout: str = "zero_sum",
                 device="cuda", dtype: "torch.dtype | None" = None, use_jit: bool = True):
        assert layout in ("zero_sum", "star", "fwmap", "quadratic")
        self.layout = layout
        n_orig = graph.n_factors

        # ---- normalize tree specs; validate tree shape --------------------
        # (tree_decomposition.hxx:39-104: every factor except the root has
        # exactly one parent edge, edge count = node count - 1)
        norm: list[list[tuple[int, str]]] = []
        for t in trees:
            msgs = t.messages if isinstance(t, TreeSpec) else t
            norm.append([(m.mid if isinstance(m, MessageRef) else int(m), side)
                         for m, side in msgs])
        covered = set()
        tree_nodes: list[list[int]] = []
        tree_edges: list[list[tuple[int, int, int]]] = []  # (mid, parent, child)
        for tn in norm:
            nodes: set[int] = set()
            edges = []
            child_seen: set[int] = set()
            for mid, side in tn:
                _, l, r, _ = graph.messages[mid]
                parent, child = (l, r) if side == "left" else (r, l)
                assert child not in child_seen, \
                    f"factor {child} has two parents: not a tree"
                child_seen.add(child)
                nodes.update((l, r))
                edges.append((mid, parent, child))
            roots = nodes - child_seen
            assert len(roots) == 1, f"tree is not connected/acyclic (roots={roots})"
            assert len(edges) == len(nodes) - 1
            tree_nodes.append(sorted(nodes))
            tree_edges.append(edges)
            covered.update(nodes)
        # factors outside every tree become singleton trees so their bound
        # still enters the decomposition (LP_with_trees keeps them as-is)
        for f in range(n_orig):
            if f not in covered:
                tree_nodes.append([f])
                tree_edges.append([])
        self.n_trees = len(tree_nodes)

        # ---- clone graph (construct_decomposition, t_d.hxx:769-887) -------
        mult = np.zeros(n_orig, dtype=np.int64)
        for nodes in tree_nodes:
            for f in nodes:
                mult[f] += 1
        cg = FactorGraph()
        clone_of: list[dict] = []
        clone2orig: list[int] = []
        clone2tree: list[int] = []
        for t, nodes in enumerate(tree_nodes):
            cmap = {}
            for f in nodes:
                ft, data = graph.factors[f]
                cmap[f] = cg.add_factor(ft, data)
                clone2orig.append(f)
                clone2tree.append(t)
            clone_of.append(cmap)
        cedges = []  # (clone mid, parent clone fid, child clone fid, depth)
        for t, edges in enumerate(tree_edges):
            cmap = clone_of[t]
            depth = {next(iter(set(cmap) - {c for _, _, c in edges})): 0} if edges else {}
            # BFS depths over the validated tree
            pend = list(edges)
            while pend:
                rest = []
                for mid, p, c in pend:
                    if p in depth:
                        depth[c] = depth[p] + 1
                    else:
                        rest.append((mid, p, c))
                assert len(rest) < len(pend), "tree not connected"
                pend = rest
            for mid, p, c in edges:
                mt, l, r, data = graph.messages[mid]
                ref = cg.add_message(mt, clone_of[t][l], clone_of[t][r], data)
                cedges.append((ref.mid, cmap[p].fid, cmap[c].fid, depth[c]))
        self.mult = mult
        self.clone2orig = np.asarray(clone2orig, dtype=np.int64)
        self.clone2tree = np.asarray(clone2tree, dtype=np.int64)

        # the Engine gives type-batched blocks, message index arrays and the
        # bound and evaluation reductions; its sweep schedule is unused here
        self.eng = eng = Engine(cg, schedule_mode="coloring", device=device, dtype=dtype,
                                use_jit=False)
        self.device, self.dtype = eng.device, eng.dtype
        self.jit = Graphs(self.device, enabled=use_jit, name="GeneralTreeDecomposition")
        self._solve_fn = self.jit.jit(self._solve_impl, "solve")

        def idx(a):
            return torch.as_tensor(np.asarray(a, dtype=np.int64), device=self.device)

        # divide clone duals by multiplicity (f->divide(n))
        self.base = {}
        for name, block in eng.state.items():
            m = torch.as_tensor(mult[self.clone2orig[eng._type_fids[name]]],
                                device=self.device)
            self.base[name] = {
                k: (torch.where(v.abs() >= PAD_COST / 2, v, v / _rows(m, v).to(v.dtype))
                    if _is_dual(v) else v)
                for k, v in block.items()}

        # ---- per-type row maps ---------------------------------------------
        self._rows_group = {name: self.clone2orig[fids] for name, fids in eng._type_fids.items()}
        self._tree_idx = {name: idx(self.clone2tree[fids]) for name, fids in eng._type_fids.items()}
        self._group_idx = {name: idx(v) for name, v in self._rows_group.items()}
        # hub = first clone (lowest tree id) of each original factor
        self._rows_hub = {}
        for name, grp in self._rows_group.items():
            first = np.full(n_orig, -1, dtype=np.int64)
            for i, g in enumerate(grp):
                if first[g] < 0:
                    first[g] = i
            self._rows_hub[name] = first[grp] == np.arange(len(grp))
        self._hub_mask = {name: torch.as_tensor(v, device=self.device)
                          for name, v in self._rows_hub.items()}

        # ---- depth-levelled up/down plans ----------------------------------
        # map clone-graph message gid -> (type name, local index)
        loc: dict[int, tuple[str, int]] = {}
        for name, blk in eng.msgs.items():
            for i, g in enumerate(blk.gids):
                loc[int(g)] = (name, i)
        # group (depth, type, child_side) -> local ids
        groups: dict[tuple[int, str, bool], list[int]] = {}
        clone_depth = np.zeros(cg.n_factors, dtype=np.int64)
        for mid, p, c, d in cedges:
            name, i = loc[mid]
            child_left = (eng.msgs[name].lfid[i] == c)
            groups.setdefault((d, name, bool(child_left)), []).append(i)
            clone_depth[c] = d
        self.max_depth = max((d for d, _, _ in groups), default=0)

        def entry(name, ids, cl):
            blk = eng.msgs[name]
            ids_t = idx(ids)
            return (name, blk.lidx[ids_t], blk.ridx[ids_t], _gather(blk.data, ids_t), cl)

        self.up_plan = [entry(name, groups[(d, name, cl)], cl)
                        for (d, name, cl) in sorted(groups, key=lambda k: -k[0])]
        # downward, bucketed by child depth so propagation at depth d sees
        # depth d-1 primals already tracked (track_solution_down order)
        self.down_plan = [[entry(name, groups[(dd, name, cl)], cl)
                           for (dd, name, cl) in sorted(groups) if dd == d]
                          for d in range(1, self.max_depth + 1)]
        # factor rows per (depth, type) for staged primal argmins
        self._depth_rows: list[dict[str, torch.Tensor]] = []
        for d in range(self.max_depth + 1):
            per = {}
            for name, fids in eng._type_fids.items():
                rows = np.nonzero(clone_depth[fids] == d)[0]
                # depth 0 includes singleton factors (depth array default 0)
                if len(rows):
                    per[name] = idx(rows)
            self._depth_rows.append(per)

        # all (i, j) clone-row pairs within each original factor's copy set
        # (Lagrangean_factor_quadratic, tree_decomposition.hxx:277-585: one
        # multiplier block per copy pair; w_ij enters copy i as +w and copy
        # j as -w, so the consensus subspace is parameterized redundantly)
        self._pairs = {}
        for name, grp in self._rows_group.items():
            rows_of: dict[int, list[int]] = {}
            for i, g2 in enumerate(grp):
                rows_of.setdefault(int(g2), []).append(i)
            pi, pj = [], []
            for rows in rows_of.values():
                for a in range(len(rows)):
                    for b in range(a + 1, len(rows)):
                        pi.append(rows[a])
                        pj.append(rows[b])
            self._pairs[name] = (idx(pi), idx(pj))
        self._n_orig = n_orig

    # ------------------------------------------------------------------
    # multipliers
    # ------------------------------------------------------------------
    def zeros_like_dual(self):
        return {name: {k: torch.zeros_like(v) for k, v in blk.items() if _is_dual(v)}
                for name, blk in self.base.items()}

    def _with_dual(self, fn):
        """Apply fn(type name, key, tensor) over a dual dict."""
        def go(tree):
            return {name: {k: fn(name, k, v) for k, v in blk.items()}
                    for name, blk in tree.items()}
        return go

    def project(self, lam):
        """Project multipliers onto the consensus subspace: per original
        factor, copies sum to zero (Lagrangean_factor_zero_sum).  Valid
        bounds require lam in this subspace."""
        def go(name, k, v):
            grp = self._group_idx[name]
            s = _segment_sum(v, grp, self._n_orig)
            cnt = _segment_sum(torch.ones(v.shape[0], dtype=v.dtype, device=v.device),
                               grp, self._n_orig)
            mean = s / _rows(cnt, v)
            return v - mean[grp]
        return self._with_dual(go)(lam)

    def star_to_dual(self, w):
        """Star layout (Lagrangean_factor_star, t_d.hxx:315-404): w lives on
        non-hub copies; lam(copy) = -w(copy), lam(hub) = sum_copies w."""
        def go(name, k, v):
            hub_b = _rows(self._hub_mask[name], v)
            grp = self._group_idx[name]
            nh = torch.where(hub_b, torch.zeros_like(v), v)
            s = _segment_sum(nh, grp, self._n_orig)
            return torch.where(hub_b, s[grp], -nh)
        return self._with_dual(go)(w)

    def star_pullback(self, g):
        """d(bound)/dw under the star layout: gw(copy) = g(hub) - g(copy)."""
        def go(name, k, v):
            hub_b = _rows(self._hub_mask[name], v)
            grp = self._group_idx[name]
            hubval = _segment_sum(torch.where(hub_b, v, torch.zeros_like(v)), grp, self._n_orig)
            return torch.where(hub_b, torch.zeros_like(v), hubval[grp] - v)
        return self._with_dual(go)(g)

    def quad_to_dual(self, w):
        """Quadratic layout (Lagrangean_factor_quadratic, t_d.hxx:277-585):
        one multiplier block per copy pair; lam(i) = sum_j>i w_ij
        - sum_j<i w_ji.  Lies in the zero-sum subspace by construction."""
        out = {}
        for name, blk in w.items():
            pi, pj = self._pairs[name]
            n_rows = next(iter(self.base[name].values())).shape[0]
            out[name] = {}
            for k, v in blk.items():
                z = torch.zeros((n_rows,) + tuple(v.shape[1:]), dtype=v.dtype, device=v.device)
                out[name][k] = z.index_add(0, pi, v).index_add(0, pj, -v)
        return out

    def quad_pullback(self, g):
        """d(bound)/dw_ij = g(copy i) - g(copy j)."""
        out = {}
        for name, blk in g.items():
            pi, pj = self._pairs[name]
            out[name] = {k: v[pi] - v[pj] for k, v in blk.items()}
        return out

    def zeros_like_w(self):
        """Zero multipliers in LAYOUT coordinates (pair blocks for
        quadratic; clone-dual shaped otherwise)."""
        if self.layout != "quadratic":
            return self.zeros_like_dual()
        out = {}
        for name, blk in self.base.items():
            pi, _ = self._pairs[name]
            out[name] = {k: torch.zeros((len(pi),) + tuple(v.shape[1:]), dtype=v.dtype,
                                        device=v.device)
                         for k, v in blk.items() if _is_dual(v)}
        return out

    def to_dual(self, w):
        if self.layout == "star":
            return self.star_to_dual(w)
        if self.layout == "quadratic":
            return self.quad_to_dual(w)
        # zero_sum / fwmap (shared block): consensus by projection
        return self.project(w)

    def pullback(self, g):
        if self.layout == "star":
            return self.star_pullback(g)
        if self.layout == "quadratic":
            return self.quad_pullback(g)
        return self.project(g)

    def n_multipliers(self) -> int:
        """Size of the external multiplier vector (joint_no_Lagrangean_vars):
        zero_sum = dual size of every copy; star = (copies-1) blocks per
        factor; fwmap = one shared block per factor; quadratic = one block
        per copy pair."""
        total = 0
        for name, blk in self.base.items():
            per_row = sum(int(np.prod(v.shape[1:])) for v in blk.values() if _is_dual(v))
            k = np.bincount(self._rows_group[name], minlength=self._n_orig)
            k = k[k > 0]
            if self.layout == "star":
                total += per_row * int(np.sum(k - 1))
            elif self.layout == "fwmap":
                total += per_row * len(k)
            elif self.layout == "quadratic":
                total += per_row * int(np.sum(k * (k - 1) // 2))
            else:
                total += per_row * int(np.sum(k))
        return total

    # ------------------------------------------------------------------
    # exact batched tree solve
    # ------------------------------------------------------------------
    def solve(self, lam=None):
        """Returns (bound_per_tree [T], primal dict, swept state)."""
        return self._solve(lam, with_state=True)

    def _solve(self, lam, with_state: bool):
        """``solve``, its swept state None unless ``with_state``."""
        if lam is None:
            lam = self.zeros_like_dual()
        return self._solve_fn(lam, with_state=with_state)

    def _solve_impl(self, lam, with_state: bool):
        eng = self.eng
        # add multipliers onto the divided base duals
        state = {name: dict(blk) for name, blk in self.base.items()}
        for name, blk in lam.items():
            for k, v in blk.items():
                b = state[name][k]
                state[name][k] = torch.where(b.abs() >= PAD_COST / 2, b, b + v)

        # upward sweep: full-weight min-marginal pushes, deepest level first
        # (send_message_up == send with omega=1, factors_messages.hxx:1553-1570)
        for name, lidx, ridx, data, child_left in self.up_plan:
            mt = eng.msgs[name].mtype
            ln, rn = mt.left_type.name, mt.right_type.name
            if child_left:
                delta = mt.marginal_left(_gather(state[ln], lidx), data)
                state[ln] = mt.repam_left(state[ln], lidx, -delta, data)
                state[rn] = mt.repam_right(state[rn], ridx, delta, data)
            else:
                delta = mt.marginal_right(_gather(state[rn], ridx), data)
                state[rn] = mt.repam_right(state[rn], ridx, -delta, data)
                state[ln] = mt.repam_left(state[ln], lidx, delta, data)

        # per-tree bound = sum of factor bounds after the sweep: the DP
        # optimum (leftover mins are constants, the root carries the rest)
        bound = torch.zeros(self.n_trees, dtype=self.dtype, device=self.device)
        for name, blk in state.items():
            bound = bound.index_add(0, self._tree_idx[name], eng.ftypes[name].lower_bound(blk))

        # downward: root argmin, then track_solution_down level by level
        prim = {name: eng.ftypes[name].init_primal(blk) for name, blk in state.items()}

        def primal_at(depth_rows):
            for tname, rows in depth_rows.items():
                newp = eng.ftypes[tname].compute_primal(_gather(state[tname], rows),
                                                        _gather(prim[tname], rows))
                prim[tname] = {k: prim[tname][k].index_put((rows,), newp[k])
                               for k in prim[tname]}

        primal_at(self._depth_rows[0])
        for d in range(1, self.max_depth + 1):
            for name, lidx, ridx, data, child_left in self.down_plan[d - 1]:
                mt = eng.msgs[name].mtype
                ln, rn = mt.left_type.name, mt.right_type.name
                if child_left:   # parent is right: propagate right -> left
                    prim[ln] = mt.propagate_primal_r2l(prim[ln], prim[rn], lidx, ridx, data)
                else:
                    prim[rn] = mt.propagate_primal_l2r(prim[ln], prim[rn], lidx, ridx, data)
            primal_at(self._depth_rows[d])
        return bound, prim, state if with_state else None

    def decomposition_lower_bound(self, lam=None) -> float:
        bound, _, _ = self._solve(lam, with_state=False)
        return float(torch.sum(bound))

    # ------------------------------------------------------------------
    # subgradient in dual coordinates
    # ------------------------------------------------------------------
    def _indicator(self, prim):
        """d(primal cost)/d(dual state): the labeling indicator in every
        factor's dual coordinates (the generic FactorTypeAdapter::
        subgradient, LP_MP.h:78-79), as torch.autograd.grad of the linear
        evaluation at zero duals."""
        leaves = {name: {k: torch.zeros_like(v, requires_grad=True)
                         for k, v in blk.items() if _is_dual(v)}
                  for name, blk in self.base.items()}
        with torch.enable_grad():
            total = 0.0
            for name, blk in leaves.items():
                v = self.eng.ftypes[name].evaluate_primal({**self.base[name], **blk}, prim[name])
                total = total + torch.sum(torch.where(torch.isfinite(v), v, torch.zeros_like(v)))
            flat = [t for blk in leaves.values() for t in blk.values()]
            grads = torch.autograd.grad(total, flat, allow_unused=True)
        it = iter(grads)
        return {name: {k: (g if g is not None else torch.zeros_like(t))
                       for k, t, g in ((k, t, next(it)) for k, t in blk.items())}
                for name, blk in leaves.items()}

    # ------------------------------------------------------------------
    # optimizers
    # ------------------------------------------------------------------
    def grad_at(self, w):
        """(bound, layout subgradient, its squared norm) at multipliers w."""
        bound, prim, _ = self._solve(self.to_dual(w), with_state=False)
        g = self.pullback(self._indicator(prim))
        return float(torch.sum(bound)), g, float(_tdot(g, g))

    def subgradient_ascent(self, n_iter: int = 100, step: float = 1.0,
                           ub_estimate: "float | None" = None, w=None):
        """Projected/Polyak subgradient ascent on the chosen layout
        (LP_subgradient_ascent, tree_decomposition.hxx:998-1029)."""
        if w is None:
            w = self.zeros_like_w()
        best, best_w, hist = -np.inf, w, []
        for k in range(n_iter):
            val, g, gnorm = self.grad_at(w)
            hist.append(val)
            if val > best:
                best, best_w = val, w
            if gnorm < 1e-14:
                break   # consensus: all copies agree
            if ub_estimate is not None and ub_estimate > val:
                alpha = step * (ub_estimate - val) / gnorm
            else:
                alpha = step / np.sqrt(k + 1.0)
            w = _tmap(lambda wi, gi: wi + alpha * gi, w, g)
        return best, best_w, hist

    def fw_map(self, n_outer: int = 10, n_inner: int = 20, prox_weight: float = 1.0):
        """Proximal-point + Frank-Wolfe over the decomposition
        (LP_FWMAP.hxx:10-139 / BCFW-Bundle): linear oracle = batched tree
        solve with consensus-penalty-tilted duals, exact line search on the
        quadratic prox model, recenter after each outer round."""
        w = prox_weight
        lam0 = self.zeros_like_dual()
        base_fin = {name: {k: _finite(v) for k, v in blk.items() if _is_dual(v)}
                    for name, blk in self.base.items()}

        def oracle(lam):
            bound, prim, _ = self._solve(lam, with_state=False)
            return torch.sum(bound), self._indicator(prim)

        # start from the zero-multiplier tree optimum
        _, mu = oracle(lam0)
        best, best_lam, hist = -np.inf, lam0, []
        for _ in range(n_outer):
            for _ in range(n_inner):
                dev = self.project(mu)
                _, s = oracle(_tmap(lambda l, dv: l + w * dv, lam0, dev))
                d = _tmap(torch.sub, s, mu)
                tilt = _tmap(lambda c, l, dv: c + l + w * dv, base_fin, lam0, dev)
                lin = _tdot(tilt, d)
                pd = self.project(d)
                curv = w * _tdot(pd, pd)
                gamma = 1.0 if float(curv) <= 1e-14 else \
                    float(torch.clamp(-lin / curv, 0.0, 1.0))
                mu = _tmap(lambda m, di: m + gamma * di, mu, d)
                lam_k = _tmap(lambda l, p: l + w * p, lam0, self.project(mu))
                val = float(oracle(lam_k)[0])
                hist.append(val)
                if val > best:
                    best, best_lam = val, lam_k
            lam0 = _tmap(lambda l, p: l + w * p, lam0, self.project(mu))
        return best, best_lam, hist

    # ------------------------------------------------------------------
    def consensus_primal(self, prim):
        """Per original factor: the hub clone's labels + agreement flag."""
        out: dict[int, dict] = {}
        agree = True
        for name in self.eng._type_fids:
            grp = self._rows_group[name]
            hub = self._rows_hub[name]
            for key, arr in prim[name].items():
                a = arr.cpu().numpy()
                for i in np.nonzero(hub)[0]:
                    out.setdefault(int(grp[i]), {})[key] = a[i]
                for g in np.unique(grp):
                    rows = np.nonzero(grp == g)[0]
                    if len(rows) > 1 and len(np.unique(a[rows])) > 1:
                        agree = False
        return out, agree

    # ------------------------------------------------------------------
    def load_duals(self, engine: Engine) -> None:
        """Rebuild the divided base duals from an engine's CURRENT
        reparametrization: the --treeDecompositionBegin mid-run engine
        switch (tree_decomposition.hxx:918-929): message passing runs
        first, then the decomposition continues from the reparametrized
        costs it produced."""
        state = engine.get_state()
        for name, blk in self.base.items():
            orig = self.clone2orig[self.eng._type_fids[name]]
            src_rows = torch.as_tensor(engine.f_local[orig], device=self.device)
            m = torch.as_tensor(self.mult[orig], device=self.device)
            for k, v in blk.items():
                if not _is_dual(v):
                    continue
                src = state[name][k].to(self.device, v.dtype)[src_rows]
                src = _fit(src, v.shape[1:], PAD_COST)
                blk[k] = torch.where(v.abs() >= PAD_COST / 2, v, src / _rows(m, v).to(v.dtype))
        # the solve's graph read the replaced base duals as constants
        self.jit.reset()

    # ------------------------------------------------------------------
    def write_back_reparametrization(self, engine: Engine, lam=None) -> None:
        """Push every tree's mass rootward (the upward sweep), then write
        sum-of-clones duals into an Engine built on the ORIGINAL graph
        (write_back_reparametrization, tree_decomposition.hxx:970-988).
        Afterwards engine.lower_bound() >= decomposition bound
        (test/test_FWMAP.cpp:20-21 acceptance)."""
        _, _, swept = self.solve(lam)
        state = engine.get_state()
        for name, blk in swept.items():
            rows = torch.as_tensor(engine.f_local[self.clone2orig[self.eng._type_fids[name]]])
            newb = dict(state[name])
            for k, v in blk.items():
                if not _is_dual(v):
                    continue
                cur = newb[k]
                tgt = torch.where(cur.abs() >= PAD_COST / 2, cur, torch.zeros_like(cur))
                contrib = _fit(_finite(v), tgt.shape[1:], 0.0).to(tgt)
                newb[k] = tgt.index_add(0, rows.to(tgt.device), contrib)
            state[name] = newb
        engine.set_state(state)
