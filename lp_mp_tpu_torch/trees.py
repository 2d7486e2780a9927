"""Tree (chain) decomposition over an MRF (counterpart of ``lp_mp_tpu/trees.py``).

Counterpart of the reference's alternate optimization engines
(tree_decomposition.hxx, LP_FWMAP.hxx):

- ``factor_tree`` / ``LP_with_trees`` (tree_decomposition.hxx:11-995):
  decompose the LP into trees, clone shared factors with their cost divided
  by multiplicity, couple the clones with Lagrange multipliers, solve each
  tree exactly;
- ``LP_subgradient_ascent`` (tree_decomposition.hxx:998-1029): projected
  subgradient on the consensus multipliers;
- ``LP_tree_FWMAP`` (LP_FWMAP.hxx:10-139): proximal block-coordinate
  Frank-Wolfe over per-tree marginal averages.

The trees are an edge-disjoint chain cover of the MRF's pairwise graph,
padded into dense blocks ``unary [T, V, L]`` and ``pairwise [T, V-1, L, L]``,
so every tree is solved at once by one batched Viterbi: a Python loop over
the V-1 positions, each step a ``[T, L, L]`` min-plus.  ``torch.argmin``
returns the first minimum on ties, as ``jnp.argmin`` does.  The cover is
host code, copied from the JAX package with its iteration over
``set(mrf.pairwise.keys())``: the port's ``MrfConstructor`` builds the same
keys, so it gives the same chains.

With ``use_jit`` (the default, as in the JAX package) ``solve`` and
``project`` run through ``capture.Graphs``: each is one CUDA graph on the
card (the solve's Viterbi loop becomes one launch), direct calls with the
same buffer logic on the CPU.  The host loops around them stay outside
the graphs: the float line search of ``fw_map`` and the steps of
``subgradient_ascent``.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from .capture import Graphs
from .config import entry_device, real_dtype
from .factors.potts import PAIRWISE_POTTS
from .factors.simplex import PAIRWISE_SIMPLEX, UNARY_SIMPLEX
from .models.mrf import MrfConstructor

BIG = 1e15


def _one_hot(x: torch.Tensor, n: int, dtype) -> torch.Tensor:
    return torch.nn.functional.one_hot(x.long(), n).to(dtype)


@dataclasses.dataclass
class ChainDecomposition:
    """Edge-disjoint chain cover of an MRF's pairwise graph.

    A variable with k copies has its unary cost split evenly
    (f->divide(n), tree_decomposition.hxx:797-826).
    """
    unary: torch.Tensor          # [T, V, L] base shares (padded with BIG)
    pairwise: torch.Tensor       # [T, V-1, L, L] (padded with 0)
    var_of: np.ndarray           # [T, V] variable id or -1 (padding)
    n_vars: int
    n_labels: int
    group_index: torch.Tensor    # [T, V] consensus-group id (var id; pads -> n_vars)
    group_size: torch.Tensor     # [n_vars+1] copies per group (pads -> 1)
    chains: list                 # list of [var ids] per tree
    mrf: "MrfConstructor | None" = None
    use_jit: bool = True         # capture solve and project as CUDA graphs

    # ------------------------------------------------------------------
    @classmethod
    def from_mrf(cls, mrf: MrfConstructor, device="cuda",
                 dtype: "torch.dtype | None" = None,
                 use_jit: bool = True) -> "ChainDecomposition":
        """The greedy chain cover of ``mrf`` as blocks on ``device`` (the
        card unless the caller asks for the CPU)."""
        device = entry_device(device)
        dtype = dtype or real_dtype(device)
        n = len(mrf.unaries)
        g = mrf.graph

        def unary_cost(i):
            ft, data = g.factors[mrf.unaries[i].fid]
            return np.asarray(data, dtype=np.float64)

        def pairwise_cost(i, j):
            ref = mrf.pairwise[(i, j)]
            ft, data = g.factors[ref.fid]
            if ft is PAIRWISE_POTTS:
                L, diff = data
                return diff * (1.0 - np.eye(L))
            return np.asarray(data, dtype=np.float64)

        # greedy edge-disjoint path cover
        unused = set(mrf.pairwise.keys())
        adj: dict[int, set[int]] = {}
        for (i, j) in unused:
            adj.setdefault(i, set()).add(j)
            adj.setdefault(j, set()).add(i)
        chains: list[list[int]] = []
        while unused:
            (i, j) = next(iter(unused))
            unused.discard((i, j))
            path = [i, j]
            # extend at the tail
            while True:
                t = path[-1]
                nxt = next((v for v in adj.get(t, ()) if
                            (min(t, v), max(t, v)) in unused and v not in path), None)
                if nxt is None:
                    break
                unused.discard((min(t, nxt), max(t, nxt)))
                path.append(nxt)
            # extend at the head
            while True:
                h = path[0]
                nxt = next((v for v in adj.get(h, ()) if
                            (min(h, v), max(h, v)) in unused and v not in path), None)
                if nxt is None:
                    break
                unused.discard((min(h, nxt), max(h, nxt)))
                path.insert(0, nxt)
            chains.append(path)
        covered = {v for c in chains for v in c}
        for i in range(n):
            if i not in covered:
                chains.append([i])  # isolated unary = length-1 chain

        L = max(len(unary_cost(i)) for i in range(n))
        T = len(chains)
        V = max(len(c) for c in chains)
        mult = np.zeros(n, dtype=np.int64)
        for c in chains:
            for v in c:
                mult[v] += 1

        unary = np.full((T, V, L), BIG)
        pair = np.zeros((T, max(V - 1, 1), L, L))
        var_of = np.full((T, V), -1, dtype=np.int64)
        for t, c in enumerate(chains):
            for p, v in enumerate(c):
                uc = unary_cost(v)
                unary[t, p, :len(uc)] = uc / mult[v]
                unary[t, p, len(uc):] = BIG
                var_of[t, p] = v
            for p in range(len(c) - 1):
                a, b = c[p], c[p + 1]
                m = pairwise_cost(min(a, b), max(a, b))
                if a > b:
                    m = m.T
                pair[t, p, :m.shape[0], :m.shape[1]] = m
                pair[t, p, m.shape[0]:, :] = BIG
                pair[t, p, :, m.shape[1]:] = BIG
            # padding positions: forced label 0, zero cost, zero coupling
            for p in range(len(c), V):
                unary[t, p, 0] = 0.0
            for p in range(max(len(c) - 1, 0), V - 1):
                pair[t, p, :, :] = 0.0

        group = np.where(var_of >= 0, var_of, n)
        gsize = np.ones(n + 1, dtype=np.int64)
        gsize[:n] = np.maximum(mult, 1)
        # cast like the JAX package (float64 numpy -> the compute dtype)
        return cls(unary=torch.as_tensor(unary.astype(np.float64)).to(device, dtype),
                   pairwise=torch.as_tensor(pair).to(device, dtype),
                   var_of=var_of, n_vars=n, n_labels=L,
                   group_index=torch.as_tensor(group, device=device),
                   group_size=torch.as_tensor(gsize, device=device), chains=chains, mrf=mrf,
                   use_jit=use_jit)

    @functools.cached_property
    def jit(self) -> Graphs:
        """The captured ``solve`` and ``project`` (``capture.Graphs``)."""
        return Graphs(self.unary.device, enabled=self.use_jit, name="ChainDecomposition")

    @functools.cached_property
    def _graphed(self) -> tuple:
        return self.jit.jit(self._solve_impl, "solve"), self.jit.jit(self._project_impl, "project")

    # ------------------------------------------------------------------
    def project(self, lam: torch.Tensor) -> torch.Tensor:
        """Project multipliers onto the consensus subspace: per variable,
        copies sum to zero (Lagrangean_factor_zero_sum semantics).  Each
        variable's copies are added one after another in a fixed order, not
        by ``index_add_`` (an unfixed order on CUDA) or a reduction (another
        order on each device): the ascent's argmins follow one path on
        every device and in every run."""
        return self._graphed[1](lam)

    def _project_impl(self, lam: torch.Tensor) -> torch.Tensor:
        T, V, L = lam.shape
        flat = torch.cat([lam.reshape(T * V, L), lam.new_zeros((1, L))])
        copies = self._copies
        total = flat[copies[:, 0]]
        for j in range(1, copies.shape[1]):
            total = total + flat[copies[:, j]]
        mean = total / self.group_size[:self.n_vars, None].to(lam.dtype)
        mean = torch.cat([mean, mean.new_zeros((1, L))])      # the padding group
        out = (flat[:-1] - mean[self.group_index.reshape(-1)]).reshape(T, V, L)
        return torch.where(self._valid, out, torch.zeros_like(out))   # padding carries no dual

    @functools.cached_property
    def _valid(self) -> torch.Tensor:
        """[T, V, 1] on the blocks' device: positions that hold a variable."""
        return torch.as_tensor(self.var_of >= 0, device=self.unary.device)[:, :, None]

    @functools.cached_property
    def _copies(self) -> torch.Tensor:
        """[n_vars, K]: the flat [T * V] positions of each variable's
        copies in order, padded with T * V (a zero row past the end)."""
        flat = self.var_of.reshape(-1)
        pos = np.nonzero(flat >= 0)[0]
        var = flat[pos]
        order = np.argsort(var, kind="stable")
        var, pos = var[order], pos[order]
        k = np.bincount(var, minlength=self.n_vars)
        first = np.concatenate([[0], np.cumsum(k)[:-1]])
        out = np.full((self.n_vars, max(int(k.max(initial=0)), 1)), flat.size, dtype=np.int64)
        out[var, np.arange(len(var)) - first[var]] = pos
        return torch.as_tensor(out, device=self.unary.device)

    # ------------------------------------------------------------------
    def solve(self, lam: torch.Tensor):
        """Exact batched chain solve (send_message_up + root argmin +
        track_solution_down, tree_decomposition.hxx:107-161).

        Returns (bound_per_tree [T], argmin labels [T, V] int32)."""
        return self._graphed[0](lam)

    def _solve_impl(self, lam: torch.Tensor):
        u = self.unary + lam
        pw = self.pairwise
        T, V, L = u.shape
        if V == 1:
            return torch.amin(u[:, 0], dim=-1), \
                torch.argmin(u[:, 0], dim=-1)[:, None].to(torch.int32)
        m = u[:, 0]
        args = []
        for v in range(1, V):
            tot = m[:, :, None] + pw[:, v - 1]              # [T, L, L]
            args.append(torch.argmin(tot, dim=1))
            m = torch.amin(tot, dim=1) + u[:, v]
        bound = torch.amin(m, dim=-1)
        x = torch.argmin(m, dim=-1)                         # [T]
        labels = [x]
        for arg in reversed(args):
            x = torch.gather(arg, 1, x[:, None])[:, 0]
            labels.append(x)
        return bound, torch.stack(labels[::-1], dim=1).to(torch.int32)

    def dual_value(self, lam: torch.Tensor) -> torch.Tensor:
        bound, _ = self.solve(lam)
        return torch.sum(bound)

    # ------------------------------------------------------------------
    def subgradient_ascent(self, n_iter: int = 100, ub_estimate: "float | None" = None,
                           step: float = 1.0, lam: "torch.Tensor | None" = None):
        """Projected (Polyak) subgradient ascent (LP_subgradient_ascent,
        tree_decomposition.hxx:998-1029).  Returns (best bound, lam, history)."""
        if lam is None:
            lam = torch.zeros_like(self.unary)
        best = -np.inf
        best_lam = lam
        hist = []
        for k in range(n_iter):
            bound, x = self.solve(lam)
            val = float(torch.sum(bound))
            hist.append(val)
            if val > best:
                best, best_lam = val, lam
            g = self.project(_one_hot(x, self.n_labels, lam.dtype))
            gnorm = float(torch.sum(g * g))
            if gnorm < 1e-14:
                break  # consensus reached: decomposition agrees
            if ub_estimate is not None and ub_estimate > val:
                alpha = step * (ub_estimate - val) / gnorm
            else:
                alpha = step / np.sqrt(k + 1.0)
            lam = lam + alpha * g
        return best, best_lam, hist

    # ------------------------------------------------------------------
    def fw_map(self, n_outer: int = 10, n_inner: int = 20,
               prox_weight: float = 1.0, n_iter: "int | None" = None):
        """Proximal-point + Frank-Wolfe (FW-MAP, LP_FWMAP.hxx:10-139 /
        BCFW-Bundle): each outer step maximizes the proximal dual model

            max_lam  g(lam) - (1/2w) ||lam - lam0||^2

        by solving its Fenchel-primal penalized problem with Frank-Wolfe
        (linear oracle = batched chain solve with tilted unaries, exact line
        search), then recenters lam0 <- lam0 + w proj(mu*).
        Returns (best bound, lam, history)."""
        if n_iter is not None:   # convenience: total budget
            n_outer = max(1, n_iter // n_inner)
        w = prox_weight
        L = self.n_labels
        dtype = self.unary.dtype

        def edge_marg(onehot):
            # [T, V, L] one-hots -> [T, V-1, L, L] outer products
            return onehot[:, :-1, :, None] * onehot[:, 1:, None, :]

        # mask BIG padding so <pairwise, mu_e> stays finite
        pw_f = torch.where(self.pairwise < BIG / 2, self.pairwise, torch.zeros_like(self.pairwise))
        un_f = torch.where(self.unary < BIG / 2, self.unary, torch.zeros_like(self.unary))

        lam0 = torch.zeros_like(self.unary)
        mu = _one_hot(self.solve(lam0)[1], L, dtype)
        mu_e = edge_marg(mu)
        best = -np.inf
        best_lam = lam0
        hist = []
        for _ in range(n_outer):
            for _ in range(n_inner):
                dev = self.project(mu)           # mu - group mean, per copy
                # linear oracle: chain solve with consensus-penalty tilt
                _, x = self.solve(lam0 + w * dev)
                s = _one_hot(x, L, dtype)
                s_e = edge_marg(s)
                d, d_e = s - mu, s_e - mu_e
                # exact line search on the quadratic objective, its sums
                # accumulated in float64 like the port's lower bounds: in
                # float32 a sum of 10^7 terms rounds by another amount on
                # each device and in each order, and the steps follow it
                f64 = torch.float64
                lin = float(torch.sum((un_f + lam0 + w * dev) * d, dtype=f64)
                            + torch.sum(pw_f * d_e, dtype=f64))
                pd = self.project(d)
                curv = float(w * torch.sum(pd * pd, dtype=f64))
                gamma = 1.0 if curv <= 1e-14 else min(1.0, max(0.0, -lin / curv))
                mu = mu + gamma * d
                mu_e = mu_e + gamma * d_e
                # dual point of the prox model and its true bound
                lam_k = lam0 + w * self.project(mu)
                bound, _ = self.solve(lam_k)
                val = float(torch.sum(bound))
                hist.append(val)
                if val > best:
                    best, best_lam = val, lam_k
            lam0 = lam0 + w * self.project(mu)   # proximal recenter (LP_FWMAP.hxx:119-133)
        return best, best_lam, hist

    # ------------------------------------------------------------------
    def primal_labels(self, lam: torch.Tensor) -> np.ndarray:
        """Majority-vote labeling across copies (rounding from trees)."""
        _, x = self.solve(lam)
        votes = np.zeros((self.n_vars, self.n_labels), dtype=np.int64)
        xx = x.cpu().numpy()
        sel = self.var_of >= 0
        np.add.at(votes, (self.var_of[sel], xx[sel]), 1)
        return votes.argmax(axis=1)

    # ------------------------------------------------------------------
    def write_back_reparametrization(self, engine, lam: torch.Tensor) -> None:
        """Push every chain's bound mass into its last unary by exact
        upward min-marginal shifts, then write the reparametrized duals
        into the engine's blocks through its state API
        (write_back_reparametrization, tree_decomposition.hxx:970-988).
        Afterwards engine.lower_bound() == sum of tree bounds
        (test/test_FWMAP.cpp acceptance).  Requires dense pairwise factors."""
        mrf = self.mrf
        u = (self.unary + lam).double().cpu().numpy()
        pw = self.pairwise.double().cpu().numpy().copy()
        T, V, L = u.shape

        new_unary = {i: np.zeros(L) for i in range(self.n_vars)}
        new_pair: dict[tuple[int, int], np.ndarray] = {}
        for t, c in enumerate(self.chains):
            uu = u[t].copy()
            for p in range(len(c) - 1):
                # unary p -> pairwise p: rows += u_p ; u_p = 0
                pw[t, p] += uu[p][:, None]
                uu[p][:] = 0.0
                # pairwise p -> unary p+1: col-min shift
                m2 = pw[t, p].min(axis=0)
                pw[t, p] -= m2[None, :]
                uu[p + 1] += m2
            for p, v in enumerate(c):
                new_unary[v] += uu[p][:len(new_unary[v])]
            for p in range(len(c) - 1):
                a, b = c[p], c[p + 1]
                m = pw[t, p]
                if a > b:
                    m = m.T
                new_pair[(min(a, b), max(a, b))] = m

        state = engine.get_state()
        uc = state[UNARY_SIMPLEX.name]["c"].double().cpu().numpy()
        for i, ref in enumerate(mrf.unaries):
            row = engine.f_local[ref.fid]
            w = min(uc.shape[1], len(new_unary[i]))
            uc[row, :w] = new_unary[i][:w]
        blk = state[UNARY_SIMPLEX.name]
        state[UNARY_SIMPLEX.name] = {**blk, "c": torch.as_tensor(uc).to(blk["c"])}
        if PAIRWISE_SIMPLEX.name in state:
            blk = state[PAIRWISE_SIMPLEX.name]
            pc = blk["c"].double().cpu().numpy()
            for (i, j), m in new_pair.items():
                row = engine.f_local[mrf.pairwise[(i, j)].fid]
                pc[row, :m.shape[0], :m.shape[1]] = m[:pc.shape[1], :pc.shape[2]]
            state[PAIRWISE_SIMPLEX.name] = {**blk, "c": torch.as_tensor(pc).to(blk["c"])}
        engine.set_state(state)


def chain_tree_messages(graph, mrf, chains) -> list:
    """A chain cover as trees for ``GeneralTreeDecomposition`` or
    ``Solver(tree_decomposition=...)``: per chain of two or more
    variables, its unary-pairwise messages as (message id, parent side)
    pairs (``TreeSpec(messages)``), rooted at the chain's middle variable,
    half the depth of a root at one end.  Reads only the graph's message
    chunks and the constructor's unary ids and pairwise refs."""
    mid_of = {}
    for ch in graph.message_chunks():
        for off, lr in enumerate(zip(np.asarray(ch.lfid).tolist(), np.asarray(ch.rfid).tolist())):
            mid_of[lr] = ch.start + off
    ufid = mrf.unaries.fids()
    pairwise = mrf.pairwise
    trees = []
    for c in chains:
        if len(c) < 2:
            continue
        root = len(c) // 2
        msgs = []
        for p in range(len(c) - 1):
            a, b = c[p], c[p + 1]
            pf = pairwise[(min(a, b), max(a, b))].fid
            near, far = (b, a) if p < root else (a, b)      # near: the root's side
            msgs.append((mid_of[(int(ufid[near]), pf)], "left"))
            msgs.append((mid_of[(int(ufid[far]), pf)], "right"))
        trees.append(msgs)
    return trees
