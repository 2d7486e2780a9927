"""Flagship dense grid Potts MRF (counterpart of ``lp_mp_tpu/models/grid_potts.py``).

Unary simplex factors on an H x W grid with Potts pairwise factors on its
4-connected edges, solved by SRMP block-coordinate ascent with a red/black
schedule.  State, label-major and dense (``ops/grid_kernels.py``):

    u    [L, H, W]        unary reparametrized costs
    hm1  [L, H, W-1]      potts slot toward left endpoint  (r, c)
    hm2  [L, H, W-1]      potts slot toward right endpoint (r, c+1)
    vm1  [L, H-1, W]      potts slot toward top endpoint   (r, c)
    vm2  [L, H-1, W]      potts slot toward bottom endpoint(r+1, c)

One iteration = forward pass (black cells update, then red) + backward pass
(red, then black).  A cell update receives the incident potts factors'
min-marginals (per the mode's receive mask), then sends omega-weighted
shares of its reparametrized cost back into the potts slots, with sender
omega = 1/deg (anisotropic) or 1/(deg+leave) (uniform/damped).

``run_fast`` fuses the cross-phase pairs (a cell's receive at the end of one
pass and its send at the start of the next) into single receive+send colour
updates after a send-only prologue: identical coordinate updates, iteration
boundary shifted by half a phase.  ``kernel="cuda"`` runs that schedule
through the hand-written kernels (``ops/grid_kernels``), ``kernel="torch"``
through the plain tensor ops.  The state stays one dense dict on the
model's device; nothing converts it between ``run_fast`` and
``lower_bound``.

With ``use_jit`` (the default, as in the JAX package) ``iterate`` (one
iteration), ``run_fast`` (per ``n``, mode and kernel), ``lower_bound`` and
``round_primal`` run through ``capture.Graphs``: captured once as CUDA
graphs on the card and replayed (``run_fast(kernel="cuda")`` then replays
its kernel launches as one graph), direct calls with the same buffer logic
on the CPU.  The state then lives in fixed buffers that each call
overwrites; ``load_state`` copies into them.

``round_primal`` on a float32 model on the card runs through the rounding
kernels (``round_phase_update``'s four label-writing phases, then
``primal_cost``); CPU and float64 models take the plain ops
(``_round_impl``), which give the same state and labels.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import tracing
from ..capture import Graphs
from ..config import ReparametrizationMode, entry_device, real_dtype
from ..ops.grid_kernels import (STATE_KEYS, cost_work_size, grid_masks, phase_update,
                                primal_cost, primal_cost_ref, receive, round_phase_update,
                                round_update, send)
from ..ops.reductions import two_min

_NUMPY_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}
_ANISOTROPIC = (ReparametrizationMode.anisotropic, ReparametrizationMode.anisotropic2)


def _potts_min_pair(m1, m2, diff):
    """min over (x1,x2) of m1[x1] + m2[x2] + diff*[x1 != x2]; labels axis 0."""
    diag = torch.amin(m1 + m2, dim=0)
    if m1.shape[0] == 1:
        return diag
    a1, s1, i1 = two_min(m1, axis=0)
    a2, s2, i2 = two_min(m2, axis=0)
    off = torch.where(i1 != i2, a1 + a2, torch.minimum(a1 + s2, s1 + a2)) + diff
    return torch.minimum(diag, off)


class GridPottsModel:
    """Grid MRF with unary simplex factors and Potts pairwise factors."""

    def __init__(self, unary, hcost, vcost, device="cuda", dtype=None, use_jit: bool = True):
        self.device = entry_device(device)
        self.dtype = dtype or real_dtype(self.device)
        if self.dtype not in _NUMPY_DTYPES:
            raise TypeError(f"GridPottsModel takes float32 or float64, not {self.dtype}")
        np_dtype = _NUMPY_DTYPES[self.dtype]
        unary = np.asarray(unary, dtype=np_dtype)
        H, W, L = unary.shape
        self.H, self.W, self.L = H, W, L
        hcost = np.asarray(hcost, dtype=np_dtype)
        vcost = np.asarray(vcost, dtype=np_dtype)
        if hcost.shape != (H, W - 1) or vcost.shape != (H - 1, W):
            raise ValueError(f"cost shapes {hcost.shape}, {vcost.shape} do not fit an "
                             f"{H}x{W} grid: expected {(H, W - 1)}, {(H - 1, W)}")

        self.state = {"u": self._tensor(np.moveaxis(unary, -1, 0))}
        for k, shape in (("hm1", (L, H, W - 1)), ("hm2", (L, H, W - 1)),
                         ("vm1", (L, H - 1, W)), ("vm2", (L, H - 1, W))):
            self.state[k] = torch.zeros(shape, dtype=self.dtype, device=self.device)
        self.hc = self._tensor(hcost)
        self.vc = self._tensor(vcost)
        self.black, self.deg = grid_masks(H, W, self.device, self.dtype)
        self._scratch_sets = None
        self._round_bufs = None
        self.jit = Graphs(self.device, enabled=use_jit, name="GridPottsModel")
        self.state = self.jit.adopt(self.state)
        self._iterate_fn = self.jit.jit(
            lambda s, mode: (self._iterate_impl(s, self._mode_params(mode)), None),
            "iterate", donate=(0,))
        self._fast_fn = self.jit.jit(self._run_fast_any, "run_fast", donate=(0,))
        self._lb_fn = self.jit.jit(self._lower_bound_impl, "lower bound")
        self._round_fn = self.jit.jit(self._round_any, "round_primal", donate=(0,))

    def _tensor(self, a):
        # a copy: the captured calls write the state in place, never into the caller's array
        return torch.from_numpy(np.array(a, order="C")).to(self.device)

    @tracing.traced("lpmp.grid.load_state")
    def load_state(self, state) -> "GridPottsModel":
        """Install a dense state dict (u/hm1/hm2/vm1/vm2 tensors, e.g. from
        ``convert.grid_state_from_numpy``) on this model's device and dtype."""
        want = {"u": (self.L, self.H, self.W),
                "hm1": (self.L, self.H, self.W - 1), "hm2": (self.L, self.H, self.W - 1),
                "vm1": (self.L, self.H - 1, self.W), "vm2": (self.L, self.H - 1, self.W)}
        new = {}
        for k in STATE_KEYS:
            t = state[k]
            if tuple(t.shape) != want[k]:
                raise ValueError(f"state[{k!r}] has shape {tuple(t.shape)}, expected {want[k]}")
            # a copy: run_fast writes the state in place, never into the caller's tensors
            new[k] = t.to(device=self.device, dtype=self.dtype, copy=True).contiguous()
        self.state = self.jit.assign(self.state, new)
        return self

    # ------------------------------------------------------------------
    def _mode_params(self, mode):
        """Per pass (fwd/bwd), per phase: (recv_mask [H,W], omega [H,W])."""
        mode = ReparametrizationMode.convert(mode)
        black, red = self.black, 1.0 - self.black
        zero = torch.zeros_like(self.deg)
        if mode in _ANISOTROPIC:
            inv = 1.0 / self.deg
            return {"fwd": ((zero, black * inv), (red, zero)),
                    "bwd": ((zero, red * inv), (black, zero))}
        if mode == ReparametrizationMode.uniform:
            w = 1.0 / self.deg
        elif mode == ReparametrizationMode.damped_uniform:
            w = 1.0 / (self.deg + 1.0)
        else:
            raise NotImplementedError(f"{mode} not supported on grid model")
        return {"fwd": ((black, black * w), (red, red * w)),
                "bwd": ((red, red * w), (black, black * w))}

    # ------------------------------------------------------------------
    def _receive(self, s, mask):
        return receive(s, mask, self.hc, self.vc)

    def _send(self, s, omega):
        return send(s, omega, self.deg)

    def _phase(self, s, recv_mask, omega):
        return self._send(self._receive(s, recv_mask), omega)

    def _iterate_impl(self, s, params):
        for phase in params["fwd"]:
            s = self._phase(s, *phase)
        for phase in params["bwd"]:
            s = self._phase(s, *phase)
        return s

    def _run_fast_impl(self, s, params, n, fuse):
        """n iterations of the fused schedule (anisotropic modes: send-only
        prologue, then two full colour updates per round), or of the exact
        4-phase round."""
        (m1, w1), (m2, w2) = params["fwd"]
        (m3, w3), (m4, w4) = params["bwd"]
        if fuse:
            s = self._phase(s, m1, w1)  # prologue: first colour send
            second = (torch.maximum(m2, m3), w2 + w3)
            first = (torch.maximum(m4, m1), w4 + w1)
            for _ in range(n):
                s = self._phase(s, *second)
                s = self._phase(s, *first)
        else:
            for _ in range(n):
                for mask, w in ((m1, w1), (m2, w2), (m3, w3), (m4, w4)):
                    s = self._phase(s, mask, w)
        return s

    def _run_fast_any(self, s, n, mode, kernel):
        """(new state, None) after ``run_fast(n, mode, kernel)`` from ``s``."""
        if kernel == "cuda":
            return self._run_fast_kernels(s, mode, n), None
        return self._run_fast_impl(s, self._mode_params(mode), n,
                                   fuse=mode in _ANISOTROPIC), None

    def _run_fast_kernels(self, s, mode, n):
        """The fused schedule of ``_run_fast_pallas`` (grid_potts.py:243-288)
        through the kernel wrappers.  Colour codes: 1=black, 2=red.  Every
        launch writes into given buffers: the first reads ``s`` and the last
        writes ``s``'s own tensors, the ones between ping-pong through the
        two scratch sets of ``_scratch``, so the call allocates nothing and
        (captured) ends without copying its state.  A schedule of one launch
        (the prologue of ``n = 0``) writes scratch and copies it back."""
        hc, vc = self.hc, self.vc
        steps = []      # (wrapper, its arguments after the state)
        if mode in _ANISOTROPIC:
            # send-only black prologue, then kernels covering two full rounds
            # per pass, and a single-round pass for an odd remainder
            steps.append((phase_update, (hc, vc, 0, 1, 0.0)))
            steps += [(round_update, (hc, vc, 2))] * (n // 2)
            if n % 2:
                steps.append((round_update, (hc, vc, 1)))
        else:
            steps += [(phase_update, (hc, vc, *p)) for _ in range(n) for p in phase_tuples(mode)]
        scratch = self._scratch() if steps else None
        src = s
        for i, (fn, args) in enumerate(steps):
            last = i == len(steps) - 1
            src = fn(src, *args, out=s if last and i else scratch[i % 2])
        if len(steps) == 1:
            for k in STATE_KEYS:
                s[k].copy_(src[k])
        return s

    def _scratch(self) -> list:
        """Two state-shaped sets of buffers that ``run_fast``'s and
        ``round_primal``'s launches write through, made at first use (under
        capture: in the warm-up)."""
        if self._scratch_sets is None:
            self._scratch_sets = [{k: torch.empty_like(v) for k, v in self.state.items()}
                                  for _ in range(2)]
        return self._scratch_sets

    # ------------------------------------------------------------------
    def _lower_bound_impl(self, s):
        f64 = torch.float64
        lb = torch.sum(torch.amin(s["u"], dim=0), dtype=f64)
        lb += torch.sum(_potts_min_pair(s["hm1"], s["hm2"], self.hc), dtype=f64)
        lb += torch.sum(_potts_min_pair(s["vm1"], s["vm2"], self.vc), dtype=f64)
        return lb

    def _round_any(self, s, mode):
        """(new state, (labels, ub)) of one rounding pass from ``s``: through
        the rounding kernels for a float32 model on the card, else the
        plain ops."""
        if self.device.type == "cuda" and self.dtype == torch.float32:
            return self._round_kernels(s, mode)
        return self._round_impl(s, self._mode_params(mode))

    def _round_impl(self, s, params):
        """One rounding pass (MpRoundingSolver semantics): run the phases,
        labeling each cell by the argmin of its post-receive cost."""
        x = torch.zeros((self.H, self.W), dtype=torch.int64, device=self.device)
        for recv_mask, omega in (*params["fwd"], *params["bwd"]):
            s = self._receive(s, recv_mask)
            am = torch.argmin(s["u"], dim=0)
            x = torch.where((recv_mask + omega) > 0, am, x)
            s = self._send(s, omega)
        return s, (x, primal_cost_ref(s, self.hc, self.vc, x))

    def _round_kernels(self, s, mode):
        """``_round_impl`` through the kernels: the mode's four phases, each
        also writing the labels of the cells it updates, then the cost pass.
        The launches ping-pong through ``_scratch`` and the last phase
        writes ``s``'s own tensors, as in ``_run_fast_kernels``; the labels
        (int32) and the cost's work buffer are the model's, made at first
        use, so the call allocates nothing."""
        if self._round_bufs is None:
            self._round_bufs = (
                torch.zeros((self.H, self.W), dtype=torch.int32, device=self.device),
                torch.empty(cost_work_size(self.H, self.W), dtype=torch.float64,
                            device=self.device))
        labels, work = self._round_bufs
        scratch = self._scratch()
        phases = phase_tuples(mode)
        src = s
        for i, p in enumerate(phases):
            dst = s if i == len(phases) - 1 else scratch[i % 2]
            src = round_phase_update(src, self.hc, self.vc, *p, labels, out=dst)
        return s, (labels, primal_cost(s, self.hc, self.vc, labels, work))

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def iterate(self, mode="anisotropic", n: int = 1):
        """n exact forward+backward iterations (LP::ComputePass)."""
        mode = ReparametrizationMode.convert(mode)
        for _ in range(n):
            self.state, _ = self._iterate_fn(self.state, mode=mode)
        return self

    @tracing.traced("lpmp.grid.run_fast")
    def run_fast(self, n: int, mode="anisotropic", kernel="cuda"):
        """n iterations of the fused schedule.

        kernel="cuda" (the default) goes through the kernel wrappers of
        ``ops/grid_kernels``: the CUDA kernels for a model on the card,
        their plain versions for a model on the CPU.  kernel="torch" runs
        the plain tensor-op path (JAX's kernel="xla")."""
        mode = ReparametrizationMode.convert(mode)
        if kernel not in ("cuda", "torch"):
            raise ValueError(f"kernel must be 'cuda' or 'torch', got {kernel!r}")
        self.state, _ = self._fast_fn(self.state, n=n, mode=mode, kernel=kernel)
        return self

    @tracing.traced("lpmp.grid.lower_bound")
    def lower_bound(self) -> float:
        return tracing.fetch("grid.lower_bound", self._lb_fn(self.state))

    @tracing.traced("lpmp.grid.round_primal")
    def round_primal(self, mode="damped_uniform"):
        self.state, (x, ub) = self._round_fn(self.state, mode=ReparametrizationMode.convert(mode))
        return (tracing.fetch("grid.round_primal.labels", x.to(torch.int32), np.ndarray),
                tracing.fetch("grid.round_primal.cost", ub))


def phase_tuples(mode) -> tuple:
    """The (recv_color, send_color, leave) of the four colour phases of one
    iteration of ``mode`` (uniform and damped modes; the rounding pass of
    the anisotropic ones), as the kernel wrappers take them."""
    if mode in _ANISOTROPIC:
        return (0, 1, 0.0), (2, 0, 0.0), (0, 2, 0.0), (1, 0, 0.0)
    if mode in (ReparametrizationMode.uniform, ReparametrizationMode.damped_uniform):
        leave = 0.0 if mode == ReparametrizationMode.uniform else 1.0
        return (1, 1, leave), (2, 2, leave), (2, 2, leave), (1, 1, leave)
    raise NotImplementedError(f"{mode} not supported on grid model")


def grid_potts_edges(hcost, vcost):
    """The grid's Potts pairs for the generic MRF constructor (variable
    r*W+c), in its per-cell order: the horizontal pair, then the vertical
    one.  Returns (pairs [E, 2] int64, diffs [E]) for
    ``MrfConstructor.add_potts_factors``."""
    hcost, vcost = np.asarray(hcost), np.asarray(vcost)
    H, W = hcost.shape[0], vcost.shape[1]
    idx = np.arange(H * W).reshape(H, W)
    pairs = np.zeros((H, W, 2, 2), dtype=np.int64)
    diffs = np.zeros((H, W, 2))
    valid = np.zeros((H, W, 2), dtype=bool)
    pairs[:, :-1, 0] = np.stack([idx[:, :-1], idx[:, 1:]], axis=-1)
    diffs[:, :-1, 0], valid[:, :-1, 0] = hcost, True
    pairs[:-1, :, 1] = np.stack([idx[:-1], idx[1:]], axis=-1)
    diffs[:-1, :, 1], valid[:-1, :, 1] = vcost, True
    return pairs[valid], diffs[valid]


def random_grid(H, W, L, seed=0, potts_scale=1.0):
    """The JAX package's generator, value for value: numpy arrays
    (unary [H,W,L], hc [H,W-1], vc [H-1,W])."""
    rng = np.random.default_rng(seed)
    unary = rng.normal(size=(H, W, L))
    hc = np.abs(rng.normal(size=(H, W - 1))) * potts_scale
    vc = np.abs(rng.normal(size=(H - 1, W))) * potts_scale
    return unary, hc, vc
