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
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import ReparametrizationMode, entry_device, real_dtype
from ..ops.grid_kernels import (STATE_KEYS, grid_masks, phase_update, receive,
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

    def __init__(self, unary, hcost, vcost, device="cuda", dtype=None):
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

    def _tensor(self, a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

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
            new[k] = t.to(device=self.device, dtype=self.dtype).contiguous()
        self.state = new
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

    def _run_fast_kernels(self, mode, n):
        """The fused schedule of ``_run_fast_pallas`` (grid_potts.py:243-288)
        through the kernel wrappers.  Colour codes: 1=black, 2=red."""
        s, hc, vc = self.state, self.hc, self.vc
        if mode in _ANISOTROPIC:
            # send-only black prologue, then kernels covering two full rounds
            # per pass, and a single-round pass for an odd remainder
            s = phase_update(s, hc, vc, 0, 1, 0.0)
            r = n
            while r >= 2:
                s = round_update(s, hc, vc, n_rounds=2)
                r -= 2
            if r:
                s = round_update(s, hc, vc, n_rounds=1)
        elif mode in (ReparametrizationMode.uniform, ReparametrizationMode.damped_uniform):
            leave = 0.0 if mode == ReparametrizationMode.uniform else 1.0
            cyc = ((1, 1, leave), (2, 2, leave), (2, 2, leave), (1, 1, leave))
            for _ in range(n):
                for p in cyc:
                    s = phase_update(s, hc, vc, *p)
        else:
            raise NotImplementedError(f"{mode} not supported on grid model")
        self.state = s

    # ------------------------------------------------------------------
    def _lower_bound_impl(self, s):
        f64 = torch.float64
        lb = torch.sum(torch.amin(s["u"], dim=0), dtype=f64)
        lb += torch.sum(_potts_min_pair(s["hm1"], s["hm2"], self.hc), dtype=f64)
        lb += torch.sum(_potts_min_pair(s["vm1"], s["vm2"], self.vc), dtype=f64)
        return lb

    def _round_impl(self, s, params):
        """One rounding pass (MpRoundingSolver semantics): run the phases,
        labeling each cell by the argmin of its post-receive cost."""
        x = torch.zeros((self.H, self.W), dtype=torch.int64, device=self.device)
        for recv_mask, omega in (*params["fwd"], *params["bwd"]):
            s = self._receive(s, recv_mask)
            am = torch.argmin(s["u"], dim=0)
            x = torch.where((recv_mask + omega) > 0, am, x)
            s = self._send(s, omega)

        def pick(t, labels):
            return torch.gather(t, 0, labels[None])[0]

        f64 = torch.float64
        zero_h, zero_v = torch.zeros_like(self.hc), torch.zeros_like(self.vc)
        ub = torch.sum(pick(s["u"], x), dtype=f64)
        xl, xr = x[:, :-1], x[:, 1:]
        ub += torch.sum(pick(s["hm1"], xl), dtype=f64)
        ub += torch.sum(pick(s["hm2"], xr), dtype=f64)
        ub += torch.sum(torch.where(xl != xr, self.hc, zero_h), dtype=f64)
        xt, xb = x[:-1], x[1:]
        ub += torch.sum(pick(s["vm1"], xt), dtype=f64)
        ub += torch.sum(pick(s["vm2"], xb), dtype=f64)
        ub += torch.sum(torch.where(xt != xb, self.vc, zero_v), dtype=f64)
        return s, x, ub

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def iterate(self, mode="anisotropic", n: int = 1):
        """n exact forward+backward iterations (LP::ComputePass)."""
        params = self._mode_params(mode)
        for _ in range(n):
            self.state = self._iterate_impl(self.state, params)
        return self

    def run_fast(self, n: int, mode="anisotropic", kernel="cuda"):
        """n iterations of the fused schedule.

        kernel="cuda" (the default) goes through the kernel wrappers of
        ``ops/grid_kernels``: the CUDA kernels for a model on the card,
        their plain versions for a model on the CPU.  kernel="torch" runs
        the plain tensor-op path (JAX's kernel="xla")."""
        mode = ReparametrizationMode.convert(mode)
        if kernel == "cuda":
            self._run_fast_kernels(mode, n)
        elif kernel == "torch":
            self.state = self._run_fast_impl(self.state, self._mode_params(mode), n,
                                             fuse=mode in _ANISOTROPIC)
        else:
            raise ValueError(f"kernel must be 'cuda' or 'torch', got {kernel!r}")
        return self

    def lower_bound(self) -> float:
        return float(self._lower_bound_impl(self.state))

    def round_primal(self, mode="damped_uniform"):
        params = self._mode_params(mode)
        self.state, x, ub = self._round_impl(self.state, params)
        return x.to(torch.int32).cpu().numpy(), float(ub)


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
