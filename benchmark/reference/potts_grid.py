"""Plain reference of the Potts-grid solves: dense PyTorch, no kernel.

Written from the semantics of SRMP on a 4-connected Potts grid (Kolmogorov,
"A new look at reweighted message passing", TPAMI 2015; LP_MP's
``factors_messages.hxx`` send/receive rules), not from the measured
package, which it never imports.  It takes the instance as the benchmark
generated it and works out again, from the start, the dual states the
program's calls should reach:

* the state: per cell its reparametrised unary ``u`` [L, H, W], and per
  Potts factor the two slots that hold what it took from its endpoints:
  ``hl``/``hr`` [L, H, W-1] (left/right endpoint of a horizontal factor),
  ``vt``/``vb`` [L, H-1, W] (top/bottom endpoint of a vertical one).  The
  factor's reparametrised cost is ``w*[x != y] + slot_a[x] + slot_b[y]``.
* a receive: a cell takes the min-marginal of each incident factor toward
  itself into ``u`` (all four from one snapshot); a send: it moves
  ``omega * u`` into each incident slot and keeps the rest.
* colours: black cells have an even ``r + c``.  ``omega`` is ``1/deg``
  (anisotropic) or ``1/(deg + leave)`` (uniform, damped uniform).

The precision is a parameter, so that the same code, run in bfloat16, is
the control that the comparison must reject.
"""
from __future__ import annotations

import numpy as np
import torch

# colour codes: 0 none, 1 black, 2 red
NONE, BLACK, RED = 0, 1, 2


class PottsGrid:
    """One grid instance: unary [H, W, L], hc [H, W-1], vc [H-1, W] (numpy,
    float64 as generated; Potts weights must be >= 0)."""

    def __init__(self, unary, hc, vc, device="cpu", dtype=torch.float32):
        unary, hc, vc = (np.asarray(a, dtype=np.float64) for a in (unary, hc, vc))
        if (hc < 0).any() or (vc < 0).any():
            raise ValueError("the reference takes Potts weights >= 0")
        self.unary, self.hc64, self.vc64 = unary, hc, vc
        self.H, self.W, self.L = unary.shape
        self.device, self.dtype = device, dtype

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)
        self.u0 = dev(np.moveaxis(unary, -1, 0))
        self.hc, self.vc = dev(hc), dev(vc)
        r = torch.arange(self.H, device=device)[:, None]
        c = torch.arange(self.W, device=device)[None, :]
        self.black = ((r + c) % 2 == 0).to(dtype)
        self.deg = ((c > 0).to(dtype) + (c < self.W - 1).to(dtype)
                    + (r > 0).to(dtype) + (r < self.H - 1).to(dtype))

    # ------------------------------------------------------------------
    def initial(self) -> dict:
        L, H, W = self.L, self.H, self.W
        z = dict(device=self.device, dtype=self.dtype)
        return {"u": self.u0.clone(),
                "hl": torch.zeros((L, H, W - 1), **z), "hr": torch.zeros((L, H, W - 1), **z),
                "vt": torch.zeros((L, H - 1, W), **z), "vb": torch.zeros((L, H - 1, W), **z)}

    def colour(self, code: int) -> torch.Tensor:
        if code == NONE:
            return torch.zeros_like(self.black)
        return self.black if code == BLACK else 1.0 - self.black

    @staticmethod
    def _toward(own, other, w):
        """Min-marginal of a Potts factor toward the endpoint whose slot is
        ``own``: own[x] + min_y (other[y] + w*[x != y]), for w >= 0."""
        return own + torch.minimum(other, other.amin(dim=0, keepdim=True) + w[None])

    def receive(self, s: dict, mask: torch.Tensor) -> dict:
        m = mask[None]
        to_l = self._toward(s["hl"], s["hr"], self.hc) * m[:, :, :-1]
        to_r = self._toward(s["hr"], s["hl"], self.hc) * m[:, :, 1:]
        to_t = self._toward(s["vt"], s["vb"], self.vc) * m[:, :-1, :]
        to_b = self._toward(s["vb"], s["vt"], self.vc) * m[:, 1:, :]
        u = s["u"].clone()
        u[:, :, :-1] += to_l
        u[:, :, 1:] += to_r
        u[:, :-1, :] += to_t
        u[:, 1:, :] += to_b
        return {"u": u, "hl": s["hl"] - to_l, "hr": s["hr"] - to_r,
                "vt": s["vt"] - to_t, "vb": s["vb"] - to_b}

    def send(self, s: dict, omega: torch.Tensor) -> dict:
        share = s["u"] * omega[None]
        return {"u": s["u"] - share * self.deg[None],
                "hl": s["hl"] + share[:, :, :-1], "hr": s["hr"] + share[:, :, 1:],
                "vt": s["vt"] + share[:, :-1, :], "vb": s["vb"] + share[:, 1:, :]}

    def phase(self, s: dict, recv: int, send: int, leave: float = 0.0) -> dict:
        omega = self.colour(send) / torch.clamp(self.deg + leave, min=1.0)
        return self.send(self.receive(s, self.colour(recv)), omega)

    # ------------------------------------------------------------------
    # the schedules the program's entry points run
    # ------------------------------------------------------------------
    def run_fast(self, s: dict, n: int, mode: str) -> dict:
        """``n`` iterations of the fused grid schedule: anisotropic: a black
        send, then per iteration red and black each receive and send
        everything; uniform and damped uniform: per iteration black, red,
        red, black, each receiving and sending 1/(deg + leave)."""
        if mode == "anisotropic":
            s = self.phase(s, NONE, BLACK)
            for _ in range(n):
                s = self.phase(s, RED, RED)
                s = self.phase(s, BLACK, BLACK)
            return s
        leave = {"uniform": 0.0, "damped_uniform": 1.0}[mode]
        for _ in range(n):
            for c in (BLACK, RED, RED, BLACK):
                s = self.phase(s, c, c, leave)
        return s

    def rounding_pass(self, s: dict, order=(BLACK, RED, RED, BLACK)) -> tuple:
        """One damped-uniform iteration that labels each cell by the argmin
        of its cost after it receives (the last such phase wins).  Returns
        (state, labels [H, W] int64)."""
        x = torch.zeros((self.H, self.W), dtype=torch.int64, device=self.device)
        for c in order:
            s = self.receive(s, self.colour(c))
            x = torch.where(self.colour(c) > 0, torch.argmin(s["u"], dim=0), x)
            s = self.send(s, self.colour(c) / (self.deg + 1.0))
        return s, x

    def engine_pass(self, s: dict, mode: str, direction: str) -> dict:
        """One SRMP sweep over the cells in colour order (black then red
        forward, red then black backward).  Anisotropic: the first colour
        receives nothing and sends everything, the second receives
        everything and sends nothing.  Damped uniform: each colour receives
        and sends 1/(deg + 1)."""
        first, second = (BLACK, RED) if direction == "forward" else (RED, BLACK)
        if mode == "anisotropic":
            s = self.phase(s, NONE, first)
            return self.phase(s, second, NONE)
        if mode == "damped_uniform":
            s = self.phase(s, first, first, 1.0)
            return self.phase(s, second, second, 1.0)
        raise ValueError(f"no engine sweep for mode {mode!r}")

    # ------------------------------------------------------------------
    # what is compared
    # ------------------------------------------------------------------
    def lower_bound(self, s: dict) -> float:
        """Sum of the factors' minima, in float64."""
        f = {k: v.to(torch.float64) for k, v in s.items()}
        hc, vc = self.hc64_t(), self.vc64_t()
        lb = f["u"].amin(dim=0).sum()
        for a, b, w in ((f["hl"], f["hr"], hc), (f["vt"], f["vb"], vc)):
            diag = (a + b).amin(dim=0)
            off = a.amin(dim=0) + b.amin(dim=0) + w
            lb = lb + torch.minimum(diag, off).sum()
        return float(lb)

    def hc64_t(self):
        return torch.from_numpy(self.hc64).to(self.device)

    def vc64_t(self):
        return torch.from_numpy(self.vc64).to(self.device)

    def energy(self, x) -> float:
        """The original cost of labelling ``x`` [H, W], in float64 on the host."""
        x = np.asarray(x, dtype=np.int64)
        e = np.take_along_axis(self.unary, x[..., None], axis=2).sum()
        e += self.hc64[x[:, :-1] != x[:, 1:]].sum()
        e += self.vc64[x[:-1, :] != x[1:, :]].sum()
        return float(e)

    def state_energy(self, s: dict, x) -> float:
        """The cost of ``x`` read from a reparametrised state ``s``, as a
        solver that reports its rounding from its own state does (float64
        sum of the state's values)."""
        x = torch.as_tensor(x, device=self.device).to(torch.int64)
        f = {k: v.to(torch.float64) for k, v in s.items()}

        def pick(t, lab):
            return torch.gather(t, 0, lab[None])[0].sum()
        e = pick(f["u"], x)
        xl, xr, xt, xb = x[:, :-1], x[:, 1:], x[:-1, :], x[1:, :]
        e = e + pick(f["hl"], xl) + pick(f["hr"], xr) + self.hc64_t()[(xl != xr)].sum()
        e = e + pick(f["vt"], xt) + pick(f["vb"], xb) + self.vc64_t()[(xt != xb)].sum()
        return float(e)


# ----------------------------------------------------------------------
# replaying a solve, and judging the program's answers
# ----------------------------------------------------------------------
def replay(grid: PottsGrid, ops) -> tuple:
    """Run the calls a solve made, in order, on ``grid``: ("fast", n, mode)
    run_fast; ("lb",) a bound; ("round",) a rounding pass; ("pass", mode)
    an engine iteration (forward and backward sweep); ("primal", mode,
    direction) an engine sweep that labels each cell after it receives.
    Returns (last bound, best rounded cost read from the state, its labels)."""
    s, lb, best, best_x = grid.initial(), float("nan"), float("inf"), None
    for op in ops:
        kind = op[0]
        if kind == "fast":
            s = grid.run_fast(s, op[1], op[2])
        elif kind == "lb":
            lb = grid.lower_bound(s)
        elif kind == "round":
            s, x = grid.rounding_pass(s)
        elif kind == "pass":
            s = grid.engine_pass(s, op[1], "forward")
            s = grid.engine_pass(s, op[1], "backward")
        elif kind == "primal":
            order = (BLACK, RED) if op[2] == "forward" else (RED, BLACK)
            if op[1] != "damped_uniform":
                raise ValueError(f"no labelling sweep for mode {op[1]!r}")
            s, x = grid.rounding_pass(s, order)
        else:
            raise ValueError(f"unknown call {op!r}")
        if kind in ("round", "primal"):
            ub = grid.state_energy(s, x)
            if ub < best:
                best, best_x = ub, x.cpu().numpy()
    return lb, best, best_x


def judge_grid(instances, answers, device, control_dtype=None) -> dict:
    """The compared numbers over ``answers`` (dicts with "instance", "ops",
    "lb", "ub", "x"): ``lb_rel``, the largest gap between the program's
    final bound and the reference's after the same calls, relative to the
    latter; ``ub_rel``, the largest gap between the program's best upper
    bound and the original cost of the labelling it reports, relative to
    the latter; ``best_ub_rel``, the largest gap between the program's best
    upper bound and the original cost of the reference's best labelling
    after the same calls (its roundings read from its own states), relative
    to the latter.  With ``control_dtype`` the reference computed in that
    precision answers in the program's place."""
    lb_rel = ub_rel = best_ub_rel = 0.0
    for a in answers:
        inst = instances[a["instance"]]
        ref = PottsGrid(inst["unary"], inst["hc"], inst["vc"], device, torch.float32)
        lb_ref, _, x_ref = replay(ref, a["ops"])
        if control_dtype is None:
            lb, ub, x = a["lb"], a["ub"], a["x"]
        else:
            low = PottsGrid(inst["unary"], inst["hc"], inst["vc"], device, control_dtype)
            lb, ub, x = replay(low, a["ops"])
            del low
        e = ref.energy(np.asarray(x).reshape(ref.H, ref.W))
        e_ref = ref.energy(x_ref)
        lb_rel = max(lb_rel, abs(lb - lb_ref) / abs(lb_ref))
        ub_rel = max(ub_rel, abs(ub - e) / abs(e))
        best_ub_rel = max(best_ub_rel, abs(ub - e_ref) / abs(e_ref))
        del ref
    return {"lb_rel": lb_rel, "ub_rel": ub_rel, "best_ub_rel": best_ub_rel}


def judge_solver(instance: dict, prepared, answers, device, control_dtype=None) -> dict:
    """``judge_grid`` for the solves of the generic engine on one grid."""
    return judge_grid([instance], [dict(a, instance=0) for a in answers], device, control_dtype)
