"""Grid-Potts colour-phase kernels: plain torch versions and CUDA wrappers.

Dense layout (no padding; every slot has exactly one owner cell):

    u    [L, H, W]      unary reparametrized costs
    hm1  [L, H, W-1]    slot of h-edge (r,c)-(r,c+1) owned by (r, c)
    hm2  [L, H, W-1]    slot of the same edge owned by (r, c+1)
    vm1  [L, H-1, W]    slot of v-edge (r,c)-(r+1,c) owned by (r, c)
    vm2  [L, H-1, W]    slot of the same edge owned by (r+1, c)
    hc   [H, W-1], vc [H-1, W]   Potts diff costs of the edges

Colour codes: 0 none, 1 black (``(r+c) % 2 == 0``), 2 red.  One phase
(``pallas_grid.py:216-238``): cells of ``recv_color`` add the Potts
min-marginals of their incident edges to ``u`` (all read from the pre-phase
snapshot), then cells of ``send_color`` send ``omega * uu`` into each own
slot with ``omega = 1 / max(deg + leave, 1)`` and keep ``uu * (1 -
omega * deg)``.

Sharded layout (one row shard of ``parallel/grid.py``): a window of ``n``
rows, global rows ``[row0, row0 + n)``, with every slot at its owner's row:

    u    [L, n, W]      hm1, hm2 [L, n, W-1]   as above
    vm1  [L, n, W]      row r: slot of the edge below r, owned by r
    vm2  [L, n, W]      row r: slot of the edge above r, owned by r
    hc   [n, W-1], vc [n, W]   vc row r: cost of the edge below r

plus, per array, a ``(top, bottom)`` pair of ``SLAB``-row slabs, the rows
just above and below the window (cut from the neighbour shards, zeros past
the grid).  Global rows >= H are inert and stay exactly 0, as do the slots
of edges that do not exist (vm1 of the last grid row, vm2 of the first).
Colour, degree and edges come from the global row and the global ``H``.

``phase_update`` replaces the TPU kernel ``_phase_kernel_v2``
(``lp_mp_tpu/ops/pallas_grid.py:161``, wrapper ``phase_update_v2``);
``phase_update_v1`` takes the int32[3] parameters of the v1 ``_phase_kernel``
(``:72``) and launches the same CUDA kernel; ``round_update`` replaces
``_round_kernel_v2`` (``:303``, wrapper ``round_update_v2``);
``phase_update_sharded`` and ``round_update_sharded`` replace
``_phase_kernel_sharded`` (``:443``) and ``_round_kernel_sharded`` (``:536``)
on one shard's window.  ``round_phase_update`` and ``primal_cost`` replace
no Pallas kernel: they are the grid model's primal rounding (a phase that
also writes each updated cell's argmin label, and the labelling's float64
cost), which the JAX package writes as ``jnp`` ops.  All are bound by
device-memory bandwidth: a phase reads and writes the five state arrays and
reads the two cost arrays, with a few dozen flops per cell and label.  The
round kernels fuse ``2 * n_rounds`` phases into one pass through shared
memory, so the bytes per iteration fall by that factor (design note in
``csrc/grid_potts.cu``).

Each wrapper runs its plain version for CPU tensors and its CUDA kernel for
CUDA tensors (float32 only, like the Pallas kernels); anything else raises.
``<wrapper>.launches`` counts the kernel launches and nothing else.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from . import _cuda_build
from .reductions import min_except

STATE_KEYS = ("u", "hm1", "hm2", "vm1", "vm2")

# Largest label count the round kernel's shared-memory tile takes
# (kMaxRoundLabels in csrc/grid_potts.cu).
ROUND_MAX_LABELS = 32
# Rows of each halo slab of the sharded layout (kSlab in csrc/grid_potts.cu):
# the round kernel's halo of 2 * n_rounds <= 4 rows.
SLAB = 4


# ---------------------------------------------------------------------------
# plain versions (dense torch)
# ---------------------------------------------------------------------------
def grid_masks(H: int, W: int, device, dtype):
    """(black [H,W], deg [H,W]) of the 4-connected H x W grid."""
    r = torch.arange(H, device=device)[:, None]
    c = torch.arange(W, device=device)[None, :]
    black = ((r + c) % 2 == 0).to(dtype)
    deg = ((c < W - 1).to(dtype) + (c > 0).to(dtype)
           + (r < H - 1).to(dtype) + (r > 0).to(dtype))
    return black, deg


def potts_marginal(own, other, diff):
    """[L, ...] marginal of a potts factor toward `own`'s side:
    own[x] + min(other[x], min_{y != x} other[y] + diff); labels axis 0."""
    if other.shape[0] == 1:
        return own + other
    return own + torch.minimum(other, min_except(other, axis=0) + diff[None])


def receive(s, mask, hc, vc):
    """Cells in `mask` pull the full min-marginals of their incident potts
    factors (ReceiveMessages with omega=1), as padded full-array adds."""
    u, hm1, hm2, vm1, vm2 = (s[k] for k in STATE_KEYS)
    m = mask[None]
    d1 = potts_marginal(hm1, hm2, hc) * m[:, :, :-1]
    d2 = potts_marginal(hm2, hm1, hc) * m[:, :, 1:]
    d3 = potts_marginal(vm1, vm2, vc) * m[:, :-1]
    d4 = potts_marginal(vm2, vm1, vc) * m[:, 1:]
    u = (u + F.pad(d1, (0, 1)) + F.pad(d2, (1, 0))
         + F.pad(d3, (0, 0, 0, 1)) + F.pad(d4, (0, 0, 1, 0)))
    return {"u": u, "hm1": hm1 - d1, "hm2": hm2 - d2,
            "vm1": vm1 - d3, "vm2": vm2 - d4}


def send(s, omega, deg):
    """Cells send omega * (own reparametrized cost) into each incident potts
    slot, all from one snapshot (factors_messages.hxx:2787-2814); the
    sender keeps the (1 - omega*deg) residual."""
    u = s["u"]
    d = u * omega[None]
    return {"u": u * (1.0 - omega * deg)[None],
            "hm1": s["hm1"] + d[:, :, :-1], "hm2": s["hm2"] + d[:, :, 1:],
            "vm1": s["vm1"] + d[:, :-1], "vm2": s["vm2"] + d[:, 1:]}


def _color_mask(code: int, black):
    if code == 0:
        return torch.zeros_like(black)
    if code == 1:
        return black
    if code == 2:
        return 1.0 - black
    raise ValueError(f"colour code {code!r} is not 0 (none), 1 (black) or 2 (red)")


def _phase_masks(state, recv_color: int, send_color: int, leave: float):
    """(receive mask, send mask, omega, deg) [H, W] of one colour phase."""
    L, H, W = state["u"].shape
    black, deg = grid_masks(H, W, state["u"].device, state["u"].dtype)
    sendm = _color_mask(send_color, black)
    return (_color_mask(recv_color, black), sendm, sendm / torch.clamp(deg + leave, min=1.0),
            deg)


def phase_update_ref(state, hc, vc, recv_color: int, send_color: int,
                     leave: float = 0.0):
    """One colour phase, plain torch (the math of ``_phase_kernel_v2``)."""
    recvm, _, omega, deg = _phase_masks(state, recv_color, send_color, leave)
    return send(receive(state, recvm, hc, vc), omega, deg)


def round_phase_ref(state, hc, vc, recv_color: int, send_color: int, leave: float, labels):
    """One colour phase of the primal rounding, plain torch: (the new state
    of ``phase_update_ref``, ``labels`` with every cell of ``recv_color`` or
    ``send_color`` set to the argmin of its post-receive cost, the rule of
    ``GridPottsModel._round_impl``)."""
    recvm, sendm, omega, deg = _phase_masks(state, recv_color, send_color, leave)
    got = receive(state, recvm, hc, vc)
    x = torch.where((recvm + sendm) > 0, torch.argmin(got["u"], dim=0).to(labels.dtype), labels)
    return send(got, omega, deg), x


def primal_cost_ref(state, hc, vc, labels):
    """The cost of the labelling ``labels`` [H, W] on the dense ``state``,
    plain torch: a float64 0-dim tensor, the seven float64 sums of
    ``GridPottsModel._round_impl`` (unaries, the h-edges' two slots and
    Potts costs, the v-edges')."""
    x = labels.long()

    def pick(t, lab):
        return torch.gather(t, 0, lab[None])[0]

    f64 = torch.float64
    ub = torch.sum(pick(state["u"], x), dtype=f64)
    xl, xr = x[:, :-1], x[:, 1:]
    ub += torch.sum(pick(state["hm1"], xl), dtype=f64)
    ub += torch.sum(pick(state["hm2"], xr), dtype=f64)
    ub += torch.sum(torch.where(xl != xr, hc, torch.zeros_like(hc)), dtype=f64)
    xt, xb = x[:-1], x[1:]
    ub += torch.sum(pick(state["vm1"], xt), dtype=f64)
    ub += torch.sum(pick(state["vm2"], xb), dtype=f64)
    ub += torch.sum(torch.where(xt != xb, vc, torch.zeros_like(vc)), dtype=f64)
    return ub


def round_update_ref(state, hc, vc, n_rounds: int = 1):
    """``n_rounds`` full anisotropic rounds (red receive+send, then black),
    plain torch (the math of ``_round_kernel_v2``)."""
    for _ in range(n_rounds):
        state = phase_update_ref(state, hc, vc, 2, 2, 0.0)
        state = phase_update_ref(state, hc, vc, 1, 1, 0.0)
    return state


def _extend(window, slabs, hc_win, vc_win, cost_slabs):
    """The window with its slabs: every array over rows [-SLAB, n + SLAB)."""
    ext = {k: torch.cat([slabs[k][0], window[k], slabs[k][1]], dim=-2) for k in STATE_KEYS}
    hc = torch.cat([cost_slabs["hc"][0], hc_win, cost_slabs["hc"][1]], dim=-2)
    vc = torch.cat([cost_slabs["vc"][0], vc_win, cost_slabs["vc"][1]], dim=-2)
    return ext, hc, vc


def _window(ext, n):
    return {k: v[..., SLAB:SLAB + n, :].contiguous() for k, v in ext.items()}


def _sharded_phase_ext(ext, hc, vc, grow, H, recv_color, send_color, leave):
    """One colour phase on extended owner-row arrays whose rows are the global
    rows ``grow`` [E].  Returns the new arrays and the post-receive cost
    ``uu`` (for rounding).  The rows at both ends go stale (their outer edge
    is missing), as the halo rows of the TPU kernels do; rows at least k rows
    inside are exact after k phases."""
    u = ext["u"]
    dev, dtype = u.device, u.dtype
    W = u.shape[-1]
    g = grow[:, None]
    c = torch.arange(W, device=dev)[None, :]
    cell = (g >= 0) & (g < H) & (c >= 0)  # [E, W]
    black = cell & ((g + c) % 2 == 0)
    color = {0: torch.zeros_like(cell), 1: black, 2: cell & ~black}
    f = lambda b: b.to(dtype)  # noqa: E731
    deg = f(cell) * (f(c < W - 1) + f(c > 0) + f(g < H - 1) + f(g > 0))
    recvm = f(color[recv_color])[None]
    omega = f(color[send_color]) / torch.clamp(deg + leave, min=1.0)
    vedge = f(cell[:-1] & (g[:-1] < H - 1))[None]  # edge between rows e and e+1
    v1, v2, vce = ext["vm1"][:, :-1], ext["vm2"][:, 1:], vc[:-1]

    d1 = potts_marginal(ext["hm1"], ext["hm2"], hc) * recvm[:, :, :-1]
    d2 = potts_marginal(ext["hm2"], ext["hm1"], hc) * recvm[:, :, 1:]
    d3 = potts_marginal(v1, v2, vce) * (recvm[:, :-1] * vedge)
    d4 = potts_marginal(v2, v1, vce) * (recvm[:, 1:] * vedge)
    uu = (u + F.pad(d1, (0, 1)) + F.pad(d2, (1, 0))
          + F.pad(d3, (0, 0, 0, 1)) + F.pad(d4, (0, 0, 1, 0)))
    d = uu * omega[None]
    exists = vedge > 0
    zero = torch.zeros((), dtype=dtype, device=dev)
    new = {"u": uu * (1.0 - omega * deg)[None],
           "hm1": ext["hm1"] - d1 + d[:, :, :-1],
           "hm2": ext["hm2"] - d2 + d[:, :, 1:],
           "vm1": F.pad(torch.where(exists, v1 - d3 + d[:, :-1], zero), (0, 0, 0, 1)),
           "vm2": F.pad(torch.where(exists, v2 - d4 + d[:, 1:], zero), (0, 0, 1, 0))}
    return new, uu


def _global_rows(row0, n, device):
    return torch.arange(row0 - SLAB, row0 + n + SLAB, device=device)


def sharded_phase(window, slabs, hc_win, vc_win, cost_slabs, row0: int, H: int,
                  recv_color: int, send_color: int, leave: float = 0.0):
    """One colour phase on a shard's window, plain torch: (new window, the
    window's post-receive cost ``uu``)."""
    n = window["u"].shape[1]
    ext, hc, vc = _extend(window, slabs, hc_win, vc_win, cost_slabs)
    new, uu = _sharded_phase_ext(ext, hc, vc, _global_rows(row0, n, hc.device), H,
                                recv_color, send_color, leave)
    return _window(new, n), uu[:, SLAB:SLAB + n]


def _write_into(out, new):
    """``new`` (a window dict) copied into ``out``, or ``new`` where ``out`` is None."""
    if out is None:
        return new
    for k in STATE_KEYS:
        out[k].copy_(new[k])
    return out


def phase_update_sharded_ref(window, slabs, hc_win, vc_win, cost_slabs, row0: int, H: int,
                             W: int, recv_color: int, send_color: int, leave: float = 0.0,
                             out=None):
    """One colour phase on a shard's window, plain torch (the math of
    ``_phase_kernel_sharded``; mirrors ``parallel/grid.py:_phase_arrays``).
    ``out`` as for ``phase_update_sharded``."""
    return _write_into(out, sharded_phase(window, slabs, hc_win, vc_win, cost_slabs, row0, H,
                                          recv_color, send_color, leave)[0])


def round_update_sharded_ref(window, slabs, hc_win, vc_win, cost_slabs, row0: int, H: int,
                             W: int, n_rounds: int = 1, out=None):
    """``n_rounds`` anisotropic rounds on a shard's window, plain torch (the
    math of ``_round_kernel_sharded``): the 2 * n_rounds <= SLAB phases run on
    the window with its slabs, and the window is cut out at the end."""
    n = window["u"].shape[1]
    ext, hc, vc = _extend(window, slabs, hc_win, vc_win, cost_slabs)
    grow = _global_rows(row0, n, hc.device)
    for _ in range(n_rounds):
        ext, _ = _sharded_phase_ext(ext, hc, vc, grow, H, 2, 2, 0.0)
        ext, _ = _sharded_phase_ext(ext, hc, vc, grow, H, 1, 1, 0.0)
    return _write_into(out, _window(ext, n))


# ---------------------------------------------------------------------------
# wrappers: plain version on the CPU, CUDA kernel on the card
# ---------------------------------------------------------------------------
def _device_of_tensors(tensors) -> torch.device:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"grid kernel inputs lie on several devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"grid kernels run on cpu or cuda tensors, not {dev}")
    return dev


def _device_of(state, hc, vc) -> torch.device:
    return _device_of_tensors((*(state[k] for k in STATE_KEYS), hc, vc))


def _check_cuda_args(state, hc, vc):
    """Shapes (L, H, W) of a valid float32 contiguous dense state, or raise."""
    u = state["u"]
    if u.ndim != 3:
        raise ValueError(f"u must be [L, H, W], got shape {tuple(u.shape)}")
    L, H, W = u.shape
    want = {"u": (L, H, W), "hm1": (L, H, W - 1), "hm2": (L, H, W - 1),
            "vm1": (L, H - 1, W), "vm2": (L, H - 1, W),
            "hc": (H, W - 1), "vc": (H - 1, W)}
    tensors = {**{k: state[k] for k in STATE_KEYS}, "hc": hc, "vc": vc}
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"the CUDA grid kernels take float32; {name} is {t.dtype}")
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {want[name]}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return L, H, W


def _check_colours(recv_color, send_color):
    for code in (recv_color, send_color):
        if code not in (0, 1, 2):
            raise ValueError(f"colour code {code!r} is not 0 (none), 1 (black) or 2 (red)")


def _sharded_tensors(window, slabs, hc_win, vc_win, cost_slabs):
    """Every input of a sharded launch by name, in the kernel's pointer order:
    per array the window, its top slab and its bottom slab."""
    named = {}
    for k, win, (top, bot) in [*((k, window[k], slabs[k]) for k in STATE_KEYS),
                               ("hc", hc_win, cost_slabs["hc"]),
                               ("vc", vc_win, cost_slabs["vc"])]:
        named[k] = win
        named[f"{k} top slab"] = top
        named[f"{k} bottom slab"] = bot
    return named


def _check_sharded_args(named, row0, H, W, cuda: bool):
    """(L, n) of a valid shard window with its slabs (``named`` as
    ``_sharded_tensors`` gives it), or raise.  For a CUDA launch the arrays
    are float32, the windows contiguous and each slab's rows contiguous; a
    slab may be a view of a neighbour's window, with its own label stride."""
    if not isinstance(row0, int) or isinstance(row0, bool) or row0 < 0:
        raise ValueError(f"row0 must be a non-negative int, got {row0!r}")
    if not isinstance(H, int) or H < 1 or not isinstance(W, int) or W < 1:
        raise ValueError(f"H and W must be positive ints, got {H!r}, {W!r}")
    u = named["u"]
    if u.ndim != 3:
        raise ValueError(f"u must be [L, n, W], got shape {tuple(u.shape)}")
    L, n, _ = u.shape
    lead = {"u": (L,), "hm1": (L,), "hm2": (L,), "vm1": (L,), "vm2": (L,), "hc": (), "vc": ()}
    width = {"u": W, "hm1": W - 1, "hm2": W - 1, "vm1": W, "vm2": W, "hc": W - 1, "vc": W}
    for name, t in named.items():
        key, slab = name.split(" ")[0], name.endswith("slab")
        want = (*lead[key], SLAB if slab else n, width[key])
        if tuple(t.shape) != want:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {want}")
        if not cuda:
            continue
        if t.dtype != torch.float32:
            raise TypeError(f"the CUDA grid kernels take float32; {name} is {t.dtype}")
        rows_ok = t.numel() == 0 or (t.stride(-1) == 1 and t.stride(-2) == t.shape[-1])
        if not (rows_ok if slab else t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous" + (" within each label" if slab else ""))
    return L, n


def _run(fn_name: str, dev, ptr_args, out, *scalars):
    lib = _cuda_build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(lib, fn_name)(*ptr_args, *scalars, dev.index, stream)
    if rc != 0:
        msg = lib.lpmp_cuda_error_string(rc).decode()
        raise RuntimeError(f"{fn_name} failed to launch: CUDA error {rc} ({msg})")
    return out


def _launch(fn_name: str, state, hc, vc, *scalars, out=None, labels=None):
    """A dense state-to-state launch; ``labels`` (the rounding's) goes after the outputs."""
    L, H, W = _check_cuda_args(state, hc, vc)
    if out is None:
        out = {k: torch.empty_like(state[k]) for k in STATE_KEYS}
    else:
        named = _dense_tensors(state, hc, vc)
        _check_out(out, named if labels is None else {**named, "labels": labels})
    ptrs = [state[k].data_ptr() for k in STATE_KEYS] + [hc.data_ptr(), vc.data_ptr()]
    ptrs += [out[k].data_ptr() for k in STATE_KEYS]
    if labels is not None:
        ptrs.append(labels.data_ptr())
    return _run(fn_name, state["u"].device, ptrs, out, L, H, W, *scalars)


def _check_labels(labels, H: int, W: int):
    """``labels`` is a contiguous int32 [H, W] tensor, or raise."""
    if not isinstance(labels, torch.Tensor) or labels.dtype != torch.int32 \
            or tuple(labels.shape) != (H, W) or not labels.is_contiguous():
        raise ValueError(f"labels must be a contiguous int32 tensor of shape {(H, W)}")


def _dense_tensors(state, hc, vc) -> dict:
    return {**{k: state[k] for k in STATE_KEYS}, "hc": hc, "vc": vc}


def _plain_into(out, named, new):
    """A plain version's result ``new`` for the inputs ``named``: copied into
    ``out`` where given (checked as a kernel's output is), else ``new``."""
    if out is not None:
        _check_out(out, named)
    return _write_into(out, new)


def _check_out(out, named):
    """``out`` fits the window of ``named`` (shape, dtype, device, contiguous)
    and shares no memory with any input of the launch, or raise."""
    inputs = {t.untyped_storage().data_ptr() for t in named.values() if t.numel()}
    for k in STATE_KEYS:
        t, w = out[k], named[k]
        if (t.shape, t.dtype, t.device) != (w.shape, w.dtype, w.device) or not t.is_contiguous():
            raise ValueError(f"out[{k!r}] must be a contiguous {w.dtype} tensor of shape "
                             f"{tuple(w.shape)} on {w.device}")
        if t.numel() and t.untyped_storage().data_ptr() in inputs:
            raise ValueError(f"out[{k!r}] shares memory with an input of the launch")


def _launch_sharded(fn_name: str, named, L, n, row0, H, W, *scalars, out=None):
    window = {k: named[k] for k in STATE_KEYS}
    if out is None:
        out = {k: torch.empty_like(window[k]) for k in STATE_KEYS}
    else:
        _check_out(out, named)
    ptrs = [t.data_ptr() for t in named.values()] + [out[k].data_ptr() for k in STATE_KEYS]
    slab_ls = [t.stride(0) if t.ndim == 3 else 0
               for name, t in named.items() if name.endswith("slab")]
    args = [(ctypes.c_void_p * len(ptrs))(*ptrs), (ctypes.c_longlong * len(slab_ls))(*slab_ls)]
    return _run(fn_name, window["u"].device, args, out, L, n, W, row0, H, *scalars)


def phase_update(state, hc, vc, recv_color: int, send_color: int,
                 leave: float = 0.0, out=None):
    """One colour phase; replaces ``phase_update_v2``.  Returns the new
    state dict (the inputs are not modified): ``out`` where given (a state
    dict that shares no memory with the inputs, written in place; the kernel
    writes there directly), else a new one."""
    dev = _device_of(state, hc, vc)
    if dev.type == "cpu":
        return _plain_into(out, _dense_tensors(state, hc, vc),
                           phase_update_ref(state, hc, vc, recv_color, send_color, leave))
    _check_colours(recv_color, send_color)
    out = _launch("lpmp_grid_phase_update", state, hc, vc,
                  int(recv_color), int(send_color), float(leave), out=out)
    phase_update.launches += 1
    return out


def phase_update_v1(params, state, hc, vc, out=None):
    """One colour phase under the v1 kernel's contract (``phase_update``,
    ``pallas_grid.py:770``): ``params`` int32[3] = (recv_color, send_color,
    leave x 10), decoded as the v1 kernel does (leave = float32(p[2]) / 10)
    and run through the phase kernel.  ``out`` as for ``phase_update``."""
    if not isinstance(params, torch.Tensor) or params.dtype != torch.int32 \
            or tuple(params.shape) != (3,):
        raise ValueError(f"params must be an int32 tensor of shape (3,), got {params!r}")
    recv_color, send_color, leave10 = params.tolist()
    leave = float(np.float32(leave10) / np.float32(10.0))
    dev = _device_of(state, hc, vc)
    if dev.type == "cpu":
        return _plain_into(out, _dense_tensors(state, hc, vc),
                           phase_update_ref(state, hc, vc, recv_color, send_color, leave))
    _check_colours(recv_color, send_color)
    out = _launch("lpmp_grid_phase_update", state, hc, vc, recv_color, send_color, leave,
                  out=out)
    phase_update_v1.launches += 1
    return out


def round_update(state, hc, vc, n_rounds: int = 1, out=None):
    """``n_rounds`` (1 or 2) full anisotropic rounds in one pass; replaces
    ``round_update_v2``.  ``out`` as for ``phase_update``."""
    if n_rounds not in (1, 2):
        raise ValueError(f"n_rounds must be 1 or 2, got {n_rounds!r}")
    dev = _device_of(state, hc, vc)
    if dev.type == "cpu":
        return _plain_into(out, _dense_tensors(state, hc, vc),
                           round_update_ref(state, hc, vc, n_rounds))
    return launch_round_update(state, hc, vc, n_rounds, out=out)


def launch_round_update(state, hc, vc, n_rounds: int, tile=(0, 0), out=None):
    """``round_update``'s kernel on CUDA tensors, with the tile ``(T_r,
    T_c)`` of cells each block writes; ``(0, 0)`` takes the kernel's own
    choice (``round_tile``).  Another tile is for a tile sweep.  ``out`` as
    for ``phase_update``."""
    _check_round_labels(state["u"].shape[0], "round_update")
    out = _launch("lpmp_grid_round_update", state, hc, vc, int(n_rounds), *map(int, tile),
                  out=out)
    round_update.launches += 1
    return out


def _check_round_labels(L, name):
    if L > ROUND_MAX_LABELS:
        raise ValueError(
            f"{name}'s shared-memory tile takes at most {ROUND_MAX_LABELS} labels, got L={L}; "
            f"use {name.replace('round', 'phase')} phases instead")


def round_tile(L: int, n_rounds: int, tile=(0, 0)) -> dict:
    """The round kernels' tile for ``L`` labels: cells written (``rows``,
    ``cols``) and loaded (``rows_loaded``, ``cols_loaded``) per block,
    ``threads`` per block and ``smem`` bytes of shared memory.  ``tile``
    as for ``launch_round_update``.  Needs the built kernel library."""
    out = (ctypes.c_longlong * 6)()
    lib = _cuda_build.library()
    rc = lib.lpmp_grid_round_tile(int(L), int(n_rounds), *map(int, tile), out)
    if rc != 0:
        raise ValueError(f"no round kernel tile for L={L}, n_rounds={n_rounds}, tile={tile}")
    return dict(zip(("rows", "cols", "rows_loaded", "cols_loaded", "threads", "smem"), out))


def phase_update_sharded(window, slabs, hc_win, vc_win, cost_slabs, row0: int, H: int, W: int,
                         recv_color: int, send_color: int, leave: float = 0.0, out=None):
    """One colour phase on a shard's window (sharded layout above); replaces
    ``phase_update_sharded`` of the TPU package.  ``slabs``: dict of
    ``(top, bottom)`` per state array; ``cost_slabs``: the same for hc, vc.
    Returns the window's new state dict: ``out`` where given (a window dict
    that shares no memory with the inputs, written in place; the kernel
    writes there directly), else a new one."""
    named = _sharded_tensors(window, slabs, hc_win, vc_win, cost_slabs)
    dev = _device_of_tensors(named.values())
    L, n = _check_sharded_args(named, row0, H, W, cuda=dev.type == "cuda")
    _check_colours(recv_color, send_color)
    if dev.type == "cpu":
        return _plain_into(out, named, phase_update_sharded_ref(
            window, slabs, hc_win, vc_win, cost_slabs, row0, H, W, recv_color, send_color, leave))
    out = _launch_sharded("lpmp_grid_phase_update_sharded", named, L, n, row0, H, W,
                          int(recv_color), int(send_color), float(leave), out=out)
    phase_update_sharded.launches += 1
    return out


def round_update_sharded(window, slabs, hc_win, vc_win, cost_slabs, row0: int, H: int, W: int,
                         n_rounds: int = 1, out=None):
    """``n_rounds`` (1 or 2) anisotropic rounds in one pass over a shard's
    window; replaces ``round_update_sharded`` of the TPU package.  ``out`` as
    for ``phase_update_sharded``."""
    if n_rounds not in (1, 2):
        raise ValueError(f"n_rounds must be 1 or 2, got {n_rounds!r}")
    named = _sharded_tensors(window, slabs, hc_win, vc_win, cost_slabs)
    dev = _device_of_tensors(named.values())
    L, n = _check_sharded_args(named, row0, H, W, cuda=dev.type == "cuda")
    if dev.type == "cpu":
        return _plain_into(out, named, round_update_sharded_ref(
            window, slabs, hc_win, vc_win, cost_slabs, row0, H, W, n_rounds))
    _check_round_labels(L, "round_update_sharded")
    out = _launch_sharded("lpmp_grid_round_update_sharded", named, L, n, row0, H, W,
                          int(n_rounds), 0, 0, out=out)
    round_update_sharded.launches += 1
    return out


def round_phase_update(state, hc, vc, recv_color: int, send_color: int, leave: float, labels,
                       out=None):
    """One colour phase of the primal rounding: returns the new state, as
    ``phase_update`` (``out`` as there), and every cell of ``recv_color`` or
    ``send_color`` writes the argmin of its post-receive cost into
    ``labels`` (int32 [H, W], in place; ties to the first minimum, as
    ``torch.argmin``); the other cells keep theirs (``round_phase_ref``)."""
    dev = _device_of_tensors((*(state[k] for k in STATE_KEYS), hc, vc, labels))
    _check_labels(labels, *state["u"].shape[1:])
    _check_colours(recv_color, send_color)
    if dev.type == "cpu":
        new, x = round_phase_ref(state, hc, vc, recv_color, send_color, leave, labels)
        out = _plain_into(out, {**_dense_tensors(state, hc, vc), "labels": labels}, new)
        labels.copy_(x)
        return out
    out = _launch("lpmp_grid_round_phase_update", state, hc, vc, int(recv_color),
                  int(send_color), float(leave), out=out, labels=labels)
    round_phase_update.launches += 1
    return out


# the cost kernel's blocks: at most this many, each over at least 1024 cells
COST_MAX_BLOCKS = 1024


def cost_work_size(H: int, W: int) -> int:
    """float64 elements of ``primal_cost``'s work buffer on the card: the
    cost, then one partial per block of its first kernel."""
    return 1 + max(1, min(-(-H * W // 1024), COST_MAX_BLOCKS))


def primal_cost(state, hc, vc, labels, work=None):
    """The cost of the labelling ``labels`` (int32 [H, W], each in [0, L))
    on the dense ``state``, in float64: a 0-dim tensor.  On the card two
    kernels, float64 partials per block into ``work`` (float64
    [``cost_work_size(H, W)``]; made here where None, so a caller that
    captures the call passes its own, made at the first, uncaptured call)
    and their sum in a fixed order, so a state gives the same cost bit for
    bit every time; the result is ``work[0]``.  The plain version
    (``primal_cost_ref``) sums in another order.  A label outside [0, L)
    makes the card's cost NaN."""
    given = () if work is None else (work,)
    dev = _device_of_tensors((*(state[k] for k in STATE_KEYS), hc, vc, labels, *given))
    _check_labels(labels, *state["u"].shape[1:])
    if dev.type == "cpu":
        return primal_cost_ref(state, hc, vc, labels)
    L, H, W = _check_cuda_args(state, hc, vc)
    n = cost_work_size(H, W)
    if work is None:
        work = torch.empty(n, dtype=torch.float64, device=labels.device)
    elif work.dtype != torch.float64 or tuple(work.shape) != (n,) or not work.is_contiguous():
        raise ValueError(f"work must be a contiguous float64 tensor of shape {(n,)}")
    ptrs = [state[k].data_ptr() for k in STATE_KEYS]
    ptrs += [hc.data_ptr(), vc.data_ptr(), labels.data_ptr(), work.data_ptr()]
    _run("lpmp_grid_primal_cost", dev, ptrs, None, n, L, H, W)
    primal_cost.launches += 2
    return work[0]


KERNEL_WRAPPERS = (phase_update, round_update, phase_update_v1, phase_update_sharded,
                   round_update_sharded, round_phase_update, primal_cost)


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


reset_launch_counts()


def launch_counts() -> dict:
    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}


def add_launch_counts(counts: dict) -> None:
    """Add ``counts`` ({wrapper name: launches}) to the wrappers' counts: a
    CUDA graph's replay launches the kernels its capture recorded without
    running the wrappers (``capture.py``)."""
    by_name = {fn.__name__: fn for fn in KERNEL_WRAPPERS}
    for name, n in counts.items():
        by_name[name].launches += n
