"""Global configuration for lp_mp_tpu_torch.

PyTorch counterpart of ``lp_mp_tpu/config.py``: the enums of the option
surface (config.hxx:39-105), the dtype policy, ``PAD_COST`` and the
verbosity switch.  It is a copy, not an import: importing
``lp_mp_tpu.config`` runs ``lp_mp_tpu/__init__``, which imports JAX, and
this package must never load JAX.

Dtype policy: float64 on the CPU, where the port is held against the JAX
package to 1e-10, and float32 on a CUDA device, where the hand-written
kernels work in float32 like the Pallas kernels they replace.
``set_dtype`` overrides both.
"""
from __future__ import annotations

import dataclasses
import enum
import functools

import torch


class Chirality(enum.Enum):
    """Which side of a message a factor sits on (config.hxx:39)."""

    left = "left"
    right = "right"


class Direction(enum.Enum):
    """Sweep direction (config.hxx:41)."""

    forward = "forward"
    backward = "backward"


class MessageSchedule(enum.Flag):
    """Message passing schedule (config.hxx:43-49), as four activity bits
    (factors_messages.hxx:1530-1545):

    - ``left``:  received from right *by* left and sent *by* left;
    - ``right``: mirror image;
    - ``full``:  both sides active;
    - ``only_send``: both sides send, nobody receives;
    - ``none``:  not touched during message passing.
    """

    NONE = 0
    LEFT_SENDS = enum.auto()  # left factor pushes its min-marginal to right
    RIGHT_SENDS = enum.auto()  # right factor pushes its min-marginal to left
    LEFT_RECEIVES = enum.auto()  # left factor pulls right's min-marginal
    RIGHT_RECEIVES = enum.auto()  # right factor pulls left's min-marginal

    @classmethod
    def left(cls) -> "MessageSchedule":
        return cls.LEFT_SENDS | cls.LEFT_RECEIVES

    @classmethod
    def right(cls) -> "MessageSchedule":
        return cls.RIGHT_SENDS | cls.RIGHT_RECEIVES

    @classmethod
    def full(cls) -> "MessageSchedule":
        return cls.left() | cls.right()

    @classmethod
    def only_send(cls) -> "MessageSchedule":
        return cls.LEFT_SENDS | cls.RIGHT_SENDS

    # memoized per member: queried per message type on the host
    # plan-construction path
    @property
    def sends_to_right(self) -> bool:
        return _schedule_bits(self)[0]

    @property
    def sends_to_left(self) -> bool:
        return _schedule_bits(self)[1]

    @property
    def left_receives(self) -> bool:
        return _schedule_bits(self)[2]

    @property
    def right_receives(self) -> bool:
        return _schedule_bits(self)[3]


@functools.lru_cache(maxsize=None)
def _schedule_bits(s: "MessageSchedule") -> tuple[bool, bool, bool, bool]:
    v = s.value
    return (bool(v & MessageSchedule.LEFT_SENDS.value),
            bool(v & MessageSchedule.RIGHT_SENDS.value),
            bool(v & MessageSchedule.LEFT_RECEIVES.value),
            bool(v & MessageSchedule.RIGHT_RECEIVES.value))


class ReparametrizationMode(enum.Enum):
    """Omega weight mode (config.hxx:72)."""

    anisotropic = "anisotropic"
    anisotropic2 = "anisotropic2"
    uniform = "uniform"
    damped_uniform = "damped_uniform"
    mixed = "mixed"

    @classmethod
    def convert(cls, s: "str | ReparametrizationMode") -> "ReparametrizationMode":
        """String conversion mirroring LPReparametrizationModeConvert (config.hxx:74-91)."""
        if isinstance(s, cls):
            return s
        try:
            return cls(s)
        except ValueError:
            raise ValueError(f"reparametrization mode {s!r} unknown") from None


@dataclasses.dataclass
class LpControl:
    """Solver control struct returned by visitors (config.hxx:95-105)."""

    repam: "ReparametrizationMode | None" = None
    compute_primal: bool = False
    compute_lower_bound: bool = False
    tighten: bool = False
    end: bool = False
    error: bool = False
    tighten_constraints: int = 0


# ---------------------------------------------------------------------------
# dtype policy
# ---------------------------------------------------------------------------

_DTYPE: "torch.dtype | None" = None


def set_dtype(dtype: "torch.dtype | None") -> None:
    """Pin the compute dtype for every device; ``None`` restores the
    per-device default."""
    global _DTYPE
    _DTYPE = dtype


def real_dtype(device="cpu") -> torch.dtype:
    """Compute dtype for dual costs on ``device`` (reference REAL,
    config.hxx:28)."""
    if _DTYPE is not None:
        return _DTYPE
    return torch.float32 if torch.device(device).type == "cuda" else torch.float64


def eps_for(dtype: "torch.dtype | None" = None) -> float:
    """Numerical tolerance, per dtype (config.hxx:51)."""
    dtype = dtype or real_dtype()
    return 1e-8 if dtype == torch.float64 else 1e-6


# Large-but-finite stand-in for +inf in padded cost entries (config.py:166-171
# of the JAX package): a finite value keeps padded lanes NaN-free.
PAD_COST = 1e20

# verbosity: 0 silent, 1 diagnostics, 2 debug (config.hxx:52-57)
verbosity: int = 0


def diagnostics() -> bool:
    return verbosity >= 1


def debug() -> bool:
    return verbosity >= 2
