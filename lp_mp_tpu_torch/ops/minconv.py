"""Batched min-(sum-)convolution (counterpart of ``lp_mp_tpu/ops/minconv.py``).

Reference: ``min_convolution::min_conv_naive`` / ``min_conv_Bussieck_et_al``
/ ``arg_min_conv_Bussieck_et_al`` (behavior pinned by test/min_conv.cpp).

    out[s] = min_{i + j = s} a[i] + b[j]

The minimum runs over the SECOND argument's width ``m``, as in the JAX
package: term j is ``a`` shifted right by j with +inf outside [0, n).  Here
the m shifted slices are the m lanes of one window view (``unfold``) of
``a`` padded with +inf, so a call is a pad, an add and a reduction whatever
``m`` is: the DP steps that call it run eagerly, one host dispatch per op.
Each term is the same float addition as the JAX package's and a minimum is
exact, so the values are equal; ``arg_min_conv`` orders the terms by
ascending j and takes the first minimum, as ``jnp.argmin`` does.  Callers
keep the smaller vector second (the DP steps pass the per-variable label
costs, width <= #labels).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

INF = float("inf")


def _windows(a: torch.Tensor, m: int, out_size: int) -> torch.Tensor:
    """[..., out_size, m] view with win[..., s, k] = a[..., s + k - (m - 1)]
    (+inf outside [0, n)): lane k holds the term of j = m - 1 - k."""
    n = a.shape[-1]
    ap = F.pad(a, (m - 1, max(0, out_size - n)), value=INF)[..., :out_size + m - 1]
    return ap.unfold(-1, m, 1)


def min_conv(a: torch.Tensor, b: torch.Tensor, out_size: int,
             out: "torch.Tensor | None" = None) -> torch.Tensor:
    """Min-convolution along the last axis, batched over leading axes.

    a: [..., n], b: [..., m] -> [..., out_size] with
    out[..., s] = min over j of b[..., j] + a[..., s - j] (inf where empty).
    ``out``, when given, receives the result (a DP writes each step into
    its row of a preallocated table)."""
    m = min(b.shape[-1], out_size)
    terms = _windows(a, m, out_size) + b[..., :m].flip(-1).unsqueeze(-2)
    return torch.amin(terms, dim=-1, out=out) if out is not None \
        else torch.amin(terms, dim=-1)


def arg_min_conv(a: torch.Tensor, b: torch.Tensor, out_size: int):
    """(values, argmin_i): also returns the minimizing index into ``a``
    (arg_min_conv_Bussieck_et_al analogue); ties go to the smallest j."""
    m = min(b.shape[-1], out_size)
    terms = _windows(a, m, out_size).flip(-1) + b[..., :m].unsqueeze(-2)
    vals, j_min = torch.min(terms, dim=-1)
    s = torch.arange(out_size, device=a.device)
    return vals, s - j_min
