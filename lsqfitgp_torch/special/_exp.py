"""Accurate exponential-family special functions.

Counterpart of ``lsqfitgp_tpu/special/_exp.py``: ``expm1x`` with the
JAX custom JVP rule, d/dx (e^x − 1 − x) = expm1(x), as a
`torch.autograd.Function`.
"""

from __future__ import annotations

import math

import torch

from ._expint import _float

__all__ = ['expm1x']


def _expm1x_value(x):
    nterms = 10 if x.dtype == torch.float32 else 17
    # x²/2 · ₁F₁(1, 3, x) as a Horner polynomial in x
    small = torch.zeros_like(x)
    for k in range(nterms, 1, -1):
        small = small * x + 1 / math.factorial(k)
    small = x * x * small
    return torch.where(x.abs() < 1, small, torch.expm1(x) - x)


class _Expm1x(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        ctx.save_for_forward(x)
        return _expm1x_value(x)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        return g * torch.expm1(x)

    @staticmethod
    def jvp(ctx, t):
        x, = ctx.saved_tensors
        return t * torch.expm1(x)


def expm1x(x):
    r"""Accurately compute :math:`e^x - 1 - x`: a Taylor series for
    |x| < 1, ``expm1(x) - x`` otherwise, the series' length adapted to
    the dtype; its derivative is ``expm1(x)``."""
    return _Expm1x.apply(_float(x))
