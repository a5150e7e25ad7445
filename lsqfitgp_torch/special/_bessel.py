"""Bessel functions of half-integer order and J0.

Counterpart of ``lsqfitgp_tpu/special/_bessel.py``: ``j0`` (power series
below 8, the Hankel expansion beyond), ``kv_half`` (K of order p + 1/2
in closed form) and ``kvmodx2_hi``, the half-integer Matérn profile as a
function of the squared scaled distance, whose derivative in x² is the
exact recurrence d/dx² f_p = −f_{p−1}/(2(2p−1)) (a
`torch.autograd.Function`, as the JAX custom JVP): autograd through
√x² would leave 1/√x²-singular terms that cancel only analytically.
"""

from __future__ import annotations

import math

import torch

__all__ = ['j0', 'kv_half', 'kvmodx2_hi']


def _float(x):
    x = torch.as_tensor(x)
    if not x.is_floating_point():
        x = x.to(torch.get_default_dtype())
    return x


def j0(x):
    """Bessel function of the first kind J0: the power series for
    |x| < 8, the Hankel asymptotic expansion (Abramowitz & Stegun 9.4.3
    coefficients) beyond."""
    x = _float(x)
    ax = x.abs()
    q = torch.where(ax < 8, ax, torch.zeros_like(ax)) ** 2 / 4
    nterms = 20 if x.dtype == torch.float32 else 36
    term = torch.ones_like(q)
    acc = torch.ones_like(q)
    for k in range(1, nterms + 1):
        term = -term * q / (k * k)
        acc = acc + term
    z = torch.where(ax >= 8, ax, torch.full_like(ax, 8.0))
    y = 64.0 / (z * z)
    p0 = (1.0 + y * (-0.1098628627e-2 + y * (0.2734510407e-4
          + y * (-0.2073370639e-5 + y * 0.2093887211e-6))))
    q0 = (-0.1562499995e-1 + y * (0.1430488765e-3 + y * (-0.6911147651e-5
          + y * (0.7621095161e-6 + y * -0.934935152e-7))))
    xx = z - 0.785398164
    big = torch.sqrt(0.636619772 / z) * (
        torch.cos(xx) * p0 - (8.0 / z) * torch.sin(xx) * q0)
    return torch.where(ax < 8, acc, big)


def kv_half(p, x):
    """Modified Bessel K of half-integer order ν = p + 1/2 (``p`` a
    nonnegative int): K_{p+1/2}(x) = √(π/(2x)) e^{−x} Σ_{i=0}^p
    (p+i)!/(i!(p−i)!) (2x)^{−i}."""
    x = _float(x)
    acc = torch.zeros_like(x)
    for i in range(p + 1):
        c = math.factorial(p + i) / (math.factorial(i) * math.factorial(p - i))
        acc = acc + c * (2 * x) ** float(-i)
    return torch.sqrt(math.pi / (2 * x)) * torch.exp(-x) * acc


def _maternp_value(x2, p):
    x = torch.sqrt(x2)
    pref = math.factorial(p) / math.factorial(2 * p)
    acc = torch.zeros_like(x)
    for i in range(p + 1):
        c = math.factorial(p + i) / (math.factorial(i) * math.factorial(p - i))
        acc = acc + c * (2 * x) ** (p - i)
    return pref * torch.exp(-x) * acc


def _expon_deriv(x2):
    """d/dx² e^{−√x²} = −e^{−x}/(2x), x clamped at √tiny: singular at
    zero distance (p = 0)."""
    x = torch.sqrt(torch.clamp(x2, min=torch.finfo(x2.dtype).tiny))
    return -torch.exp(-x) / (2 * x)


def _hi_deriv(x2, p):
    if p >= 1:
        # −f_{p−1}/(2(2p−1)): regular at x² = 0, and a Function again
        return -kvmodx2_hi(x2, p - 1) / (2 * (2 * p - 1))
    return _expon_deriv(x2)


class _KvModX2Hi(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x2, p):
        ctx.save_for_backward(x2)
        ctx.save_for_forward(x2)
        ctx.p = p
        return _maternp_value(x2, p)

    @staticmethod
    def backward(ctx, g):
        x2, = ctx.saved_tensors
        return g * _hi_deriv(x2, ctx.p), None

    @staticmethod
    def jvp(ctx, dx2, _):
        x2, = ctx.saved_tensors
        return _hi_deriv(x2, ctx.p) * dx2


def kvmodx2_hi(x2, p):
    """The Matérn half-integer normalized profile of the squared scaled
    distance: with x = √x², f(x) = e^{−x} p!/(2p)! Σ_{i=0}^p
    (p+i)!/(i!(p−i)!) (2x)^{p−i}, ν = p + 1/2 (``p`` a nonnegative
    int).  Differentiable to any order by the exact recurrence."""
    return _KvModX2Hi.apply(_float(x2), int(p))
