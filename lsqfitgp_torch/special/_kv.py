"""Modified Bessel K and Bessel J of real order, and the Matérn and
Bessel profiles.

Counterpart of ``lsqfitgp_tpu/special/_kv.py``: I_ν by its power series,
K_ν by a fixed 100-point Gauss-Legendre quadrature of its integral
representation (the prefactor fused into the exponent), J_ν by the
series below a dtype-dependent cut and the Hankel expansion beyond.
``kvmodx2`` and ``jvmodx2`` differentiate in x² by the exact
recurrences of the JAX custom JVP rules (`torch.autograd.Function`s).
"""

from __future__ import annotations

import math

import numpy
import torch

__all__ = ['iv', 'kv', 'kvmodx2', 'jv', 'jvmodx2']

_SERIES_K = 40

_GL_X, _GL_W = numpy.polynomial.legendre.leggauss(100)


def _dt():
    return torch.get_default_dtype()


def _tensor(v, like=None):
    """``v`` as a tensor of ``like``'s dtype and device; without
    ``like``, a floating tensor as it is, anything else in the default
    dtype."""
    if like is not None:
        return torch.as_tensor(v, dtype=like.dtype, device=like.device)
    if isinstance(v, torch.Tensor) and v.is_floating_point():
        return v
    return torch.as_tensor(v, dtype=_dt())


def _gammasgn(z):
    """The sign of Γ(z): 1 for z > 0, (−1)^⌈−z⌉ for z < 0, nan at the
    poles, as ``jax.scipy.special.gammasgn``."""
    neg = torch.where(torch.ceil(-z) % 2 == 1, -1.0, 1.0).to(z.dtype)
    pole = (z <= 0) & (z == torch.floor(z))
    out = torch.where(z > 0, torch.ones_like(z), neg)
    return torch.where(pole, torch.full_like(z, math.nan), out)


def _series(nu, x, sign):
    k = torch.arange(_SERIES_K, dtype=x.dtype, device=x.device)
    logx2 = torch.log(torch.clamp(x / 2, min=torch.finfo(x.dtype).tiny))[
        ..., None]
    nu_ = nu[..., None]
    logterm = (2 * k + nu_) * logx2 - torch.lgamma(k + 1) \
        - torch.lgamma(nu_ + k + 1)
    return (sign(nu_, k) * torch.exp(logterm)).sum(-1)


def _iv_series(nu, x):
    """I_ν(x) by its power series in log-prefactor form; negative
    non-integer ν too (the sign of Γ(ν + k + 1) tracked)."""
    return _series(nu, x, lambda nu_, k: _gammasgn(nu_ + k + 1))


def iv(nu, x):
    """Modified Bessel I_ν(x), series implementation (x ≲ 20)."""
    x = _tensor(x)
    nu = _tensor(nu, x)
    nu, x = torch.broadcast_tensors(nu, x)
    return _iv_series(nu, x)


def _acosh1p(u):
    """arccosh(1 + u), overflow-safe for huge u."""
    us = torch.clamp(u, max=1e6)
    small = torch.log1p(us + torch.sqrt(us * (us + 2.0)))
    large = math.log(2.0) + torch.log(torch.clamp(u, min=1.0))
    return torch.where(u < 1e6, small, large)


def _logcosh(z):
    a = z.abs()
    return a + torch.log1p(torch.exp(-2 * a)) - math.log(2.0)


def _kv_quad_scaled(nu, x, logpref=None):
    """e^{logpref} K_ν(x), the prefactor fused into the quadrature
    exponent: K_ν(x) = e^{−x} ∫_0^∞ e^{−x(cosh t − 1)} cosh(νt) dt by
    100-point Gauss-Legendre on [0, tmax], every intermediate guarded
    against overflow (x → 0, where K_ν ~ x^{−ν} and the Matérn prefactor
    ~ x^ν, would otherwise give 0·inf)."""
    x = torch.clamp(x, min=1e3 * torch.finfo(x.dtype).tiny)
    gx = torch.as_tensor(_GL_X, dtype=x.dtype, device=x.device)
    gw = torch.as_tensor(_GL_W, dtype=x.dtype, device=x.device)
    t0 = _acosh1p(45.0 / x)
    tmax = _acosh1p((45.0 + nu * t0) / x)
    t = 0.5 * tmax[..., None] * (gx + 1.0)
    w = 0.5 * tmax[..., None] * gw
    big = torch.finfo(x.dtype).max / 4
    cosh_m1 = torch.clamp(torch.cosh(t) - 1, max=big)
    e = -(x[..., None] * cosh_m1 + x[..., None]) + _logcosh(nu[..., None] * t)
    if logpref is not None:
        e = e + logpref[..., None]
    return (w * torch.exp(e)).sum(-1)


def kv(nu, x):
    """Modified Bessel K_ν(x) for real ν (uses |ν|), x > 0, by the
    quadrature of its integral representation (≲1e-9 relative for ν in
    [0, 15], x in [1e-6, 500], as in the JAX package)."""
    x = _tensor(x)
    nu = _tensor(nu, x).abs()
    nu, x = torch.broadcast_tensors(nu, x)
    return _kv_quad_scaled(nu, x)


def _tiny(x):
    return torch.finfo(x.dtype).tiny


def _kvmodx2_value(nu, x2):
    x = torch.sqrt(torch.clamp(x2, min=_tiny(x2)))
    nut = _tensor(nu, x2)
    lpref = (1 - nut) * math.log(2.0) - torch.lgamma(nut) + nut * torch.log(x)
    lpref, xb = torch.broadcast_tensors(lpref, x)
    val = _kv_quad_scaled((torch.zeros_like(xb) + nut).abs(), xb, lpref)
    one, zero = torch.ones_like(val), torch.zeros_like(val)
    if float(nu) == 0:
        # the ν = 0 limit is white noise: 1 at 0, 0 elsewhere
        val = torch.where(x2 == 0, one, zero)
    return torch.where(x2 <= _tiny(x2), one, val)


def _kvmodx2_raw(nu, x2, j):
    """The j-th x²-derivative of f_ν = 2^{1−ν}/Γ(ν) x^ν K_ν(x),
    (−½)^j 2^{1−ν}/Γ(ν) x^{ν−j} K_{|ν−j|}(x) (from d/dx [x^μ K_μ] =
    −x^μ K_{μ−1}), the prefactor fused into the quadrature: singular at
    zero distance for ν ≤ j."""
    x = torch.sqrt(torch.clamp(x2, min=_tiny(x2)))
    nut = _tensor(nu, x2)
    lpref = (1 - nut) * math.log(2.0) - torch.lgamma(nut) \
        + (nut - j) * torch.log(x)
    lpref, xb = torch.broadcast_tensors(lpref, x)
    return (-0.5) ** j * _kv_quad_scaled(
        (torch.zeros_like(xb) + nut - j).abs(), xb, lpref)


def _kvmodx2_deriv(nu, x2):
    if nu > 1:
        # the exact recurrence d/dx² f_ν = −f_{ν−1}/(4(ν−1)): regular at
        # x² = 0 and a Function again
        return -kvmodx2(abs(nu - 1), x2) / (4 * (nu - 1))
    # ν ≤ 1: singular at zero distance
    return _kvmodx2_raw(nu, x2, 1)


class _KvModX2(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x2, nu):
        ctx.save_for_backward(x2)
        ctx.save_for_forward(x2)
        ctx.nu = nu
        return _kvmodx2_value(nu, x2)

    @staticmethod
    def backward(ctx, g):
        x2, = ctx.saved_tensors
        return g * _kvmodx2_deriv(ctx.nu, x2), None

    @staticmethod
    def jvp(ctx, dx2, _):
        x2, = ctx.saved_tensors
        return _kvmodx2_deriv(ctx.nu, x2) * dx2


def kvmodx2(nu, x2):
    """The Matérn profile 2^{1−ν}/Γ(ν) x^ν K_ν(x) as a function of x²
    (1 at x² = 0), ``nu`` a Python number."""
    return _KvModX2.apply(_tensor(x2), float(nu))


def _jv_series(nu, x):
    return _series(nu, x, lambda nu_, k: (-1.0) ** k)


def _jv_asymp(nu, x, nterms=10):
    """Hankel expansion: J_ν(x) ~ √(2/πx)(cos ω P − sin ω Q)."""
    mu = 4 * nu * nu
    omega = x - nu * math.pi / 2 - math.pi / 4
    P = torch.ones_like(x * nu)
    Q = torch.zeros_like(x * nu)
    term = torch.ones_like(x * nu)
    for k in range(1, 2 * nterms + 1):
        term = term * (mu - (2 * k - 1) ** 2) / (8 * x * k)
        if k % 2 == 1:
            Q = Q + term * (-1.0) ** ((k - 1) // 2)
        else:
            P = P + term * (-1.0) ** (k // 2)
    return torch.sqrt(2 / (math.pi * x)) * (torch.cos(omega) * P
                                            - torch.sin(omega) * Q)


def jv(nu, x):
    """Bessel J_ν(x) for real ν ≥ 0, x ≥ 0: the series below a cut (20 in
    float64, 8 in float32, where the alternating series cancels), the
    Hankel expansion beyond."""
    x = _tensor(x)
    nu = _tensor(nu, x)
    nu, x = torch.broadcast_tensors(nu, x)
    cut = 20.0 if torch.finfo(x.dtype).eps < 1e-10 else 8.0
    small = _jv_series(nu, torch.clamp(x, max=cut))
    large = _jv_asymp(nu, torch.clamp(x, min=cut))
    return torch.where(x < cut, small, large)


def _jvmodx2_value(nu, x2):
    x = torch.sqrt(torch.clamp(x2, min=_tiny(x2)))
    nut = _tensor(nu, x2)
    lpref = torch.lgamma(nut + 1) + nut * (math.log(2.0) - torch.log(x))
    val = torch.exp(lpref) * jv(nut, x)
    return torch.where(x2 <= _tiny(x2), torch.ones_like(val), val)


def _jvmodx2_deriv(nu, x2):
    # d/dx² [Γ(ν+1)(2/x)^ν J_ν] = −jvmodx2(ν+1, x²)/(4(ν+1))
    return -jvmodx2(nu + 1, x2) / (4 * (nu + 1))


class _JvModX2(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x2, nu):
        ctx.save_for_backward(x2)
        ctx.save_for_forward(x2)
        ctx.nu = nu
        return _jvmodx2_value(nu, x2)

    @staticmethod
    def backward(ctx, g):
        x2, = ctx.saved_tensors
        return g * _jvmodx2_deriv(ctx.nu, x2), None

    @staticmethod
    def jvp(ctx, dx2, _):
        x2, = ctx.saved_tensors
        return _jvmodx2_deriv(ctx.nu, x2) * dx2


def jvmodx2(nu, x2):
    """Γ(ν+1) (2/x)^ν J_ν(x) as a function of x² (1 at x² = 0), ``nu`` a
    Python number."""
    return _JvModX2.apply(_tensor(x2), float(nu))
