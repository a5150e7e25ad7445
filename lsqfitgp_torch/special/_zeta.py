"""Riemann, Hurwitz and periodic zeta functions.

Counterpart of ``lsqfitgp_tpu/special/_zeta.py``, with the same
branches: Riemann ζ by ``torch.special.zeta`` for s ≥ 2.5, the
Stieltjes (Laurent) expansion for −0.5 < s < 2.5 and the functional
equation below; the periodic zeta F(x, s) = Σ_{k≥1} e^{2πikx}/k^s by
its direct 50-term series for large s and by DLMF 25.13.2 with the
Hurwitz-ζ Taylor expansion around a = 1 below, evaluated symmetrically
at s₀ ± eps^{1/3} near an integer s₀ (the Γ·cos·ζ cancellations).

What differs is the evaluation, for Grams of n × m entries.  The JAX
package broadcasts a trailing series axis (n × m × 50, n × m × 40) and
evaluates both branches under ``where``, which XLA fuses; eager PyTorch
would keep each of those tensors.  Here s is static (a number, as the
kernels pass it): the branch is chosen once per call, the Hurwitz
branch's 40 coefficients and its prefactor, which depend on s only, are
computed once, in float64 on the host, those of the two nudged points
folded into one polynomial, summed by Horner in x², and the direct
series accumulates term by term into one buffer; a few n × m buffers at
the peak.  The nudge's eps is x's dtype's,
as in the JAX package: near an integer s the bracket x^{−s1} + ζ(s1, 1+x)
± ζ(s1, 1−x) cancels in that dtype.  A tensor s of more
than one value goes through the same code with its coefficients of s's
shape, both branches evaluated where s straddles the cut.

``periodic_zeta`` is differentiable in x (each derivative lowers s by
1, the JAX custom JVP rule as a `torch.autograd.Function`, whose
backward calls ``periodic_zeta`` again); s is not differentiable.
"""

from __future__ import annotations

import math

import torch

from ._expint import _float

__all__ = ['zeta_real', 'periodic_zeta', 'periodic_bernoulli']

# Stieltjes constants γ_n (generated with mpmath.stieltjes at 40 dps)
_STIELTJES = [
    0.5772156649015329, -0.07281584548367673, -0.00969036319287232,
    0.002053834420303346, 0.0023253700654673, 0.0007933238173010627,
    -0.0002387693454301996, -0.000527289567057751,
    -0.0003521233538030395, -3.439477441808805e-05,
    0.0002053328149090648, 0.0002701844395439035, 0.0001672729121051402,
    -2.7463806603760158e-05, -0.00020920926205929996,
    -0.0002834686553202414, -0.00019969685830896976,
    2.6277037109918338e-05, 0.0003073684081492528, 0.0005036054530473557,
    0.00046634356151155945, 0.00010443776975600011,
    -0.0005415995822039977, -0.0012439620904082457,
    -0.0015885112789035616, -0.0010745919527384888,
    0.0006568035186371545, 0.0034778369136185382, 0.00640006853170063,
    0.007371151770472239,
]
# the Laurent coefficients (−1)^n γ_n / n!
_LAURENT = [g * (-1) ** n / math.factorial(n)
            for n, g in enumerate(_STIELTJES)]

_NMAX = 50      # direct-series terms
_KSER = 40      # Hurwitz Taylor terms


def _zeta_laurent(s):
    """ζ(s) = 1/(s−1) + Σ_n (−1)^n γ_n (s−1)^n / n!, |s−1| ≲ 1.5."""
    ds = s - 1
    poly = torch.zeros_like(s)
    for c in reversed(_LAURENT):
        poly = poly * ds + c
    return 1 / ds + poly


def _zeta_refl(s):
    """DLMF 25.4.1: ζ(s) = 2 (2π)^{s−1} sin(πs/2) Γ(1−s) ζ(1−s), s < 0."""
    s1 = 1 - s  # > 1
    log = (s - 1) * math.log(2 * math.pi) + torch.lgamma(s1)
    zs1 = torch.where(
        s1 >= 2.5,
        torch.special.zeta(torch.clamp(s1, min=2.5), 1.0),
        _zeta_laurent(torch.clamp(s1, max=2.5)),
    )
    return 2 * torch.exp(log) * torch.sin(math.pi * s / 2) * zs1


def zeta_real(s):
    """Riemann ζ(s) for any real s (s = 1 is the pole)."""
    s = _float(s)
    large = torch.special.zeta(torch.clamp(s, min=2.5), 1.0)
    mid = _zeta_laurent(torch.clamp(s, -0.5, 2.5))
    small = _zeta_refl(torch.clamp(s, max=-0.5))
    return torch.where(s >= 2.5, large, torch.where(s > -0.5, mid, small))


def _larges(dtype):
    """The s from which the direct series' truncation error, below
    NMAX^{-s}, is under the dtype's eps."""
    eps = torch.finfo(dtype).eps
    return math.ceil(-math.log(eps) / math.log(_NMAX))


def _standard_x(x):
    """Map x to [0, 1/2] by periodicity and reflection.  The reflection
    flips the sign of the imaginary part."""
    x = x % 1.0
    neg = x > 0.5
    return neg, torch.where(neg, 1 - x, x)


def _pz_larges(x, s, imag):
    """The direct series, one term at a time into one buffer; truncation
    error < NMAX^{-s}."""
    out = None
    fn = torch.sin if imag else torch.cos
    for k in range(1, _NMAX + 1):
        neg, kx = _standard_x(x * k)
        term = fn(2 * math.pi * kx) * k ** -s
        if imag:
            term = torch.where(neg, -term, term)
        out = term if out is None else out.add_(term)
    return out


def _hurwitz_coefs(s1):
    """The coefficients 2 (−1)^k (s1)_k ζ(s1+k) / k!, k < KSER, of
    ζ(s1, 1+x) ± ζ(s1, 1−x) = 2 Σ_{k parity} c_k x^k (even k for +, odd
    for −), in a trailing axis."""
    k = torch.arange(_KSER, dtype=s1.dtype, device=s1.device)
    M = s1[..., None] + k
    # (s1)_k / k! as a cumulative product of O(1) factors (s1+j)/(j+1)
    factors = M / (k + 1)
    pf = torch.cat([torch.ones_like(M[..., :1]),
                    torch.cumprod(factors[..., :-1], -1)], -1)
    sign = torch.where(k % 2 == 1, -2.0, 2.0).to(s1.dtype)
    return sign * pf * zeta_real(M)


def _smalls_parts(s, delta):
    """For DLMF 25.13.2 at s (a float64 or x-dtype tensor): the points it
    is evaluated at, s₀ ± delta when s is within delta of an integer s₀
    (the Γ(s1)-pole cancellations: the average cancels the linear bias,
    error O(delta²)), else s itself, each as (1 − s, the prefactor
    (2π)^{−s1} Γ(s1) {cos, sin}(π s1/2) for (real, imaginary), the
    Hurwitz coefficients)."""
    srnd = torch.round(s)
    near = (s - srnd).abs() < delta
    points = [s] if not bool(near.any()) else [
        torch.where(near, srnd - delta, s),
        torch.where(near, srnd + delta, s)]
    out = []
    for sp in points:
        s1 = 1 - sp
        # Γ(s1), s1 negative non-integer, by reflection
        gam = math.pi / (torch.sin(math.pi * s1)
                         * torch.exp(torch.lgamma(1 - s1)))
        pref = (2 * math.pi) ** -s1 * gam
        pha = (torch.cos(math.pi * s1 / 2), torch.sin(math.pi * s1 / 2))
        out.append((s1, (pref * pha[0], pref * pha[1]), _hurwitz_coefs(s1)))
    return out


def _pz_smalls(x, parts, imag):
    """DLMF 25.13.2 for moderate s > 1, x in [0, 1/2], averaged over the
    evaluation points ``parts`` (`_smalls_parts`):

    Re/Im F(x,s) = (2π)^{−s1} Γ(s1) {cos,sin}(πs1/2)
                   · [x^{−s1} + (ζ(s1,1+x) ± ζ(s1,1−x))],  s1 = 1−s;

    the points' Hurwitz sums are one polynomial (their coefficients
    weighted by the prefactors and added in the coefficients' dtype),
    summed by Horner in x² over the coefficients of its parity, then
    each point's power is added."""
    w = 1 / len(parts)
    coefs = sum(pref[imag][..., None] * w * c for _, pref, c in parts)
    c = coefs.to(x)[..., 1 if imag else 0::2]
    x2 = x * x
    out = torch.zeros_like(x2).add_(c[..., -1])
    for j in range(c.shape[-1] - 2, -1, -1):
        out.mul_(x2).add_(c[..., j])
    if imag:
        out.mul_(x)
    xs = torch.clamp(x, min=torch.finfo(x.dtype).tiny)
    for s1, pref, _ in parts:
        out.addcmul_(xs ** -s1.to(x), (pref[imag] * w).to(x))
    if imag:
        out = torch.where(x == 0, 0.0, out)
    return out


def _periodic_zeta_value(x, s, imag):
    larges = _larges(x.dtype)
    if isinstance(s, torch.Tensor):
        # coefficients of s's shape: x and s broadcast to one shape
        x, s = torch.broadcast_tensors(x, s.to(device=x.device))
        small = s < larges
        anysmall, allsmall = bool(small.any()), bool(small.all())
    else:
        anysmall = allsmall = s < larges
        s = torch.tensor(s, dtype=torch.float64)
    z = None
    if anysmall:
        # the cancellation at an integer s is in x's dtype, which sets
        # delta (the JAX package's eps of result_type(x, s))
        delta = torch.finfo(x.dtype).eps ** (1 / 3)
        parts = _smalls_parts(torch.clamp(s, max=larges), delta)
        neg, xstd = _standard_x(x)
        z = _pz_smalls(xstd, parts, imag)
        if imag:
            z = torch.where(neg, -z, z)
    if not allsmall:
        sl = torch.clamp(s, min=1.0)
        z_large = _pz_larges(x, sl.to(x.dtype) if sl.dim() else float(sl),
                             imag)
        z = z_large if z is None else torch.where(s < larges, z, z_large)
    return z


def _static_s(s):
    """s as a float when it is one number, else as a tensor."""
    if isinstance(s, torch.Tensor):
        if s.dim() == 0:
            return float(s)
        return s.detach()
    return float(s)


class _PeriodicZeta(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, s, imag):
        ctx.save_for_backward(x)
        ctx.save_for_forward(x)
        ctx.s, ctx.imag = s, imag
        return _periodic_zeta_value(x, s, imag)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        return g * _dperiodic_zeta(x, ctx.s, ctx.imag), None, None

    @staticmethod
    def jvp(ctx, t, *_):
        x, = ctx.saved_tensors
        return t * _dperiodic_zeta(x, ctx.s, ctx.imag)


def _dperiodic_zeta(x, s, imag):
    sgn = 1.0 if imag else -1.0
    return 2 * math.pi * sgn * periodic_zeta(x, s - 1, not imag)


def periodic_zeta(x, s, imag=False):
    """F(x, s) = Σ_{k≥1} e^{2πikx}/k^s for real s > 1: real part by
    default, imaginary part with ``imag=True``.  Differentiable in x
    (each derivative lowers s by 1); s is non-differentiable."""
    x = _float(x)
    return _PeriodicZeta.apply(x, _static_s(s), bool(imag))


def periodic_bernoulli(n, x):
    """Periodic Bernoulli polynomial B_n(x mod 1) for static int n ≥ 2:

    B_{2m}(x)   = (−1)^{m+1} 2 (2m)!/(2π)^{2m}   Σ cos(2πkx)/k^{2m},
    B_{2m+1}(x) = (−1)^{m+1} 2 (2m+1)!/(2π)^{2m+1} Σ sin(2πkx)/k^{2m+1}.
    """
    n = int(n)
    m = n // 2
    sign = (-1.0) ** (m + 1)
    pref = sign * 2.0 * math.factorial(n) / (2 * math.pi) ** n
    return pref * periodic_zeta(x, float(n), bool(n % 2))
