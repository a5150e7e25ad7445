"""Exponential-integral special functions.

Counterpart of ``lsqfitgp_tpu/special/_expint.py``: ``si`` and ``ci``
from ``sici``, the Cephes rational approximations that
``jax.scipy.special.sici`` evaluates (the series below |x| = 4, the
auxiliary functions f and g to 1e9, the leading asymptotic terms
beyond), with its derivative rule (sin x / x and cos x / x) as a
`torch.autograd.Function`; and ``expn_imag_real``, Re E_n(−ix) by the
power series below x = 1 and the continued fraction above, as the JAX
package computes it.
"""

from __future__ import annotations

import math

import torch

__all__ = ['ci', 'si', 'expn_imag_real']

_EULER = 0.5772156649015329

# Cephes sici.c, the coefficients jax.scipy.special.sici takes
_SN = [-8.39167827910303881427E-11, 4.62591714427012837309E-8,
       -9.75759303843632795789E-6, 9.76945438170435310816E-4,
       -4.13470316229406538752E-2, 1.00000000000000000302E0]
_SD = [2.03269266195951942049E-12, 1.27997891179943299903E-9,
       4.41827842801218905784E-7, 9.96412122043875552487E-5,
       1.42085239326149893930E-2, 9.99999999999999996984E-1]
_CN = [2.02524002389102268789E-11, -1.35249504915790756375E-8,
       3.59325051419993077021E-6, -4.74007206873407909465E-4,
       2.89159652607555242092E-2, -1.00000000000000000080E0]
_CD = [4.07746040061880559506E-12, 3.06780997581887812692E-9,
       1.23210355685883423679E-6, 3.17442024775032769882E-4,
       5.10028056236446052392E-2, 4.00000000000000000080E0]
_FN4 = [4.23612862892216586994E0, 5.45937717161812843388E0,
        1.62083287701538329132E0, 1.67006611831323023771E-1,
        6.81020132472518137426E-3, 1.08936580650328664411E-4,
        5.48900223421373614008E-7]
_FD4 = [1, 8.16496634205391016773E0, 7.30828822505564552187E0,
        1.86792257950184183883E0, 1.78792052963149907262E-1,
        7.01710668322789753610E-3, 1.10034357153915731354E-4,
        5.48900252756255700982E-7]
_GN4 = [8.71001698973114191777E-2, 6.11379109952219284151E-1,
        3.97180296392337498885E-1, 7.48527737628469092119E-2,
        5.38868681462177273157E-3, 1.61999794598934024525E-4,
        1.97963874140963632189E-6, 7.82579040744090311069E-9]
_GD4 = [1, 1.64402202413355338886E0, 6.66296701268987968381E-1,
        9.88771761277688796203E-2, 6.22396345441768420760E-3,
        1.73221081474177119497E-4, 2.02659182086343991969E-6,
        7.82579218933534490868E-9]
_FN8 = [4.55880873470465315206E-1, 7.13715274100146711374E-1,
        1.60300158222319456320E-1, 1.16064229408124407915E-2,
        3.49556442447859055605E-4, 4.86215430826454749482E-6,
        3.20092790091004902806E-8, 9.41779576128512936592E-11,
        9.70507110881952024631E-14]
_FD8 = [1.0, 9.17463611873684053703E-1, 1.78685545332074536321E-1,
        1.22253594771971293032E-2, 3.58696481881851580297E-4,
        4.92435064317881464393E-6, 3.21956939101046018377E-8,
        9.43720590350276732376E-11, 9.70507110881952025725E-14]
_GN8 = [6.97359953443276214934E-1, 3.30410979305632063225E-1,
        3.84878767649974295920E-2, 1.71718239052347903558E-3,
        3.48941165502279436777E-5, 3.47131167084116673800E-7,
        1.70404452782044526189E-9, 3.85945925430276600453E-12,
        3.14040098946363334640E-15]
_GD8 = [1.0, 1.68548898811011640017E0, 4.87852258695304967486E-1,
        4.67913194259625806320E-2, 1.90284426674399523638E-3,
        3.68475504442561108162E-5, 3.57043223443740838771E-7,
        1.72693748966316146736E-9, 3.87830166023954706752E-12,
        3.14040098946363335242E-15]


def _float(x):
    x = torch.as_tensor(x)
    if not x.is_floating_point():
        x = x.to(torch.get_default_dtype())
    return x


def _polyval(coef, x):
    """Σ coef[i] x^(deg − i), highest power first (``jnp.polyval``)."""
    out = torch.full_like(x, coef[0])
    for c in coef[1:]:
        out = out * x + c
    return out


def _sici_value(x):
    """(Si(x), Ci(x)) by the branches of ``jax.scipy.special.sici``."""
    ax = x.abs()
    # the series, |x| <= 4 (at 0: Si = 0, Ci = -inf)
    xs = torch.where((ax <= 4) & (ax > 0), ax, torch.ones_like(ax))
    t = xs * xs
    si_s = torch.where(ax == 0, torch.zeros_like(ax),
                       xs * _polyval(_SN, t) / _polyval(_SD, t))
    ci_s = torch.where(ax == 0, torch.full_like(ax, -math.inf),
                       _EULER + torch.log(xs)
                       + t * _polyval(_CN, t) / _polyval(_CD, t))
    # the auxiliary functions, 4 < |x| <= 1e9
    xa = torch.where((ax > 4) & (ax <= 1e9), ax, torch.full_like(ax, 5.0))
    s, c = torch.sin(xa), torch.cos(xa)
    z = 1.0 / (xa * xa)
    f = torch.where(xa < 8, _polyval(_FN4, z) / (xa * _polyval(_FD4, z)),
                    _polyval(_FN8, z) / (xa * _polyval(_FD8, z)))
    g = torch.where(xa < 8, z * _polyval(_GN4, z) / _polyval(_GD4, z),
                    z * _polyval(_GN8, z) / _polyval(_GD8, z))
    si_a = math.pi / 2 - f * c - g * s
    ci_a = f * s - g * c
    # beyond 1e9, the leading terms
    xb = torch.where(ax > 1e9, ax, torch.full_like(ax, 2e9))
    si_b = torch.where(torch.isinf(xb), torch.full_like(xb, math.pi / 2),
                       math.pi / 2 - torch.cos(xb) / xb)
    ci_b = torch.where(torch.isinf(xb), torch.zeros_like(xb),
                       torch.sin(xb) / xb)
    small, mid = ax <= 4, (ax > 4) & (ax <= 1e9)
    si = torch.where(small, si_s, torch.where(mid, si_a, si_b))
    ci = torch.where(small, ci_s, torch.where(mid, ci_a, ci_b))
    si = torch.sign(x) * si
    ci = torch.where(torch.isneginf(x), torch.full_like(ci, math.nan), ci)
    return si, ci


class _Sici(torch.autograd.Function):
    """(Si, Ci) with the derivatives sin x / x and cos x / x, the JAX
    rule (``sici_jvp``); the backward is plain torch of the saved x, so
    it differentiates again."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        ctx.save_for_forward(x)
        return _sici_value(x)

    @staticmethod
    def _derivs(x):
        return torch.sinc(x / math.pi), torch.cos(x) / x

    @staticmethod
    def backward(ctx, gs, gc):
        x, = ctx.saved_tensors
        ds, dc = _Sici._derivs(x)
        return gs * ds + gc * dc

    @staticmethod
    def jvp(ctx, dx):
        x, = ctx.saved_tensors
        ds, dc = _Sici._derivs(x)
        return ds * dx, dc * dx


def sici(x):
    """(Si(x), Ci(x)), differentiable to any order."""
    return _Sici.apply(_float(x))


def si(x):
    """Sine integral Si(x)."""
    return sici(x)[0]


def ci(x):
    """Cosine integral Ci(x)."""
    return sici(x)[1]


def _expn_imag_series(m, x, nterms=40):
    """E_m(−ix), complex, for integer m >= 1 by DLMF 8.19.8 (x small and
    > 0): (ix)^(m−1)/(m−1)! (ψ(m) − ln(−ix)) − Σ_{k != m−1, k < nterms}
    (ix)^k / (k! (k − m + 1)), ln(−ix) = ln|x| − iπ/2; the real part
    keeps the even k, the imaginary part the odd."""
    psi_m = -_EULER + sum(1.0 / j for j in range(1, m))
    A = psi_m - torch.log(x.abs())   # ln(−ix) = ln|x| − iπ/2
    B = math.pi / 2
    xp = x ** (m - 1) / math.factorial(m - 1)
    lead = ((xp * A, xp * B), (-xp * B, xp * A), (-xp * A, -xp * B),
            (xp * B, -xp * A))[(m - 1) % 4]
    re, im = torch.zeros_like(x), torch.zeros_like(x)
    for k in range(nterms):
        if k == m - 1:
            continue
        term = ((1.0, -1.0)[k // 2 % 2] / (math.factorial(k) * (k - m + 1))
                * x ** k)
        if k % 2:
            im = im + term
        else:
            re = re + term
    return torch.complex(lead[0] - re, lead[1] - im)


def _expn_imag_cf(n, x, iters=130):
    """E_n(−ix), complex, by the modified-Lentz continued fraction

        E_n(z) = e^{-z} / (z + n/(1 + 1/(z + (n+1)/(1 + 2/(z + ...)))))

    with z = −ix, for x ≳ 1 (the JAX package's 130 steps)."""
    z = torch.complex(torch.zeros_like(x), -x)
    b = z + n
    d = 1.0 / b
    c = torch.full_like(z, 1e30)
    h = d
    for i in range(1, iters + 1):
        a = -i * (n - 1 + i)
        b = b + 2
        d = 1.0 / (a * d + b)
        c = b + a / c
        h = h * (c * d)
    return h * torch.exp(-z)


def expn_imag_derivs(n, x):
    """(Re E_n(−ix), Im E_{n−1}(−ix), Re E_{n−2}(−ix)) for static integer
    n >= 2 and x >= 0, the Color profile's value and first two
    derivatives over ±(n − 1) (dE_m(−ix)/dx = i E_{m−1}(−ix)): below
    x = 1 each order's series (E_0(−ix) = i e^{ix}/x in closed form),
    above it one continued fraction for E_n and the recurrence E_{m−1} =
    (e^{ix} − (m − 1) E_m)/(−ix); below eps the limits (1/(n − 1), 0,
    0) of the value and of `expn_imag_real`'s clamped derivative."""
    assert int(n) == n and n >= 2, n
    n = int(n)
    x = _float(x)
    eps = torch.finfo(x.dtype).eps
    xs = torch.clamp(x, min=eps)
    xl = torch.where(xs < 1, xs, torch.full_like(xs, 0.5))
    xh = torch.where(xs >= 1, xs, torch.full_like(xs, 5.0))

    def series(m):
        if m == 0:
            return torch.complex(-torch.sin(xl), torch.cos(xl)) / xl
        return _expn_imag_series(m, xl)

    lo = [series(n).real, series(n - 1).imag, series(n - 2).real]
    eix = torch.complex(torch.cos(xh), torch.sin(xh))
    zi = torch.complex(torch.zeros_like(xh), -xh)
    En = _expn_imag_cf(n, xh)
    En1 = (eix - (n - 1) * En) / zi
    En2 = (eix - (n - 2) * En1) / zi
    hi = [En.real, En1.imag, En2.real]
    lim = [1.0 / (n - 1), 0.0, 0.0]
    return tuple(torch.where(x < eps, torch.full_like(x, v),
                             torch.where(xs < 1, a, b))
                 for a, b, v in zip(lo, hi, lim))


def expn_imag_real(n, x):
    """Re E_n(−ix) = ∫_1^∞ cos(x t) / t^n dt for static integer n >= 2,
    real x >= 0.  Power series below x = 1, continued fraction above;
    below eps the limit 1/(n − 1)."""
    assert int(n) == n and n >= 2, n
    n = int(n)
    x = _float(x)
    eps = torch.finfo(x.dtype).eps
    xs = torch.clamp(x, min=eps)
    small = _expn_imag_series(
        n, torch.where(xs < 1, xs, torch.full_like(xs, 0.5))).real
    large = _expn_imag_cf(
        n, torch.where(xs >= 1, xs, torch.full_like(xs, 5.0))).real
    out = torch.where(xs < 1, small, large)
    return torch.where(x < eps, torch.full_like(out, 1.0 / (n - 1)), out)
