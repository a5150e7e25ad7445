"""The real-order Matérn's tables: kernel C's Matérn-ν core by Chebyshev
panels in place of a quadrature per entry.

The Matérn profile of real order ν (``PROFILES['matern']``) is
f_ν(x²) = 2^{1−ν}/Γ(ν) x^ν K_ν(x) at x² = 2ν t, a function of one
variable for a fixed ν, and its first derivative in x² is another:
−f_{ν−1}/(4(ν−1)) for ν > 1, the raw form −½ 2^{1−ν}/Γ(ν) x^{ν−1}
K_{|ν−1|}(x) for ν ≤ 1.  The order is static (the profile's argument
without a gradient), so each is tabulated once per order and dtype and
read by every entry of every Gram of a fit.  A table holds, for x in
[2^E_LO, 2^E_HI), the Chebyshev coefficients of

    q(x) = e^x f(x)          (kind 0: f = f_μ)
    q(x) = e^x g(x)          (kind 1: g the raw form of order μ)

on panels: each octave [2^e, 2^{e+1}) cut in SUB equal parts, degree
NC − 1 in the panel's variable y ∈ [−1, 1).  On octave panels the
non-analytic terms at x = 0 (x^{2μ}, log x, x^{2μ−2}) are smooth, and
the factor e^x leaves a function that grows like a power.  An entry is
then a panel found from x's exponent and top mantissa bits, a Clenshaw
sum and one exponential, e^{−x}, whose argument's rounding in x = √x²
is corrected by the residual x² − x·x (so the value holds its relative
accuracy up to the underflow point, where x·u would otherwise be lost).
Below 2^E_LO (entries next to the diagonal) the kernels keep the
quadrature; at and above 2^E_HI the value underflows to 0 in the dtype.
The lookup reads the panel's variable at √x² rather than at the rounded
x (y moved by the same residual), so that q's own slope, about (ν − ½)/x,
does not carry x's rounding into the value.

The layout is fixed, so the tables hold their contract up to an order:
on a panel q grows like x^{ν−½}, and past ν ≈ 8 its series needs more
coefficients or narrower panels than the layout has (float64 reads about
3e-14 at ν = 15, 3e-11 at 20 and 2e-4 at 50; float32 about 6 eps at
ν = 10).  Orders above `NU_MAX` have no table: the kernels keep the
per-entry quadrature for them, as below the tables.

The table is built on the card by ``matern_table_kernel``
(``csrc/special.cuh``): the float64 quadrature of
``special._kv._kv_quad_scaled`` (the exponent without its −x, so that it
keeps its relative accuracy at large x) at each panel's Chebyshev nodes,
one thread a node, and a DCT per panel; float32 tables store the float64
coefficients rounded.  `matern_table_plain` is its plain version (the
same nodes and formulas in float64 torch) and `matern_table_eval_plain`
the plain version of the device's evaluation.

Accuracy contract (``tests/test_torch_matern_table.py``, held at seeded
points for ν ∈ {0.3, 0.5, 0.7, 1.0, 1.5, 1.7, 2.5, 3.7, 7.3, 8}, the
value and the first derivative; every order up to `NU_MAX`): in float64 the table is within 2e-14 relative
of a 40-digit truth wherever f ≥ 1e-290, and within 2e-14 + 1.5 (x +
ν |log x|) eps of the float64 quadrature (the JAX package's ``kvmodx2``
and its JVP), whose exponent rounds to about (x + ν |log x|) eps (its −x
cosh t, and the prefactor's ν log x against log cosh νt); in
float32 (coefficients rounded, the evaluation in float32) within 4 u
relative of the float64 table at the same float32 argument wherever f
is a normal float32.
"""

from __future__ import annotations

import ctypes
import math

import numpy
import torch

from . import _build
from ._syrk import _ptr, _stream

__all__ = ['matern_table', 'matern_table_plain', 'matern_table_eval_plain',
           'matern_tables', 'layout', 'tabulated', 'NU_MAX']

# the panels of each dtype (csrc/special.cuh MTab): the octaves from
# 2^E_LO to 2^E_HI (past the underflow of e^{-x}), SUB panels each, NC
# coefficients a panel; SPLIT, from where e^{-x} is taken as two halves
# (e^{-x} alone would be subnormal while the value is not)
SUB = 4
_LAYOUT = {torch.float64: (-12, 10, 13, 700.0),
           torch.float32: (-12, 7, 7, 80.0)}
KIND_VALUE, KIND_RAW = 0, 1
# the largest order with tables (the module's docstring)
NU_MAX = 8.0


def tabulated(nu):
    """Whether the real-order Matérn of order ``nu`` (as stated, a float)
    reads tables on the card; above `NU_MAX` the kernels keep the
    quadrature."""
    return 0 < float(nu) <= NU_MAX


def _check(nu, kind):
    """Refuse an order and kind without a table."""
    if not tabulated(nu) or (kind == KIND_RAW and nu > 1):
        raise ValueError(f'no Matérn table of order {nu}, kind {kind}')


def layout(dtype):
    """(E_LO, E_HI, NC, number of panels) of a dtype's table."""
    elo, ehi, nc, _ = _LAYOUT[dtype]
    return elo, ehi, nc, (ehi - elo) * SUB


def _nodes(dtype):
    """The Chebyshev nodes x (float64, (panels, NC)) of a dtype's table and
    the DCT's cosines (NC, NC), [j, k] = cos(j π (k + ½) / NC)."""
    elo, _, nc, npan = layout(dtype)
    k = numpy.arange(nc)
    y = numpy.cos(numpy.pi * (k + 0.5) / nc)
    p = numpy.arange(npan)
    e, sub = elo + p // SUB, p % SUB
    x = numpy.ldexp(1.0, e)[:, None] * (
        1 + (sub[:, None] + (y[None, :] + 1) / 2) / SUB)
    cos = numpy.cos(numpy.pi * numpy.outer(k, 2 * k + 1) / (2 * nc))
    return x, cos


def _node_values(nu, kind, x):
    """e^x f_ν(x²) (kind 0) or e^x times the raw first x²-derivative of
    f_ν (kind 1) at x (float64), by the quadrature with the prefactor and
    e^x in the exponent."""
    from ..special import _kv
    pw, mu, c = (nu, nu, 1.0) if kind == KIND_VALUE \
        else (nu - 1, abs(nu - 1), -0.5)
    lpref = (1 - nu) * math.log(2.0) - math.lgamma(nu) + pw * torch.log(x)
    return c * _kv._kv_quad_scaled(torch.full_like(x, mu), x, lpref, ex=True)


def matern_table_plain(nu, kind, dtype, device='cpu'):
    """Plain version of `matern_table`: the coefficients of order ``nu``
    and ``kind`` (0 the value's, 1 the raw derivative's), flat,
    (panels · NC,), computed in float64 and returned in ``dtype``."""
    nu = float(nu)
    _check(nu, kind)
    x, cos = _nodes(dtype)
    nc = cos.shape[0]
    xt = torch.as_tensor(x, dtype=torch.float64, device=device)
    v = _node_values(nu, kind, xt)
    c = v @ torch.as_tensor(cos.T, dtype=torch.float64, device=device)
    c = c * (2.0 / nc)
    c[:, 0] /= 2
    return c.reshape(-1).to(dtype)


def _locate(x, dtype):
    """The panel of each x, its variable y in [−1, 1) and dy/dx, as the
    device finds them from x's exponent and top mantissa bits."""
    elo = layout(dtype)[0]
    m, e = torch.frexp(x)            # x = m 2^e, m in [0.5, 1)
    f = 4 * m - 2                    # x / 2^(e−1) − 1 in [0, 1), times 2
    sub = torch.floor(f * (SUB / 2))
    y = 2 * (f * (SUB / 2) - sub) - 1
    dydx = torch.ldexp(torch.full_like(x, 2.0 * SUB), 1 - e)
    return (e - 1 - elo) * SUB + sub.long(), y, dydx


def _residual(x, x2):
    """x2 − x·x exactly (Dekker's product: the device's fma)."""
    c = 134217729.0 * x if x.dtype == torch.float64 else 4097.0 * x
    hi = c - (c - x)
    lo = x - hi
    p = x * x
    err = ((hi * hi - p) + 2 * hi * lo) + lo * lo
    return (x2 - p) - err


def matern_table_eval_plain(tab, x2):
    """Plain version of the device's table evaluation (``csrc/special.cuh``
    ``mtab_value``): the tabulated function at x² (same dtype as the
    table), with x = √x²; NaN below the table (x < 2^E_LO, where the
    kernels keep the quadrature), 0 at and above its end."""
    dtype = tab.dtype
    elo, ehi, nc, npan = layout(dtype)
    split = _LAYOUT[dtype][3]
    x2 = torch.as_tensor(x2, dtype=dtype, device=tab.device)
    x = torch.sqrt(x2)
    inside = (x >= 2.0 ** elo) & (x < 2.0 ** ehi)
    xs = torch.where(inside, x, torch.ones_like(x))
    panel, y, dydx = _locate(xs, dtype)
    # √x² − x to first order; y at √x² (dydx a power of 2: one rounding,
    # the device's fma)
    d = _residual(xs, x2) * (0.5 / xs)
    y = y + d * dydx
    c = tab.reshape(npan, nc)[panel.clamp(0, npan - 1)]
    y2 = y + y
    b1 = b2 = torch.zeros_like(y)
    for k in range(nc - 1, 0, -1):
        b1, b2 = y2 * b1 + (c[..., k] - b2), b1
    q = y * b1 + (c[..., 0] - b2)
    big = xs >= split
    E = torch.exp(torch.where(big, -0.5 * xs, -xs))
    H = torch.where(big, E, torch.ones_like(E))
    v = (q * H) * E
    v = v - d * v
    nan = torch.full_like(v, math.nan)
    return torch.where(inside, v, torch.where(x < 2.0 ** elo, nan,
                                              torch.zeros_like(v)))


_CACHE = {}


def matern_table(nu, kind, dtype, device):
    """The table of order ``nu`` and ``kind`` on ``device``: on a CUDA
    device built once by ``matern_table_kernel`` and kept (keyed by
    order, kind, dtype and device; ``matern_table.launches`` counts the
    builds), on the CPU the plain builder's."""
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None:
        device = torch.device('cuda', torch.cuda.current_device())
    key = float(nu), int(kind), dtype, device
    tab = _CACHE.get(key)
    if tab is not None:
        return tab
    if device.type == 'cpu':
        tab = matern_table_plain(nu, kind, dtype)
    else:
        nu = float(nu)
        _check(nu, kind)
        suffix = {torch.float32: '_f32', torch.float64: '_f64'}[dtype]
        elo, ehi, nc, npan = layout(dtype)
        tab = torch.empty(npan * nc, dtype=dtype, device=device)
        err = getattr(_build.lib(), 'lsq_matern_table' + suffix)(
            ctypes.c_double(nu), int(kind), _ptr(tab), _stream(device))
        _build.check(err, 'matern_table')
        matern_table.launches += 1
    _CACHE[key] = tab
    return tab


matern_table.launches = 0


def matern_tables(nu, dtype, device):
    """(value table, first-derivative table) of the real-order Matérn core
    of order ``nu`` in (0, `NU_MAX`]: f_ν's, and f_{ν−1}'s (ν > 1, the
    recurrence; the same cache serves order ν − 1's value) or the raw
    form's (ν ≤ 1)."""
    f = matern_table(nu, KIND_VALUE, dtype, device)
    d = matern_table(nu - 1, KIND_VALUE, dtype, device) if nu > 1 \
        else matern_table(nu, KIND_RAW, dtype, device)
    return f, d


def matern_parts_plain(t, nu, j, dtype=None):
    """The device's Matérn-ν core by the tables on the CPU: s^j times the
    j-th x²-derivative of f_ν at x² = s t, s = 2ν, j = 0 or 1, from the
    tables where x ≥ 2^E_LO, the quadrature (``_gram._matern_parts``)
    below and for an order without tables; the tables of ``dtype`` (t's
    by default)."""
    from ._gram import _matern_parts
    dtype = t.dtype if dtype is None else dtype
    if not tabulated(nu):
        return _matern_parts(t, torch.tensor(float(nu), dtype=dtype), j)
    # the order as the kernels read it, in the dtype
    nu = float(torch.tensor(nu, dtype=dtype))
    f, d = matern_tables(nu, dtype, 'cpu')
    s = 2 * nu
    x2 = s * t
    if j == 0:
        v = matern_table_eval_plain(f, x2)
    else:
        v = matern_table_eval_plain(d, x2)
        v = s * (-v / (4 * (nu - 1)) if nu > 1 else v)
    low = torch.isnan(v)
    if bool(low.any()):
        ref = _matern_parts(t, torch.tensor(nu, dtype=dtype), j)
        v = torch.where(low, ref, v)
    return v
