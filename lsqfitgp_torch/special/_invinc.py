"""Inverse incomplete gamma and beta functions.

Counterpart of ``lsqfitgp_tpu/special/_invinc.py``: the same
safeguarded rootfinds (log-space bisection and a Newton polish for the
gamma inverses, Newton in logit space for the beta inverse, with the
same iteration counts) and the same implicit-function derivative rules,
as `torch.autograd.Function`s.  PyTorch has ``gammainc`` and
``gammaincc`` but no derivative of them with respect to the shape a and
no incomplete beta; here ∂P/∂a sums the series of P (x < a + 1) or runs
the derivative through Lentz's continued fraction of Q, and the
regularized incomplete beta is the continued fraction of DLMF 8.17.22
by Lentz's method.  ``betaincinv`` is differentiable in y only.
"""

from __future__ import annotations

import functools

import torch

__all__ = ['gammaincinv', 'gammainccinv', 'betaincinv']

_NEWTON_ITERS = 40
_BISECT_ITERS = 90
_POLISH_ITERS = 4
# the most terms of the series and steps of the continued fractions
# below (enough for a and b up to about 10⁴ in float64); each stops
# once every entry's last steps changed nothing, checked every _CHECK
_SERIES_TERMS = 400
_CF_ITERS = 300
_CHECK = 10


def _converged(i, step, dtype):
    """Whether, at a checking step i, every entry of the relative change
    ``step`` is below the dtype's eps."""
    return i % _CHECK == 0 and bool(
        (step.abs() <= torch.finfo(dtype).eps).all())


def _floats(*xs):
    """The arguments as tensors of one floating dtype (their floating
    dtypes promoted, else the default), on the first tensor argument's
    device, broadcast."""
    ts = [torch.as_tensor(x) for x in xs]
    floating = [t.dtype for t in ts if t.is_floating_point()]
    dtype = functools.reduce(torch.promote_types, floating) if floating \
        else torch.get_default_dtype()
    dev = next((x.device for x in xs if isinstance(x, torch.Tensor)), None)
    return torch.broadcast_tensors(*(t.to(dtype=dtype, device=dev)
                                     for t in ts))


def _bisect_monotone(f, lo, hi, iters=_BISECT_ITERS):
    """Vectorized bisection for f increasing in u, f(lo) ≤ 0 ≤ f(hi)."""
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        below = f(mid) < 0
        lo, hi = torch.where(below, mid, lo), torch.where(below, hi, mid)
    return 0.5 * (lo + hi)


def _polish(f, a, u, lggam):
    for _ in range(_POLISH_ITERS):
        x = torch.exp(u)
        dfdu = torch.exp(a * u - x - lggam)        # dP/du
        step = f(u) / torch.clamp(dfdu, min=1e-300)
        u = u - torch.clamp(step, -1.0, 1.0)
    return torch.exp(u)


def _gammaincinv_newton(a, p):
    """Solve P(a, x) = p: log-space bisection + Newton polish.

    Bisection in u = log x is branchless, vectorizes, and is immune to
    the flat tails of P that break plain Newton at extreme p/a.
    """
    lggam = torch.lgamma(a)
    p = torch.clamp(p, 1e-300, 1 - 1e-16)
    # bracket: small-x expansion P ≈ x^a/(aΓ(a)) gives a lower edge;
    # upper edge from the far upper tail
    u_lo = torch.clamp((torch.log(p) + lggam + torch.log(a)) / a - 1.0,
                       max=-1.0)
    u_hi = torch.log(torch.clamp(4 * a + 40.0, min=100.0))
    f = lambda u: torch.special.gammainc(a, torch.exp(u)) - p
    return _polish(f, a, _bisect_monotone(f, u_lo, u_hi), lggam)


def _gammainccinv_newton(a, q):
    """Solve Q(a, x) = q: log-space bisection + Newton polish."""
    lggam = torch.lgamma(a)
    q = torch.clamp(q, 1e-300, 1 - 1e-16)
    # far-tail upper edge: log q ≈ (a−1)log x − x − lnΓ(a)
    y0 = torch.clamp(-torch.log(q), min=1.0)
    y_far = y0 + torch.clamp(a - 1, min=0) * torch.log(
        y0 + torch.clamp(a, min=2.0)) + lggam.abs() + 10.0
    u_hi = torch.log(y_far + 4 * a + 40.0)
    # lower edge: x where P = 1−q is tiny
    u_lo = torch.clamp((torch.log1p(-q) + lggam + torch.log(a)) / a - 1.0,
                       max=-1.0)
    f = lambda u: q - torch.special.gammaincc(a, torch.exp(u))  # increasing
    return _polish(f, a, _bisect_monotone(f, u_lo, u_hi), lggam)


def _dgammainc_dx(a, x):
    """∂P(a, x)/∂x = x^{a−1} e^{−x} / Γ(a)."""
    return torch.exp((a - 1) * torch.log(x) - x - torch.lgamma(a))


def _dgammainc_da(a, x):
    """∂P(a, x)/∂a: for x < a + 1 the series P = Σ_k t_k, t_k = x^{a+k}
    e^{−x} / Γ(a+k+1), differentiated term by term (∂t_k/∂a = t_k (log x
    − ψ(a+k+1))); beyond, −∂Q/∂a, the derivative carried through
    Lentz's evaluation of Q's continued fraction (Numerical Recipes'
    ``gcf``), so that neither tail is a difference of numbers near 1."""
    series = x < a + 1
    # the series, at x clamped into its branch
    xs = torch.where(series, x, torch.zeros_like(x) + 0.5)
    lxs = torch.log(xs)
    t = torch.exp(a * lxs - xs - torch.lgamma(a + 1))
    psi = torch.digamma(a + 1)
    ds = t * (lxs - psi)
    for k in range(1, _SERIES_TERMS):
        t = t * xs / (a + k)
        psi = psi + 1 / (a + k)
        term = t * (lxs - psi)
        ds = ds + term
        if _converged(k, term / ds, x.dtype):
            break
    # the continued fraction, at x clamped into its branch
    xc = torch.where(series, a + 2, x)
    tiny = torch.finfo(x.dtype).tiny / torch.finfo(x.dtype).eps
    b, db = xc + 1 - a, -1.0
    c, dc = torch.full_like(xc, 1 / tiny), torch.zeros_like(xc)
    d, dd = 1 / b, 1 / (b * b)
    h, dh = d, dd
    for i in range(1, _CF_ITERS):
        an, dan = -i * (i - a), float(i)
        b = b + 2
        d, dd = an * d + b, dan * d + an * dd + db
        d = torch.where(d.abs() < tiny, tiny, d)
        c, dc = b + an / c, db + (dan * c - an * dc) / (c * c)
        c = torch.where(c.abs() < tiny, tiny, c)
        d, dd = 1 / d, -dd / (d * d)
        dl, ddl = d * c, dd * c + d * dc
        h, dh = h * dl, dh * dl + h * ddl
        if _converged(i, (dl - 1) + ddl / dh, x.dtype):
            break
    lpre = a * torch.log(xc) - xc - torch.lgamma(a)
    dq = torch.exp(lpre) * ((torch.log(xc) - torch.digamma(a)) * h + dh)
    return torch.where(series, ds, -dq)


class _GammaIncInv(torch.autograd.Function):
    """x(a, y) with F(a, x) = y, F = P (``upper=False``) or Q; the
    implicit-function derivatives dx = (dy − ∂F/∂a da) / (∂F/∂x)."""

    @staticmethod
    def forward(ctx, a, y, upper):
        x = (_gammainccinv_newton if upper else _gammaincinv_newton)(a, y)
        ctx.upper = upper
        ctx.save_for_backward(a, x)
        ctx.save_for_forward(a, x)
        return x

    @staticmethod
    def _partials(ctx):
        a, x = ctx.saved_tensors
        sign = -1 if ctx.upper else 1
        inv = sign / _dgammainc_dx(a, x)
        return inv, sign * _dgammainc_da(a.detach(), x.detach())

    @staticmethod
    def backward(ctx, g):
        inv, dfda = _GammaIncInv._partials(ctx)
        return -g * inv * dfda, g * inv, None

    @staticmethod
    def jvp(ctx, at, yt, _):
        inv, dfda = _GammaIncInv._partials(ctx)
        out = 0
        if yt is not None:
            out = out + inv * yt
        if at is not None:
            out = out - inv * dfda * at
        return out


def gammaincinv(a, y):
    """x with P(a, x) = y (regularized lower incomplete gamma inverse)."""
    a, y = _floats(a, y)
    return _GammaIncInv.apply(a, y, False)


def gammainccinv(a, y):
    """x with Q(a, x) = y (regularized upper incomplete gamma inverse)."""
    a, y = _floats(a, y)
    return _GammaIncInv.apply(a, y, True)


def _betaln(a, b):
    return torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)


def _betacf(a, b, x):
    """The continued fraction of I_x(a, b) (DLMF 8.17.22) by Lentz's
    method, as Numerical Recipes' ``betacf``; converges fast for
    x < (a + 1)/(a + b + 2)."""
    tiny = torch.finfo(x.dtype).tiny / torch.finfo(x.dtype).eps

    def floor(v):
        return torch.where(v.abs() < tiny, tiny, v)

    qab, qap, qam = a + b, a + 1, a - 1
    c = torch.ones_like(x)
    d = 1 / floor(1 - qab * x / qap)
    h = d
    for m in range(1, _CF_ITERS):
        m2 = 2 * m
        aa = m * (b - m) * x / ((qam + m2) * (a + m2))
        d = 1 / floor(1 + aa * d)
        c = floor(1 + aa / c)
        h = h * d * c
        aa = -(a + m) * (qab + m) * x / ((a + m2) * (qap + m2))
        d = 1 / floor(1 + aa * d)
        c = floor(1 + aa / c)
        h = h * d * c
        if _converged(m, d * c - 1, x.dtype):
            break
    return h


def _betainc(a, b, x):
    """The regularized incomplete beta I_x(a, b), by the continued
    fraction of x or, past its fast region, of 1 − x (I_x(a, b) = 1 −
    I_{1−x}(b, a))."""
    lnB = _betaln(a, b)
    xs = torch.clamp(x, 0, 1)
    front = torch.exp(a * torch.log(xs) + b * torch.log1p(-xs) - lnB)
    direct = xs < (a + 1) / (a + b + 2)
    xd = torch.where(direct, xs, 0.0)
    xr = torch.where(direct, 0.0, 1 - xs)
    low = front * _betacf(a, b, xd) / a
    high = 1 - front * _betacf(b, a, xr) / b
    out = torch.where(direct, low, high)
    return torch.where(xs <= 0, 0.0, torch.where(xs >= 1, 1.0, out))


class _BetaIncInv(torch.autograd.Function):

    @staticmethod
    def forward(ctx, a, b, y):
        yc = torch.clamp(y, 1e-300, 1 - 1e-16)
        lnB = _betaln(a, b)
        # initial guess: mean, refined toward the tails by the power-law
        # approximations I_x ≈ x^a/(a B) (x→0), 1−I_x ≈ (1−x)^b/(b B)
        # (x→1)
        t_small = (torch.log(yc) + lnB + torch.log(a)) / a      # log x
        t_large = (torch.log1p(-yc) + lnB + torch.log(b)) / b   # log(1-x)
        x0 = torch.where(
            yc < 0.1, torch.exp(t_small),
            torch.where(yc > 0.9, 1 - torch.exp(t_large), a / (a + b)))
        x0 = torch.clamp(x0, 1e-15, 1 - 1e-15)
        # Newton in t = logit(x)
        t = torch.log(x0) - torch.log1p(-x0)
        for _ in range(_NEWTON_ITERS + 20):
            x = torch.sigmoid(t)
            f = _betainc(a, b, x) - yc
            # dI/dt = pdf(x)·x(1−x) = exp(a log x + b log(1−x) − lnB)
            dfdt = torch.exp(a * torch.log(x) + b * torch.log1p(-x) - lnB)
            step = f / torch.clamp(dfdt, min=1e-300)
            t = t - torch.clamp(step, -4.0, 4.0)
        x = torch.sigmoid(t)
        ctx.save_for_backward(a, b, x)
        ctx.save_for_forward(a, b, x)
        return x

    @staticmethod
    def _didx(ctx):
        a, b, x = ctx.saved_tensors
        return torch.exp((a - 1) * torch.log(x) + (b - 1) * torch.log1p(-x)
                         - _betaln(a, b))

    @staticmethod
    def backward(ctx, g):
        return None, None, g / _BetaIncInv._didx(ctx)

    @staticmethod
    def jvp(ctx, at, bt, yt):
        return yt / _BetaIncInv._didx(ctx)


def betaincinv(a, b, y):
    """x with I_x(a, b) = y (regularized incomplete beta inverse).
    Differentiable in y only (like the reference)."""
    a, b, y = _floats(a, b, y)
    return _BetaIncInv.apply(a.detach(), b.detach(), y)
