"""Tiled Gram-matrix evaluators for isotropic kernels (kernels C and E)
and their fused backward passes.

Counterpart of ``lsqfitgp_tpu/ops/_gram.py`` (``gram``, ``gram_sym``).
The Gram

    K[i, j] = k(‖x_i − y_j‖²) (+ noise if i == j)

is evaluated by the hand-written CUDA kernels of ``csrc/gram.cu`` for
CUDA tensors and by their plain PyTorch versions, `gram_plain` and
`gram_sym_plain`, for CPU tensors.  Kernel C (`gram`) replaces
``lsqfitgp_tpu/ops/_gram.py::_gram_kernel``; kernel E (`gram_sym`, y =
x) replaces ``_gram_sym_kernel``: it evaluates the upper-triangle tile
pairs only and writes each tile and its mirror, half the profile
evaluations of C.  On the H100 both are bound by writing the output;
each thread writes 16 bytes of a row at once, and the ragged edge is
masked instead of padding the points.  Both evaluate an entry by the
same expression, so they write identical matrices.

The profile.  A Pallas kernel traces any profile callable; a CUDA
kernel cannot, so a profile is chosen from a registry, `PROFILES`,
whose ids match the device code (``csrc/profiles.cuh``), and the
kernels evaluate a description of the JAX package's
``kernelalg/_fastgram.py::build_profile`` profiles: a `Term` (a
registered core, its distance mode 'squared', 'abs' (√r² clamped at
tiny) or 'posabs' (√(r² + eps²)), its static integer, its arguments,
an optional scale applied to r² and its post chain of scalar ``('mul',
a)`` / ``('add', c)`` steps), or a `Terms` sum of such terms (up to
`MAXTERMS` in all) with a post chain of its own.  A profile given by
name is one 'squared' term without arguments.  The numbers (arguments,
scales, chains, the nugget) are the parameter vector of the public
functions, in the order of `_flat`; `_fold` maps it, differentiably,
to the kernels' folded vector (``csrc/profiles.cuh``: the constant b,
the diagonal term, and per term its coefficient c, r² factor w and two
arguments), which stays on the device, so every number of the
description is differentiable.

Differentiation replaces the JAX ``_gram_d_jvp`` (and
``_gram_sym_d_jvp``) rules with `torch.autograd.Function`s of the
points and the folded vector, whose backward, `gram_backward`
(`gram_sym_backward`), is one more kernel of ``csrc/gram.cu`` on CUDA
tensors: it reads the output gradient ``G`` once, recomputes each
entry's profile and its r²-derivative, and sums what the gradients
need, with ``Wr = dK/dr²`` (zero at r² = 0) and ``C = G ∘ Wr``: ``dX =
2 Σ_j C_ij (x_i − y_j)``, ``dY = −2 Σ_i C_ij (x_i − y_j)``, and the
gradient of ⟨G, K⟩ with respect to the folded vector: the sum of G, its
trace, and per term the sums of G times K's partial derivatives in c,
w and the two arguments (the JAX rule's ``_elemgrad_pk``), from which
autograd forms the gradient of every number of the description.  Each
kernel block writes its partial sums to its own slots of a small
scratch buffer, summed here over the slots: no atomics, so the gradient
is the same to the bit from run to run, and no n × m buffer.  The
symmetric version contracts ``G + Gᵀ`` (both of K's arguments are x)
and reads the mirrored tiles of ``G`` in the same pass.  The plain
versions, `gram_backward_plain` and `gram_sym_backward_plain`, evaluate
``Wr`` and the partial derivatives as whole matrices and contract them
in plain torch; CPU tensors take them.

Second-order and forward-mode derivatives run on four more kernels.
Kernel C′ (`gram_jvp`, E′ `gram_sym_jvp`) is the forward direction of
``_gram_d_jvp``, fused into one pass: the tangent Gram

    dK = (dK/dr²) dr² + Σ_k (∂K/∂θ_k) dθ_k (+ dnoise·I),
    dr² = 2 (x_i − y_j)·(dx_i − dy_j),

with the weight of dr² zero at r² = 0, over every parameter θ_k of the
folded vector.  It is `_Gram.jvp` (torch forward AD) and, since the
backward is linear in G with transpose J_K, the G-cotangent of the
backward's own backward.  Kernel C″ (`gram_backward_jvp`, E″
`gram_sym_backward_jvp`) is the tangent of C's backward at a fixed G
for a one-term description, the counterpart of JAX's second
differentiation of the ``_elemgrad_*`` Pallas calls: with g, g' and g''
per entry it sums ``G ((dα g' + α g'' dr²)(x_i − y_j) + α g' (dx_i −
dy_j))`` over rows and columns, and ``Σ G g' dr²``, into the backward's
per-block slots (no atomics, the same bits in two calls), α the term's
coefficient.  Under ``create_graph`` the Functions' backward is itself
a Function (`_GramBackward`, `_GramSymBackward`) whose backward sends
the cotangent of G through C′ (E′) and those of the points and α
through C″ (E″): the backward's Hessian is symmetric, so its transpose
is its tangent.  That route needs a single term whose scale and
arguments carry no gradient (the points and the chain's scalars do):
the host decides it from the description (`_fast_second`).  Any other
description (a term sum, a dynamic argument or scale) takes its second
derivatives on the host from the plain backward, differentiated by
autograd: C″ and E″ have no mixed derivatives in the profile's
parameters.  Without ``create_graph`` the first-order path is
unchanged.  A third derivative raises.
"""

from __future__ import annotations

import collections
import math

import torch

from . import _build
from ._syrk import _device_kind, _ptr, _stream, _suffix

__all__ = ['gram', 'gram_plain', 'gram_sym', 'gram_sym_plain',
           'gram_backward', 'gram_backward_plain', 'gram_sym_backward',
           'gram_sym_backward_plain', 'gram_jvp', 'gram_jvp_plain',
           'gram_sym_jvp', 'gram_sym_jvp_plain', 'gram_backward_jvp',
           'gram_backward_jvp_plain', 'gram_sym_backward_jvp',
           'gram_sym_backward_jvp_plain', 'Profile', 'PROFILES', 'Term',
           'Terms', 'MAXTERMS', 'MATERNP_MAX', 'k0', 'map_scalars']

# the device code's limits (csrc/profiles.cuh): terms of a sum, and the
# largest Maternp order of its coefficient table
MAXTERMS, MATERNP_MAX = 4, 16

Profile = collections.namedtuple('Profile', ['name', 'id', 'value', 'deriv',
                                             'deriv2', 'dargs'])
Profile.__doc__ = """A registered profile: ``id`` is its number in
``csrc/profiles.cuh`` (PROFILE_*); ``value``, ``deriv`` and ``deriv2``
are the plain torch core g(t), g'(t) and g''(t) of its own argument t,
``dargs`` its derivatives in its two arguments ``(∂g/∂a, ∂g/∂b)``
(None where it takes none), each a function ``f(t, k, a, b)`` with k
the static integer (Maternp's p, Wendland's k) and a, b 0-d tensors."""

Term = collections.namedtuple(
    'Term', ['profile', 'mode', 'k', 'args', 'scale', 'post'],
    defaults=('squared', 0, (), None, ()))
Term.__doc__ = """One profiled kernel: ``post(g(mode(r² / scale²)))``,
``profile`` a `Profile` (or its name), ``mode`` 'squared', 'abs' or
'posabs', ``k`` the static integer, ``args`` the core's arguments (up
to 2 numbers or 0-d tensors), ``scale`` None or a scalar, ``post`` a
chain of ('mul' | 'add', scalar) steps."""

Terms = collections.namedtuple('Terms', ['terms', 'post'], defaults=((),))
Terms.__doc__ = """A sum of `Term`s (or nested `Terms`) followed by the
post chain ``post``."""

_MODES = {'squared': 0, 'abs': 1, 'posabs': 2}
_NPAR = 4   # folded parameters per term: c, w, a, b


# -- the registered profiles, plain versions ------------------------------------

def _tiny(t):
    return torch.finfo(t.dtype).tiny


def _exp_neg(t, k, a, b):
    return torch.exp(-t)


def _neg_exp_neg(t, k, a, b):
    return -torch.exp(-t)


def _mp(x2, p):
    from ..special import kvmodx2_hi
    return kvmodx2_hi(x2, p)


def _maternp_value(t, k, a, b):
    return _mp((2 * k + 1) * t, k)


def _maternp_deriv(t, k, a, b):
    s = 2 * k + 1
    if k >= 1:
        return -s * _mp(s * t, k - 1) / (2 * (2 * k - 1))
    from ..special._bessel import _expon_deriv
    return _expon_deriv(t)


def _maternp_deriv2(t, k, a, b):
    s = 2 * k + 1
    x2 = s * t
    if k >= 2:
        return s * s * _mp(x2, k - 2) / (4 * (2 * k - 1) * (2 * k - 3))
    xc = torch.sqrt(torch.clamp(x2, min=_tiny(x2)))
    ec = torch.exp(-xc)
    if k == 1:
        return s * s * ec / (4 * xc)
    return torch.where(x2 > _tiny(x2), ec * (xc + 1) / (4 * xc ** 3),
                       torch.zeros_like(x2))


def _gammaexp_parts(t, a):
    """(γ == 2, g, s, log(t + tiny)) of GammaExp's non-smooth branch."""
    tt = t + _tiny(t)
    s = tt ** (a / 2)
    return a == 2, torch.exp(-s), s, torch.log(tt)


def _gammaexp_value(t, k, a, b):
    is2, g, _, _ = _gammaexp_parts(t, a)
    return torch.where(is2, torch.exp(-t), g)


def _gammaexp_d1(t, a):
    is2, g, s, _ = _gammaexp_parts(t, a)
    return is2, torch.where(is2, -torch.exp(-t), -g * (a / 2) * s / (t + _tiny(t)))


def _gammaexp_deriv(t, k, a, b):
    return _gammaexp_d1(t, a)[1]


def _gammaexp_deriv2(t, k, a, b):
    is2, g1 = _gammaexp_d1(t, a)
    _, _, s, _ = _gammaexp_parts(t, a)
    h = a / 2
    return torch.where(is2, torch.exp(-t),
                       -g1 * (h * s - (h - 1)) / (t + _tiny(t)))


def _gammaexp_dargs(t, k, a, b):
    is2, g, s, ls = _gammaexp_parts(t, a)
    return torch.where(is2, torch.zeros_like(t), -g * s * ls / 2), None


def _cauchy_parts(t, a, b):
    """(g, P, P_t, P_tt, P_a, B, log B) of the generalized Cauchy core,
    P = r^α (r² at α == 2), B = 1 + P/β."""
    is2 = a == 2
    tt = t + _tiny(t)
    h = a / 2
    Pn = tt ** h
    P = torch.where(is2, t, Pn)
    Pt = torch.where(is2, torch.ones_like(t), h * Pn / tt)
    Ptt = torch.where(is2, torch.zeros_like(t), (h - 1) * h * Pn / tt / tt)
    Pa = torch.where(is2, torch.zeros_like(t), Pn * torch.log(tt) / 2)
    B = 1 + P / b
    return B ** (-b / a), P, Pt, Ptt, Pa, B, torch.log1p(P / b)


def _cauchy_value(t, k, a, b):
    return _cauchy_parts(t, a, b)[0]


def _cauchy_deriv(t, k, a, b):
    g, _, Pt, _, _, B, _ = _cauchy_parts(t, a, b)
    return -g * Pt / (a * B)


def _cauchy_deriv2(t, k, a, b):
    g, _, Pt, Ptt, _, B, _ = _cauchy_parts(t, a, b)
    g1 = -g * Pt / (a * B)
    return -(g1 * Pt / B + g * Ptt / B - g * Pt * Pt / (b * B * B)) / a


def _cauchy_dargs(t, k, a, b):
    g, P, _, _, Pa, B, lB = _cauchy_parts(t, a, b)
    return (g * (b / (a * a) * lB - Pa / (a * B)),
            g * (P / (b * B) - lB) / a)


def _cauchy2_value(t, k, a, b):
    return (1 + t / a) ** (-a / 2)


def _cauchy2_deriv(t, k, a, b):
    return -0.5 * _cauchy2_value(t, k, a, b) / (1 + t / a)


def _cauchy2_deriv2(t, k, a, b):
    g = _cauchy2_value(t, k, a, b)
    B = 1 + t / a
    return -0.5 * (-0.5 * g / B / B - g / (a * B * B))


def _cauchy2_dargs(t, k, a, b):
    g = _cauchy2_value(t, k, a, b)
    B = 1 + t / a
    return 0.5 * g * (t / (a * B) - torch.log1p(t / a)), None


def _expquad(c):
    return lambda t, k, a, b: c * torch.exp(-0.5 * t)


# -- the 1-D time-series and compact-support cores (each a function of t
# that returns (g, g', g'', ∂g/∂a, ∂g/∂b), None where the core takes no
# such argument; `_parts` splits it into a Profile's four functions) -----

def _parts(pid, name, fn, nargs):
    def pick(i):
        return lambda t, k, a, b: fn(t, k, a, b)[i]

    dargs = None if nargs == 0 else \
        (lambda t, k, a, b: fn(t, k, a, b)[3:])
    return Profile(name, pid, pick(0), pick(1), pick(2), dargs)


def _periodic(t, k, a, b):
    # exp(-2 sin²(t/2) / a²), a the outer scale
    h = torch.sin(t / 2)
    g = torch.exp(-2 * h * h / (a * a))
    s = torch.sin(t)
    return (g, -g * s / (a * a), g * (s * s / a ** 4 - torch.cos(t) / (a * a)),
            g * 4 * h * h / a ** 3, None)


def _holeeffect(t, k, a, b):
    e = torch.exp(-t)
    return (1 - t) * e, (t - 2) * e, (3 - t) * e, None, None


def _causalexpquad(t, k, a, b):
    # erfc(α t / 4) exp(-t²/2), α = a
    c = a / 4
    E = torch.exp(-0.5 * t * t)
    g = torch.special.erfc(c * t) * E
    d = 2 / math.sqrt(math.pi) * torch.exp(-c * c * t * t) * E
    g1 = -c * d - t * g
    g2 = c * d * t * (2 * c * c + 1) - g - t * g1
    return g, g1, g2, -t * d / 4, None


# below these arguments the series of Log's and Sinc's cores, whose
# closed forms cancel near 0; their terms
LOG_SERIES, LOG_TERMS = 0.1, 20
SINC_SERIES, SINC_TERMS = 1.0, 10


def _log(t, k, a, b):
    # log1p(t) / t; the series Σ (−t)^j / (j + 1) below LOG_SERIES
    ts = torch.clamp(t, max=LOG_SERIES)
    s0 = s1 = s2 = torch.zeros_like(t)
    for j in range(LOG_TERMS, -1, -1):
        c = (-1) ** j / (j + 1)
        s0 = s0 * ts + c
        if j >= 1:
            s1 = s1 * ts + c * j
        if j >= 2:
            s2 = s2 * ts + c * j * (j - 1)
    tc = torch.clamp(t, min=LOG_SERIES)
    L = torch.log1p(tc)
    u = 1 / (1 + tc)
    g = L / tc
    g1 = (tc * u - L) / (tc * tc)
    g2 = 2 * L / tc ** 3 - 2 * u / (tc * tc) - u * u / tc
    small = t < LOG_SERIES
    return (torch.where(small, s0, g), torch.where(small, s1, g1),
            torch.where(small, s2, g2), None, None)


# Wendland's polynomial: the coefficient of t^(k − j) is a polynomial in
# ν = k + α, highest power first (lsqfitgp_tpu/kernels/_wendland.py)
WENDLAND_POLY = {
    0: [[1]],
    1: [[1, 1], [1]],
    2: [[1 / 3, 4 / 3, 1], [1, 2], [1]],
    3: [[1 / 15, 3 / 5, 23 / 15, 1], [2 / 5, 12 / 5, 3], [1, 3], [1]],
}


def _polyval(coef, x):
    """Σ coef[i] x^(deg − i) by Horner, for numbers or tensors."""
    out = 0
    for c in coef:
        out = out * x + c
    return out


def _polyder(coef):
    n = len(coef) - 1
    return [c * (n - i) for i, c in enumerate(coef[:-1])] or [0]


def _wendland(t, k, a, b):
    # (1 − t)_+^(ν + k) P(t), ν = k + α, P's coefficients polynomials in ν
    nu = k + a
    e = nu + k
    cs = [_polyval(pj, nu) for pj in WENDLAND_POLY[k]]
    dcs = [_polyval(_polyder(pj), nu) for pj in WENDLAND_POLY[k]]
    P = _polyval(cs, t)
    P1 = _polyval(_polyder(cs), t)
    P2 = _polyval(_polyder(_polyder(cs)), t)
    Pa = _polyval(dcs, t)
    inside = t < 1
    w = torch.where(inside, 1 - t, torch.ones_like(t))
    L = torch.log(w)
    we = torch.exp(e * L)
    we1 = torch.exp((e - 1) * L)
    we2 = torch.exp((e - 2) * L)
    zero = torch.zeros_like(t)
    g = we * P
    g1 = we1 * (w * P1 - e * P)
    g2 = e * (e - 1) * we2 * P - 2 * e * we1 * P1 + we * P2
    ga = we * (L * P + Pa)
    return (torch.where(inside, g, zero), torch.where(inside, g1, zero),
            torch.where(inside, g2, zero), torch.where(inside, ga, zero),
            None)


def _circular(t, k, a, b):
    # (1 + τ s/c)(1 − s/c)_+^τ, s the distance to the nearest integer of
    # t (period 1), τ = a, c = b
    x = torch.remainder(t, 1.0)
    sg = torch.where(x <= 0.5, torch.ones_like(x), -torch.ones_like(x))
    s = torch.minimum(x, 1 - x)
    q = 1 - s / b
    inside = q > 0
    qs = torch.where(inside, q, torch.ones_like(q))
    lq = torch.log(qs)
    qt = torch.exp(a * lq)
    qt1 = torch.exp((a - 1) * lq)
    qt2 = torch.exp((a - 2) * lq)
    f = a * (a + 1) / (b * b)
    zero = torch.zeros_like(t)
    g = (1 + a * s / b) * qt
    g1 = -sg * f * s * qt1
    g2 = -f * (qt1 - (a - 1) * s / b * qt2)
    ga = s / b * qt + (1 + a * s / b) * qt * lq
    gb = f * s * s / b * qt1
    return tuple(torch.where(inside, v, zero) for v in (g, g1, g2, ga, gb))


def _celerite(t, k, a, b):
    # exp(−γ t)(cos t + B sin t), γ = a, B = b
    E = torch.exp(-a * t)
    C, S = torch.cos(t), torch.sin(t)
    g = E * (C + b * S)
    g1 = E * ((b - a) * C - (1 + a * b) * S)
    g2 = E * ((a * a - 2 * a * b - 1) * C + (2 * a + a * a * b - b) * S)
    return g, g1, g2, -t * g, E * S


def _harmonic(t, k, a, b):
    """The damped oscillator, Q = a: within √eps of Q = 1 the
    Matérn-3/2 form of ``_harmonic_q1``; below, e^{-s}(cosh ηs + sinh
    ηs / η) and above, e^{-s}(cos ηs + sin ηs / η), s = t/Q, η =
    √|1 − Q²|, the JAX package's functions.  Below 1 the hyperbolic
    functions are taken as e^{-(1-η)s} and expm1(−2ηs), which cannot
    overflow at large s (the JAX expression's cosh does, and gives
    inf·0 = nan there)."""
    eps = torch.finfo(t.dtype).eps
    rt = math.sqrt(eps)
    # the branches at clamped Q, so that each is finite where another is
    # taken
    x = t / a
    e = torch.exp(-x)
    T = t * t * (1 + t / 3)
    P = (1 - a) * T
    P1 = (1 - a) * (2 * t + t * t)
    P2 = (1 - a) * (2 + 2 * t)
    q1 = ((1 + x) * e + e * P,
          -x * e / a + e * (P1 - P / a),
          (x - 1) * e / (a * a) + e * (P / (a * a) - 2 * P1 / a + P2),
          x * e * t / (a * a) + e * T * ((1 - a) * t / (a * a) - 1))
    ql = torch.clamp(a, max=1 - rt)
    eta = torch.sqrt((1 - ql) * (1 + ql))
    s = t / ql
    A = torch.exp(-ql * ql / (1 + eta) * s)
    m = torch.expm1(-2 * eta * s)
    C, S = A * (2 + m) / 2, -A * m / 2
    lo = _harmonic_branch(C, S, eta, s, ql, -ql / eta)
    qh = torch.clamp(a, min=1 + rt)
    eta = torch.sqrt((qh - 1) * (qh + 1))
    s = t / qh
    e = torch.exp(-s)
    C, S = e * torch.cos(eta * s), e * torch.sin(eta * s)
    hi = _harmonic_branch(C, -S, eta, s, qh, qh / eta, sgn=-1)
    near1 = (a - 1).abs() < rt
    out = tuple(torch.where(near1, u, torch.where(a < 1, v, w))
                for u, v, w in zip(q1, lo, hi))
    return out + (None,)


def _harmonic_branch(C, S, eta, s, Q, deta, sgn=1):
    """(g, g', g'', ∂g/∂Q) of g = C + S'/η with C = e^{-s} cosh ηs (cos
    ηs), S' = e^{-s} sinh ηs (sin ηs) and sgn = 1 (−1), given C and
    sgn·S'; ``deta`` = dη/dQ."""
    Sp = sgn * S
    g = C + Sp / eta
    gs = -g + C + eta * S
    gss = -gs - Q * Q * C
    geta = s * S + s * C / eta - Sp / (eta * eta)
    return g, gs / Q, gss / (Q * Q), gs * (-s / Q) + geta * deta


def _cos(t, k, a, b):
    c = torch.cos(t)
    return c, -torch.sin(t), -c, None, None


def _sinc(t, k, a, b):
    # sin(πt)/(πt); the series Σ (−1)^j x^{2j}/(2j + 1)! in x = πt below
    # SINC_SERIES
    x = math.pi * t
    xs = torch.clamp(x, max=SINC_SERIES)
    z = xs * xs
    s0 = s1 = s2 = torch.zeros_like(t)
    for j in range(SINC_TERMS, -1, -1):
        c = (-1) ** j / math.factorial(2 * j + 1)
        s0 = s0 * z + c
        if j >= 1:
            s1 = s1 * z + c * 2 * j
            s2 = s2 * z + c * 2 * j * (2 * j - 1)
    s1 = s1 * xs   # the odd series: x^{2j−1}
    xc = torch.clamp(x, min=SINC_SERIES)
    sn, cs = torch.sin(xc), torch.cos(xc)
    f = sn / xc
    f1 = (xc * cs - sn) / (xc * xc)
    f2 = -f - 2 * f1 / xc
    small = x < SINC_SERIES
    pi = math.pi
    return (torch.where(small, s0, f), pi * torch.where(small, s1, f1),
            pi * pi * torch.where(small, s2, f2), None, None)


# StationaryFracBrownian: from SFB_SERIES on, the profile sums its
# binomial series, SFB_TERMS[dtype] terms (the JAX expression's three
# powers of about t^2H cancel to a value of about t^(2H−2))
SFB_SERIES = 2.0
SFB_TERMS = {torch.float32: 14, torch.float64: 30}


def _sfb_parts(t, a, parts):
    """The requested ``parts`` of (g, g', g'', ∂g/∂H) of ½(|t+1|^α +
    |t−1|^α − 2t^α), α = 2H, H = a: below SFB_SERIES as written (a zero
    base has no H-derivative, as torch.pow's and lax.pow's rules), above
    it t^α Σ_{j≥1} C(α, 2j) t^{−2j} and the t- and H-derivatives of the
    same sums (C(α, m) and its α-derivative by their product
    recurrence); None for a part not asked."""
    al = 2 * a
    one = torch.ones_like(t)
    # below the switch: (exponent, coefficient, sign) of each part
    tl = torch.clamp(t, max=SFB_SERIES)
    sg = torch.where(tl >= 1, one, -one)
    lo = [0, 0, 0, 0]
    for base, w, s1 in ((tl + 1, 0.5, 1), ((tl - 1).abs(), 0.5, sg),
                        (tl, -1.0, 1)):
        if 0 in parts:
            lo[0] = lo[0] + w * base ** al
        if 1 in parts:
            lo[1] = lo[1] + w * s1 * al * base ** (al - 1)
        if 2 in parts:
            lo[2] = lo[2] + w * al * (al - 1) * base ** (al - 2)
        if 3 in parts:
            pos = base > 0
            lb = torch.log(torch.where(pos, base, one))
            lo[3] = lo[3] + 2 * w * torch.where(pos, lb * base ** al, 0 * one)
    # the series
    th = torch.clamp(t, min=SFB_SERIES)
    z = 1 / (th * th)
    c, dc, zj = 1.0, 0.0, one
    sums = [0, 0, 0, 0]
    for j in range(1, SFB_TERMS[t.dtype] + 1):
        for i in (2 * j - 2, 2 * j - 1):
            c, dc = c * (al - i) / (i + 1), (dc * (al - i) + c) / (i + 1)
        zj = zj * z
        m = al - 2 * j
        if 0 in parts or 3 in parts:
            sums[0] = sums[0] + c * zj
        if 1 in parts:
            sums[1] = sums[1] + c * m * zj
        if 2 in parts:
            sums[2] = sums[2] + c * m * (m - 1) * zj
        if 3 in parts:
            sums[3] = sums[3] + dc * zj
    lt = torch.log(th)
    P = torch.exp(al * lt)
    hi = (lambda: P * sums[0], lambda: P / th * sums[1],
          lambda: P / (th * th) * sums[2],
          lambda: 2 * P * (sums[3] + lt * sums[0]))
    small = t < SFB_SERIES
    return tuple(torch.where(small, lo[i], hi[i]()) if i in parts else None
                 for i in range(4))


def _sfb_profile():
    """The 'sfb' profile: each of its functions computes its own part."""
    def part(i):
        return lambda t, k, a, b: _sfb_parts(t, a, (i,))[i]

    return Profile('sfb', 17, part(0), part(1), part(2),
                   lambda t, k, a, b: (_sfb_parts(t, a, (3,))[3], None))


def _matern_parts(t, a, j):
    """The j-th t-derivative of the Matérn profile of real order ν = a
    (static) in t = r²: s^j f_ν^{(j)}(s t), s = 2ν (2 at ν = 0), f_ν =
    2^{1−ν}/Γ(ν) x^ν K_ν(x) as a function of x² (``special.kvmodx2``,
    whose autograd rule is the exact recurrence); its x²-derivatives by
    the recurrences f_ν' = −f_{ν−1}/(4(ν−1)) (ν > 1) and f_ν'' =
    f_{ν−2}/(16(ν−1)(ν−2)) (ν > 2), regular at 0, else by the
    quadrature's raw forms (singular at zero distance)."""
    from ..special import _kv
    nu = float(a.detach())
    s = 2 * nu if nu else 2.0
    x2 = s * t
    if j == 0:
        return _kv.kvmodx2(nu, x2)
    if nu > j:
        # (−¼)^j f_{ν−j} / ((ν−1) … (ν−j))
        den = math.prod(nu - i for i in range(1, j + 1))
        f = (-0.25) ** j * _kv.kvmodx2(nu - j, x2) / den
    else:
        f = _kv._kvmodx2_raw(nu, x2, j)
    return s ** j * f


def _bessel_parts(t, a, j):
    """The j-th t-derivative of the Bessel profile of order ν = a
    (static) in t = r²: s^j f_ν^{(j)}(s t), s = (2 + ν/2)², f_ν =
    Γ(ν+1)(2/x)^ν J_ν(x) as a function of x² (``special.jvmodx2``),
    f_ν^{(j)} = (−¼)^j f_{ν+j} / ((ν+1) … (ν+j))."""
    from ..special import _kv
    nu = float(a.detach())
    s = (2 + nu / 2) ** 2
    den = math.prod(nu + i for i in range(1, j + 1))
    return s ** j * (-0.25) ** j * _kv.jvmodx2(nu + j, s * t) / den


def _order_profile(name, pid, parts):
    """A profile of static order (the argument a, no gradient) whose
    j-th derivative is ``parts(t, a, j)``."""
    def part(j):
        return lambda t, k, a, b: parts(t, a, j)

    return Profile(name, pid, part(0), part(1), part(2), None)


def _pink(t, k, a, b):
    """(Ci(t u) − Ci(t)) / log1p(δω), u = 1 + δω, δω = a; below t δω <
    √eps, cos(t m), m = 1 + δω/2, as the JAX core.  Its derivatives in
    closed form, cos(tu) − cos t as −2 sin(t m) sin(t δω/2), which does
    not cancel."""
    from ..special import ci
    u, m, h = 1 + a, 1 + a / 2, a / 2
    L = torch.log1p(a)
    sm, cm = torch.sin(t * m), torch.cos(t * m)
    stu, ctu = torch.sin(t * u), torch.cos(t * u)
    A = -2 * sm * torch.sin(t * h)
    g = (ci(t * u) - ci(t)) / L
    g1 = A / (t * L)
    g2 = ((torch.sin(t) - u * stu) / t - A / (t * t)) / L
    ga = (ctu - g) / (u * L)
    small = t * a < math.sqrt(torch.finfo(t.dtype).eps)
    lo = (cm, -m * sm, -m * m * cm, -t / 2 * sm)
    return tuple(torch.where(small, v, w)
                 for v, w in zip(lo, (g, g1, g2, ga))) + (None,)


def _color(t, k, a, b):
    """(n − 1) Re E_n(−it), n = k: ``special.expn_imag_derivs``, g' =
    −(n − 1) Im E_{n−1}(−it), g'' = −(n − 1) Re E_{n−2}(−it)."""
    from ..special._expint import expn_imag_derivs
    e0, e1, e2 = expn_imag_derivs(k, t)
    return (k - 1) * e0, -(k - 1) * e1, -(k - 1) * e2, None, None


PROFILES = {
    'expquad': Profile('expquad', 0, _expquad(1.0), _expquad(-0.5),
                       _expquad(0.25), None),
    'maternp': Profile('maternp', 1, _maternp_value, _maternp_deriv,
                       _maternp_deriv2, None),
    'gammaexp': Profile('gammaexp', 2, _gammaexp_value, _gammaexp_deriv,
                        _gammaexp_deriv2, _gammaexp_dargs),
    'gammaexp2': Profile('gammaexp2', 3, _exp_neg, _neg_exp_neg, _exp_neg,
                         None),
    'cauchy': Profile('cauchy', 4, _cauchy_value, _cauchy_deriv,
                      _cauchy_deriv2, _cauchy_dargs),
    'cauchy2': Profile('cauchy2', 5, _cauchy2_value, _cauchy2_deriv,
                       _cauchy2_deriv2, _cauchy2_dargs),
    'expon': Profile('expon', 6, _exp_neg, _neg_exp_neg, _exp_neg, None),
    'periodic': _parts(7, 'periodic', _periodic, 1),
    'holeeffect': _parts(8, 'holeeffect', _holeeffect, 0),
    'causalexpquad': _parts(9, 'causalexpquad', _causalexpquad, 1),
    'log': _parts(10, 'log', _log, 0),
    'wendland': _parts(11, 'wendland', _wendland, 1),
    'circular': _parts(12, 'circular', _circular, 2),
    'celerite': _parts(13, 'celerite', _celerite, 2),
    'harmonic': _parts(14, 'harmonic', _harmonic, 1),
    'cos': _parts(15, 'cos', _cos, 0),
    'sinc': _parts(16, 'sinc', _sinc, 0),
    'sfb': _sfb_profile(),
    # the static order rides the argument slot a: no argument derivative
    'matern': _order_profile('matern', 18, _matern_parts),
    'bessel': _order_profile('bessel', 19, _bessel_parts),
    'pink': _parts(20, 'pink', _pink, 1),
    'color': _parts(21, 'color', _color, 0),
}

# the backward kernels' tiling (csrc/gram.cu): the tile edge, the rows a
# block of C's backward covers (TILE * CROWS) and the coordinates one
# launch of E's backward, C″ or E″ takes at p > 1 (PCHUNK)
_TILE, _BWD_ROWS, _PCHUNK = 64, 256, 4


# -- descriptions and the parameter vector ------------------------------------

# the structure of a description: per term (profile, mode, k, number of
# arguments, whether it has a scale, its chain's steps), nested sums as
# ('sum', children, steps); hashable, so it rides the Functions' meta
_TermSt = collections.namedtuple('_TermSt', ['profile', 'mode', 'k', 'nargs',
                                             'scaled', 'ops'])
_SumSt = collections.namedtuple('_SumSt', ['terms', 'ops'])


def _profile(profile):
    return PROFILES[profile] if isinstance(profile, str) else profile


def _desc(profile, post=()):
    """The `Terms` of ``profile`` (a name, `Profile`, `Term` or `Terms`)
    followed by the chain ``post``."""
    post = tuple(post)
    if isinstance(profile, Terms):
        return profile._replace(post=tuple(profile.post) + post)
    if isinstance(profile, Term):
        return Terms((profile,), post)
    return Terms((Term(_profile(profile)),), post)


def _ops(post):
    ops = tuple(op for op, _ in post)
    for op in ops:
        if op not in ('mul', 'add'):
            raise ValueError(f'unknown post step {op!r}')
    return ops


def _struct(desc):
    """The hashable structure of a description (the numbers apart)."""
    if isinstance(desc, Terms):
        return _SumSt(tuple(_struct(t) for t in desc.terms), _ops(desc.post))
    prof = _profile(desc.profile)
    if desc.mode not in _MODES:
        raise ValueError(f'unknown distance mode {desc.mode!r}')
    if len(desc.args) > 2:
        raise ValueError('a profile takes at most 2 arguments')
    return _TermSt(prof, desc.mode, int(desc.k), len(desc.args),
                   desc.scale is not None, _ops(desc.post))


def _flat(desc):
    """The numbers of a description in the parameter vector's order: per
    term its arguments, its scale, its chain; a sum's terms, then its
    chain."""
    if isinstance(desc, Terms):
        out = [v for t in desc.terms for v in _flat(t)]
    else:
        out = list(desc.args)
        if desc.scale is not None:
            out.append(desc.scale)
    return out + [v for _, v in desc.post]


def _rebuild(st, vals):
    """The description of structure ``st`` with the numbers ``vals`` (an
    iterator, consumed in `_flat`'s order)."""
    vals = iter(vals)

    def build(s):
        if isinstance(s, _SumSt):
            terms = tuple(build(t) for t in s.terms)
            return Terms(terms, tuple((op, next(vals)) for op in s.ops))
        args = tuple(next(vals) for _ in range(s.nargs))
        scale = next(vals) if s.scaled else None
        return Term(s.profile, s.mode, s.k, args, scale,
                    tuple((op, next(vals)) for op in s.ops))

    return build(st)


def map_scalars(desc, fn):
    """The description with ``fn`` applied to each of its numbers."""
    return _rebuild(_struct(desc), map(fn, _flat(desc)))


def _leaves(st):
    """The terms of a structure, depth first."""
    if isinstance(st, _SumSt):
        return [t for s in st.terms for t in _leaves(s)]
    return [st]


# the entry points' infix per evaluator: ZooSpecial's kernels are built
# apart (csrc/gram_special.cu)
_SPECIAL_SUFFIX = {0: '', 1: '', 2: '_zs'}
# the first id of the special-function cores, which only ZooSpecial
# evaluates (csrc/profiles.cuh PROFILE_SFB)
_FIRST_SPECIAL = 17


def _codes(st):
    """(term count, packed codes, evaluator) for the kernels: term t's
    code id | mode << 5 | k << 7 at bit 16 t; the evaluator 0 for a
    single unscaled ExpQuad term (FixedExpQuad), 2 for a list with a
    special-function core (ZooSpecial), 1 otherwise (Zoo)."""
    terms = _leaves(st)
    if not 1 <= len(terms) <= MAXTERMS:
        raise ValueError(f'the kernels take 1 to {MAXTERMS} terms, not '
                         f'{len(terms)}')
    kmax = {'maternp': MATERNP_MAX, 'wendland': max(WENDLAND_POLY)}
    codes = 0
    for t, s in enumerate(terms):
        kmin = 2 if s.profile.name == 'color' else 0
        if not kmin <= s.k <= kmax.get(s.profile.name, 511):
            raise ValueError(f'static integer {s.k} out of the kernels\' '
                             f'range for {s.profile.name}')
        codes |= (s.profile.id | _MODES[s.mode] << 5 | s.k << 7) << (16 * t)
    t0 = terms[0]
    fixed = len(terms) == 1 and t0.profile.name == 'expquad' \
        and t0.mode == 'squared' and not t0.scaled
    special = any(t.profile.id >= _FIRST_SPECIAL for t in terms)
    return len(terms), codes, 0 if fixed else 2 if special else 1


def _chain(ops, vals, one, zero):
    """The chain folded to post(g) = α g + β: (α, β)."""
    a, b = one, zero
    for op, v in zip(ops, vals):
        if op == 'mul':
            a, b = a * v, b * v
        else:
            b = b + v
    return a, b


def _fold(st, pvec):
    """The kernels' folded vector from the parameter vector ``pvec``
    (`_flat`'s numbers then the nugget): [b, nugget, (c, w, a, b) per
    term], differentiable in pvec."""
    one, zero = pvec.new_ones(()), pvec.new_zeros(())
    vals = iter(pvec.unbind())

    def read(s):
        """The numbers of ``s``, in `_flat`'s order."""
        if isinstance(s, _SumSt):
            return [read(t) for t in s.terms], [next(vals) for _ in s.ops]
        args = [next(vals) for _ in range(s.nargs)]
        scale = next(vals) if s.scaled else None
        return args, scale, [next(vals) for _ in s.ops]

    terms = []

    def fold(s, nums, A):
        """Append the terms of ``s`` under the outer coefficient A;
        return its constant."""
        if isinstance(s, _SumSt):
            inner, chain = nums
            a, b = _chain(s.ops, chain, one, zero)
            const = zero
            for t, n in zip(s.terms, inner):
                const = const + fold(t, n, A * a)
            return const + A * b
        args, scale, chain = nums
        a, b = _chain(s.ops, chain, one, zero)
        w = one if scale is None else 1 / (scale * scale)
        terms.extend([A * a, w, *args, *[zero] * (2 - len(args))])
        return A * b

    nums = read(st)
    noise = next(vals)
    const = fold(st, nums, one)
    return torch.stack([const, noise, *terms])


def _paramvec(vals, x):
    return torch.stack([
        torch.as_tensor(v, dtype=x.dtype, device=x.device).reshape(())
        for v in vals])


def _fast_second(desc, st):
    """Whether C″ and E″ can take the second derivatives: one term whose
    arguments and scale (the first numbers of `_flat`) carry no
    gradient."""
    terms = _leaves(st)
    if len(terms) != 1:
        return False
    fixed = _flat(desc)[:terms[0].nargs + terms[0].scaled]
    return not any(isinstance(v, torch.Tensor) and v.requires_grad
                   for v in fixed)


def _prep(x):
    x = torch.as_tensor(x)
    if x.dim() == 1:
        x = x[:, None]
    if not x.is_floating_point():
        x = x.to(torch.get_default_dtype())
    return x.contiguous()


def _cdiv(a, b):
    return -(-a // b)


def _profile_name(st):
    """The terms' profile names joined by '+' (the launch tallies' key)."""
    return '+'.join(s.profile.name for s in _leaves(st))


def _count(fn, attr, st):
    """One launch of ``fn``'s kernel: its count ``attr`` and its count for
    the profile, ``fn.by_profile[attr, name]``, go up by one."""
    setattr(fn, attr, getattr(fn, attr) + 1)
    key = attr, _profile_name(st)
    fn.by_profile[key] = fn.by_profile.get(key, 0) + 1


# -- plain versions -----------------------------------------------------------

def _sqdist_plain(x, y):
    r2 = None
    for d in range(x.shape[1]):
        dl = x[:, d, None] - y[None, :, d]
        r2 = dl * dl if r2 is None else r2 + dl * dl
    return r2


_Eval = collections.namedtuple('_Eval', ['g', 'gu', 'guu', 'ga', 'gb'])


def _term_eval(s, u, a, b, d1=False, d2=False, da=False):
    """Term ``s`` at the scaled r² ``u``: g and, as asked, its first and
    second u-derivatives (the mode's chain rule applied) and its
    derivatives in the arguments."""
    prof, k = s.profile, s.k
    if s.mode == 'squared':
        t, pos = u, None
    elif s.mode == 'abs':
        v = torch.clamp(u, min=_tiny(u))
        t, pos = torch.sqrt(v), u > _tiny(u)
    else:
        eps = torch.finfo(u.dtype).eps
        v = u + eps * eps
        t, pos = torch.sqrt(v), None
    g = prof.value(t, k, a, b)
    g1 = prof.deriv(t, k, a, b) if d1 or d2 else None
    g2 = prof.deriv2(t, k, a, b) if d2 else None
    ga = gb = None
    if da and prof.dargs is not None:
        ga, gb = prof.dargs(t, k, a, b)
    if s.mode != 'squared':
        tu = 0.5 / t
        if d2:
            g2 = g2 * tu * tu - g1 * tu / (2 * v)
        if d1 or d2:
            g1 = g1 * tu
        if pos is not None:
            zero = torch.zeros_like(u)
            g1 = None if g1 is None else torch.where(pos, g1, zero)
            g2 = None if g2 is None else torch.where(pos, g2, zero)
    return _Eval(g, g1, g2, ga, gb)


def _terms_plain(st, fv, r2, **kw):
    """[(c, w, _Eval)] of the terms at r²."""
    out = []
    for t, s in enumerate(_leaves(st)):
        c, w, a, b = fv[2 + _NPAR * t:2 + _NPAR * (t + 1)].unbind()
        out.append((c, w, _term_eval(s, r2 * w, a, b, **kw)))
    return out


def _value_r2(st, fv, r2):
    """K without the diagonal term: b + Σ c g."""
    v = fv[0]
    for c, _, e in _terms_plain(st, fv, r2):
        v = v + c * e.g
    return v


def _dr2(st, fv, r2, evals=None):
    """dK/dr² = Σ c w g_u."""
    v = None
    for c, w, e in evals or _terms_plain(st, fv, r2, d1=True):
        t = c * w * e.gu
        v = t if v is None else v + t
    return v


def _partials(st, fv, r2, evals=None):
    """K's partial derivatives in the folded vector's entries from index
    2 on, as matrices (None where zero): per term g, c r² g_u (zero at
    r² <= 0), c ∂g/∂a, c ∂g/∂b."""
    out = []
    zero = r2.new_zeros(())
    for c, _, e in evals or _terms_plain(st, fv, r2, d1=True, da=True):
        out += [e.g, torch.where(r2 <= 0, zero, c * r2 * e.gu),
                None if e.ga is None else c * e.ga,
                None if e.gb is None else c * e.gb]
    return out


def _eval_plain(st, x, y, fv, with_noise):
    v = _value_r2(st, fv, _sqdist_plain(x, y))
    if with_noise:
        v = v + fv[1] * torch.eye(*v.shape, dtype=v.dtype, device=v.device)
    return v


def _deriv_plain(st, x, y, fv, evals=None, r2=None):
    """The r²-derivative weights ``Wr`` of K, zero at r² <= 0 where the
    true tangent vanishes."""
    r2 = _sqdist_plain(x, y) if r2 is None else r2
    v = _dr2(st, fv, r2, evals)
    return torch.where(r2 <= 0, torch.zeros((), dtype=v.dtype,
                                            device=v.device), v)


def _sums_plain(G, st, fv, r2, with_noise, evals=None):
    """The gradient of ⟨G, K⟩ with respect to the folded vector."""
    zero = G.new_zeros(())
    out = [G.sum(), G.diagonal().sum() if with_noise else zero]
    for m in _partials(st, fv, r2, evals):
        out.append(zero if m is None else (G * m).sum())
    return torch.stack(out)


def _point_grads(C, x, y):
    if x.shape[1] == 1:
        C = C * (x - y.T)
        return 2 * C.sum(1, keepdim=True), -2 * C.sum(0)[:, None]
    return (2 * (C.sum(1, keepdim=True) * x - C @ y),
            2 * (C.sum(0)[:, None] * y - C.T @ x))


def _backward_plain(G, st, x, y, fv, with_noise, need_xy, need_p):
    """(gx, gy, gfv): the points' gradients and the folded vector's, in
    differentiable torch (the route of the second derivatives that C″
    does not take)."""
    r2 = _sqdist_plain(x, y)
    evals = _terms_plain(st, fv, r2, d1=True, da=need_p)
    gx = gy = gfv = None
    if need_xy:
        gx, gy = _point_grads(G * _deriv_plain(st, x, y, fv, evals, r2), x,
                              y)
    if need_p:
        gfv = _sums_plain(G, st, fv, r2, with_noise, evals)
    return gx, gy, gfv


def _sym_backward_plain(G, st, x, fv, with_noise, need_x, need_p):
    r2 = _sqdist_plain(x, x)
    evals = _terms_plain(st, fv, r2, d1=True, da=need_p)
    gx = gfv = None
    if need_x:
        # both arguments of K are x: the y-gradient of C's backward
        # transposed lands on x too, so G enters symmetrized
        gx = _point_grads((G + G.T) * _deriv_plain(st, x, x, fv, evals, r2),
                          x, x)[0]
    if need_p:
        gfv = _sums_plain(G, st, fv, r2, with_noise, evals)
    return gx, gfv


def _dsqdist_plain(x, y, dx, dy):
    """dr² = 2 Σ_d (x_d − y_d)(dx_d − dy_d), from exact differences."""
    t = None
    for d in range(x.shape[1]):
        dl = (x[:, d, None] - y[None, :, d]) * (dx[:, d, None]
                                                - dy[None, :, d])
        t = dl if t is None else t + dl
    return 2 * t


def _tangent_plain(st, x, y, dx, dy, fv, dfv, with_noise):
    """C′: dK = (dK/dr²) dr² (zero at r² <= 0) + Σ_k (∂K/∂θ_k) dθ_k (+
    dnoise on the diagonal)."""
    r2 = _sqdist_plain(x, y)
    evals = _terms_plain(st, fv, r2, d1=True, da=True)
    v = _deriv_plain(st, x, y, fv, evals, r2) * _dsqdist_plain(x, y, dx, dy) \
        + dfv[0]
    for k, m in enumerate(_partials(st, fv, r2, evals)):
        if m is not None:
            v = v + m * dfv[2 + k]
    if with_noise:
        v = v + dfv[1] * torch.eye(*v.shape, dtype=v.dtype, device=v.device)
    return v


class _Single:
    """The one term of a one-term description at its parameters, in r²:
    g, dg/dr² and d²g/dr² (its coefficient apart), for C″ and E″."""

    def __init__(self, st, fv):
        (self.term,) = _leaves(st)
        self.st, self.fv = st, fv
        self.w, self.a, self.b = fv[3], fv[4], fv[5]

    def _eval(self, r2, **kw):
        return _term_eval(self.term, r2 * self.w, self.a, self.b, **kw)

    def value(self, r2):
        return self._eval(r2).g

    def deriv(self, r2):
        return self.w * self._eval(r2, d1=True).gu

    def deriv2(self, r2):
        return self.w * self.w * self._eval(r2, d2=True).guu


def _tangent_weights_plain(one, x, y, dx, dy, alpha, dalpha):
    """(w1, w2, dr², r²): the weights of (x_i − y_j) and (dx_i − dy_j)
    in the tangent of the backward, zero at r² <= 0."""
    r2 = _sqdist_plain(x, y)
    dr2 = _dsqdist_plain(x, y, dx, dy)
    zero = r2.new_zeros(())
    d1 = one.deriv(r2)
    w1 = torch.where(r2 <= 0, zero,
                     dalpha * d1 + alpha * one.deriv2(r2) * dr2)
    w2 = torch.where(r2 <= 0, zero, alpha * d1)
    return w1, w2, dr2, r2


def _tangent_scalars_plain(G, one, r2, dr2):
    """(Σ G g' dr², Σ G, Σ G g), the scalar slots of C″ and E″."""
    return torch.stack([(G * one.deriv(r2) * dr2).sum(), G.sum(),
                        (G * one.value(r2)).sum()])


def _bwd_tangent_plain(G, one, x, y, dx, dy, coef, need_xy, need_s):
    """C″: the tangent of C's backward at fixed G along (dx, dy, dα),
    coef = [α, dα]: (dgx, dgy, scalars) with scalars (Σ G g' dr², Σ G,
    Σ G g)."""
    gx = gy = sc = None
    w1, w2, dr2, r2 = _tangent_weights_plain(one, x, y, dx, dy, coef[0],
                                             coef[1])
    if need_xy:
        w1 = G * w1
        w2 = G * w2
        gx = 2 * (w1.sum(1, keepdim=True) * x - w1 @ y
                  + w2.sum(1, keepdim=True) * dx - w2 @ dy)
        gy = 2 * (w1.sum(0)[:, None] * y - w1.T @ x
                  + w2.sum(0)[:, None] * dy - w2.T @ dx)
    if need_s:
        sc = _tangent_scalars_plain(G, one, r2, dr2)
    return gx, gy, sc


def _sym_bwd_tangent_plain(G, one, x, dx, coef, need_x, need_s):
    """E″: C″ for y = x, dy = dx; G enters as G + Gᵀ."""
    gx = sc = None
    w1, w2, dr2, r2 = _tangent_weights_plain(one, x, x, dx, dx, coef[0],
                                             coef[1])
    if need_x:
        S = G + G.T
        w1 = S * w1
        w2 = S * w2
        gx = 2 * (w1.sum(1, keepdim=True) * x - w1 @ x
                  + w2.sum(1, keepdim=True) * dx - w2 @ dx)
    if need_s:
        sc = _tangent_scalars_plain(G, one, r2, dr2)
    return gx, sc


# -- the CUDA kernels ---------------------------------------------------------

def _check_dtypes(*tensors):
    if any(t.dtype != tensors[0].dtype for t in tensors):
        raise ValueError('the points, the parameters and the output '
                         'gradient must share one dtype')
    return _suffix(tensors[0].dtype)


def _nsums(ev):
    """The scalar slots per block of the backwards: Σ G, tr G and the
    evaluator's parameter sums (csrc/gram.cu ParSums)."""
    return 3 if ev == 0 else 2 + _NPAR * MAXTERMS


def _gfv(scal, fv):
    """The folded vector's gradient from the blocks' slots."""
    s = scal.sum(0)
    out = fv.new_zeros(fv.shape)
    n = min(s.shape[0], out.shape[0])
    out[:n] = s[:n]
    return out


def _eval_cuda(st, x, y, fv, with_noise):
    suffix = _check_dtypes(x, y, fv)
    n, p = x.shape
    m, py = y.shape
    if py != p:
        raise ValueError(f'x has {p} coordinates, y has {py}')
    nterms, codes, ev = _codes(st)
    fv = fv.contiguous()
    out = torch.empty((n, m), dtype=x.dtype, device=x.device)
    err = getattr(_build.lib(), 'lsq_gram' + _SPECIAL_SUFFIX[ev] + suffix)(
        _ptr(x), _ptr(y), n, m, p, _ptr(fv), nterms, codes, int(with_noise),
        ev, _ptr(out), _stream(x.device))
    _build.check(err, 'gram')
    _count(gram, 'launches', st)
    return out


def _eval(st, x, y, fv, with_noise):
    if _device_kind(x, y, fv) == 'cpu':
        return _eval_plain(st, x, y, fv, with_noise)
    return _eval_cuda(st, x, y, fv, with_noise)


def _eval_sym_cuda(st, x, fv, with_noise):
    suffix = _check_dtypes(x, fv)
    n, p = x.shape
    nterms, codes, ev = _codes(st)
    fv = fv.contiguous()
    out = torch.empty((n, n), dtype=x.dtype, device=x.device)
    err = getattr(_build.lib(), 'lsq_gram_sym' + _SPECIAL_SUFFIX[ev] + suffix)(
        _ptr(x), n, p, _ptr(fv), nterms, codes, int(with_noise), ev,
        _ptr(out), _stream(x.device))
    _build.check(err, 'gram_sym')
    _count(gram_sym, 'launches', st)
    return out


def _eval_sym(st, x, fv, with_noise):
    """K(x, x): kernel E for CUDA tensors; for CPU ones the plain full
    evaluation, which equals the mirrored upper triangle exactly (r² is
    computed symmetrically)."""
    if _device_kind(x, fv) == 'cpu':
        return _eval_plain(st, x, x, fv, with_noise)
    return _eval_sym_cuda(st, x, fv, with_noise)


def _wide(G, ncols):
    """Whether G's rows are 16-byte aligned (the kernels' wide loads)."""
    return int(G.data_ptr() % 16 == 0 and ncols % (16 // G.element_size())
               == 0)


def _transposed(G):
    """Whether G is the transpose of a contiguous matrix, as the GP's
    linear transformations (permuted views) hand the output gradient
    on: the backward kernels then read Gᵀ in place rather than copy G
    into a second n × m buffer."""
    return not G.is_contiguous() and G.mT.is_contiguous()


def _chunks(p, need_xy):
    """The first coordinate of each launch of E's backward and of C″ and
    E″: one launch takes every coordinate at p = 1 and up to _PCHUNK at
    p > 1 (C's backward takes all p in one launch)."""
    return range(0, p, 1 if p == 1 else _PCHUNK) if need_xy else range(1)


def _backward_cuda(G, st, x, y, fv, with_noise, need_xy, need_p):
    if _transposed(G):
        # <G, K(x, y)> = <Gᵀ, K(y, x)>: the same sums and trace
        gy, gx, gfv = _backward_cuda(G.mT, st, y, x, fv, with_noise,
                                     need_xy, need_p)
        return gx, gy, gfv
    G = G.contiguous()
    suffix = _check_dtypes(G, x, y, fv)
    n, p = x.shape
    m = y.shape[0]
    if G.shape != (n, m):
        raise ValueError(f'G has shape {tuple(G.shape)}, K {(n, m)}')
    nterms, codes, ev = _codes(st)
    fv = fv.contiguous()
    nbj, nbi = _cdiv(m, _TILE), _cdiv(n, _BWD_ROWS)
    # each block's partial sums: over its columns for its rows, over its
    # rows for its columns, and its scalars
    rowpart = x.new_empty((nbj, n, p)) if need_xy else None
    colpart = x.new_empty((nbi, m, p)) if need_xy else None
    scal = x.new_empty((nbi * nbj, _nsums(ev))) if need_p else None
    # one launch for all p: G is read once
    err = getattr(_build.lib(), 'lsq_gram_bwd' + _SPECIAL_SUFFIX[ev] + suffix)(
        _ptr(G), _ptr(x), _ptr(y), n, m, p, _ptr(fv), nterms, codes,
        int(with_noise), ev, int(need_xy), int(need_p), _wide(G, m),
        _ptr(rowpart), _ptr(colpart), _ptr(scal), _stream(x.device))
    _build.check(err, 'gram backward')
    _count(gram, 'launches_bwd', st)
    gx = gy = None
    if need_xy:
        gx = 2 * rowpart.sum(0)
        gy = -2 * colpart.sum(0)
    return gx, gy, _gfv(scal, fv) if need_p else None


def _sym_backward_cuda(G, st, x, fv, with_noise, need_x, need_p):
    # K(x, x) is symmetric: Gᵀ gives the same gradients
    G = G.mT if _transposed(G) else G.contiguous()
    suffix = _check_dtypes(G, x, fv)
    n, p = x.shape
    if G.shape != (n, n):
        raise ValueError(f'G has shape {tuple(G.shape)}, K {(n, n)}')
    nterms, codes, ev = _codes(st)
    fv = fv.contiguous()
    nt = _cdiv(n, _TILE)
    # rows of tile I: one slot per other tile J (the pair (I, J) or
    # (J, I) writes it); the scalars per upper tile pair
    part = x.new_empty((nt, n, p)) if need_x else None
    scal = x.new_empty((nt * (nt + 1) // 2, _nsums(ev))) if need_p else None
    fn = getattr(_build.lib(), 'lsq_gram_sym_bwd' + _SPECIAL_SUFFIX[ev] + suffix)
    for d0 in _chunks(p, need_x):
        err = fn(_ptr(G), _ptr(x), n, p, d0, _ptr(fv), nterms, codes,
                 int(with_noise), ev, int(need_x), int(need_p and d0 == 0),
                 _wide(G, n), _ptr(part), _ptr(scal), _stream(x.device))
        _build.check(err, 'gram_sym backward')
        _count(gram_sym, 'launches_bwd', st)
    gx = 2 * part.sum(0) if need_x else None
    return gx, _gfv(scal, fv) if need_p else None


def _backward(G, st, x, y, fv, with_noise, need_xy, need_p):
    """(gx, gy, gfv): C's backward, the folded vector's gradient gfv."""
    fn = _backward_plain if _device_kind(G, x, y, fv) == 'cpu' \
        else _backward_cuda
    return fn(G, st, x, y, fv, with_noise, need_xy, need_p)


def _sym_backward(G, st, x, fv, with_noise, need_x, need_p):
    fn = _sym_backward_plain if _device_kind(G, x, fv) == 'cpu' \
        else _sym_backward_cuda
    return fn(G, st, x, fv, with_noise, need_x, need_p)


# -- the tangent kernels (C′, C″, E′, E″) ----------------------------------------

def _tangent_cuda(st, x, y, dx, dy, fv, dfv, with_noise):
    suffix = _check_dtypes(x, y, dx, dy, fv, dfv)
    n, p = x.shape
    m = y.shape[0]
    if y.shape[1] != p or dx.shape != x.shape or dy.shape != y.shape:
        raise ValueError('the points and their tangents must have shapes '
                         f'(n, p), (m, p): {tuple(x.shape)}, '
                         f'{tuple(y.shape)}, {tuple(dx.shape)}, '
                         f'{tuple(dy.shape)}')
    nterms, codes, ev = _codes(st)
    dx, dy = dx.contiguous(), dy.contiguous()
    fv, dfv = fv.contiguous(), dfv.contiguous()
    out = torch.empty((n, m), dtype=x.dtype, device=x.device)
    err = getattr(_build.lib(), 'lsq_gram_jvp' + _SPECIAL_SUFFIX[ev] + suffix)(
        _ptr(x), _ptr(y), _ptr(dx), _ptr(dy), n, m, p, _ptr(fv), _ptr(dfv),
        nterms, codes, int(with_noise), ev, _ptr(out), _stream(x.device))
    _build.check(err, 'gram tangent')
    _count(gram, 'launches_jvp', st)
    return out


def _sym_tangent_cuda(st, x, dx, fv, dfv, with_noise):
    suffix = _check_dtypes(x, dx, fv, dfv)
    n, p = x.shape
    if dx.shape != x.shape:
        raise ValueError(f'dx has shape {tuple(dx.shape)}, x '
                         f'{tuple(x.shape)}')
    nterms, codes, ev = _codes(st)
    dx, fv, dfv = dx.contiguous(), fv.contiguous(), dfv.contiguous()
    out = torch.empty((n, n), dtype=x.dtype, device=x.device)
    err = getattr(_build.lib(), 'lsq_gram_sym_jvp' + _SPECIAL_SUFFIX[ev] + suffix)(
        _ptr(x), _ptr(dx), n, p, _ptr(fv), _ptr(dfv), nterms, codes,
        int(with_noise), ev, _ptr(out), _stream(x.device))
    _build.check(err, 'gram_sym tangent')
    _count(gram_sym, 'launches_jvp', st)
    return out


def _bwd_tangent_cuda(G, one, x, y, dx, dy, coef, need_xy, need_s):
    if _transposed(G):
        gy, gx, sc = _bwd_tangent_cuda(G.mT, one, y, x, dy, dx, coef,
                                       need_xy, need_s)
        return gx, gy, sc
    G = G.contiguous()
    suffix = _check_dtypes(G, x, y, dx, dy, coef, one.fv)
    n, p = x.shape
    m = y.shape[0]
    if G.shape != (n, m):
        raise ValueError(f'G has shape {tuple(G.shape)}, K {(n, m)}')
    _, codes, ev = _codes(one.st)
    dx, dy, coef = dx.contiguous(), dy.contiguous(), coef.contiguous()
    fv = one.fv.contiguous()
    nbj, nbi = _cdiv(m, _TILE), _cdiv(n, _BWD_ROWS)
    rowpart = x.new_empty((nbj, n, p)) if need_xy else None
    colpart = x.new_empty((nbi, m, p)) if need_xy else None
    scal = x.new_empty((nbi * nbj, 3)) if need_s else None
    fn = getattr(_build.lib(), 'lsq_gram_bwd_jvp' + _SPECIAL_SUFFIX[ev] + suffix)
    for d0 in _chunks(p, need_xy):
        err = fn(_ptr(G), _ptr(x), _ptr(y), _ptr(dx), _ptr(dy), n, m, p, d0,
                 _ptr(fv), _ptr(coef), codes, ev, int(need_xy),
                 int(need_s and d0 == 0), _wide(G, m), _ptr(rowpart),
                 _ptr(colpart), _ptr(scal), _stream(x.device))
        _build.check(err, 'gram backward tangent')
        _count(gram, 'launches_bwd_jvp', one.st)
    gx = gy = None
    if need_xy:
        gx = 2 * rowpart.sum(0)
        gy = -2 * colpart.sum(0)
    return gx, gy, scal.sum(0) if need_s else None


def _sym_bwd_tangent_cuda(G, one, x, dx, coef, need_x, need_s):
    G = G.mT if _transposed(G) else G.contiguous()
    suffix = _check_dtypes(G, x, dx, coef, one.fv)
    n, p = x.shape
    if G.shape != (n, n):
        raise ValueError(f'G has shape {tuple(G.shape)}, K {(n, n)}')
    _, codes, ev = _codes(one.st)
    dx, coef, fv = dx.contiguous(), coef.contiguous(), one.fv.contiguous()
    nt = _cdiv(n, _TILE)
    part = x.new_empty((nt, n, p)) if need_x else None
    scal = x.new_empty((nt * (nt + 1) // 2, 3)) if need_s else None
    fn = getattr(_build.lib(), 'lsq_gram_sym_bwd_jvp' + _SPECIAL_SUFFIX[ev] + suffix)
    for d0 in _chunks(p, need_x):
        err = fn(_ptr(G), _ptr(x), _ptr(dx), n, p, d0, _ptr(fv), _ptr(coef),
                 codes, ev, int(need_x), int(need_s and d0 == 0),
                 _wide(G, n), _ptr(part), _ptr(scal), _stream(x.device))
        _build.check(err, 'gram_sym backward tangent')
        _count(gram_sym, 'launches_bwd_jvp', one.st)
    gx = 2 * part.sum(0) if need_x else None
    return gx, scal.sum(0) if need_s else None


def _tangent(st, x, y, dx, dy, fv, dfv, with_noise):
    fn = _tangent_plain if _device_kind(x, y, dx, dy, fv) == 'cpu' \
        else _tangent_cuda
    return fn(st, x, y, dx, dy, fv, dfv, with_noise)


def _sym_tangent(st, x, dx, fv, dfv, with_noise):
    """E′: the tangent of K(x, x); for CPU tensors the plain full
    evaluation, equal to the mirrored upper triangle."""
    if _device_kind(x, dx, fv) == 'cpu':
        return _tangent_plain(st, x, x, dx, dx, fv, dfv, with_noise)
    return _sym_tangent_cuda(st, x, dx, fv, dfv, with_noise)


def _bwd_tangent(G, one, x, y, dx, dy, coef, need_xy, need_s):
    fn = _bwd_tangent_plain if _device_kind(G, x, y, dx, dy, coef) == 'cpu' \
        else _bwd_tangent_cuda
    return fn(G, one, x, y, dx, dy, coef, need_xy, need_s)


def _sym_bwd_tangent(G, one, x, dx, coef, need_x, need_s):
    fn = _sym_bwd_tangent_plain if _device_kind(G, x, dx, coef) == 'cpu' \
        else _sym_bwd_tangent_cuda
    return fn(G, one, x, dx, coef, need_x, need_s)


# -- differentiable wrappers --------------------------------------------------

_THIRD = ('the Gram kernels are differentiable twice in lsqfitgp_torch: '
          'a third derivative is not implemented')


def _zeros_if_none(t, like):
    return torch.zeros_like(like) if t is None else t


class _Gram(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, y, fv, st, with_noise, fast2):
        ctx.save_for_backward(x, y, fv)
        ctx.save_for_forward(x, y, fv)
        ctx.meta = st, with_noise, fast2
        return _eval(st, x, y, fv, with_noise)

    @staticmethod
    def jvp(ctx, dx, dy, dfv, *_):
        x, y, fv = ctx.saved_tensors
        st, with_noise, _ = ctx.meta
        return _tangent(st, x, y, _zeros_if_none(dx, x),
                        _zeros_if_none(dy, y), fv, _zeros_if_none(dfv, fv),
                        with_noise)

    @staticmethod
    def backward(ctx, G):
        x, y, fv = ctx.saved_tensors
        st, with_noise, fast2 = ctx.meta
        need_x, need_y, need_p = ctx.needs_input_grad[:3]
        if not (need_x or need_y or need_p):
            return None, None, None, None, None, None
        args = st, x, y, fv, with_noise, need_x or need_y, need_p
        if not torch.is_grad_enabled():
            gx, gy, gfv = _backward(G, *args)
        elif fast2:
            # create_graph: the backward as a Function of its own
            gx, gy, gfv = _GramBackward.apply(G, *args)
        else:
            # create_graph on a sum or with dynamic profile parameters:
            # the plain backward, differentiated by autograd
            gx, gy, gfv = _backward_plain(G, *args)
        return gx, gy, gfv, None, None, None


class _GramBackward(torch.autograd.Function):
    """C's backward as a function of (G, x, y, fv) for one term whose
    w, a and b are constant: (gx, gy, gfv).  Its backward is C′ for G
    (the backward is linear in G, with transpose J_K) and C″ for x, y
    and the coefficient c = fv[2] (the backward is a gradient, so its
    Jacobian in them is a symmetric Hessian: the transpose is the
    tangent)."""

    @staticmethod
    def forward(ctx, G, st, x, y, fv, with_noise, need_xy, need_p):
        ctx.save_for_backward(G, x, y, fv)
        ctx.meta = st, with_noise, need_xy, need_p
        ctx.set_materialize_grads(False)
        return _backward(G, st, x, y, fv, with_noise, need_xy, need_p)

    @staticmethod
    def backward(ctx, ugx, ugy, ugfv):
        if torch.is_grad_enabled():
            raise RuntimeError(_THIRD)
        G, x, y, fv = ctx.saved_tensors
        st, with_noise, _, _ = ctx.meta
        need_G, _, need_x, need_y, need_f = ctx.needs_input_grad[:5]
        dx = _zeros_if_none(ugx, x)
        dy = _zeros_if_none(ugy, y)
        dfv = _zeros_if_none(ugfv, fv)
        gG = gx = gy = gf = None
        if need_G:
            gG = _tangent(st, x, y, dx, dy, fv, dfv, with_noise)
        if need_x or need_y or need_f:
            gx, gy, sc = _bwd_tangent(G, _Single(st, fv), x, y, dx, dy,
                                      torch.stack([fv[2], dfv[2]]),
                                      need_x or need_y, need_f)
            if need_f:
                gf = torch.zeros_like(fv)
                gf[2] = sc[0]
        return gG, None, gx, gy, gf, None, None, None


class _GramSym(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, fv, st, with_noise, fast2):
        ctx.save_for_backward(x, fv)
        ctx.save_for_forward(x, fv)
        ctx.meta = st, with_noise, fast2
        return _eval_sym(st, x, fv, with_noise)

    @staticmethod
    def jvp(ctx, dx, dfv, *_):
        x, fv = ctx.saved_tensors
        st, with_noise, _ = ctx.meta
        return _sym_tangent(st, x, _zeros_if_none(dx, x), fv,
                            _zeros_if_none(dfv, fv), with_noise)

    @staticmethod
    def backward(ctx, G):
        x, fv = ctx.saved_tensors
        st, with_noise, fast2 = ctx.meta
        need_x, need_p = ctx.needs_input_grad[:2]
        if not (need_x or need_p):
            return None, None, None, None, None
        args = st, x, fv, with_noise, need_x, need_p
        if not torch.is_grad_enabled():
            gx, gfv = _sym_backward(G, *args)
        elif fast2:
            gx, gfv = _GramSymBackward.apply(G, *args)
        else:
            gx, gfv = _sym_backward_plain(G, *args)
        return gx, gfv, None, None, None


class _GramSymBackward(torch.autograd.Function):
    """E's backward as a function of (G, x, fv): (gx, gfv); its backward
    is E′ for G and E″ for x and the coefficient."""

    @staticmethod
    def forward(ctx, G, st, x, fv, with_noise, need_x, need_p):
        ctx.save_for_backward(G, x, fv)
        ctx.meta = st, with_noise
        ctx.set_materialize_grads(False)
        return _sym_backward(G, st, x, fv, with_noise, need_x, need_p)

    @staticmethod
    def backward(ctx, ugx, ugfv):
        if torch.is_grad_enabled():
            raise RuntimeError(_THIRD)
        G, x, fv = ctx.saved_tensors
        st, with_noise = ctx.meta
        need_G, _, need_x, need_f = ctx.needs_input_grad[:4]
        dx = _zeros_if_none(ugx, x)
        dfv = _zeros_if_none(ugfv, fv)
        gG = gx = gf = None
        if need_G:
            gG = _sym_tangent(st, x, dx, fv, dfv, with_noise)
        if need_x or need_f:
            gx, sc = _sym_bwd_tangent(G, _Single(st, fv), x, dx,
                                      torch.stack([fv[2], dfv[2]]), need_x,
                                      need_f)
            if need_f:
                gf = torch.zeros_like(fv)
                gf[2] = sc[0]
        return gG, None, gx, gf, None, None, None


def _args(profile, x, y, post, noise):
    """(desc, st, x, y, pvec): the description, its structure, the
    points and the parameter vector (`_flat`'s numbers, then the nugget,
    0 without one)."""
    desc = _desc(profile, post)
    st = _struct(desc)
    x = _prep(x)
    y = x if y is None else _prep(y)
    pvec = _paramvec(_flat(desc) + [0.0 if noise is None else noise], x)
    return desc, st, x, y, pvec


def gram(profile, x, y=None, *, post=(), noise=None):
    """Tiled Gram matrix ``K[i, j] = k(‖x_i − y_j‖²)`` (+ noise·I).

    Parameters
    ----------
    profile : str, Profile, Term or Terms
        A registered profile (`PROFILES`) by name, e.g. ``'expquad'``,
        or a description of a profiled kernel or a sum of them.
    x, y : (n, p), (m, p) tensors
        Input points (y defaults to x); 1-D inputs are p = 1.
    post : tuple of ('mul' | 'add', scalar)
        Scalar chain applied to the profile in order; scalars may be
        tensors and are differentiable, as are the description's.
    noise : scalar, optional
        Nugget on the global diagonal; differentiable.
    """
    desc, st, x, y, pvec = _args(profile, x, y, post, noise)
    return _Gram.apply(x, y, _fold(st, pvec), st, noise is not None,
                       _fast_second(desc, st))


gram.launches = gram.launches_bwd = 0
gram.launches_jvp = gram.launches_bwd_jvp = 0
gram.by_profile = {}


def gram_plain(profile, x, y=None, *, post=(), noise=None):
    """Plain PyTorch version of `gram` on any device, differentiable by
    autograd; the reference the kernel is held against."""
    _, st, x, y, pvec = _args(profile, x, y, post, noise)
    return _eval_plain(st, x, y, _fold(st, pvec), noise is not None)


def k0(profile, post=(), like=None):
    """The kernel's value at zero distance, differentiable in the
    description's numbers (a 0-d tensor of ``like``'s dtype and
    device)."""
    if like is None:
        like = torch.zeros(())
    _, st, z, _, pvec = _args(profile, like.new_zeros((1, 1)), None, post,
                              None)
    return _value_r2(st, _fold(st, pvec), z.new_zeros(()))


def _pgrad(st, pvec, gfv):
    """The parameter vector's gradient from the folded vector's."""
    return torch.func.vjp(lambda p: _fold(st, p), pvec)[1](gfv)[0]


def _backward_public(fn, G, profile, x, y, post, noise, need_xy, need_p):
    _, st, x, y, pvec = _args(profile, x, y, post, noise)
    fv = _fold(st, pvec)
    gx, gy, gfv = fn(G, st, x, y, fv, noise is not None, need_xy, need_p)
    return gx, gy, _pgrad(st, pvec, gfv) if need_p else None


def gram_backward(G, profile, x, y=None, *, post=(), noise=None,
                  need_xy=True, need_p=True):
    """The backward of `gram`: the gradients of ``<G, K>``, K =
    ``gram(profile, x, y, post=post, noise=noise)``, as ``(gx, gy, gp)``:
    with respect to x and y (of their (n, p) and (m, p) shapes; with y
    None, K's two arguments apart), and to the parameter vector, the
    description's numbers (`_flat`'s order; for a profile by name the
    post chain's scalars) then the nugget (0 without one).  ``need_xy``
    and ``need_p`` say which are computed; the others are None.  One
    launch of the fused kernel for CUDA tensors, whatever p (a G that
    is the transpose of a contiguous matrix read in place),
    `gram_backward_plain` for CPU ones."""
    return _backward_public(_backward, G, profile, x, y, post, noise,
                            need_xy, need_p)


def gram_backward_plain(G, profile, x, y=None, *, post=(), noise=None,
                        need_xy=True, need_p=True):
    """Plain PyTorch version of `gram_backward` on any device: the
    derivative weights and partial derivatives as n × m matrices,
    contracted with G in torch."""
    return _backward_public(_backward_plain, G, profile, x, y, post, noise,
                            need_xy, need_p)


def gram_sym(profile, x, *, post=(), noise=None):
    """Symmetric Gram matrix ``K(x, x)`` (+ noise·I) evaluated on the
    upper-triangle tiles only and mirrored (kernel E on CUDA): half the
    profile evaluations of `gram`.  Arguments as for `gram`."""
    desc, st, x, _, pvec = _args(profile, x, None, post, noise)
    return _GramSym.apply(x, _fold(st, pvec), st, noise is not None,
                          _fast_second(desc, st))


gram_sym.launches = gram_sym.launches_bwd = 0
gram_sym.launches_jvp = gram_sym.launches_bwd_jvp = 0
gram_sym.by_profile = {}


def gram_sym_plain(profile, x, *, post=(), noise=None):
    """Plain PyTorch version of `gram_sym` on any device, differentiable
    by autograd."""
    _, st, x, _, pvec = _args(profile, x, None, post, noise)
    return _eval_plain(st, x, x, _fold(st, pvec), noise is not None)


def _sym_public(fn, G, profile, x, post, noise, need_x, need_p):
    _, st, x, _, pvec = _args(profile, x, None, post, noise)
    gx, gfv = fn(G, st, x, _fold(st, pvec), noise is not None, need_x,
                 need_p)
    return gx, _pgrad(st, pvec, gfv) if need_p else None


def gram_sym_backward(G, profile, x, *, post=(), noise=None, need_x=True,
                      need_p=True):
    """The backward of `gram_sym`: the gradients of ``<G, K(x, x)>`` with
    respect to x and the parameter vector, ``(gx, gp)``, as for
    `gram_backward`.  The fused kernel for CUDA tensors (upper tile pairs
    only, G and its mirror read in one pass), `gram_sym_backward_plain`
    for CPU ones."""
    return _sym_public(_sym_backward, G, profile, x, post, noise, need_x,
                       need_p)


def gram_sym_backward_plain(G, profile, x, *, post=(), noise=None,
                            need_x=True, need_p=True):
    """Plain PyTorch version of `gram_sym_backward` on any device."""
    return _sym_public(_sym_backward_plain, G, profile, x, post, noise,
                       need_x, need_p)


# -- tangents -----------------------------------------------------------------

def _tangent_args(profile, x, y, dx, dy, post, noise, dpost, dnoise):
    """(desc, st, x, y, dx, dy, pvec, dpvec): `_args` and the tangents,
    zeros where not given; with y None, dy is dx.  ``dpost`` is the
    tangent of ``post`` (the chain given apart from the description),
    ``dnoise`` the nugget's."""
    desc, st, xx, yy, pvec = _args(profile, x, y, post, noise)
    dx = torch.zeros_like(xx) if dx is None else _prep(dx).to(xx.dtype)
    if y is None:
        dy = dx
    else:
        dy = torch.zeros_like(yy) if dy is None else _prep(dy).to(yy.dtype)
    npost = len(tuple(post))
    dpost = [0.0] * npost if dpost is None else list(dpost)
    if len(dpost) != npost:
        raise ValueError(f'{len(dpost)} chain tangents for {npost} steps')
    lead = [0.0] * (pvec.shape[0] - 1 - npost)
    dpvec = _paramvec(lead + dpost + [0.0 if dnoise is None else dnoise],
                      xx)
    return desc, st, xx, yy, dx, dy, pvec, dpvec


def _jvp_public(fn, profile, x, y, dx, dy, post, noise, dpost, dnoise):
    _, st, x, y, dx, dy, pvec, dpvec = _tangent_args(
        profile, x, y, dx, dy, post, noise, dpost, dnoise)
    fv, dfv = torch.func.jvp(lambda p: _fold(st, p), (pvec,), (dpvec,))
    return fn(st, x, y, dx, dy, fv, dfv, noise is not None)


def gram_jvp(profile, x, y=None, dx=None, dy=None, *, post=(), noise=None,
             dpost=None, dnoise=None):
    """The tangent of `gram` along the points' tangents ``dx``, ``dy``
    (zeros if None; with y None, K(x, x) and dy = dx), the chain's
    scalars' ``dpost`` and the nugget's ``dnoise``: ``dK = (dK/dr²) dr²
    + Σ_k (∂K/∂θ_k) dθ_k (+ dnoise·I)``, zero weight at r² = 0.  Kernel
    C′ for CUDA tensors, `gram_jvp_plain` for CPU ones.  (The tangents
    of a description's own numbers reach C′ through torch's forward AD
    on `gram`.)"""
    return _jvp_public(_tangent, profile, x, y, dx, dy, post, noise, dpost,
                       dnoise)


def gram_jvp_plain(profile, x, y=None, dx=None, dy=None, *, post=(),
                   noise=None, dpost=None, dnoise=None):
    """Plain PyTorch version of `gram_jvp` on any device."""
    return _jvp_public(_tangent_plain, profile, x, y, dx, dy, post, noise,
                       dpost, dnoise)


def gram_sym_jvp(profile, x, dx=None, *, post=(), noise=None, dpost=None,
                 dnoise=None):
    """The tangent of `gram_sym` (kernel E′ on CUDA: the upper tile
    pairs, mirrored; the same entries as `gram_jvp`)."""
    def fn(st, x, y, dx, dy, fv, dfv, with_noise):
        return _sym_tangent(st, x, dx, fv, dfv, with_noise)
    return _jvp_public(fn, profile, x, None, dx, None, post, noise, dpost,
                       dnoise)


def gram_sym_jvp_plain(profile, x, dx=None, *, post=(), noise=None,
                       dpost=None, dnoise=None):
    """Plain PyTorch version of `gram_sym_jvp` on any device."""
    return gram_jvp_plain(profile, x, None, dx, None, post=post, noise=noise,
                          dpost=dpost, dnoise=dnoise)


def _backward_jvp(fn, G, profile, x, y, dx, dy, post, noise, dpost, need_xy,
                  need_p):
    desc, st, x, y, dx, dy, pvec, dpvec = _tangent_args(
        profile, x, y, dx, dy, post, noise, dpost, None)
    if len(_leaves(st)) != 1:
        raise ValueError('the backward tangent (C″, E″) takes one term')
    fv, dfv = torch.func.jvp(lambda p: _fold(st, p), (pvec,), (dpvec,))
    gx, gy, sc = fn(G, _Single(st, fv), x, y, dx, dy,
                    torch.stack([fv[2], dfv[2]]), need_xy, need_p)
    gp = None
    if need_p:
        # gp = J_foldᵀ gfv, gfv = [Σ G, tr G, Σ G g, ...]: its tangent
        # moves Σ G g by Σ G g' dr², and J_fold with dpvec
        gfv = torch.zeros_like(fv)
        gfv[0], gfv[2] = sc[1], sc[2]
        dgfv = torch.zeros_like(fv)
        dgfv[2] = sc[0]
        gp = torch.func.jvp(lambda p, g: _pgrad(st, p, g), (pvec, gfv),
                            (dpvec, dgfv))[1]
    return gx, gy, gp


def gram_backward_jvp(G, profile, x, y=None, dx=None, dy=None, *, post=(),
                      noise=None, dpost=None, need_xy=True, need_p=True):
    """The tangent of `gram_backward` at fixed ``G`` along the points'
    tangents and the chain's ``dpost``, for a one-term profile whose
    arguments and scale stay fixed: ``(dgx, dgy, dgp)``, as
    `gram_backward` returns ``(gx, gy, gp)``.  One launch of kernel C″
    for CUDA tensors (one per 4 coordinates at p > 4), reading G once,
    `gram_backward_jvp_plain` for CPU ones."""
    return _backward_jvp(_bwd_tangent, G, profile, x, y, dx, dy, post, noise,
                         dpost, need_xy, need_p)


def gram_backward_jvp_plain(G, profile, x, y=None, dx=None, dy=None, *,
                            post=(), noise=None, dpost=None, need_xy=True,
                            need_p=True):
    """Plain PyTorch version of `gram_backward_jvp` on any device."""
    return _backward_jvp(_bwd_tangent_plain, G, profile, x, y, dx, dy, post,
                         noise, dpost, need_xy, need_p)


def _sym_bwd_tangent_as(fn):
    def run(G, one, x, y, dx, dy, coef, need_x, need_s):
        gx, sc = fn(G, one, x, dx, coef, need_x, need_s)
        return gx, None, sc
    return run


def gram_sym_backward_jvp(G, profile, x, dx=None, *, post=(), noise=None,
                          dpost=None, need_x=True, need_p=True):
    """The tangent of `gram_sym_backward` at fixed ``G``: ``(dgx, dgp)``.
    Kernel E″ for CUDA tensors (the upper tile pairs, G and its mirror
    read in one pass), `gram_sym_backward_jvp_plain` for CPU ones."""
    gx, _, gp = _backward_jvp(_sym_bwd_tangent_as(_sym_bwd_tangent), G,
                              profile, x, None, dx, None, post, noise, dpost,
                              need_x, need_p)
    return gx, gp


def gram_sym_backward_jvp_plain(G, profile, x, dx=None, *, post=(),
                                noise=None, dpost=None, need_x=True,
                                need_p=True):
    """Plain PyTorch version of `gram_sym_backward_jvp` on any device."""
    gx, _, gp = _backward_jvp(_sym_bwd_tangent_as(_sym_bwd_tangent_plain), G,
                              profile, x, None, dx, None, post, noise, dpost,
                              need_x, need_p)
    return gx, gp
