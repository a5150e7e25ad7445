"""The 1-D time-series kernels (Celerite, Harmonic, Cos, Sinc, Pink,
Color), the exponential integrals and the profiles that kernels C, D and
E evaluate for them and for the rest of the 'abs'/'posabs' zoo
(Periodic, HoleEffect, CausalExpQuad, Log, Wendland, Circular), on the
CPU, against the JAX package on the same inputs (made from a seed with
numpy), in float64.

- the kernels' values, and their derivative kernels where ``derivable``
  allows; Harmonic in each static-Q branch, inside the |Q − 1| < √eps
  window and with a tensor Q on both sides of 1;
- ``si``, ``ci`` and ``expn_imag_real`` and their first derivatives;
- each new profile's ``build_profile`` description evaluated by kernel
  C's plain version (``ops.gram``) and its gradients in the points and
  the dynamic numbers, against the JAX ``build_profile`` and
  ``jax.grad``; two-term sums with a new core;
- ``ops.gram``, ``gram_sym`` and ``schur_update_gram`` on these
  descriptions against the JAX functions in interpret mode;
- the 'pink' and 'color' profiles on each of their branches, and GP
  models on Pink and Color, dense and ``chol-stream``;
- ``why_not``: None for every spec-carrying core, a reason for a Maternp
  order above the kernels' table and for sums of more than 4 kernels;
- the time-series example's model (``amp * Celerite(gamma, B=0.05) +
  noise * White()``) at n = 300, dense and ``chol-stream``, and a
  3-iteration ``empbayes_fit``; and ``examples/timeseries_streaming.py``,
  ``periodic_seasonal.py`` and ``decompose_series.py`` run against the
  port with their own assertions.

Tolerances: the same float64 formulas with sums in another order, 1e-12
relative unless a test says otherwise: the profiles' gradients 1e-11
(their derivatives are taken in closed form on one side and by
autodiff on the other), the kernels 1e-11 and Pink's derivative kernel
1e-10 (the difference of two cosine integrals cancels digits), the
exponential integrals 1e-11 (the continued fraction's 130 complex
steps), GP likelihoods and gradients 1e-9 and
1e-8 as in ``tests/test_torch_gp.py``, the fit's end point 1e-6 as in
``tests/test_torch_zoo.py``.  Wendland's points keep every distance
inside its support: outside it the JAX package's gradient is nan
((1 − r)^(ν+k) at a negative base under ``jnp.where``), the port's 0.
"""

import math
import os

import numpy as np
import pytest
import torch
import jax
from jax import numpy as jnp

import lsqfitgp_tpu as ltpu
from lsqfitgp_tpu import ops as jops
from lsqfitgp_tpu import special as jspecial
from lsqfitgp_tpu.kernelalg import _fastgram as jfg
import lsqfitgp_torch as lt
from lsqfitgp_torch import ops, special
from lsqfitgp_torch.kernelalg import _fastgram as fg
from lsqfitgp_torch.ops import _gram

pytestmark = pytest.mark.x64only

SEED = 20261018
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope='module', autouse=True)
def cpu_device():
    """The package computes on the CUDA card unless asked for the CPU."""
    with lt.using_device('cpu'):
        yield


@pytest.fixture(autouse=True)
def torch_f64():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    torch.set_num_threads(2)
    yield
    torch.set_default_dtype(old)


def close(a, b, rtol=1e-12, atol=1e-13):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol)


# -- the kernels ---------------------------------------------------------------

# name: (constructor, arguments, derivatives to check, points away from
# each other: a kernel whose derivative at Δ = 0 the two packages take
# by autodiff through different cancelling expressions)
KERNELS = {
    'Celerite': ('Celerite', dict(gamma=0.3, B=0.1), [], False),
    'Celerite-ridge': ('Celerite', dict(gamma=0.5, B=0.5), [(1, 1)], True),
    'Harmonic-0.3': ('Harmonic', dict(Q=0.3), [(1, 1)], True),
    'Harmonic-0.8': ('Harmonic', dict(Q=0.8), [(1, 1)], True),
    'Harmonic-1': ('Harmonic', dict(Q=1.0), [(1, 1)], True),
    'Harmonic-1+1e-10': ('Harmonic', dict(Q=1 + 1e-10), [], False),
    'Harmonic-1+1e-6': ('Harmonic', dict(Q=1 + 1e-6), [], False),
    'Harmonic-2': ('Harmonic', dict(Q=2.0), [(1, 1)], True),
    'Cos': ('Cos', {}, [(1, 1), (2, 2)], False),
    'Sinc': ('Sinc', {}, [(1, 1)], True),
    'Pink': ('Pink', dict(dw=1.5), [(1, 1)], True),
    'Color-2': ('Color', dict(n=2), [], False),
    'Color-4': ('Color', dict(n=4), [(1, 1)], True),
}


def _points(apart, rng):
    x = rng.uniform(-6, 6, 9)
    if apart:
        return x, rng.uniform(-6, 6, 7)
    # coincident pairs and a far one (the continued fraction's branch)
    return x, np.concatenate([x[:3], rng.uniform(-6, 6, 3), [40.0]])


@pytest.mark.parametrize('name', sorted(KERNELS))
def test_kernel(name):
    """Values and derivative kernels against the JAX package's."""
    cls, kw, derivs, apart = KERNELS[name]
    rng = np.random.default_rng(SEED + sorted(KERNELS).index(name))
    x, y = _points(apart, rng)
    kt, kj = getattr(lt, cls)(**kw), getattr(ltpu, cls)(**kw)
    for d in [(0, 0)] + derivs:
        ft, fj = (kt, kj) if d == (0, 0) else \
            (kt.linop('diff', *d), kj.linop('diff', *d))
        got = ft(torch.as_tensor(x)[:, None], torch.as_tensor(y)[None, :])
        ref = fj(jnp.asarray(x)[:, None], jnp.asarray(y)[None, :])
        tol = 1e-10 if cls == 'Pink' and d != (0, 0) else 1e-11
        close(got, ref, rtol=tol, atol=1e-12)


@pytest.mark.parametrize('Q', [0.7, 1.0, 1.6])
def test_harmonic_tensor_q(Q):
    """A tensor Q takes the JAX package's where over the lo, mid and hi
    branches with the safe_lo/safe_hi clamps: values and the gradient in
    Q and in the points agree on either side of Q = 1 and at 1."""
    rng = np.random.default_rng(SEED + int(Q * 10))
    x, y = rng.uniform(-5, 5, 11), rng.uniform(-5, 5, 8)
    G = rng.standard_normal((11, 8))

    def jf(xx, q):
        K = ltpu.Harmonic(Q=q)(xx[:, None], jnp.asarray(y)[None, :])
        return jnp.sum(K * G), K

    (_, Kj), gj = jax.value_and_grad(jf, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), jnp.asarray(Q))
    xt = torch.as_tensor(x).requires_grad_()
    qt = torch.tensor(Q, requires_grad=True)
    K = lt.Harmonic(Q=qt)(xt[:, None], torch.as_tensor(y)[None, :])
    close(K, Kj)
    g = torch.autograd.grad((K * torch.as_tensor(G)).sum(), (xt, qt))
    for a, b in zip(g, gj):
        close(a, b, rtol=1e-11, atol=1e-12)


def test_exports():
    """`import lsqfitgp_torch` has the JAX package's celerite and spectral
    kernels, with its derivable and maxdim rules."""
    from lsqfitgp_tpu.kernels import _celerite, _spectral
    for name in _celerite.__all__ + _spectral.__all__:
        assert hasattr(lt, name), name
    for cls, kw in (('Celerite', dict(gamma=0.5, B=0.5)),
                    ('Celerite', dict(gamma=0.3)), ('Harmonic', dict(Q=2.0)),
                    ('Color', dict(n=4)), ('Sinc', {}), ('Pink', {}),
                    ('Cos', {})):
        kt, kj = getattr(lt, cls)(**kw), getattr(ltpu, cls)(**kw)
        assert kt.initkw == kj.initkw
        if kj._fastgram is not None:
            assert kt._fastgram.maxdim == kj._fastgram.maxdim
            assert kt._fastgram.mode == kj._fastgram.mode
    from lsqfitgp_torch.kernels import _celerite as tc, _spectral as ts
    for kw in (dict(gamma=0.5, B=0.5), dict(gamma=0.3), {}):
        assert tc._celerite_derivable(**kw) == \
            _celerite._celerite_derivable(**kw)
    for n in (2, 3, 4, 7):
        assert ts._color_derivable(n) == _spectral._color_derivable(n)


# -- special functions -----------------------------------------------------------

Z = np.concatenate([[1e-300, 1e-8, 0.3, 0.999, 1.0, 1.5, 3.9, 4.0, 4.1],
                    np.linspace(4.5, 7.9, 5), [8.0, 12.0, 80.0, 1e5, 3e9]])


def _grad(f, z, torch_side):
    if torch_side:
        t = torch.as_tensor(z).requires_grad_()
        (g,) = torch.autograd.grad(f(t).sum(), t)
        return g
    return jax.vmap(jax.grad(f))(jnp.asarray(z))


def test_sici():
    """Si and Ci and their derivatives, every branch, both signs."""
    z = np.concatenate([-Z[::3], [0.0], Z])
    close(special.si(torch.as_tensor(z)), jspecial.si(jnp.asarray(z)))
    close(special.ci(torch.as_tensor(Z)), jspecial.ci(jnp.asarray(Z)))
    close(special.ci(torch.zeros(1)), [-np.inf])
    for ft, fj in ((special.si, jspecial.si), (special.ci, jspecial.ci)):
        close(_grad(ft, Z, True), _grad(fj, Z, False))


@pytest.mark.parametrize('n', [2, 3, 5])
def test_expn_imag_real(n):
    """Re E_n(−ix): the series below 1, the continued fraction above, the
    limit below eps; and the first derivative off the clamp."""
    z = np.concatenate([[0.0], Z[:-2]])
    f = lambda v, m: m.expn_imag_real(n, v)
    close(f(torch.as_tensor(z), special), f(jnp.asarray(z), jspecial),
          rtol=1e-11, atol=1e-13)
    zz = Z[2:-3]
    close(_grad(lambda v: f(v, special), zz, True),
          _grad(lambda v: f(v, jspecial), zz, False), rtol=1e-10,
          atol=1e-12)


# -- build_profile and kernel C's plain version ----------------------------------

DYN = dict(a=1.3, os=1.4, al=1.7, g=0.3, B=0.1, q=0.7, tau=4.5, c=0.4,
           wa=1.6)


def _cases(mod, d):
    """name -> (kernel, point span): each new profile with its arguments
    dynamic (and some static), and 2-term sums with a new core."""
    return {
        'periodic': (d['a'] * mod.Periodic(outerscale=d['os']), 3),
        'holeeffect': (mod.HoleEffect() * d['a'], 3),
        'causalexpquad': (mod.CausalExpQuad(alpha=d['al'],
                                            derivable=False), 3),
        'log': (mod.Log(), 3),
        'wendland0': (mod.Wendland(k=0, alpha=1.5), 0.45),
        'wendland2': (mod.Wendland(k=2, alpha=d['wa']), 0.45),
        'wendland3': (d['a'] * mod.Wendland(k=3, alpha=d['wa']), 0.45),
        'circular': (mod.Circular(tau=d['tau'], c=d['c']), 3),
        'celerite': (d['a'] * mod.Celerite(gamma=d['g'], B=d['B']), 3),
        'celerite-static': (mod.Celerite(gamma=0.2, B=0.05), 3),
        'harmonic-lo': (mod.Harmonic(Q=d['q']), 3),
        'harmonic-hi': (mod.Harmonic(Q=d['q'] + 1.0), 3),
        'harmonic-0.3': (mod.Harmonic(Q=0.3), 3),
        'harmonic-0.8': (mod.Harmonic(Q=0.8), 3),
        'harmonic-1': (mod.Harmonic(Q=1.0), 3),
        'harmonic-2': (mod.Harmonic(Q=2.0), 3),
        'cos': (mod.Cos(), 3),
        'sinc': (mod.Sinc(), 3),
        'celerite+harmonic': (mod.Celerite(gamma=d['g'], B=d['B'])
                              + d['a'] * mod.Harmonic(Q=d['q']), 3),
        'periodic+expquad': (mod.Periodic(outerscale=d['os'], scale=2.0)
                             + d['a'] * mod.ExpQuad(scale=3.0), 3),
        # the spectral cores: δω dynamic and static, Color's series and
        # continued fraction (distances on both sides of 1)
        'pink': (d['a'] * mod.Pink(dw=d['os']), 3),
        'pink-static': (mod.Pink(dw=0.5), 3),
        'color2': (mod.Color(n=2), 3),
        'color3': (d['a'] * mod.Color(n=3), 3),
        'color5': (mod.Color(n=5), 3),
        'pink+color': (mod.Pink() + d['a'] * mod.Color(n=4, scale=2.0), 3),
    }


NAMES = sorted(_cases(lt, {k: 1.0 for k in DYN}))


@pytest.mark.parametrize('name', NAMES)
def test_build_profile(name):
    """The port's description evaluated by kernel C's plain version
    against the JAX package's profile on the same r², and the gradients
    of <G, K> in the points and in every dynamic number against
    jax.grad."""
    rng = np.random.default_rng(SEED + 7)
    keys = sorted(DYN)
    span = _cases(lt, {k: 1.0 for k in DYN})[name][1]
    x = np.concatenate([[0.0, 0.0], rng.uniform(-span, span, 14)])
    y = np.concatenate([[0.0], rng.uniform(-span, span, 9)])
    G = rng.standard_normal((x.size, y.size))

    def jfun(xx, *vals):
        spec = _cases(ltpu, dict(zip(keys, vals)))[name][0]._fastgram
        fn, params = jfg.build_profile(spec)
        K = fn((xx[:, None] - jnp.asarray(y)[None, :]) ** 2, *params)
        return jnp.sum(K * G), K

    (_, Kj), gj = jax.value_and_grad(
        jfun, argnums=tuple(range(len(keys) + 1)), has_aux=True)(
        jnp.asarray(x), *[jnp.asarray(DYN[k]) for k in keys])
    leaves = [torch.as_tensor(x).requires_grad_()] + [
        torch.as_tensor(DYN[k]).requires_grad_() for k in keys]
    spec = _cases(lt, dict(zip(keys, leaves[1:])))[name][0]._fastgram
    assert fg.why_not(spec) is None
    desc = fg.build_profile(spec)
    K = ops.gram(desc, leaves[0], torch.as_tensor(y))
    close(K, Kj)
    grads = torch.autograd.grad((K * torch.as_tensor(G)).sum(), leaves,
                                allow_unused=True)
    for g, r in zip(grads, gj):
        close(torch.zeros(()) if g is None else g, r, rtol=1e-11,
              atol=1e-12)


def test_why_not():
    """Every spec-carrying core has a CUDA profile now: the ten cores of
    this file, the real-order Matérn and Bessel, Pink, Color and
    StationaryFracBrownian; a Maternp order above the kernels' table and
    a sum of more than 4 profiled kernels are refused for a stated
    reason."""
    for k in (lt.Periodic(), lt.HoleEffect(), lt.CausalExpQuad(), lt.Log(),
              lt.Wendland(k=2), lt.Circular(), lt.Celerite(gamma=0.2),
              lt.Harmonic(Q=0.5), lt.Cos(), lt.Sinc(), lt.Matern(nu=1.5),
              lt.Bessel(nu=1.0), lt.Pink(), lt.Color(n=3),
              lt.StationaryFracBrownian(H=0.7)):
        assert fg.why_not(k._fastgram) is None
        assert fg.build_profile(k._fastgram) is not None
    for k, what in ((lt.Maternp(p=ops.MATERNP_MAX + 1), 'Maternp'),
                    (sum(lt.Cos(scale=s) for s in (1.0, 2.0, 3.0, 4.0, 5.0)),
                     'sum of 5')):
        assert what in fg.why_not(k._fastgram)
        assert fg.build_profile(k._fastgram) is None


def _jcore(core, *args):
    return lambda t: core(t, *args)


@pytest.mark.parametrize('name', ['pink-1.5', 'pink-0.2', 'color2', 'color3',
                                  'color5'])
def test_spectral_profiles(name):
    """The 'pink' and 'color' profiles' value, first t-derivative and
    δω-derivative against the JAX cores by autodiff: Pink below √eps
    (the cosine branch), near it and beyond; Color on both sides of t =
    1 (the series and the continued fraction) and below eps; g'' against
    a central difference of g'.  Pink's derivative in closed form
    (cos(tu) − cos t as a product of sines) against autodiff of the
    difference of two cosine integrals, which cancels: within 4 eps /
    (t log1p δω) absolute."""
    from lsqfitgp_tpu.kernels import _spectral as js
    kind, arg = name.split('-') if '-' in name else (name[:5], name[5:])
    prof = ops.PROFILES[kind]
    if kind == 'pink':
        dw = float(arg)
        t = np.array([0.0, 1e-12, 1e-9, 3e-8, 1e-6, 1e-3, 0.7, 5.0, 50.0])
        a, k = torch.tensor(dw), 0
        core = lambda v, w: js.Pink.__wrapped__(v, dw=w)
        g1j = jax.vmap(jax.grad(core), (0, None))(jnp.asarray(t), dw)
        gaj = jax.vmap(jax.grad(core, 1), (0, None))(jnp.asarray(t),
                                                      jnp.asarray(dw))
    else:
        k = int(arg)
        t = np.array([1e-20, 1e-3, 0.3, 0.999, 1.001, 3.0, 40.0])
        a = torch.tensor(0.0)
        core = lambda v, w: js.Color.__wrapped__(v, n=k)
        g1j = jax.vmap(jax.grad(core), (0, None))(jnp.asarray(t), 0.0)
        gaj = None
    tt = torch.as_tensor(t)
    gj = jax.vmap(core, (0, None))(jnp.asarray(t), dw if kind == 'pink'
                                   else 0.0)
    close(prof.value(tt, k, a, None), gj, rtol=1e-12, atol=1e-14)
    g1 = prof.deriv(tt, k, a, None)
    ok = t > 1e-15
    # JAX's (cos(tu) − cos t)/(t L) loses eps/(t L) to cancellation
    cancel = 4 * np.finfo(float).eps / (np.maximum(t, 1e-300)
                                        * math.log1p(float(a))) \
        if kind == 'pink' else 0 * t
    assert np.all(np.abs(g1.numpy() - np.asarray(g1j))[ok]
                  <= (1e-13 + cancel + 1e-10 * np.abs(np.asarray(g1j)))[ok])
    if gaj is not None:
        # at t = 0 JAX's where gives nan (its unselected branch's 0/0);
        # (cos(tu) − g)/(u L) cancels to eps/(u L) on both sides
        close(prof.dargs(tt, k, a, None)[0].numpy()[1:], np.asarray(gaj)[1:],
              rtol=1e-10, atol=4 * np.finfo(float).eps / math.log1p(dw))
    h = 1e-6 * np.maximum(t, 1e-3)
    far = t > 0.1
    d2 = (prof.deriv(tt + torch.as_tensor(h), k, a, None)
          - prof.deriv(tt - torch.as_tensor(h), k, a, None)) / \
        torch.as_tensor(2 * h)
    close(prof.deriv2(tt, k, a, None).numpy()[far], d2.numpy()[far],
          rtol=1e-5, atol=1e-8)


def _profile_at(name, t, mod):
    """(g, g', g'') of a profile by name at the distances t: the port's
    plain PROFILES functions, or the JAX core by autodiff."""
    if mod is lt:
        prof = ops.PROFILES[name]
        tt = torch.as_tensor(t)
        z = torch.zeros(())
        return [f(tt, 0, z, z) for f in (prof.value, prof.deriv,
                                         prof.deriv2)]
    core = {'log': lambda v: jnp.log1p(v) / v, 'sinc': jnp.sinc}[name]
    d1 = jax.grad(core)
    d2 = jax.grad(d1)
    tt = jnp.asarray(t)
    return [core(tt), jax.vmap(d1)(tt), jax.vmap(d2)(tt)]


@pytest.mark.parametrize('name', ['log', 'sinc'])
def test_series_profiles(name):
    """Log's and Sinc's cores take a series below their threshold (their
    closed forms cancel near 0): the value and its two derivatives
    against JAX's autodiff on each side of the threshold, and at t = eps
    (the 'posabs' distance at r² = 0) the value against JAX's and the
    derivatives against their limits (there JAX's autodiff cancels
    to noise)."""
    cut = (_gram.LOG_SERIES if name == 'log'
           else _gram.SINC_SERIES / math.pi)
    t = np.array([0.3 * cut, 0.999 * cut, 1.001 * cut, 2 * cut, 1.7, 9.0])
    got = _profile_at(name, t, lt)
    ref = _profile_at(name, t, ltpu)
    for a, b in zip(got, ref):
        close(a, b, rtol=1e-10, atol=1e-13)
    eps = np.finfo(np.float64).eps
    g, g1, g2 = _profile_at(name, np.array([eps]), lt)
    close(g, _profile_at(name, np.array([eps]), ltpu)[0])
    lim = {'log': (-0.5, 2 / 3), 'sinc': (0.0, -math.pi ** 2 / 3)}[name]
    close(g1, [lim[0]], atol=1e-14)
    close(g2, [lim[1]], atol=1e-14)


def test_harmonic_profile_does_not_overflow():
    """Below Q = 1 the profile takes e^{-(1-η)s} and expm1(−2ηs) where
    the JAX expression takes cosh and sinh: at large distances (here
    η t / Q past float64's exp range) it stays finite and equals the
    analytic two-exponential form, where the JAX core gives nan."""
    Q = 0.6
    t = np.array([1.0, 50.0, 1000.0, 2000.0])
    prof = ops.PROFILES['harmonic']
    g = prof.value(torch.as_tensor(t), 0, torch.tensor(Q), None)
    eta = math.sqrt(1 - Q * Q)
    ref = 0.5 * ((1 + 1 / eta) * np.exp(-(1 - eta) * t / Q)
                 + (1 - 1 / eta) * np.exp(-(1 + eta) * t / Q))
    close(g, ref)
    assert np.isnan(np.asarray(ltpu.Harmonic(Q=Q)(jnp.asarray(t),
                                                   jnp.zeros(4)))[-1])


def _jdesc(name):
    keys = sorted(DYN)
    spec = _cases(ltpu, {k: jnp.asarray(DYN[k]) for k in keys})[name][0] \
        ._fastgram
    return jfg.build_profile(spec)


def _tdesc(name):
    keys = sorted(DYN)
    spec = _cases(lt, {k: torch.as_tensor(DYN[k]) for k in keys})[name][0] \
        ._fastgram
    return fg.build_profile(spec)


@pytest.mark.parametrize('name', ['celerite', 'harmonic-lo', 'periodic',
                                  'celerite+harmonic'])
def test_ops_against_jax(name):
    """`ops.gram` (with a nugget), `gram_sym` and `schur_update_gram` on
    a description, p = 1, against the JAX functions in interpret mode."""
    rng = np.random.default_rng(SEED + 3)
    x = rng.uniform(-20, 20, (40, 1))
    y = rng.uniform(-20, 20, (24, 1))
    fn, params = _jdesc(name)
    desc = _tdesc(name)
    ref = jops.gram(fn, jnp.asarray(x), jnp.asarray(y), params=params,
                    noise=0.2, tile=128, interpret=True)
    close(ops.gram(desc, torch.as_tensor(x), torch.as_tensor(y), noise=0.2),
          ref, atol=1e-12)
    ref = jops.gram_sym(fn, jnp.asarray(x), params=params, noise=0.3,
                        tile=128, interpret=True)
    close(ops.gram_sym(desc, torch.as_tensor(x), noise=0.3), ref, atol=1e-12)
    tile, size, offset = 128, 128, 128
    npad = offset + size
    nreal = npad - 30
    X = rng.uniform(-30, 30, (npad, 1))
    A = rng.standard_normal((size, 128)) / 4
    ref = jops._syrk.schur_update_gram(
        fn, jnp.asarray(X), jnp.sum(jnp.asarray(X) ** 2, -1, keepdims=True),
        jnp.asarray(A), params=params, eps=0.1, nreal=nreal, size=size,
        offset=offset, tile=tile, kchunk=tile, precision='highest',
        interpret='pallas')
    got = ops.schur_update_gram(desc, torch.as_tensor(X), torch.as_tensor(A),
                                eps=0.1, nreal=nreal, size=size,
                                offset=offset, tile=tile)
    close(got, ref, rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize('name', ['periodic', 'celerite', 'wendland2'])
def test_backward_and_tangents_plain(name):
    """The plain backward and C′ on a description against autograd and
    forward AD of the plain Gram (the backward to 1e-12, C′ to a central
    difference at 1e-6); C″ on Periodic, smooth at 0, against the
    double backward."""
    import torch.autograd.forward_ad as fwAD
    rng = np.random.default_rng(SEED + 11)
    span = 0.4 if name.startswith('wendland') else 2
    x = torch.as_tensor(rng.uniform(-span, span, (30, 1)))
    y = torch.as_tensor(np.concatenate([[[0.0]],
                                        rng.uniform(-span, span, (12, 1))]))
    x[0] = 0.0
    G = torch.as_tensor(rng.standard_normal((30, 13)))
    desc = _tdesc(name)
    vals = list(_gram._flat(desc))
    st = _gram._struct(desc)
    pvec = torch.stack([torch.as_tensor(v) for v in vals]
                       + [torch.tensor(0.1)])
    dx = torch.as_tensor(rng.standard_normal((30, 1)))
    dp = torch.as_tensor(rng.standard_normal(pvec.shape))

    def K(xx, pv):
        return ops.gram(_gram._rebuild(st, pv[:-1]), xx, y, noise=pv[-1])

    xx, pv = x.clone().requires_grad_(), pvec.clone().requires_grad_()
    gx, gp = torch.autograd.grad((K(xx, pv) * G).sum(), (xx, pv))
    gxb, _, gpb = ops.gram_backward_plain(G, _gram._rebuild(st, vals), x, y,
                                          noise=0.1)
    close(gx, gxb)
    close(gp, gpb)
    with fwAD.dual_level():
        tan = fwAD.unpack_dual(K(fwAD.make_dual(x, dx),
                                 fwAD.make_dual(pvec, dp))).tangent
    fd = (K(x + 1e-6 * dx, pvec + 1e-6 * dp)
          - K(x - 1e-6 * dx, pvec - 1e-6 * dp)) / 2e-6
    close(tan, fd, rtol=1e-6, atol=1e-7)
    if name == 'periodic':
        post = _gram._rebuild(st, vals)
        got = ops.gram_backward_jvp_plain(G, post, x, y, dx, noise=0.1)
        xx = x.clone().requires_grad_()
        k = ops.gram(post, xx, y, noise=0.1)
        (g1,) = torch.autograd.grad((k * G).sum(), xx, create_graph=True)
        (h,) = torch.autograd.grad((g1 * dx).sum(), xx)
        close(got[0], h, rtol=1e-10, atol=1e-12)


# -- the slice: the time-series example's model ----------------------------------

N = 300
TRUE = dict(amp=1.2, gamma=0.1, B=0.05, noise=0.04)


@pytest.fixture(scope='module')
def series():
    """The example's sampling density (t uniform on [0, 120 n / 700]) and
    model, drawn by a Cholesky of the true covariance."""
    rng = np.random.default_rng(SEED)
    t = np.sort(rng.uniform(0.0, 120.0 * N / 700, N))
    d = np.abs(t[:, None] - t[None, :])
    K = TRUE['amp'] * np.exp(-TRUE['gamma'] * d) * (
        np.cos(d) + TRUE['B'] * np.sin(d)) + TRUE['noise'] * np.eye(N)
    return t, np.linalg.cholesky(K) @ rng.standard_normal(N)


def _model(mod, hp, **kw):
    k = hp['amp'] * mod.Celerite(gamma=hp['gamma'], B=0.05) \
        + hp['noise'] * mod.White()
    return mod.GP(k, **kw)


PRIOR = {'log(amp)': (0.0, 1.0), 'log(gamma)': (math.log(0.2), 1.0),
         'log(noise)': (math.log(0.02), 1.0)}


@pytest.mark.parametrize('solver', ['tiled', 'chol-stream'])
def test_model(series, solver):
    """The example's NLL and its gradient in the log hyperparameters,
    dense through kernel C's plain version and streaming with the exact
    gradient (C and D's plain versions), against the JAX package."""
    t, y = series
    kw = dict(gram='tiled') if solver == 'tiled' \
        else dict(solver='chol-stream', block=128, b1=128)
    p0 = np.array([0.1, math.log(0.15), math.log(0.05)])
    keys = ('amp', 'gamma', 'noise')

    def fj(p):
        hp = {k: jnp.exp(p[i]) for i, k in enumerate(keys)}
        return _model(ltpu, hp, **kw).addx(t, 'obs') \
            .marginal_likelihood({'obs': y})

    vj, gj = jax.value_and_grad(fj)(jnp.asarray(p0))
    p = torch.as_tensor(p0).requires_grad_()
    hp = {k: p[i].exp() for i, k in enumerate(keys)}
    v = _model(lt, hp, **kw).addx(t, 'obs').marginal_likelihood({'obs': y})
    v.backward()
    close(v, vj, rtol=1e-9)
    close(p.grad, gj, rtol=1e-8, atol=1e-9)


def test_fit(series):
    """A 3-iteration streaming empbayes_fit of the example's model ends
    at the JAX package's hyperparameters (BFGS walks the same iterates
    on both sides)."""
    t, y = series

    def factory(mod):
        return lambda hp: _model(mod, hp, solver='chol-stream', block=128,
                                 b1=128).addx(t, 'obs')

    kw = dict(minkw={'options': {'maxiter': 3}}, raises=False)
    fj = ltpu.empbayes_fit(PRIOR, factory(ltpu), {'obs': y}, **kw)
    ft = lt.empbayes_fit(PRIOR, factory(lt), {'obs': y}, **kw)
    close(ft.pmean.buf, fj.pmean.buf, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize('solver', ['tiled', 'chol-stream'])
@pytest.mark.parametrize('core', ['pink', 'color'])
def test_spectral_model(series, core, solver):
    """amp * Pink(dw) + noise * White() and amp * Color(n=3, scale) +
    noise * White() on the example's series: NLL and gradient in the log
    hyperparameters, dense through kernel C's plain version and
    streaming (C and D's plain versions), against the JAX package."""
    t, y = series
    kw = dict(gram='tiled') if solver == 'tiled' \
        else dict(solver='chol-stream', block=128, b1=128)
    p0 = np.array([0.1, math.log(0.8), math.log(0.05)])

    def model(mod, p, exp):
        if core == 'pink':
            k = exp(p[0]) * mod.Pink(dw=exp(p[1]))
        else:
            k = exp(p[0]) * mod.Color(n=3, scale=exp(p[1]))
        return mod.GP(k + exp(p[2]) * mod.White(), **kw).addx(t, 'obs')

    vj, gj = jax.value_and_grad(
        lambda p: model(ltpu, p, jnp.exp).marginal_likelihood({'obs': y}))(
        jnp.asarray(p0))
    p = torch.as_tensor(p0).requires_grad_()
    v = model(lt, p, torch.exp).marginal_likelihood({'obs': y})
    v.backward()
    close(v, vj, rtol=1e-9)
    close(p.grad, gj, rtol=1e-8, atol=1e-9)


@pytest.mark.parametrize('name', ['timeseries_streaming', 'periodic_seasonal',
                                  'decompose_series'])
def test_example(name):
    """The time-series examples run against lsqfitgp_torch with their own
    assertions (the import line swapped; ``timeseries_streaming.py``'s
    ``jnp.asarray`` arrays reach the port through numpy's
    ``__array__``)."""
    path = os.path.join(ROOT, 'examples', name + '.py')
    src = open(path).read()
    assert 'import lsqfitgp_tpu as lgp' in src
    src = src.replace('import lsqfitgp_tpu as lgp',
                      'import lsqfitgp_torch as lgp')
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float32)
    try:
        ns = {'__name__': 'example'}
        exec(compile(src, path, 'exec'), ns)
        ns['main']()
    finally:
        torch.set_default_dtype(old)
