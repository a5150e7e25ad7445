"""The random-walk kernels (Wiener, FracBrownian, WienerIntegral,
OrnsteinUhlenbeck, BrownianBridge, StationaryFracBrownian) and the
profile 'sfb' that kernels C, D and E evaluate for StationaryFracBrownian,
on the CPU, against the JAX package on the same inputs (made from a seed
with numpy).

- the kernels' values, their derivative kernels where ``derivable``
  allows, and forward mode (torch's forward AD against ``jax.jvp``),
  with the min/max derivative rules at ties;
- the 'sfb' profile's value, t-derivative and H-derivative against the
  JAX core by autodiff at t = 0, 1, 2 and at large lags, and in float32
  against a float64 truth where the JAX expression cancels;
- the description through kernel C's plain version with its gradients,
  ``ops.gram``/``gram_sym``/``schur_update_gram`` against the JAX
  functions in interpret mode, and the fractional-Gaussian-noise model
  through the GP (dense ``gram='tiled'`` and ``chol-stream``).

Tolerances, in float64: the same formulas with sums in another order,
1e-12 relative; the profile against the JAX expression, which cancels
three powers of about t^2H, absolute 8 eps t^2H (the series form the
port takes from t = 2 on does not); GP likelihoods and gradients 1e-9
and 1e-8 as in ``tests/test_torch_gp.py``.  In float32 the profile is
held to its float64 value within 16 eps32 of the value's scale
(|H(2H−1)| t^(2H−2)), where the JAX float32 expression loses the value.
"""

import math

import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD
import jax
from jax import numpy as jnp

import lsqfitgp_tpu as ltpu
from lsqfitgp_tpu import ops as jops
from lsqfitgp_tpu.kernelalg import _fastgram as jfg
import lsqfitgp_torch as lt
from lsqfitgp_torch import ops
from lsqfitgp_torch.kernelalg import _fastgram as fg
from lsqfitgp_torch.ops import _gram

pytestmark = pytest.mark.x64only

SEED = 20261020


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

# name: (class, arguments, point kind, derivative kernels to check)
KERNELS = {
    'Wiener': ('Wiener', {}, 'pos', []),
    'FracBrownian': ('FracBrownian', dict(H=0.7, K=0.8), 'real', []),
    'FracBrownian-1': ('FracBrownian', dict(H=1, K=1), 'real', [(1, 1)]),
    'WienerIntegral': ('WienerIntegral', {}, 'pos', [(1, 1), (1, 0)]),
    'OrnsteinUhlenbeck': ('OrnsteinUhlenbeck', {}, 'pos', []),
    'BrownianBridge': ('BrownianBridge', {}, 'unit', []),
    'SFB-0.3': ('StationaryFracBrownian', dict(H=0.3), 'real', []),
    'SFB-0.75': ('StationaryFracBrownian', dict(H=0.75), 'real', []),
    'SFB-1': ('StationaryFracBrownian', dict(H=1), 'real', [(1, 1)]),
}


def _points(kind, rng):
    """(x, y) with ties (x's first three among y's)."""
    lo, hi = {'pos': (0, 4), 'unit': (0, 1), 'real': (-3, 3)}[kind]
    x = rng.uniform(lo, hi, 9)
    return x, np.concatenate([x[:3], rng.uniform(lo, hi, 5)])


@pytest.mark.parametrize('name', sorted(KERNELS))
def test_kernel(name):
    """Values and derivative kernels against the JAX package's."""
    cls, kw, kind, derivs = KERNELS[name]
    rng = np.random.default_rng(SEED + sorted(KERNELS).index(name))
    x, y = _points(kind, rng)
    kt, kj = getattr(lt, cls)(**kw), getattr(ltpu, cls)(**kw)
    for d in [(0, 0)] + derivs:
        ft, fj = (kt, kj) if d == (0, 0) else \
            (kt.linop('diff', *d), kj.linop('diff', *d))
        got = ft(torch.as_tensor(x)[:, None], torch.as_tensor(y)[None, :])
        ref = fj(jnp.asarray(x)[:, None], jnp.asarray(y)[None, :])
        close(got, ref, atol=1e-12)


@pytest.mark.parametrize('name', ['FracBrownian-1', 'WienerIntegral',
                                  'SFB-1'])
def test_forward_mode(name):
    """Forward AD of the derivable kernels along both points (ties
    included, where the min/max rules pick one side) against
    ``jax.jvp``."""
    cls, kw, kind, _ = KERNELS[name]
    rng = np.random.default_rng(SEED + 100 + sorted(KERNELS).index(name))
    x, y = _points(kind, rng)
    X, Y = (np.array(a) for a in np.broadcast_arrays(x[:, None],
                                                     y[None, :]))
    dX, dY = rng.standard_normal(X.shape), rng.standard_normal(Y.shape)
    kt, kj = getattr(lt, cls)(**kw), getattr(ltpu, cls)(**kw)
    _, ref = jax.jvp(lambda a, b: kj(a, b), (jnp.asarray(X), jnp.asarray(Y)),
                     (jnp.asarray(dX), jnp.asarray(dY)))
    with fwAD.dual_level():
        out = kt(fwAD.make_dual(torch.as_tensor(X), torch.as_tensor(dX)),
                 fwAD.make_dual(torch.as_tensor(Y), torch.as_tensor(dY)))
        got = fwAD.unpack_dual(out).tangent
    close(got, ref, atol=1e-12)


@pytest.mark.parametrize('name', ['FracBrownian', 'SFB-0.3', 'SFB-0.75'])
def test_forward_mode_hyper(name):
    """Forward AD along H (a tensor: the fit's ``forward=True`` and Fisher
    paths) against ``jax.jvp``, lags of 0 and 1 included (no
    H-derivative where a base is 0)."""
    cls, kw, kind, _ = KERNELS[name]
    rng = np.random.default_rng(SEED + 200 + sorted(KERNELS).index(name))
    x, y = _points(kind, rng)
    y = np.concatenate([y, x[:2] + 1])
    rest = {k: v for k, v in kw.items() if k != 'H'}

    def fj(h):
        k = getattr(ltpu, cls)(H=h, **rest)
        return k(jnp.asarray(x)[:, None], jnp.asarray(y)[None, :])

    _, ref = jax.jvp(fj, (jnp.asarray(kw['H']),), (jnp.asarray(1.0),))
    with fwAD.dual_level():
        h = fwAD.make_dual(torch.tensor(kw['H']), torch.tensor(1.0))
        k = getattr(lt, cls)(H=h, **rest)
        out = k(torch.as_tensor(x)[:, None], torch.as_tensor(y)[None, :])
        got = fwAD.unpack_dual(out).tangent
    close(got, ref, atol=1e-12)


def test_minmax_at_ties():
    """WienerIntegral's min and max send the derivative at x == y wholly
    to one side (the JAX custom JVPs); torch's own would split it."""
    from lsqfitgp_torch.kernels import _randomwalk as rw
    x = torch.tensor([1.0, 2.0, 3.0], requires_grad=True)
    y = torch.tensor([1.0, 1.5, 3.5], requires_grad=True)
    gx, gy = torch.autograd.grad(rw._minimum(x, y).sum(), (x, y))
    close(gx, [0.0, 0.0, 1.0])
    close(gy, [1.0, 1.0, 0.0])
    gx, gy = torch.autograd.grad(rw._maximum(x, y).sum(), (x, y))
    close(gx, [1.0, 1.0, 0.0])
    close(gy, [0.0, 0.0, 1.0])
    # broadcast operands reduce to their shapes
    xb, yb = x[:, None], y[None, :]
    gx, gy = torch.autograd.grad(rw._minimum(xb, yb).sum(), (x, y))
    jx, jy = jax.grad(lambda a, b: jnp.sum(
        ltpu.kernels._randomwalk._minimum(a[:, None], b[None, :])),
        argnums=(0, 1))(jnp.asarray(x.detach()), jnp.asarray(y.detach()))
    close(gx, jx)
    close(gy, jy)


def test_exports():
    """The kernels are at the top level and in ``kernels``, with the JAX
    package's derivable and maxdim rules."""
    from lsqfitgp_tpu.kernels import _randomwalk
    for name in _randomwalk.__all__:
        assert hasattr(lt, name) and hasattr(lt.kernels, name), name
    for cls, kw in (('FracBrownian', dict(H=1, K=1)),
                    ('StationaryFracBrownian', dict(H=0.4)),
                    ('WienerIntegral', {})):
        kt, kj = getattr(lt, cls)(**kw), getattr(ltpu, cls)(**kw)
        assert kt.initkw == kj.initkw
    for k, ok in ((lt.StationaryFracBrownian(H=0.7), True),
                  (lt.StationaryFracBrownian(H=torch.tensor(0.7)), True),
                  (lt.Wiener(), False), (lt.OrnsteinUhlenbeck(), False)):
        spec = getattr(k, '_fastgram', None)
        assert (spec is not None and fg.why_not(spec) is None) == ok


# -- the profile ---------------------------------------------------------------

def _jcore(t, H):
    a = 2 * H
    return 0.5 * (jnp.abs(t + 1) ** a + jnp.abs(t - 1) ** a
                  - 2 * jnp.abs(t) ** a)


@pytest.mark.parametrize('H', [0.3, 0.5, 0.75, 1.0])
def test_sfb_profile(H):
    """The profile's value, t- and H-derivatives against the JAX core by
    autodiff on each side of the series' switch (t = 2), at t = 0, 1, 2
    and at large lags; the t-derivative away from the points where it
    is singular (t = 0 and 1 for H < 1/2)."""
    t = np.array([0.0, 0.3, 1.0, 1.5, 1.999, 2.0, 2.001, 3.0, 17.0, 300.0,
                  16383.0])
    prof = _gram.PROFILES['sfb']
    tt, Ht = torch.as_tensor(t), torch.tensor(H)
    g, g1, ga = (prof.value(tt, 0, Ht, None), prof.deriv(tt, 0, Ht, None),
                 prof.dargs(tt, 0, Ht, None)[0])
    tj = jnp.asarray(t)
    gj = _jcore(tj, H)
    g1j = jax.vmap(jax.grad(_jcore), (0, None))(tj, H)
    gaj = jax.vmap(jax.grad(_jcore, 1), (0, None))(tj, jnp.asarray(H))
    scale = 8 * np.finfo(float).eps * np.maximum(t, 1) ** (2 * H)

    def within(a, b, rtol, atol):
        a = a.detach().numpy() if isinstance(a, torch.Tensor) else a
        b = np.asarray(b)
        assert np.all(np.abs(a - b) <= atol + rtol * np.abs(b)), (a, b)

    within(g, gj, 1e-12, scale)
    within(ga, gaj, 1e-11, scale * np.log(np.maximum(t, 2)) * 4)
    ok = (t > 0) & (t != 1) if H < 0.5 else t > 0
    within(g1.numpy()[ok], np.asarray(g1j)[ok], 1e-11, scale[ok] * 4)
    # g'' against the derivative of g' (central difference)
    h = 1e-5
    far = t > 2.5
    d2 = (prof.deriv(tt + h, 0, Ht, None) - prof.deriv(tt - h, 0, Ht, None)) \
        / (2 * h)
    close(prof.deriv2(tt, 0, Ht, None).numpy()[far], d2.numpy()[far],
          rtol=1e-6, atol=1e-12)


def test_sfb_float32():
    """At lags to 16384 the float32 profile stays within 16 eps32 of the
    value's scale |H(2H−1)| t^(2H−2) of its float64 value, where the JAX
    float32 expression loses half the value or all of it (its three
    powers of about t^2H cancel; ROADMAP's reference-side faults)."""
    H = 0.75
    t = np.array([2.5, 10.0, 300.0, 4096.0, 16383.0])
    prof = _gram.PROFILES['sfb']
    truth = prof.value(torch.as_tensor(t), 0, torch.tensor(H), None).numpy()
    got = prof.value(torch.as_tensor(t, dtype=torch.float32), 0,
                     torch.tensor(H, dtype=torch.float32), None).numpy()
    scale = abs(H * (2 * H - 1)) * t ** (2 * H - 2)
    eps32 = np.finfo(np.float32).eps
    assert np.all(np.abs(got - truth) <= 16 * eps32 * scale)
    jax32 = np.asarray(_jcore(jnp.asarray(t, jnp.float32), jnp.float32(H)))
    assert np.all(np.abs(jax32 - truth)[-2:] >= 0.5 * truth[-2:])


def _cases(mod, H):
    return {
        'sfb': 1.3 * mod.StationaryFracBrownian(H=H),
        'sfb-scaled': mod.StationaryFracBrownian(H=H, scale=0.5) + 0.2,
        'sfb+expquad': mod.StationaryFracBrownian(H=H)
        + 0.7 * mod.ExpQuad(scale=3.0),
    }


@pytest.mark.parametrize('name', ['sfb', 'sfb-scaled', 'sfb+expquad'])
def test_build_profile(name):
    """The port's description evaluated by kernel C's plain version
    against the JAX package's profile (its cancelling expression: the
    absolute tolerance above) and the gradients of <G, K> in the points
    and in H against jax.grad."""
    rng = np.random.default_rng(SEED + 7)
    H = 0.7
    x = np.concatenate([[0.0, 0.0, 1.0, 2.0], rng.uniform(-12, 12, 14)])
    y = np.concatenate([[0.0], rng.uniform(-12, 12, 9)])
    G = rng.standard_normal((x.size, y.size))

    def jfun(xx, h):
        fn, params = jfg.build_profile(_cases(ltpu, h)[name]._fastgram)
        K = fn((xx[:, None] - jnp.asarray(y)[None, :]) ** 2, *params)
        return jnp.sum(K * G), K

    (_, Kj), gj = jax.value_and_grad(jfun, (0, 1), has_aux=True)(
        jnp.asarray(x), jnp.asarray(H))
    xt = torch.as_tensor(x).requires_grad_()
    Ht = torch.tensor(H, requires_grad=True)
    spec = _cases(lt, Ht)[name]._fastgram
    assert fg.why_not(spec) is None
    K = ops.gram(fg.build_profile(spec), xt, torch.as_tensor(y))
    atol = 8 * np.finfo(float).eps * 48 ** (2 * H) * 4
    close(K, Kj, atol=atol)
    gx, gH = torch.autograd.grad((K * torch.as_tensor(G)).sum(), (xt, Ht))
    # the points' gradient where no lag is 0 or 1 (a kink of |t − 1|)
    close(gx.numpy()[4:], np.asarray(gj[0])[4:], rtol=1e-10, atol=1e-10)
    close(gH, gj[1], rtol=1e-10, atol=1e-10)


def test_ops_against_jax():
    """`ops.gram` (with a nugget), `gram_sym` and `schur_update_gram` on
    the 'sfb' description, p = 1, against the JAX functions in
    interpret mode."""
    rng = np.random.default_rng(SEED + 3)
    x = rng.uniform(-20, 20, (40, 1))
    y = rng.uniform(-20, 20, (24, 1))
    spec = _cases(ltpu, jnp.asarray(0.7))['sfb']._fastgram
    fn, params = jfg.build_profile(spec)
    desc = fg.build_profile(_cases(lt, torch.tensor(0.7))['sfb']._fastgram)
    atol = 8 * np.finfo(float).eps * 80 ** 1.4 * 4
    ref = jops.gram(fn, jnp.asarray(x), jnp.asarray(y), params=params,
                    noise=0.2, tile=128, interpret=True)
    close(ops.gram(desc, torch.as_tensor(x), torch.as_tensor(y), noise=0.2),
          ref, atol=atol)
    ref = jops.gram_sym(fn, jnp.asarray(x), params=params, noise=0.3,
                        tile=128, interpret=True)
    close(ops.gram_sym(desc, torch.as_tensor(x), noise=0.3), ref, atol=atol)
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
    close(got, ref, rtol=1e-10, atol=8 * np.finfo(float).eps * 120 ** 1.4 * 4)


def test_backward_and_tangents_plain():
    """The plain backward and C′ on the 'sfb' description against
    autograd and forward AD of the plain Gram (the backward to 1e-12, C′
    to a central difference), points apart from lags 0 and 1."""
    rng = np.random.default_rng(SEED + 11)
    x = torch.as_tensor(rng.uniform(-6, 6, (30, 1)))
    y = torch.as_tensor(rng.uniform(-6, 6, (12, 1)))
    G = torch.as_tensor(rng.standard_normal((30, 12)))
    desc = fg.build_profile(_cases(lt, torch.tensor(0.7))['sfb']._fastgram)
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


# -- the slice: fractional Gaussian noise through the GP --------------------------

N = 300


def _model(mod, p, **kw):
    """amp * StationaryFracBrownian(H) + noise * White() on the unit grid,
    H = 1/(1 + e^{-h})."""
    exp = jnp.exp if mod is ltpu else torch.exp
    H = 1 / (1 + exp(-p[1]))
    k = exp(p[0]) * mod.StationaryFracBrownian(H=H) + exp(p[2]) * mod.White()
    return mod.GP(k, **kw)


@pytest.mark.parametrize('solver', ['tiled', 'chol-stream'])
def test_model(solver):
    """The fractional-Gaussian-noise model's NLL and gradient in (log amp,
    h, log noise), dense through kernel C's plain version and streaming
    with the exact gradient (C and D's plain versions), against the JAX
    package."""
    rng = np.random.default_rng(SEED)
    t = np.arange(N, dtype=float)
    y = rng.standard_normal(N)
    kw = dict(gram='tiled') if solver == 'tiled' \
        else dict(solver='chol-stream', block=128, b1=128)
    p0 = np.array([0.1, 1.0, math.log(0.3)])

    def fj(p):
        return _model(ltpu, p, **kw).addx(t, 'y').marginal_likelihood(
            {'y': y})

    vj, gj = jax.value_and_grad(fj)(jnp.asarray(p0))
    p = torch.as_tensor(p0).requires_grad_()
    v = _model(lt, p, **kw).addx(t, 'y').marginal_likelihood({'y': y})
    v.backward()
    close(v, vj, rtol=1e-9)
    close(p.grad, gj, rtol=1e-8, atol=1e-9)
