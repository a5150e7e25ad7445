"""The port's kernel zoo, its special functions and the zoo's profiles in
kernels C, D and E on the CPU, against the JAX package on the same
inputs (made from a seed with numpy), in float64.

- every ported zoo kernel's values, and its derivative kernels where
  ``derivable`` allows (``linop('diff', ...)``);
- ``kvmodx2_hi``, ``kvmodx2`` and ``jvmodx2`` and their x²-derivatives
  on grids that include x² = 0;
- the port's ``build_profile`` description, evaluated by kernel C's
  plain version (``ops.gram``), and its gradients in the points and the
  dynamic numbers, against the JAX ``build_profile`` profile and
  ``jax.grad``, for single cores in each distance mode and 2- and 3-term
  sums;
- ``ops.gram``, ``gram_sym`` and ``schur_update_gram`` on those
  descriptions against the JAX functions in interpret mode;
- the Matérn-5/2 model and the multi-scale term sum through the GP,
  dense and ``chol-stream`` (exact gradient), and a 3-iteration
  ``empbayes_fit`` of the Matérn model, against ``lsqfitgp_tpu``.

Tolerances: the same float64 formulas with sums in another order, 1e-12
relative unless a test says otherwise: the real-order Bessel functions'
quadratures and series 1e-10, relative and absolute (their terms are
summed in another order over 100 nodes or 40 terms, and J_ν's
alternating series cancels terms up to e^x: 2e-11 absolute at x = 12
on the zoo test's points), GP likelihoods and gradients 1e-9 and 1e-8
as in ``tests/test_torch_gp.py`` (condition numbers below 1e5).
"""

import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD
import jax
from jax import numpy as jnp

import lsqfitgp_tpu as ltpu
from lsqfitgp_tpu import ops as jops
from lsqfitgp_tpu import special as jspecial
from lsqfitgp_tpu.kernelalg import _fastgram as jfg
import lsqfitgp_torch as lt
from lsqfitgp_torch import ops, special
from lsqfitgp_torch.kernelalg import _fastgram as fg

pytestmark = pytest.mark.x64only

SEED = 20261017
RTOL = 1e-12


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


def close(a, b, rtol=RTOL, atol=1e-13):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol)


# -- the zoo -------------------------------------------------------------------

def _points(kind, rng):
    """(x, y) as numpy arrays of the kind a kernel takes."""
    if kind == 'pos':
        return rng.uniform(0, 3, 9), rng.uniform(0, 3, 7)
    if kind == 'int':
        return rng.integers(0, 3, 9), rng.integers(0, 3, 7)
    if kind == 'str':
        words = np.array(['a b c', 'b c', 'c, c d', 'x y', 'a-a b'])
        return words[rng.integers(0, 5, 6)], words[rng.integers(0, 5, 5)]
    if kind == 'unit':
        return rng.uniform(-0.9, 0.9, 9), rng.uniform(-0.9, 0.9, 7)
    x = rng.uniform(-3, 3, 9)
    return x, np.concatenate([x[:3], rng.uniform(-3, 3, 4)])


COV = np.array([[1.0, 0.3, 0.1], [0.3, 2.0, -0.2], [0.1, -0.2, 1.5]])

# name: (constructor arguments, point kind, derivatives to check)
ZOO = {
    'Maternp-0': ('Maternp', dict(p=0), 'real', []),
    'Maternp-1': ('Maternp', dict(p=1), 'real', [(1, 1)]),
    'Maternp-2': ('Maternp', dict(p=2, scale=1.3), 'real', [(1, 1), (2, 2)]),
    'Maternp-3': ('Maternp', dict(p=3), 'real', [(2, 2), (3, 1)]),
    'Matern-0.5': ('Matern', dict(nu=0.5), 'real', []),
    'Matern-2.2': ('Matern', dict(nu=2.2), 'real', [(1, 1), (2, 0)]),
    'Bessel-0': ('Bessel', dict(nu=0), 'unit', []),
    'Bessel-3': ('Bessel', dict(nu=3.0), 'unit', [(1, 1)]),
    'Linear': ('Linear', {}, 'real', [(1, 1)]),
    'GammaExp-1': ('GammaExp', dict(gamma=1), 'real', []),
    'GammaExp-1.5': ('GammaExp', dict(gamma=1.5), 'real', []),
    'GammaExp-2': ('GammaExp', dict(gamma=2), 'real', [(1, 1), (2, 2)]),
    'NNKernel': ('NNKernel', dict(sigma0=1.3), 'real', [(1, 1)]),
    'Gibbs': ('Gibbs', dict(scalefun=lambda x: 1 + x ** 2 / 4), 'real', []),
    'Periodic': ('Periodic', dict(outerscale=1.5), 'real', [(1, 1)]),
    'Categorical': ('Categorical', dict(cov=COV), 'int', []),
    'Rescaling': ('Rescaling', dict(stdfun=lambda x: 1 + x ** 2), 'real',
                  []),
    'Expon': ('Expon', {}, 'real', []),
    'BagOfWords': ('BagOfWords', {}, 'str', []),
    'HoleEffect': ('HoleEffect', {}, 'real', []),
    'Cauchy-2': ('Cauchy', dict(beta=1.5), 'real', [(1, 1)]),
    'Cauchy-1.2': ('Cauchy', dict(alpha=1.2, beta=2.5), 'real', []),
    'CausalExpQuad': ('CausalExpQuad', dict(alpha=1.5), 'real', []),
    'CausalExpQuad-0': ('CausalExpQuad', dict(alpha=0), 'real', [(1, 1)]),
    'Decaying': ('Decaying', dict(alpha=1.5), 'pos', [(1, 1)]),
    'Log': ('Log', {}, 'real', []),
    'Taylor': ('Taylor', {}, 'real', [(1, 1)]),
    'Wendland-0': ('Wendland', dict(k=0, alpha=1.5), 'unit', []),
    'Wendland-2': ('Wendland', dict(k=2, alpha=1.5), 'unit', [(1, 1)]),
    'Wendland-3': ('Wendland', dict(k=3, alpha=1), 'unit', [(2, 1)]),
    'Circular': ('Circular', dict(tau=4, c=0.5), 'unit', [(1, 1)]),
}


def _kw(mod, kw):
    if 'scalefun' in kw or 'stdfun' in kw:
        name = 'scalefun' if 'scalefun' in kw else 'stdfun'
        f = {'scalefun': lambda x: 1 + x ** 2 / 4,
             'stdfun': lambda x: 1 + x ** 2}[name]
        return {name: f}
    if 'cov' in kw:
        return dict(cov=kw['cov'] if mod is ltpu else torch.as_tensor(kw['cov']))
    return kw


@pytest.mark.parametrize('name', sorted(ZOO))
def test_zoo_kernel(name):
    """Values and derivative kernels of each ported zoo kernel against
    the JAX package's."""
    cls, kw, kind, derivs = ZOO[name]
    rng = np.random.default_rng(SEED + sorted(ZOO).index(name))
    x, y = _points(kind, rng)
    kt = getattr(lt, cls)(**_kw(lt, kw))
    kj = getattr(ltpu, cls)(**_kw(ltpu, kw))
    tol = dict(rtol=1e-10, atol=1e-10) if cls in ('Matern', 'Bessel') \
        else {}
    for d in [(0, 0)] + derivs:
        if d == (0, 0):
            ft, fj = kt, kj
        else:
            ft, fj = kt.linop('diff', *d), kj.linop('diff', *d)
        if kind == 'str':
            got = ft(x[:, None], y[None, :])
            ref = fj(x[:, None], y[None, :])
        else:
            xt = torch.as_tensor(x)
            yt = torch.as_tensor(y)
            got = ft(xt[:, None], yt[None, :])
            ref = fj(jnp.asarray(x)[:, None], jnp.asarray(y)[None, :])
        close(got, ref, **tol)


def test_zoo_exports():
    """`import lsqfitgp_torch` has every ported zoo kernel, with the JAX
    package's derivable and maxdim rules."""
    from lsqfitgp_tpu.kernels import _basic, _matern, _wendland
    for name in _basic.__all__ + _matern.__all__ + _wendland.__all__:
        assert hasattr(lt, name), name
    for cls, kw in (('Maternp', dict(p=2)), ('Matern', dict(nu=2.2)),
                    ('Bessel', dict(nu=3.0)), ('Wendland', dict(k=2)),
                    ('GammaExp', dict(gamma=2)), ('Cauchy', {})):
        kt, kj = getattr(lt, cls)(**kw), getattr(ltpu, cls)(**kw)
        assert kt.initkw == kj.initkw


# -- special functions ---------------------------------------------------------

X2 = np.concatenate([[0.0, 1e-300, 1e-30, 1e-12], np.linspace(1e-3, 30, 23)])


def _d(f, order, x2):
    """The order-th derivative of f at each x2, by autograd (torch) and by
    nested jax.grad (JAX)."""
    if isinstance(x2, torch.Tensor):
        t = x2.clone().requires_grad_()
        v = f(t)
        for _ in range(order):
            (v,) = torch.autograd.grad(v.sum(), t, create_graph=True)
        return v
    g = f
    for _ in range(order):
        g = jax.grad(lambda z, g=g: jnp.sum(g(z)))
    return g(x2)


@pytest.mark.parametrize('p', [0, 1, 2, 4])
def test_kvmodx2_hi(p):
    """The half-integer Matérn profile and its exact x²-derivatives (the
    recurrence), including x² = 0; p = 0's singular derivative clamped
    at tiny; up to the order the profile is differentiable at 0."""
    xt, xj = torch.as_tensor(X2), jnp.asarray(X2)
    for order in range(min(p, 2) + 1):
        got = _d(lambda z: special.kvmodx2_hi(z, p), order, xt)
        ref = _d(lambda z: jspecial.kvmodx2_hi(z, p), order, xj)
        close(got, ref)
    close(special.kv_half(p, xt[4:]), jspecial.kv_half(p, xj[4:]))


@pytest.mark.parametrize('nu', [0.5, 1.5, 2.7])
def test_kvmodx2(nu):
    xt, xj = torch.as_tensor(X2), jnp.asarray(X2)
    for order in (0, 1):
        got = _d(lambda z: special.kvmodx2(nu, z), order, xt)
        ref = _d(lambda z: jspecial.kvmodx2(nu, z), order, xj)
        close(got, ref, rtol=1e-10, atol=1e-12)
    close(special.kv(nu, xt[4:]), jspecial.kv(nu, xj[4:]), rtol=1e-10)
    close(special.iv(nu, xt[4:12]), jspecial.iv(nu, xj[4:12]), rtol=1e-10)


@pytest.mark.parametrize('nu', [0.0, 1.5, 3.0])
def test_jvmodx2(nu):
    xt, xj = torch.as_tensor(X2), jnp.asarray(X2)
    for order in (0, 1):
        got = _d(lambda z: special.jvmodx2(nu, z), order, xt)
        ref = _d(lambda z: jspecial.jvmodx2(nu, z), order, xj)
        close(got, ref, rtol=1e-10, atol=1e-12)
    # the series below x = 8 (above, its terms reach e^x and their sum
    # in another order differs by ~e^x 1e-16) and the Hankel expansion
    z = np.concatenate([np.linspace(0, 8, 17), np.linspace(20, 30, 11)])
    close(special.jv(nu, torch.as_tensor(z)), jspecial.jv(nu, jnp.asarray(z)),
          rtol=1e-10, atol=1e-12)
    close(special.j0(torch.as_tensor(z)), jspecial.j0(jnp.asarray(z)))


# -- build_profile and kernel C's plain version --------------------------------

def _cases(mod, dyn):
    """The kernels whose profiles are compared: name -> kernel, with
    ``dyn`` the dynamic numbers (a jnp array or a tensor each)."""
    d = dyn
    return {
        'maternp2': d['a'] * mod.Maternp(p=2),
        'maternp0': mod.Maternp(p=0) * d['a'],
        'maternp5': mod.Maternp(p=5),
        'expon': d['a'] * mod.Expon() + d['c'],
        'gammaexp-dyn': mod.GammaExp(gamma=d['g'], derivable=False),
        'gammaexp-1.5': mod.GammaExp(gamma=1.5),
        'gammaexp-2': d['a'] * mod.GammaExp(gamma=2),
        'cauchy-dyn': mod.Cauchy(alpha=d['al'], beta=d['be']),
        'cauchy-2': mod.Cauchy(beta=d['be']),
        'cauchy-static': mod.Cauchy(alpha=1.3, beta=0.7),
        'posabs': _posabs(mod, d['a']),
        'sum2': d['a'] * mod.Maternp(p=2, scale=d['s']) + d['b']
                * mod.ExpQuad(scale=d['s2']),
        'sum3': (d['a'] * mod.Maternp(p=1, scale=d['s'])
                 + mod.GammaExp(gamma=d['g'], scale=d['s2'],
                                derivable=False)) * d['b']
                + mod.Expon(scale=1.7),
        'sum-chain': (mod.Cauchy(alpha=d['al'], scale=d['s'])
                      + d['a'] * mod.ExpQuad(scale=d['s2']) + d['c']) * d['b'],
        # the real-order Matérn (its quadrature; static ν), alone and in
        # a sum; Bessel's series and Hankel branches have a test of their
        # own (its alternating series' rounding needs its own tolerance)
        'matern1.7': d['a'] * mod.Matern(nu=1.7),
        'matern0.3+expquad': mod.Matern(nu=0.3, scale=d['s'])
        + d['b'] * mod.ExpQuad(scale=d['s2']),
    }


def _posabs(mod, a):
    """ExpQuad's core under the 'posabs' mode: a spec made by hand, as no
    zoo kernel with a CUDA profile has that mode."""
    k = a * mod.ExpQuad()
    spec = k._fastgram
    return spec._replace(mode='posabs')


DYN = dict(a=1.3, b=0.8, c=0.2, g=1.4, al=1.6, be=2.2, s=0.9, s2=2.5)


def _spec(k):
    return k if isinstance(k, tuple) else k._fastgram


@pytest.mark.parametrize('name', sorted(_cases(lt, {k: 1.0 for k in DYN})))
def test_build_profile(name):
    """The port's description evaluated by kernel C's plain version
    (`ops.gram` on the CPU) against the JAX package's profile on the
    same r², and the gradients of <G, K> in the points and in every
    dynamic number against jax.grad."""
    rng = np.random.default_rng(SEED + 7)
    x = np.concatenate([[0.0, 0.0], rng.uniform(-3, 3, 14)])
    y = np.concatenate([[0.0], rng.uniform(-3, 3, 9)])
    G = rng.standard_normal((x.size, y.size))
    keys = sorted(DYN)

    def jfun(xx, *vals):
        spec = _spec(_cases(ltpu, dict(zip(keys, vals)))[name])
        fn, params = jfg.build_profile(spec)
        r2 = (xx[:, None] - jnp.asarray(y)[None, :]) ** 2
        K = fn(r2, *params)
        return jnp.sum(K * G), K

    jvals = [jnp.asarray(DYN[k]) for k in keys]
    (_, Kj), gj = jax.value_and_grad(
        jfun, argnums=tuple(range(len(keys) + 1)), has_aux=True)(
        jnp.asarray(x), *jvals)
    leaves = [torch.as_tensor(x).requires_grad_()] + [
        torch.as_tensor(DYN[k]).requires_grad_() for k in keys]
    spec = _spec(_cases(lt, dict(zip(keys, leaves[1:])))[name])
    desc = fg.build_profile(spec)
    assert desc is not None and fg.why_not(spec) is None
    K = ops.gram(desc, leaves[0], torch.as_tensor(y))
    close(K, Kj)
    grads = torch.autograd.grad((K * torch.as_tensor(G)).sum(), leaves,
                                allow_unused=True)
    for g, r in zip(grads, gj):
        close(torch.zeros(()) if g is None else g, r, rtol=1e-11,
              atol=1e-12)


def test_build_profile_refuses():
    """The real-order Matérn and Bessel, Pink, Color and
    StationaryFracBrownian carry a CUDA profile now; a Maternp order above
    the kernels' table and sums wider than the kernels' term limit take
    the broadcast path, for a stated reason."""
    for k in (lt.Matern(nu=1.7), lt.Bessel(nu=1.0), lt.Pink(),
              lt.Color(n=3), lt.StationaryFracBrownian(H=0.7),
              lt.ExpQuad() + lt.Matern(nu=0.7)):
        assert fg.why_not(k._fastgram) is None
        assert fg.build_profile(k._fastgram) is not None
    for k in (lt.Maternp(p=ops.MATERNP_MAX + 1),
              sum(lt.ExpQuad(scale=s) for s in (1.0, 2.0, 3.0, 4.0, 5.0))):
        assert fg.build_profile(k._fastgram) is None
        assert fg.why_not(k._fastgram)
    assert 'Maternp' in fg.why_not(
        lt.Maternp(p=ops.MATERNP_MAX + 1)._fastgram)
    assert 'sum of 5' in fg.why_not(
        sum(lt.ExpQuad(scale=s) for s in (1.0, 2.0, 3.0, 4.0, 5.0))._fastgram)


def _jcore(spec):
    """The JAX core of a one-kernel spec as a function of r²."""
    fn, params = jfg.build_profile(spec)
    return lambda r2: fn(r2, *params)


@pytest.mark.parametrize('name,nu', [('matern', 0.3), ('matern', 1.7),
                                     ('matern', 2.5), ('matern', 4.2),
                                     ('bessel', 0.0), ('bessel', 1.0),
                                     ('bessel', 2.5)])
def test_real_order_profiles(name, nu):
    """The 'matern' and 'bessel' profiles (value and first r²-derivative;
    their static order has no argument derivative) against the JAX core
    and jax.grad on r² grids from 0, Bessel's on both sides of its
    series-to-Hankel cut (x = 20 in float64); g'' against a central
    difference of g' (for Bessel away from the cut, where g''s rounding
    over the difference's step swamps it).  Bessel within 2e-16 x
    I_0(min(x, 20)) absolute: the alternating series' terms, up to
    I_0(x) in sum, each the exponential of its logarithm (of size ~x, by
    lgamma in another implementation), rounded differently (the JAX
    package's own error there)."""
    cls = lt.Matern if name == 'matern' else lt.Bessel
    jcls = ltpu.Matern if name == 'matern' else ltpu.Bessel
    s = (2 * nu if nu else 2.0) if name == 'matern' else (2 + nu / 2) ** 2
    x = np.concatenate([[0.0, 1e-12, 1e-3, 0.5, 2.0, 7.0], np.linspace(
        18.0, 22.0, 9), [30.0, 60.0]])
    r2 = x * x / s
    prof = ops.PROFILES[name]
    desc = fg.build_profile(cls(nu=nu)._fastgram)
    a = torch.tensor(desc.terms[0].args[0])
    t = torch.as_tensor(r2)
    g, g1 = prof.value(t, 0, a, None), prof.deriv(t, 0, a, None)
    core = _jcore(jcls(nu=nu)._fastgram)
    gj = core(jnp.asarray(r2))
    g1j = jax.vmap(jax.grad(core))(jnp.asarray(r2))
    if name == 'matern':
        close(g, gj, rtol=1e-10, atol=1e-13)
        ok = r2 > 0 if nu <= 1 else r2 >= 0
        close(g1.numpy()[ok], np.asarray(g1j)[ok], rtol=1e-10, atol=1e-13)
    else:
        from scipy.special import i0
        atol = 2e-16 * np.maximum(x, 1) * i0(np.minimum(x, 20.0)) + 1e-14
        assert np.all(np.abs(g.numpy() - np.asarray(gj)) <= atol)
        assert np.all(np.abs(g1.numpy() - np.asarray(g1j)) <= s * atol)
    h = 1e-6 * np.maximum(r2, 1e-3)
    far = r2 > 1e-3
    if name == 'bessel':
        far &= (x < 10) | (x > 25)
    d2 = (prof.deriv(t + torch.as_tensor(h), 0, a, None)
          - prof.deriv(t - torch.as_tensor(h), 0, a, None)) / \
        torch.as_tensor(2 * h)
    close(prof.deriv2(t, 0, a, None).numpy()[far], d2.numpy()[far],
          rtol=1e-5, atol=1e-7)


def _jdesc(name, x):
    keys = sorted(DYN)
    spec = _spec(_cases(ltpu, {k: jnp.asarray(DYN[k]) for k in keys})[name])
    return jfg.build_profile(spec)


def _tdesc(name):
    keys = sorted(DYN)
    spec = _spec(_cases(lt, {k: torch.as_tensor(DYN[k]) for k in keys})[name])
    return fg.build_profile(spec)


@pytest.mark.parametrize('name', ['maternp2', 'sum2', 'cauchy-dyn'])
def test_ops_against_jax(name):
    """`ops.gram` (p = 2, with a nugget), `gram_sym` and
    `schur_update_gram` on a description against the JAX functions in
    interpret mode."""
    rng = np.random.default_rng(SEED + 3)
    x = rng.uniform(-2, 2, (40, 2))
    y = rng.uniform(-2, 2, (24, 2))
    fn, params = _jdesc(name, x)
    desc = _tdesc(name)
    ref = jops.gram(fn, jnp.asarray(x), jnp.asarray(y), params=params,
                    noise=None, tile=128, interpret=True)
    close(ops.gram(desc, torch.as_tensor(x), torch.as_tensor(y)), ref,
          atol=1e-12)
    ref = jops.gram_sym(fn, jnp.asarray(x), params=params, noise=0.3,
                        tile=128, interpret=True)
    close(ops.gram_sym(desc, torch.as_tensor(x), noise=0.3), ref, atol=1e-12)
    tile, size, offset = 128, 128, 128
    npad = offset + size
    nreal = npad - 30
    X = rng.uniform(-4, 4, (npad, 1))
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


@pytest.mark.parametrize('name', ['maternp2', 'expon', 'sum2'])
def test_backward_and_tangents_plain(name):
    """The plain backward and C′ on a description against autograd and
    forward AD of the plain Gram; C″ (one term) against the double
    backward."""
    rng = np.random.default_rng(SEED + 11)
    x = torch.as_tensor(rng.uniform(-2, 2, (30, 1)))
    y = torch.as_tensor(np.concatenate([[[0.0]], rng.uniform(-2, 2, (12, 1))]))
    x[0] = 0.0
    G = torch.as_tensor(rng.standard_normal((30, 13)))
    desc = _tdesc(name)
    vals = [v for v in ops._gram._flat(desc)]
    st = ops._gram._struct(desc)
    pvec = torch.stack([torch.as_tensor(v) for v in vals]
                       + [torch.tensor(0.1)])
    dx = torch.as_tensor(rng.standard_normal((30, 1)))
    dp = torch.as_tensor(rng.standard_normal(pvec.shape))

    def K(xx, pv):
        return ops.gram(ops._gram._rebuild(st, pv[:-1]), xx, y, noise=pv[-1])

    xx, pv = x.clone().requires_grad_(), pvec.clone().requires_grad_()
    k = K(xx, pv)
    gx, gp = torch.autograd.grad((k * G).sum(), (xx, pv))
    gxb, _, gpb = ops.gram_backward_plain(G, ops._gram._rebuild(st, vals), x,
                                          y, noise=0.1)
    close(gx, gxb)
    close(gp, gpb)
    with fwAD.dual_level():
        tan = fwAD.unpack_dual(K(fwAD.make_dual(x, dx),
                                 fwAD.make_dual(pvec, dp))).tangent
    fd = (K(x + 1e-6 * dx, pvec + 1e-6 * dp)
          - K(x - 1e-6 * dx, pvec - 1e-6 * dp)) / 2e-6
    close(tan, fd, rtol=1e-6, atol=1e-7)
    if name != 'sum2':
        # C″ along the points and the chain: the double backward
        post = ops._gram._rebuild(st, vals)
        got = ops.gram_backward_jvp_plain(G, post, x, y, dx, noise=0.1)
        xx = x.clone().requires_grad_()
        k = ops.gram(post, xx, y, noise=0.1)
        (g1,) = torch.autograd.grad((k * G).sum(), xx, create_graph=True)
        (h,) = torch.autograd.grad((g1 * dx).sum(), xx)
        close(got[0], h, rtol=1e-10, atol=1e-12)


# -- through the GP ----------------------------------------------------------------

N = 320


@pytest.fixture(scope='module')
def data():
    rng = np.random.default_rng(SEED)
    x = np.sort(rng.uniform(-20, 20, N))
    y = np.sin(x) + 0.3 * rng.standard_normal(N)
    return x, y


def _matern(mod, hp, **kw):
    return mod.GP(hp['amp'] * mod.Maternp(p=2, scale=hp['scale'])
                  + 0.09 * mod.White(), **kw)


def _multiscale(mod, hp, **kw):
    return mod.GP(hp['a1'] * mod.Maternp(p=2, scale=hp['s1'])
                  + hp['a2'] * mod.ExpQuad(scale=hp['s2'])
                  + 0.09 * mod.White(), **kw)


def _matern_nu(mod, hp, **kw):
    return mod.GP(hp['amp'] * mod.Matern(nu=1.7, scale=hp['scale'])
                  + 0.09 * mod.White(), **kw)


def _bessel(mod, hp, **kw):
    # scaled so that x = (2 + ν/2) r stays below 13: the series' rounding
    # (e^x u, in both packages) stays below the likelihood's tolerance
    return mod.GP(hp['amp'] * mod.Bessel(nu=1.0, scale=hp['scale'])
                  + 0.09 * mod.White(), **kw)


MODELS = {
    'matern': (_matern, np.array([0.3, 0.5])),
    'multiscale': (_multiscale, np.array([0.1, 1.2, -0.5, -0.3])),
    'matern-nu': (_matern_nu, np.array([0.3, 0.5])),
    'bessel': (_bessel, np.array([0.2, 2.1])),
}


def _hp(name, p, lib):
    keys = ('a1', 's1', 'a2', 's2') if name == 'multiscale' \
        else ('amp', 'scale')
    return {k: lib.exp(p[i]) for i, k in enumerate(keys)}


@pytest.mark.parametrize('solver', ['tiled', 'chol-stream'])
@pytest.mark.parametrize('name', sorted(MODELS))
def test_gp_models(data, name, solver):
    """NLL and gradient in the log hyperparameters of the Matérn-5/2, the
    multi-scale, the real-order Matérn (ν = 1.7) and the Bessel (ν = 1)
    models, dense through kernel C's plain version and
    streaming with the exact gradient (kernels C and D's plain versions),
    against the JAX package's dense and streaming GP."""
    x, y = data
    make, p0 = MODELS[name]
    kw = dict(gram='tiled') if solver == 'tiled' \
        else dict(solver='chol-stream', block=128, b1=128)

    def fj(p):
        return make(ltpu, _hp(name, p, jnp), **kw).addx(x, 'y') \
            .marginal_likelihood({'y': y})

    vj, gj = jax.value_and_grad(fj)(jnp.asarray(p0))
    p = torch.as_tensor(p0).requires_grad_()
    v = make(lt, _hp(name, p, torch), **kw).addx(x, 'y') \
        .marginal_likelihood({'y': y})
    v.backward()
    close(v, vj, rtol=1e-9)
    close(p.grad, gj, rtol=1e-8, atol=1e-9)


def test_matern_fit(data):
    """A 3-iteration empbayes_fit of the Matérn-5/2 model ends at the JAX
    package's hyperparameters: BFGS walks the same iterates on both sides
    (objectives equal to ~1e-12), so the point agrees to rtol 1e-6, as
    in ``tests/test_torch_stream.py``."""
    x, y = data
    prior = {'log(amp)': (0.0, 1.0), 'log(scale)': (0.0, 1.0)}

    def factory(mod):
        def f(h):
            return _matern(mod, {'amp': h['amp'], 'scale': h['scale']},
                           gram='tiled').addx(x, 'y')
        return f

    fj = ltpu.empbayes_fit(prior, factory(ltpu), {'y': y},
                           minkw={'options': {'maxiter': 3}}, raises=False)
    ft = lt.empbayes_fit(prior, factory(lt), {'y': y},
                         minkw={'options': {'maxiter': 3}}, raises=False)
    close(ft.pmean.buf, fj.pmean.buf, rtol=1e-6, atol=1e-9)
