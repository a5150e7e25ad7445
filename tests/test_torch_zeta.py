"""The Zeta family (config #3) and the zeta special functions, on the
CPU, against the JAX package on the same inputs (made from a seed with
numpy), in float64 unless a test says otherwise.

- ``zeta_real`` across its branch edges, ``hurwitz_zeta``,
  ``periodic_zeta`` (real and imaginary part) at integer and
  non-integer s on both sides of the direct series' cut, with its first
  and second x-derivatives against ``jax.grad``, ``periodic_bernoulli``,
  and a tensor s that straddles the cut;
- in float32, ``periodic_zeta`` at integer s (the Γ-pole cancellation,
  evaluated symmetrically at s ± eps^{1/3}) against a float64 truth,
  within twice the JAX package's own float32 error there (measured in
  the test with x64 off), plus 8 eps32;
- the kernels ``Zeta`` (and its derivative blocks), ``ZetaFourier`` and
  ``CrossZetaFourier`` through the 'fourier' linop with loc and scale
  applied (after ``tests/kernels/test_zeta_matern.py``), the streaming
  solver's refusal (no fast-Gram spec in either package); Zeta in
  float32 against the JAX package's float64 values with
  ``tests/conftest.py``'s float32 tolerances;
- the smoke's Zeta model (``amp * Zeta(nu=1.5)`` and its 'fourier'
  linop) at n = 60: its NLL and gradient, the posterior coefficients
  and a 3-iteration ``empbayes_fit`` against the JAX package's;
- ``examples/fourier_series.py``, ``fourier_coefficients.py`` and
  ``dft_domain.py`` run against the port with their own assertions.

Tolerances: the functions 1e-12 relative and absolute unless said
(the same series; at integer s the nudge's O(eps^{2/3}) error, 1e-9,
as ``tests/kernels/test_zeta_matern.py`` holds it); GP likelihoods and
gradients 1e-9 and 1e-8 as in ``tests/test_torch_gp.py``, the fit's
end point 1e-6 as in ``tests/test_torch_timeseries.py``.
"""

import math
import os
import warnings

import numpy as np
import pytest
import torch
import jax
from jax import numpy as jnp

import lsqfitgp_tpu as ltpu
from lsqfitgp_tpu import special as jspecial
import lsqfitgp_torch as lt
from lsqfitgp_torch import special

pytestmark = pytest.mark.x64only

SEED = 20261022
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


def close(a, b, rtol=1e-12, atol=1e-12):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol)


# -- the special functions -------------------------------------------------------


@pytest.mark.parametrize('s', [-3.0, -0.5 - 1e-9, -0.5, 0.7, 1 - 1e-3,
                               1 + 1e-3, 2.5 - 1e-9, 2.5, 7.0])
def test_zeta_real(s):
    """Riemann ζ on each branch and at the edges between them."""
    close(special.zeta_real(s), jspecial.zeta_real(s))


def test_zeta_real_tensor():
    s = np.array([-7.5, -3.0, -0.2, 0.5, 1.7, 2.5, 3.0, 30.0])
    close(special.zeta_real(torch.tensor(s)), jspecial.zeta_real(s))


def test_hurwitz_zeta():
    rng = np.random.default_rng(SEED)
    s, q = rng.uniform(1.5, 8, 10), rng.uniform(0.1, 5, 10)
    close(special.hurwitz_zeta(torch.tensor(s), torch.tensor(q)),
          jspecial.hurwitz_zeta(s, q))


def _xs(seed):
    """Points spanning three periods, with the special points 0, 1/2 and
    a negative integer."""
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(-1.3, 1.7, 23), [0.0, 0.5, -1.0]])


# non-integer and integer s below the float64 cut (10) and above it
PZ_S = [1.5, 3.0, 4.0, 4.7, 10.0, 12.25]


@pytest.mark.parametrize('imag', [False, True])
@pytest.mark.parametrize('s', PZ_S)
def test_periodic_zeta(s, imag):
    """Values, and the x-derivatives where s − k > 1, against
    ``jax.grad`` of the JAX custom JVP (an integer s − k takes the
    nudge)."""
    x = _xs(SEED + int(4 * s))
    tol = dict(rtol=1e-9, atol=1e-9) if s < 10 else {}
    xt = torch.tensor(x, requires_grad=True)
    v = special.periodic_zeta(xt, s, imag)
    close(v, jspecial.periodic_zeta(jnp.asarray(x), s, imag), **tol)
    fj = lambda u: jspecial.periodic_zeta(u, s, imag)
    got, f = [], v
    for order in (1, 2):
        if s - order <= 1:
            break
        f, = torch.autograd.grad(f.sum(), xt, create_graph=True)
        fj = jax.grad(fj)
        close(f, jax.vmap(fj)(jnp.asarray(x)), rtol=1e-9, atol=1e-9)
        got.append(order)
    assert got or s - 1 <= 1


def test_periodic_zeta_tensor_s():
    """A tensor s straddling the cut: each entry as its own static s."""
    x = _xs(SEED + 1)
    s = np.linspace(2.2, 13.1, x.size)
    for imag in (False, True):
        got = special.periodic_zeta(torch.tensor(x), torch.tensor(s), imag)
        want = [float(special.periodic_zeta(torch.tensor(xi), si, imag))
                for xi, si in zip(x, s)]
        close(got, want, rtol=1e-9, atol=1e-9)
        close(got, jspecial.periodic_zeta(jnp.asarray(x), jnp.asarray(s),
                                          imag), rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize('n', [2, 3, 4])
def test_periodic_bernoulli(n):
    x = _xs(SEED + 10 * n)
    close(special.periodic_bernoulli(n, torch.tensor(x)),
          jspecial.periodic_bernoulli(n, jnp.asarray(x)), rtol=1e-9,
          atol=1e-9)


@pytest.mark.parametrize('s', [2.0, 3.0, 4.0])
def test_periodic_zeta_float32_integer_s(s):
    """Float32 at integer s: the bracket's cancellation costs ~eps32 /
    eps32^{1/3} and the nudge ~eps32^{2/3}, about 2e-5 in the JAX
    package (its float32 error, measured here with x64 off, against the
    float64 truth).  The bound: twice that error, plus 8 eps32 of the
    function's size."""
    x = np.linspace(-1.3, 1.7, 301)
    for imag in (False, True):
        truth = np.asarray(jspecial.periodic_zeta(jnp.asarray(x), s, imag))
        with jax.enable_x64(False), warnings.catch_warnings():
            warnings.simplefilter('ignore')
            j32 = np.asarray(jspecial.periodic_zeta(
                jnp.asarray(x, jnp.float32), s, imag))
        assert j32.dtype == np.float32
        got = special.periodic_zeta(torch.tensor(x, dtype=torch.float32), s,
                                    imag)
        assert got.dtype == torch.float32
        jerr = np.abs(j32 - truth).max()
        bound = 2 * jerr + 8 * np.finfo(np.float32).eps * np.abs(truth).max()
        err = np.abs(got.double().numpy() - truth).max()
        assert err <= bound, (imag, err, jerr)


# -- the kernels -------------------------------------------------------------------


@pytest.mark.parametrize('nu', [0.0, 0.3, 1.5, 3.25])
def test_zeta_kernel(nu):
    """Values (ν = 0 takes the white-noise-like branch), and the
    derivative kernels that ⌈ν⌉ − 1 allows."""
    rng = np.random.default_rng(SEED + int(8 * nu))
    x, y = rng.uniform(-1, 2, 9), rng.uniform(-1, 2, 7)
    y[:2] = x[:2]
    kt, kj = lt.Zeta(nu=nu), ltpu.Zeta(nu=nu)
    derivs = [(0, 0)] + [(i, j) for i in range(3) for j in range(3)
                         if 0 < max(i, j) and max(i, j) <= math.ceil(nu) - 1]
    for d in derivs:
        ft, fj = (kt, kj) if d == (0, 0) else \
            (kt.linop('diff', *d), kj.linop('diff', *d))
        got = ft(torch.tensor(x)[:, None], torch.tensor(y)[None, :])
        ref = fj(jnp.asarray(x)[:, None], jnp.asarray(y)[None, :])
        close(got, ref, rtol=1e-9, atol=1e-9)


def test_zeta_kernel_float32():
    """Float32 (the port's default dtype), s = 4 and s = 6 (the Hurwitz
    branch with the nudge) and s = 7.5 (the direct series, past float32's
    cut at 5), against the JAX package in float64 with
    ``tests/conftest.py``'s float32 tolerances (2e-4 relative, 1e-5
    absolute)."""
    rng = np.random.default_rng(SEED + 5)
    x, y = rng.uniform(-1, 2, 12), rng.uniform(-1, 2, 10)
    for nu in (1.5, 2.5, 3.25):
        got = lt.Zeta(nu=nu)(torch.tensor(x, dtype=torch.float32)[:, None],
                             torch.tensor(y, dtype=torch.float32)[None, :])
        assert got.dtype == torch.float32
        ref = ltpu.Zeta(nu=nu)(jnp.asarray(x)[:, None],
                               jnp.asarray(y)[None, :])
        close(got, ref, rtol=2e-4, atol=1e-5)


def test_zeta_derivable_bound():
    """⌈ν⌉ − 1 derivatives: one more raises, in both packages."""
    x = torch.linspace(0, 1, 5)
    lt.Zeta(nu=1.5).linop('diff', 1, 1)(x[:, None], x[None, :])
    with pytest.raises(Exception):
        lt.Zeta(nu=1.5).linop('diff', 2, 0)(x[:, None], x[None, :])
    with pytest.raises(Exception):
        ltpu.Zeta(nu=1.5).linop('diff', 2, 0)(jnp.asarray(x)[:, None],
                                               jnp.asarray(x)[None, :])


FOURIER = {'plain': [], 'loc': [('loc', 0.25)], 'scale': [('scale', 1.7)],
           'both': [('loc', -0.3), ('scale', 0.6), ('mul', 1.4),
                    ('add', 0.2)]}


def _transform(k, steps):
    for name, arg in steps:
        if name == 'mul':
            k = arg * k
        elif name == 'add':
            k = k + arg
        else:
            k = k.linop(name, arg)
    return k


@pytest.mark.parametrize('name', sorted(FOURIER))
def test_fourier_family(name):
    """ZetaFourier and CrossZetaFourier (both sides) through the 'fourier'
    linop after loc, scale, mul and add (the AffineSpan's tracking),
    against the JAX package's; the k = 0 entry is the offset."""
    nu = 1.5
    kt = _transform(lt.Zeta(nu=nu), FOURIER[name])
    kj = _transform(ltpu.Zeta(nu=nu), FOURIER[name])
    ks = np.arange(0, 9)
    x = np.random.default_rng(SEED + len(name)).uniform(-1, 1, 6)
    pairs = [
        (kt.linop('fourier', True), kj.linop('fourier', True), ks, ks),
        (kt.linop('fourier', True, None), kj.linop('fourier', True, None),
         ks, x),
        (kt.linop('fourier', None, True), kj.linop('fourier', None, True),
         x, ks),
    ]
    for ft, fj, a, b in pairs:
        got = ft(torch.tensor(a)[:, None], torch.tensor(b)[None, :])
        ref = fj(jnp.asarray(a)[:, None], jnp.asarray(b)[None, :])
        close(got, ref)


def test_fourier_reconstruction():
    """tests/kernels/test_zeta_matern.py:140: after a loc shift the
    kernel is Σ_k cross(k, x) cross(k, y) / var_k."""
    moved = lt.Zeta(nu=1.5).linop('loc', 0.25)
    cross = moved.linop('fourier', True, None)
    both = moved.linop('fourier', True)
    x = torch.linspace(0, 1, 7, dtype=torch.float64)
    ks = torch.arange(1, 600)
    C = cross(ks[:, None], x[None, :])
    V = both(ks, ks)
    recon = torch.einsum('ka,k,kb->ab', C, 1 / V, C)
    close(recon, moved(x[:, None], x[None, :]), rtol=1e-4, atol=1e-6)


def test_no_fast_gram():
    """Neither package has a fast-Gram spec for Zeta: the streaming
    solver refuses it with the same words, and a dense GP broadcasts its
    core (no spec to build a description from)."""
    x = np.linspace(0, 1, 8)
    y = np.sin(2 * np.pi * x)
    assert lt.Zeta(nu=1.5)._fastgram is None
    for mod in (lt, ltpu):
        gp = mod.GP(mod.Zeta(nu=1.5), solver='chol-stream').addx(x, 'x')
        with pytest.raises(ValueError, match='carries no fast-Gram spec'):
            gp.marginal_likelihood({'x': y}, 0.1 * np.eye(8))


# -- the smoke's model -----------------------------------------------------------


def _zeta_data(n=60):
    rng = np.random.default_rng(SEED + 99)
    x = np.sort(rng.uniform(0, 1, n))
    y = np.cos(2 * np.pi * x) + 0.5 * np.sin(4 * np.pi * x) \
        + 0.25 * np.cos(6 * np.pi * x) + 0.3 * rng.standard_normal(n)
    return x, y


def _zeta_gp(mod, amp, x):
    return mod.GP().defproc('f', amp * mod.Zeta(nu=1.5)) \
        .deflinop('F', 'fourier', True, 'f').addx(x, 'y', proc='f')


def test_zeta_model():
    """The smoke's Zeta model at n = 60: NLL and gradient in (log amp,
    log noise), and the posterior means and covariance of the
    coefficients k = 1 … 8, against the JAX package's."""
    x, y = _zeta_data()
    lp0 = np.array([0.2, math.log(0.09)])

    def nll_t(lp):
        gp = _zeta_gp(lt, lp[0].exp(), torch.tensor(x))
        return -gp.marginal_likelihood({'y': torch.tensor(y)}, lp[1].exp())

    def nll_j(lp):
        gp = _zeta_gp(ltpu, jnp.exp(lp[0]), jnp.asarray(x))
        return -gp.marginal_likelihood({'y': jnp.asarray(y)},
                                       jnp.exp(lp[1]) * jnp.eye(x.size))

    lp = torch.tensor(lp0, requires_grad=True)
    v = nll_t(lp)
    g, = torch.autograd.grad(v, lp)
    vj, gj = jax.value_and_grad(nll_j)(jnp.asarray(lp0))
    close(v, vj, rtol=1e-9, atol=1e-9)
    close(g, gj, rtol=1e-8, atol=1e-9)
    ks = np.arange(1, 9)
    ut = _zeta_gp(lt, 1.2, torch.tensor(x)).addx(torch.tensor(ks), 'c',
                                                  proc='F') \
        .predfromdata({'y': torch.tensor(y)}, 'c', 0.09, raw=True)
    uj = _zeta_gp(ltpu, 1.2, jnp.asarray(x)).addx(jnp.asarray(ks), 'c',
                                                   proc='F') \
        .predfromdata({'y': jnp.asarray(y)}, 'c', 0.09 * jnp.eye(x.size),
                      raw=True)
    close(ut[0], uj[0], rtol=1e-9, atol=1e-10)
    close(ut[1], uj[1], rtol=1e-8, atol=1e-10)


def test_zeta_fit():
    """A 3-iteration empbayes_fit of the smoke's Zeta model at n = 60 ends
    at the JAX package's hyperparameters (BFGS walks the same iterates
    on both sides)."""
    x, y = _zeta_data()
    prior = {'log(amp)': (0., 1.), 'log(noise)': (math.log(0.09), 1.)}
    kw = dict(minkw={'options': {'maxiter': 3}}, raises=False)
    fj = ltpu.empbayes_fit(
        prior, lambda hp: _zeta_gp(ltpu, hp['amp'], jnp.asarray(x)),
        lambda hp: ({'y': y}, hp['noise'] * jnp.eye(x.size)), **kw)
    ft = lt.empbayes_fit(
        prior, lambda hp: _zeta_gp(lt, hp['amp'], torch.tensor(x)),
        lambda hp: ({'y': y}, hp['noise']), **kw)
    close(ft.pmean.buf, fj.pmean.buf, rtol=1e-6, atol=1e-9)


# -- the examples --------------------------------------------------------------


@pytest.mark.parametrize('name', ['fourier_series', 'fourier_coefficients',
                                  'dft_domain'])
def test_example(name):
    """Config #3's examples run against lsqfitgp_torch with their own
    assertions: the import line swapped in memory, and
    ``dft_domain.py``'s ``import jax.numpy as jnp`` by ``import torch as
    jnp`` (its ``jnp.asarray`` weights, then, are tensors)."""
    path = os.path.join(ROOT, 'examples', name + '.py')
    src = open(path).read()
    assert 'import lsqfitgp_tpu as lgp' in src
    src = src.replace('import lsqfitgp_tpu as lgp',
                      'import lsqfitgp_torch as lgp')
    if name == 'dft_domain':
        assert 'import jax.numpy as jnp' in src
        src = src.replace('import jax.numpy as jnp', 'import torch as jnp')
    ns = {'__name__': 'example'}
    exec(compile(src, path, 'exec'), ns)
    u = ns['main']()
    assert isinstance(u, lt.uncert.UArray)
