"""lsqfitgp_torch's derived processes, derivative observations and
structured points on the CPU against lsqfitgp_tpu's on the same models
and data (made from a seed with numpy), in float64: ``addtransf``,
``defproc``, ``deftransf``, ``deflintransf``, ``deflinop``,
``defderiv``, ``defxtransf``, ``defrescale``, ``addx(deriv=)``,
``addcov(decomps=)``, ``GP.decompose``, the kernel linops ``diff``,
``xtransf``, ``rescale``, ``normalize``, ``cond`` and the algops
``pow``, ``rpow`` and the ufuncs, ``derivable``'s bound, ``uncert.corr``
and ``uncert.sample``; the fit of the derivative model of
``chip_smoke.py``'s derivative phase (NLL, gradient, covariance='hess');
point blocks by kernel C's plain version ('tiled') against the broadcast
core on structured points, the derivative falling back to the
broadcast, and 'auto' broadcasting on the CPU; and the examples
``double_integral.py`` and ``even_symmetry.py`` run against the port.

Tolerances: the two packages evaluate the same float64 expressions
(derivatives by reverse mode with a ones cotangent against JAX's jvp),
in another order at most: 1e-12 relative on kernels and priors, 1e-9
on posteriors and likelihoods (conditioning ~1e3), 1e-5 on fitted
hyperparameters and Laplace covariances (as tests/test_torch_fit.py);
the sample statistics as tests/test_uncert.py:68 (40000 draws)."""

import functools
import os

import numpy as np
import pytest
import torch
import jax
from jax import numpy as jnp

import lsqfitgp_tpu as ltpu
import lsqfitgp_torch as lt
from lsqfitgp_torch import _torchutil

pytestmark = pytest.mark.x64only

SEED = 20261016
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIGHT = dict(rtol=1e-12, atol=1e-13)
POST = dict(rtol=1e-9, atol=1e-11)


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


@pytest.fixture
def gen():
    return np.random.default_rng(SEED)


def close(t, j, **tol):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               **(tol or TIGHT))


def structured(gen, n, fields=('x', 't'), span=2.0):
    x = np.empty(n, dtype=[(f, float) for f in fields])
    for f in fields:
        x[f] = gen.uniform(-span, span, n)
    return x


# -- kernel linops and algops -------------------------------------------------

LINOPS = {
    'diff-1-1': lambda k: k.linop('diff', 1, 1),
    'diff-2-0': lambda k: k.linop('diff', 2, 0),
    'diff-0-3': lambda k: k.linop('diff', 0, 3),
    'diff-2-2': lambda k: k.linop('diff', 2, 2),
    'xtransf': lambda k: k.linop('xtransf', lambda x: x ** 2, None),
    'rescale': lambda k: k.linop('rescale', lambda x: 1 + x ** 2),
    'normalize': lambda k: (k + 0.5 * k.linop('scale', 0.5)).linop(
        'normalize', True),
    'cond': lambda k: k.linop('cond', k.linop('scale', 3.0),
                              lambda x: x > 0),
    'pow': lambda k: k ** 3,
    'rpow': lambda k: 2.0 ** k,
    'exp': lambda k: k.algop('exp'),
    'expm1x': lambda k: k.algop('expm1x'),
    '1/(1-x)': lambda k: (0.5 * k).algop('1/(1-x)'),
}


@pytest.mark.parametrize('name', list(LINOPS))
def test_kernel_transformations(gen, name):
    """Each transformation of ExpQuad on plain points, and its class (a
    derivative or an x transformation is not isotropic, and every
    transformation here drops the fast-Gram spec but the algops on a
    bare scalar)."""
    x = np.sort(gen.uniform(-2, 2, 9))
    kt = LINOPS[name](lt.ExpQuad(scale=1.3))
    kj = LINOPS[name](ltpu.ExpQuad(scale=1.3))
    xt = torch.as_tensor(x)
    close(kt(xt[:, None], xt[None, :]), kj(x[:, None], x[None, :]))
    assert type(kt).__name__ == type(kj).__name__
    assert kt._fastgram is None


@pytest.mark.parametrize('deriv', [('u', 'u'), ('v', 'u'), ((2, 'u'), 'v'),
                                   (('u', 'v'), ('u', 'v'))])
def test_deriv_structured_field(gen, deriv):
    """Derivatives along named fields of 2-field points (mixed, of any
    order, both sides), as tests/kernels/test_zoo_properties.py:209."""
    x = structured(gen, 6, ('u', 'v'))
    xt, xj = lt.asarray(x), ltpu.asarray(x)
    Kt = lt.ExpQuad().linop('diff', *deriv)(xt[:, None], xt[None, :])
    Kj = ltpu.ExpQuad().linop('diff', *deriv)(xj[:, None], xj[None, :])
    close(Kt, Kj)
    if deriv[0] == deriv[1]:
        eig = np.linalg.eigvalsh(Kt.numpy())
        assert eig.min() > -1e-10 * abs(eig.max())


def test_derivatives_of_expquad(gen):
    """tests/kernels/test_zoo.py:190 for ExpQuad: the derivative
    process's Gram is finite and positive semidefinite, and equals the
    JAX package's."""
    x = np.sort(gen.uniform(-2, 2, 10))
    xt = torch.as_tensor(x)
    K = lt.ExpQuad().linop('diff', 1, 1)(xt[:, None], xt[None, :])
    close(K, ltpu.ExpQuad().linop('diff', 1, 1)(x[:, None], x[None, :]))
    eigs = np.linalg.eigvalsh(K.numpy())
    assert eigs.min() > -1e-7 * max(1.0, eigs.max())


def test_derivable_bound(gen):
    """derivable=n raises past n derivatives along one variable, as the
    JAX package's custom-JVP counter does, and counts each field of a
    mixed derivative apart; White (derivable=False) takes none."""
    x = np.sort(gen.uniform(-2, 2, 5))
    xt = torch.as_tensor(x)
    k1 = lt.ExpQuad(derivable=1)
    k1.linop('diff', 1, 1)(xt[:, None], xt[None, :])
    for mod, err in ((lt, _torchutil.TooManyDerivativesError),
                     (ltpu, ltpu._jaxutil.TooManyDerivativesError)):
        with pytest.raises(err):
            mod.ExpQuad(derivable=1).linop('diff', 2, 0)(x[:, None],
                                                         x[None, :])
        with pytest.raises(err):
            mod.White().linop('diff', 1, 0)(x[:, None], x[None, :])
    s = structured(gen, 5, ('u', 'v'))
    st, sj = lt.asarray(s), ltpu.asarray(s)
    mixed = (('u', 'v'), None)
    close(lt.ExpQuad(derivable=1).linop('diff', *mixed)(st[:, None],
                                                        st[None, :]),
          ltpu.ExpQuad(derivable=1).linop('diff', *mixed)(sj[:, None],
                                                          sj[None, :]))


def test_derivative_under_no_grad_and_fit(gen):
    """A derivative block under torch.no_grad() leaves no graph; under
    autograd its gradient in a hyperparameter, and the gradient's own
    derivative (a Hessian entry), match JAX's."""
    x = np.sort(gen.uniform(-2, 2, 7))
    xt = torch.as_tensor(x)
    with torch.no_grad():
        K = lt.ExpQuad(scale=1.3).linop('diff', 1, 1)(xt[:, None],
                                                      xt[None, :])
    assert not K.requires_grad
    s = torch.tensor(1.3, requires_grad=True)

    def vt(s):
        return lt.ExpQuad(scale=s).linop('diff', 1, 1)(
            xt[:, None], xt[None, :]).sum()

    def vj(s):
        return ltpu.ExpQuad(scale=s).linop('diff', 1, 1)(
            x[:, None], x[None, :]).sum()

    g, = torch.autograd.grad(vt(s), s, create_graph=True)
    h, = torch.autograd.grad(g, s)
    close(g, jax.grad(vj)(1.3), rtol=1e-11)
    close(h, jax.grad(jax.grad(vj))(1.3), rtol=1e-10)

    # forward mode (the fit's Fisher information), through a kernel with
    # a finite derivability (its limiters) too
    import torch.autograd.forward_ad as fwAD

    def kt(s):
        return lt.ExpQuad(scale=s, derivable=2).linop('diff', 1, 1)(
            xt[:, None], xt[None, :])

    def kj(s):
        return ltpu.ExpQuad(scale=s, derivable=2).linop('diff', 1, 1)(
            x[:, None], x[None, :])

    with fwAD.dual_level():
        tangent = fwAD.unpack_dual(kt(fwAD.make_dual(
            torch.tensor(1.3), torch.tensor(1.0)))).tangent
    close(tangent, jax.jvp(kj, (1.3,), (1.0,))[1], rtol=1e-11, atol=1e-13)


# -- GP processes ----------------------------------------------------------


def _prior(gp, keys):
    return gp.prior(keys, raw=True)


def _check_prior(gt, gj, keys):
    pt, pj = _prior(gt, keys), _prior(gj, keys)
    for k in pj:
        close(pt[k], pj[k])


def test_addtransf(gen):
    """tests/GP/test_gp.py:149: a tensor contraction of an element."""
    x = gen.uniform(-3, 3, 12)
    T = gen.standard_normal((7, len(x)))
    gt = lt.GP(lt.ExpQuad(scale=1.3)).addx(x, 'a').addtransf({'a': T}, 't')
    gj = ltpu.GP(ltpu.ExpQuad(scale=1.3)).addx(x, 'a').addtransf({'a': T},
                                                                 't')
    _check_prior(gt, gj, ['a', 't'])
    # two keys, a scalar weight and axes=0 (outer product)
    x2 = gen.uniform(-3, 3, 7)
    gt = gt.addx(x2, 'b').addtransf({'t': 2.0, 'b': -1.0}, 's')
    gj = gj.addx(x2, 'b').addtransf({'t': 2.0, 'b': -1.0}, 's')
    _check_prior(gt, gj, ['s', 'a'])
    with pytest.raises(ValueError):
        gt.addtransf({'a': np.ones(3)}, 'bad')


def test_defproc_independent(gen):
    """tests/GP/test_gp.py:180: two independent processes."""
    x = np.linspace(0, 1, 8)
    for mod in (lt, ltpu):
        gp = mod.GP().defproc('p1', mod.ExpQuad()) \
            .defproc('p2', mod.ExpQuad(scale=0.3)) \
            .addx(x, 'a', proc='p1').addx(x, 'b', proc='p2')
        pr = gp.prior(['a', 'b'])
        np.testing.assert_allclose(
            np.asarray(mod.uncert.evalcov(pr['a'], pr['b'])), 0,
            atol=1e-12)


def test_deftransf(gen):
    """tests/GP/test_gp.py:193: a linear combination of processes, with
    a scalar and a function coefficient."""
    x = np.linspace(0, 1, 8)

    def build(mod):
        gp = mod.GP().defproc('p1', mod.ExpQuad()) \
            .defproc('p2', mod.ExpQuad(scale=0.3))
        gp = gp.deftransf('s', {'p1': 2.0, 'p2': lambda x: 1 + x})
        gp = gp.deftransf('ds', {'p1': 1.0}, deriv=1)
        return gp.addx(x, 'a', proc='s').addx(x, 'b', proc='p1') \
            .addx(x, 'd', proc='ds')

    _check_prior(build(lt), build(ltpu), ['a', 'b', 'd'])
    K = _prior(build(lt), ['a'])['a', 'a'].numpy()
    k1 = np.exp(-0.5 * (x[:, None] - x[None, :]) ** 2)
    k2 = np.exp(-0.5 * ((x[:, None] - x[None, :]) / 0.3) ** 2)
    np.testing.assert_allclose(
        K, 4 * k1 + np.outer(1 + x, 1 + x) * k2, **TIGHT)


def test_defderiv(gen):
    """tests/GP/test_gp.py:206: cov(f(x), f'(y)) = (x - y) exp(-(x -
    y)²/2), and defproc(deriv=) equals defderiv."""
    x = np.sort(gen.uniform(-2, 2, 9))

    def build(mod):
        gp = mod.GP(mod.ExpQuad()).defderiv('df', 1, mod.DefaultProcess)
        gp = gp.defproc('dg', mod.ExpQuad(), deriv=1)
        return gp.addx(x, 'f').addx(x, 'd', proc='df') \
            .addx(x, 'g', proc='dg')

    gt = build(lt)
    _check_prior(gt, build(ltpu), ['f', 'd', 'g'])
    p = _prior(gt, ['f', 'd', 'g'])
    d = x[:, None] - x[None, :]
    np.testing.assert_allclose(p['f', 'd'].numpy(), d * np.exp(-0.5 * d ** 2),
                               **TIGHT)
    np.testing.assert_allclose(p['g', 'g'].numpy(), p['d', 'd'].numpy(),
                               **TIGHT)


def test_addx_deriv_equivalent_to_defderiv(gen):
    """tests/GP/test_gp.py:219, and named derivatives on structured
    points, with the field checks."""
    x = np.sort(gen.uniform(-2, 2, 9))
    K1 = lt.GP(lt.ExpQuad()).addx(x, 'd', deriv=1).prior('d', raw=True)
    K2 = lt.GP(lt.ExpQuad()).defderiv('df', 1, lt.DefaultProcess) \
        .addx(x, 'd', proc='df').prior('d', raw=True)
    np.testing.assert_allclose(K1.numpy(), K2.numpy(), **TIGHT)
    s = structured(gen, 8)
    for mod in (lt, ltpu):
        with pytest.raises(ValueError):
            mod.GP(mod.ExpQuad()).addx(s, 'a', deriv='z')
        with pytest.raises(ValueError):
            mod.GP(mod.ExpQuad()).addx(x, 'a', deriv='x')

    def build(mod):
        return mod.GP(mod.ExpQuad(scale=1.4)).addx(s, 'v') \
            .addx(s, 'dx', deriv='x').addx(s, 'dxt', deriv=['x', 't'])

    _check_prior(build(lt), build(ltpu), ['v', 'dx', 'dxt'])


def test_defxtransf_defrescale_deflinop(gen):
    """tests/GP/test_gp.py:229, and deflinop and deflintransf with a
    derivative."""
    x = np.sort(gen.uniform(0.1, 2, 8))

    def build(mod):
        gp = mod.GP(mod.ExpQuad())
        gp = gp.defxtransf('sq', lambda x: x ** 2, mod.DefaultProcess)
        gp = gp.defrescale('rs', lambda x: x, mod.DefaultProcess)
        gp = gp.deflinop('sc', 'scale', 2.0, mod.DefaultProcess)
        gp = gp.deflintransf('ev', lambda f: (lambda x: f(x) + f(-x)),
                             [mod.DefaultProcess], deriv=1)
        return gp.addx(x, 'a', proc='sq').addx(x, 'b', proc='rs') \
            .addx(x, 'c', proc='sc').addx(x, 'e', proc='ev').addx(x, 'f')

    gt = build(lt)
    _check_prior(gt, build(ltpu), ['a', 'b', 'c', 'e', 'f'])
    d2 = (x[:, None] ** 2 - x[None, :] ** 2) ** 2
    np.testing.assert_allclose(_prior(gt, ['a'])['a', 'a'].numpy(),
                               np.exp(-0.5 * d2), **TIGHT)
    for mod in (lt, ltpu):
        with pytest.raises(TypeError):
            mod.GP(mod.ExpQuad()).defxtransf('q', 1.0, mod.DefaultProcess)
        with pytest.raises(KeyError):
            mod.GP(mod.ExpQuad()).defproc(mod.DefaultProcess)


def test_posterior_through_derivatives(gen):
    """predfromdata from values and derivative observations on
    structured points, to values and another field's derivative: the
    means and covariances."""
    s = structured(gen, 20, span=3.0)
    sd = structured(gen, 12, span=3.0)
    ss = structured(gen, 5, span=3.0)
    y = np.sin(s['x']) * np.cos(s['t'])
    yd = np.cos(sd['x']) * np.cos(sd['t'])

    def post(mod):
        gp = mod.GP(1.3 * mod.ExpQuad(scale=1.1)).addx(s, 'f') \
            .addx(sd, 'd', deriv='x').addx(ss, 'F').addx(ss, 'Ft',
                                                          deriv='t')
        return gp.predfromdata({'f': y, 'd': yd}, ['F', 'Ft'],
                               0.01 * np.eye(32))

    pt, pj = post(lt), post(ltpu)
    for k in ('F', 'Ft'):
        close(pt[k].mean, pj[k].mean, **POST)
        close(pt[k].cov(), pj[k].cov(), **POST)


# -- kernel C on structured points and the 'auto' rule --------------------


def test_tiled_matches_broadcast_structured(gen):
    """tests/GP/test_tiled_gram.py:44: three fields through kernel C's
    plain version ('tiled') against the broadcast core, both packages."""
    x = structured(gen, 50, ('u', 'v', 'w'))

    def cov(mod, gram):
        return mod.GP(mod.ExpQuad(scale=1.7), gram=gram, checkpos=False) \
            .addx(x, 'a').prior('a', raw=True)

    Kt = cov(lt, 'tiled')
    close(Kt, cov(lt, 'broadcast'))
    close(Kt, cov(ltpu, 'broadcast'))
    close(Kt, cov(ltpu, 'tiled'))


def test_mixed_dtype_columns(gen):
    """An int field beside a float field: kernel C's columns (the int
    floated) in the JAX package's order give the broadcast core's
    block."""
    x = np.empty(30, dtype=[('k', int), ('u', float)])
    x['k'] = gen.integers(-3, 4, 30)
    x['u'] = gen.uniform(-2, 2, 30)
    from lsqfitgp_torch.kernelalg import _fastgram
    cols = _fastgram.leaf_columns(lt.asarray(x))
    colsj = ltpu.kernelalg._fastgram.leaf_columns(ltpu.asarray(x))
    for c, cj in zip(cols, colsj):
        close(c, cj)
    Kt = lt.GP(lt.ExpQuad(scale=1.5), gram='tiled').addx(x, 'a') \
        .prior('a', raw=True)
    Kb = lt.GP(lt.ExpQuad(scale=1.5), gram='broadcast').addx(x, 'a') \
        .prior('a', raw=True)
    close(Kt, Kb)


def test_deriv_falls_back(gen, monkeypatch):
    """tests/GP/test_tiled_gram.py:117: a derivative element goes to the
    broadcast path under gram='tiled' (the derivative drops the spec),
    with the broadcast's values; the value block still takes kernel C."""
    x = gen.uniform(-3, 3, 20)
    from lsqfitgp_torch.ops import _gram
    calls = []
    inner = _gram._eval_plain
    monkeypatch.setattr(_gram, '_eval_plain',
                        lambda *a: calls.append(1) or inner(*a))

    def cov(mod, gram):
        return mod.GP(mod.ExpQuad(), gram=gram, checkpos=False) \
            .addx(x, 'a', deriv=1).addx(x, 'v').prior(['a', 'v'], raw=True)

    Kt = cov(lt, 'tiled')
    assert len(calls) == 1  # the ('v', 'v') block only
    Kb = cov(ltpu, 'broadcast')
    for k in Kb:
        close(Kt[k], Kb[k])


def test_auto_broadcasts_on_cpu(monkeypatch):
    """gram='auto' evaluates point blocks by broadcasting the core on the
    CPU, as the JAX package does off its accelerator: kernel C's plain
    version does not run, at any size."""
    from lsqfitgp_torch.ops import _gram
    monkeypatch.setattr(_gram, '_eval_plain', None)
    x = np.linspace(-5, 5, 1100)
    gp = lt.GP(lt.ExpQuad(scale=2.0)).addx(x, 'a')
    K = gp.prior('a', raw=True)
    assert K.shape == (1100, 1100)


# -- addcov(decomps=) and decompose ------------------------------------------


def test_addcov_decomps_used(gen):
    """tests/GP/test_halfmatrix_decomps.py:69: the stored decomposition
    is the solver's, and the likelihood through it is the JAX
    package's."""
    n = 40
    S = gen.standard_normal((n, n))
    N = S @ S.T / n + np.eye(n)
    y = gen.standard_normal(n)
    dec = lt.GP.decompose(N)
    gp = lt.GP(lt.ExpQuad()).addcov(N, 'noise', decomps=dec)
    assert gp._solver_for(['noise']) is dec
    decj = ltpu.GP.decompose(N)
    gj = ltpu.GP(ltpu.ExpQuad()).addcov(N, 'noise', decomps=decj)
    close(gp.marginal_likelihood({'noise': y}),
          gj.marginal_likelihood({'noise': y}), **POST)
    close(gp.marginal_likelihood({'noise': y}),
          -dec.minus_log_normal_density(torch.as_tensor(y)), rtol=1e-12)


def test_addcov_decomps_dict_and_errors():
    """tests/GP/test_halfmatrix_decomps.py:76-86."""
    n = 10
    N = np.eye(n)
    dec = lt.GP.decompose(N)
    gp = lt.GP(lt.ExpQuad()).addcov({('a', 'a'): N}, decomps={'a': dec})
    assert gp._solver_for(['a']) is dec
    with pytest.raises(KeyError):
        lt.GP(lt.ExpQuad()).addcov({('a', 'a'): N}, decomps={'b': dec})
    with pytest.raises(TypeError):
        lt.GP(lt.ExpQuad()).addcov(N, 'a', decomps=np.eye(n))
    with pytest.raises(ValueError):
        lt.GP(lt.ExpQuad()).addcov(np.eye(n + 1), 'a', decomps=dec)
    with pytest.raises(KeyError):
        lt.GP.decompose(N, solver='nope')


# -- uncert ----------------------------------------------------------------


def test_corr(gen):
    """tests/test_uncert.py:39 with corr: the correlation of two parts of
    one UArray."""
    n = 4
    A = gen.standard_normal((2 * n, 2 * n))
    C = A @ A.T
    m = gen.standard_normal(2 * n)
    ut, uj = lt.uncert.from_cov(m, C), ltpu.uncert.from_cov(m, C)
    close(lt.uncert.evalcov(ut[:n], ut[n:]),
          ltpu.uncert.evalcov(uj[:n], uj[n:]), rtol=1e-10, atol=1e-12)
    close(lt.uncert.corr(ut[:n], ut[n:]), ltpu.uncert.corr(uj[:n], uj[n:]),
          rtol=1e-10, atol=1e-12)
    close(lt.uncert.corr(ut), ltpu.uncert.corr(uj), rtol=1e-10, atol=1e-12)


def test_sample_stats(gen):
    """tests/test_uncert.py:68: the mean and covariance of 40000 joint
    samples (the generators differ, so the statistics are compared)."""
    n = 3
    A = gen.standard_normal((n, n))
    C = A @ A.T + np.eye(n)
    m = gen.standard_normal(n)
    u = lt.uncert.from_cov(m, C)
    g = torch.Generator().manual_seed(SEED)
    s = lt.uncert.sample(g, u, 40000).numpy()
    assert s.shape == (40000, n)
    np.testing.assert_allclose(s.mean(0), m, atol=0.1)
    np.testing.assert_allclose(np.cov(s.T), C, atol=0.15, rtol=0.1)
    sj = np.asarray(ltpu.uncert.sample(jax.random.PRNGKey(0),
                                       ltpu.uncert.from_cov(m, C), 40000))
    np.testing.assert_allclose(np.cov(s.T), np.cov(sj.T), atol=0.3,
                               rtol=0.1)


# -- the slice: chip_smoke.py's derivative model at n = 48 -----------------


@functools.lru_cache(maxsize=None)
def _deriv_data():
    rng = np.random.default_rng(SEED)
    pf = structured(rng, 32, span=4.0)
    pd = structured(rng, 16, span=4.0)
    yf = np.sin(pf['x'] / 1.5) * np.cos(pf['t'] / 2) \
        + 0.3 * rng.standard_normal(32)
    yd = np.cos(pd['x'] / 1.5) / 1.5 * np.cos(pd['t'] / 2) \
        + 0.3 * rng.standard_normal(16)
    return pf, pd, yf, yd


def _deriv_factory(mod, gram='auto'):
    pf, pd, _, _ = _deriv_data()

    def gpfactory(hp):
        gp = mod.GP(hp['amp'] * mod.ExpQuad(scale=hp['scale']), gram=gram)
        return gp.addx(pf, 'f').addx(pd, 'd', deriv='x')
    return gpfactory


HYPERPRIOR = {'log(scale)': (0., 1.), 'log(amp)': (0., 1.)}


def test_deriv_model_likelihood():
    """The derivative model's NLL and its gradient in (log scale, log
    amp), the port's autograd against jax.grad."""
    _, _, yf, yd = _deriv_data()
    data = {'f': yf, 'd': yd}

    def ft(lp):
        gp = _deriv_factory(lt)({'scale': lp[0].exp(), 'amp': lp[1].exp()})
        return gp.marginal_likelihood(data, 0.09 * np.eye(48))

    def fj(lp):
        gp = _deriv_factory(ltpu)({'scale': jnp.exp(lp[0]),
                                   'amp': jnp.exp(lp[1])})
        return gp.marginal_likelihood(data, 0.09 * np.eye(48))

    lp0 = np.array([0.3, -0.2])
    lp = torch.tensor(lp0, requires_grad=True)
    v = ft(lp)
    g, = torch.autograd.grad(v, lp)
    close(v, fj(jnp.asarray(lp0)), **POST)
    close(g, jax.grad(fj)(jnp.asarray(lp0)), **POST)


def test_deriv_blocks_recomputed(monkeypatch):
    """The derivative blocks keep no graph once formed: after the NLL's
    forward, autograd holds no tensor of the (f, d) or (d, d) block's
    shape (`_torchutil.recompute` builds it again in the backward),
    where with each block's graph kept it holds several; the NLL's
    gradient and Hessian in (log scale, log amp) are the same to 1e-12
    relative either way."""
    import weakref
    _, _, yf, yd = _deriv_data()
    data = {'f': yf, 'd': yd}
    lp0 = np.array([0.3, -0.2])

    def run():
        saved = []

        def pack(t):
            # a detached alias: the saved tensor itself would make a
            # cycle with its own grad_fn and never be freed
            d = t.detach()
            saved.append(weakref.ref(d))
            return d

        lp = torch.tensor(lp0, requires_grad=True)
        with lt.linalg.second_order(), \
                torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            gp = _deriv_factory(lt)({'scale': lp[0].exp(),
                                     'amp': lp[1].exp()})
            v = gp.marginal_likelihood(data, 0.09 * np.eye(48))
        blocks = sum(1 for r in saved if r() is not None
                     and tuple(r().shape) in {(32, 16), (16, 32), (16, 16)}
                     and 0 not in r().stride())
        g, = torch.autograd.grad(v, lp, create_graph=True)
        h = torch.stack([torch.autograd.grad(g[i], lp, retain_graph=True)[0]
                         for i in range(2)])
        return blocks, g.detach(), h

    blocks, g, h = run()
    monkeypatch.setattr(_torchutil, 'recompute', lambda fn: fn())
    blocks_kept, g_kept, h_kept = run()
    assert blocks == 0 < blocks_kept
    close(g, g_kept, **TIGHT)
    close(h, h_kept, **TIGHT)


SECOND = {'hess': dict(covariance='hess'),
          'fisher': dict(covariance='fisher'),
          'forward': dict(forward=True)}


@functools.lru_cache(maxsize=None)
def _jax_deriv_fit(name, path):
    """The JAX package's fit of the derivative model with SECOND[name],
    saved at ``path`` (its state, as the port loads it)."""
    _, _, yf, yd = _deriv_data()
    data = ({'f': yf, 'd': yd}, 0.09 * np.eye(48))
    ltpu.empbayes_fit(HYPERPRIOR, _deriv_factory(ltpu), data,
                      **SECOND[name]).save(path)
    return lt.empbayes_fit.load(path)


@pytest.mark.parametrize('name,gram', [('hess', 'auto'), ('hess', 'tiled'),
                                       ('fisher', 'auto'),
                                       ('forward', 'auto')])
def test_deriv_model_hess_fit(tmp_path_factory, name, gram):
    """empbayes_fit of the derivative model with covariance='hess' or
    'fisher', or forward=True: the MAP and the Laplace covariance
    against the JAX fit's.  The Hessian differentiates the derivative
    blocks twice by plain autograd, and with 'tiled' the value block
    through kernel C's Function (its plain version on the CPU) and its
    second-order rule; the Fisher information and forward=True carry
    forward-mode tangents through the derivative blocks."""
    _, _, yf, yd = _deriv_data()
    data = ({'f': yf, 'd': yd}, 0.09 * np.eye(48))
    state = _jax_deriv_fit(
        name, str(tmp_path_factory.getbasetemp() / f'deriv_{name}.npz'))
    ft = lt.empbayes_fit(HYPERPRIOR, _deriv_factory(lt, gram), data,
                         **SECOND[name])
    np.testing.assert_allclose(ft.pmean.buf.numpy(), state['pmean'].numpy(),
                               rtol=1e-5, atol=1e-12)
    np.testing.assert_allclose(ft.pcov.numpy(), state['pcov'].numpy(),
                               rtol=1e-5, atol=1e-12)


def test_stream_raises_on_derivative():
    """solver='chol-stream' refuses a derivative element with the JAX
    package's message, as data and as an output of predfromdata."""
    x = np.linspace(-3, 3, 30)
    y = np.cos(x)
    for mod in (lt, ltpu):
        gp = mod.GP(mod.ExpQuad(), solver='chol-stream').addx(x, 'd',
                                                              deriv=1)
        with pytest.raises(ValueError,
                           match='derivative elements are not streamable'):
            gp.marginal_likelihood({'d': y}, 0.01)
        gp = gp.addx(x, 'f')
        with pytest.raises(ValueError, match='plain addx points'):
            gp.predfromdata({'f': y}, 'd', 0.01)


# -- the examples -----------------------------------------------------------


@pytest.mark.parametrize('name', ['double_integral', 'even_symmetry',
                                  'ornstein_uhlenbeck_filter',
                                  'model_comparison'])
def test_example(name):
    """examples/double_integral.py (a second derivative observed, the
    double antiderivative predicted: the affine-deflated rmse < 0.05),
    examples/even_symmetry.py (deflintransf: the mirror side within
    0.05 of the data with sdev < 0.05), ornstein_uhlenbeck_filter.py
    (the OU kernel: the smoothed path beats the raw data, the forecast's
    sdev relaxes to 1) and model_comparison.py (the log evidence of
    ExpQuad, Expon, the real-order Matérn and White: ExpQuad wins), run
    against lsqfitgp_torch with their own assertions."""
    path = os.path.join(ROOT, 'examples', name + '.py')
    src = open(path).read()
    assert 'import lsqfitgp_tpu as lgp' in src
    src = src.replace('import lsqfitgp_tpu as lgp',
                      'import lsqfitgp_torch as lgp')
    ns = {'__name__': 'example'}
    exec(compile(src, path, 'exec'), ns)
    u = ns['main']()
    if name in ('double_integral', 'even_symmetry'):
        assert isinstance(u, lt.uncert.UArray)


# -- the kernel classes' machinery -------------------------------------------


def _affine_kernel(mod):
    @mod.crosskernel(bases=(mod.AffineSpan, mod.Kernel))
    def AffK(x, y, *, lloc, rloc, lscale, rscale, offset, ampl):
        return offset + ampl * (lscale * (x - lloc)) * (rscale * (y - rloc))
    return AffK


def test_affine_span(gen):
    """tests/kernels/test_kernelalg.py:204: loc, scale and the scalar add
    and mul keep an AffineSpan kernel's class and track the affine map;
    a non-affine operation drops the class; no direct instantiation."""
    x = gen.uniform(-1, 1, 5)
    out = []
    for mod in (lt, ltpu):
        AffK = _affine_kernel(mod)
        k2 = (2.0 * AffK().linop('scale', 3.0).linop('loc', 1.0)) + 5.0
        assert isinstance(k2, AffK)
        dk = k2.dynkw
        assert (dk['lscale'], dk['lloc'], dk['offset'], dk['ampl']) == \
            pytest.approx((3.0, 3.0, 5.0, 2.0))
        assert not isinstance(k2.algop('exp'), AffK)
        with pytest.raises(TypeError):
            mod.AffineSpan(lambda x, y: 0 * x)
        xx = torch.as_tensor(x) if mod is lt else x
        out.append(np.asarray(k2(xx[:, None], xx[None, :])))
    np.testing.assert_allclose(out[0], out[1], **TIGHT)


def test_preserved_by_swap_and_nary(gen):
    """tests/kernels/test_kernelalg_deep.py:438 and :474: _nary on either
    side, and a PreservedBySwap class kept through a transposition."""
    x = gen.uniform(-2, 2, 6)
    for mod in (lt, ltpu):
        xx = torch.as_tensor(x) if mod is lt else x
        k = mod.ExpQuad()
        K = np.asarray(k(xx[:, None], xx[None, :]))
        for side in (mod.CrossKernel._side.LEFT, mod.CrossKernel._side.RIGHT):
            two = mod.CrossKernel._nary(lambda f: lambda v: 2 * f(v), [k],
                                        side)
            np.testing.assert_allclose(
                np.asarray(two(xx[:, None], xx[None, :])), 2 * K, **TIGHT)

        class P(mod.PreservedBySwap, mod.CrossKernel):
            pass

        p = P(lambda x, y: x - 2 * y)
        assert isinstance(p._swap(), P)
        np.testing.assert_allclose(
            np.asarray(p._swap()(xx[:, None], xx[None, :])),
            np.asarray(p(xx[None, :], xx[:, None])), **TIGHT)
        with pytest.raises(TypeError):
            mod.PreservedBySwap(lambda x, y: 0 * x)


def _family(mod):
    """A seed kernel whose linop 'tr' (multiplying each transformed side
    by a) links it to a left, a transposed right and a both-sides
    class."""
    @mod.kernel
    def Seed(x, y, *, a):
        return 1 + 0 * x * y

    @mod.kernel
    def Both(x, y, *, a):
        return a * a * x * y

    @mod.crosskernel(bases=(mod.PreservedBySwap, mod.CrossKernel))
    def Left(x, y, *, a):
        return a * x + 0 * y

    Right = Seed.make_linop_family('tr', Both, Left,
                                   argparser=lambda v: v if v else None)
    return Seed, Both, Left, Right


def test_make_linop_family(gen):
    """make_linop_family's class closure: seed -> left, right (generated
    as the transposed left) or both; left or right -> both; again on
    the same side raises."""
    x = gen.uniform(-2, 2, 5)
    vals = []
    for mod in (lt, ltpu):
        Seed, Both, Left, Right = _family(mod)
        xx = torch.as_tensor(x) if mod is lt else x
        s = Seed(a=1.5)
        left, right = s.linop('tr', True, None), s.linop('tr', None, True)
        assert isinstance(left, Left) and isinstance(right, Right)
        assert isinstance(s.linop('tr', True), Both)
        assert isinstance(left.linop('tr', None, True), Both)
        assert isinstance(right.linop('tr', True, None), Both)
        with pytest.raises(ValueError):
            left.linop('tr', True, None)
        vals.append([np.asarray(k(xx[:, None], xx[None, :])) for k in
                     (left, right, s.linop('tr', True))])
    for t, j in zip(*vals):
        np.testing.assert_allclose(t, j, **TIGHT)
