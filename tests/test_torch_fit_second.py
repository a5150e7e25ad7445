"""lsqfitgp_torch.empbayes_fit's second-order paths on the CPU against
lsqfitgp_tpu's on the same model and data (made from a seed with numpy),
in float64: covariance='hess' and 'fisher', method='fisher' (trust-ncg
with the Hessian at P <= 20 and Fisher-vector products at P > 20, on the
P = 25 model of the JAX package's tests/test_fit.py), forward=True and
custom_nll.  The JAX fits are carried across with `empbayes_fit.load`.

The JAX side assembles its Gram by broadcasting (gram='auto' on the
CPU): its Pallas rule cannot be differentiated twice in interpret mode.
The port's goes through kernel C's plain version (gram='tiled').

Tolerances: the objectives agree to ~1e-12 relative, so the minimizers
walk the same iterates; fitted pmean and pcov at rtol 1e-5, the
matrices of one point at rtol 1e-8."""

import functools

import numpy as np
import pytest
import torch
from jax import numpy as jnp

import lsqfitgp_tpu as ltpu
import lsqfitgp_torch as lt

pytestmark = pytest.mark.x64only

N = 200
HYPERPRIOR = {'log(scale)': (0., 1.), 'log(amp)': (0., 1.)}
FIT = dict(rtol=1e-5, atol=1e-12)


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


@functools.lru_cache(maxsize=None)
def _data():
    rng = np.random.default_rng(20261016)
    x = rng.uniform(-5, 5, N)
    y = np.sin(x) + 0.3 * rng.standard_normal(N)
    return x, y


def _factory(mod, gram, halfmatrix=False):
    x, _ = _data()

    def gpfactory(hp):
        kw = dict(gram=gram, halfmatrix=True) if halfmatrix \
            else dict(gram=gram)
        gp = mod.GP(hp['amp'] * mod.ExpQuad(scale=hp['scale']), **kw)
        gp = gp.addx(x, 'f').addcov(0.09 * np.eye(len(x)), 'e')
        return gp.addlintransf(lambda f, e: f + e, ['f', 'e'], 'y')
    return gpfactory


def _carried(fj, tmp_path):
    """The JAX fit's state as the port loads it."""
    fj.save(tmp_path / 'fit.npz')
    return lt.empbayes_fit.load(tmp_path / 'fit.npz')


def _assert_fit(ft, state):
    np.testing.assert_allclose(ft.pmean.buf.numpy(),
                               state['pmean'].numpy(), **FIT)
    np.testing.assert_allclose(ft.pcov.numpy(), state['pcov'].numpy(),
                               **FIT)


@pytest.mark.parametrize('kw', [
    dict(covariance='hess'),
    dict(covariance='fisher'),
    dict(method='fisher'),
], ids=['hess', 'fisher', 'method-fisher'])
def test_second_order_fit(kw, tmp_path):
    """The MAP and the Laplace covariance of each second-order estimator
    against the JAX fit's, and with method='fisher' (P = 2) trust-ncg
    takes the Hessian."""
    _, y = _data()
    fj = ltpu.empbayes_fit(HYPERPRIOR, _factory(ltpu, 'auto'), {'y': y},
                           **kw)
    ft = lt.empbayes_fit(HYPERPRIOR, _factory(lt, 'tiled'), {'y': y}, **kw)
    _assert_fit(ft, _carried(fj, tmp_path))
    assert ft.minresult.nit == fj.minresult.nit
    if kw.get('method') == 'fisher':
        assert ft.covariance == 'hess'
        assert ft.counts['hess'] > 0


def test_hess_halfmatrix():
    """covariance='hess' on the halfmatrix model (kernel E's second-order
    kernels, E′ and E″) equals the full model's (C′ and C″)."""
    _, y = _data()
    fh = lt.empbayes_fit(HYPERPRIOR, _factory(lt, 'tiled', True), {'y': y},
                         covariance='hess')
    ff = lt.empbayes_fit(HYPERPRIOR, _factory(lt, 'tiled'), {'y': y},
                         covariance='hess')
    np.testing.assert_allclose(fh.pcov.numpy(), ff.pcov.numpy(), rtol=1e-8)


def test_hess_matrix_is_jax_jacfwd_grad():
    """The Hessian of the objective at one point (P double-backward
    passes) against jax.jacfwd(jax.grad) of the JAX fit's objective."""
    _, y = _data()
    fj = ltpu.empbayes_fit(HYPERPRIOR, _factory(ltpu, 'auto'), {'y': y},
                           covariance='none',
                           minkw={'options': {'maxiter': 1}}, raises=False)
    ft = lt.empbayes_fit(HYPERPRIOR, _factory(lt, 'tiled'), {'y': y},
                         covariance='none', minkw={'maxiter': 1},
                         raises=False)
    w = np.array([0.3, -0.2])
    import jax
    ref = np.asarray(jax.jacfwd(jax.grad(fj._nll))(jnp.asarray(w)))
    got = ft._hessian(torch.as_tensor(w)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-8,
                               atol=1e-10 * np.abs(ref).max())


def test_forward_mode_gradient():
    """forward=True: the gradient by forward mode (one pass per
    hyperparameter, one factorization) equals reverse mode's, and the
    fit lands where the JAX package's forward-mode fit does."""
    _, y = _data()
    ft = lt.empbayes_fit(HYPERPRIOR, _factory(lt, 'tiled'), {'y': y},
                         forward=True)
    fr = lt.empbayes_fit(HYPERPRIOR, _factory(lt, 'tiled'), {'y': y})
    w = torch.tensor([0.3, -0.2])
    vf, gf = ft._value_and_grad(w)
    vr, gr = fr._value_and_grad(w)
    np.testing.assert_allclose(float(vf), float(vr), rtol=1e-12)
    np.testing.assert_allclose(gf.numpy(), gr.numpy(), rtol=1e-8)
    fj = ltpu.empbayes_fit(HYPERPRIOR, _factory(ltpu, 'auto'), {'y': y},
                           forward=True)
    np.testing.assert_allclose(ft.pmean.buf.numpy(),
                               np.asarray(fj.pmean.buf), **FIT)


def test_forward_mode_factors_once(monkeypatch):
    """The P forward-mode passes of one gradient share one
    factorization."""
    from lsqfitgp_torch.linalg import _decomp
    _, y = _data()
    fit = lt.empbayes_fit(HYPERPRIOR, _factory(lt, 'tiled'), {'y': y},
                          forward=True, covariance='none',
                          minkw={'maxiter': 1}, raises=False)
    made = []
    init = _decomp.Chol.__init__

    def counting(self, *args, **kw):
        made.append(1)
        init(self, *args, **kw)

    monkeypatch.setattr(_decomp.Chol, '__init__', counting)
    fit._value_and_grad(torch.tensor([0.3, -0.2]))
    assert len(made) == 1


def _many_param_setup(n=24):
    """The JAX package's tests/test_fit.py P = n + 1 model: per-point
    noise levels plus the kernel scale."""
    rng = np.random.default_rng(5)
    x = np.sort(rng.uniform(-5, 5, n))
    K = np.exp(-0.5 * (x[:, None] - x[None, :]) ** 2 / 4)
    L = np.linalg.cholesky(K + 1e-6 * np.eye(n))
    y = L @ rng.standard_normal(n) + 0.1 * rng.standard_normal(n)

    def factory(mod, diag):
        def gpfactory(hp):
            gp = mod.GP(mod.ExpQuad(scale=hp['scale']))
            gp = gp.addx(x, 'f')
            gp = gp.addcov(diag(hp['sigma'] ** 2), 'e')
            return gp.addlintransf(lambda f, e: f + e, ['f', 'e'], 'y',
                                   checklin=False)
        return gpfactory

    hp = {'log(scale)': (0.0, 1.0),
          'log(sigma)': (np.full(n, np.log(0.1)), np.full(n, 0.5))}
    return hp, factory(ltpu, jnp.diag), factory(lt, torch.diag), y


@pytest.mark.parametrize('kw', [
    dict(method='fisher'),
    dict(covariance='fisher'),
    dict(method='fisher', covariance='fisher', minkw=dict(fishvec=False)),
], ids=['fishvec', 'fisher-columns', 'fishvec-off'])
def test_many_parameters(kw, tmp_path):
    """P = 25 > 20: trust-ncg on Fisher-vector products (and with
    minkw['fishvec'] = False on the Hessian), the Fisher covariance from
    columns of Fisher-vector products; against the JAX fits."""
    hp, jfac, tfac, y = _many_param_setup()
    fj = ltpu.empbayes_fit(hp, jfac, {'y': y}, **kw)
    ft = lt.empbayes_fit(hp, tfac, {'y': y}, **kw)
    _assert_fit(ft, _carried(fj, tmp_path))
    assert ft.minresult.nit == fj.minresult.nit
    if kw.get('method') == 'fisher':
        assert ft.counts['hess'] > 0
    eig = torch.linalg.eigvalsh(ft.pcov)
    assert float(eig.min()) > 0


def test_custom_nll():
    """custom_nll replaces the GP's likelihood: the same MAP as the
    gpfactory fit, 'hess' through the user's objective with 'auto' the
    BFGS estimate; the JAX package's errors for 'fisher'."""
    _, y = _data()
    fac = _factory(lt, 'tiled')

    def custom(hp):
        return -fac(hp).marginal_likelihood({'y': y})

    fc = lt.empbayes_fit(HYPERPRIOR, custom_nll=custom)
    fg = lt.empbayes_fit(HYPERPRIOR, fac, {'y': y})
    np.testing.assert_allclose(fc.pmean.buf.numpy(), fg.pmean.buf.numpy(),
                               rtol=1e-10)
    assert fc.covariance == 'minhess'
    with pytest.raises(ValueError, match='custom_nll'):
        lt.empbayes_fit(HYPERPRIOR, custom_nll=custom, method='fisher')
    with pytest.raises(ValueError, match="covariance='hess'"):
        lt.empbayes_fit(HYPERPRIOR, custom_nll=custom, covariance='hess')
    with pytest.raises(TypeError, match='custom_nll'):
        lt.empbayes_fit(HYPERPRIOR)


def test_stream_hess_raises():
    """A streaming objective has no second derivative: covariance='hess'
    raises the JAX package's ValueError."""
    x, y = _data()

    def gpfactory(hp):
        k = hp['amp'] * lt.ExpQuad(scale=hp['scale']) + 0.09 * lt.White()
        return lt.GP(k, solver='chol-stream', block=64, b1=64).addx(
            x[:128], 'y')

    with pytest.raises(ValueError, match='custom-VJP'):
        lt.empbayes_fit(HYPERPRIOR, gpfactory, {'y': y[:128]},
                        covariance='hess')
