"""lsqfitgp_torch.empbayes_fit on the CPU against lsqfitgp_tpu's on the
same model and data (made from a seed with numpy), in float64, plus the
state carried across packages: a fit saved by the JAX package loaded by
the port, and the JAX hyperparameters handed to the port.

Tolerances: the two objectives agree to ~1e-12 relative, so scipy's
BFGS walks the same iterates and the MAP agrees to far better than
rtol 1e-6; the BFGS inverse Hessian ('minhess') is built from the same
steps and gradients, checked at rtol 1e-5."""

import numpy as np
import pytest
import torch

import lsqfitgp_tpu as ltpu
import lsqfitgp_torch as lt

pytestmark = pytest.mark.x64only

N = 200
HYPERPRIOR = {'log(scale)': (0., 1.), 'log(amp)': (0., 1.)}


@pytest.fixture(autouse=True)
def torch_f64():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    torch.set_num_threads(2)
    yield
    torch.set_default_dtype(old)


@pytest.fixture(scope='module')
def data():
    rng = np.random.default_rng(20261016)
    x = rng.uniform(-5, 5, N)
    y = np.sin(x) + 0.3 * rng.standard_normal(N)
    return x, y


def _factory(mod, x):
    def gpfactory(hp):
        gp = mod.GP(hp['amp'] * mod.ExpQuad(scale=hp['scale']),
                    gram='tiled')
        gp = gp.addx(x, 'f').addcov(0.09 * np.eye(len(x)), 'e')
        return gp.addlintransf(lambda f, e: f + e, ['f', 'e'], 'y')
    return gpfactory


@pytest.fixture(scope='module')
def fits(data):
    x, y = data
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        fj = ltpu.empbayes_fit(HYPERPRIOR, _factory(ltpu, x), {'y': y})
        ft = lt.empbayes_fit(HYPERPRIOR, _factory(lt, x), {'y': y})
    finally:
        torch.set_default_dtype(old)
    return fj, ft


def test_map_and_laplace(fits):
    fj, ft = fits
    np.testing.assert_allclose(ft.pmean.buf.numpy(),
                               np.asarray(fj.pmean.buf), rtol=1e-6)
    np.testing.assert_allclose(ft.pcov.numpy(), np.asarray(fj.pcov),
                               rtol=1e-5)
    np.testing.assert_allclose(float(ft.pmean['scale']),
                               float(fj.pmean['scale']), rtol=1e-6)
    np.testing.assert_allclose(ft.p['scale'].sdev.numpy(),
                               np.asarray(fj.p['scale'].sdev), rtol=1e-5)
    assert ft.minresult.nit == fj.minresult.nit


def test_posterior_at_map(fits, data):
    x, y = data
    fj, ft = fits
    xs = np.linspace(-6, 6, 9)
    pj = fj.gp().addx(xs, 'pred').predfromdata({'y': y}, 'pred')
    pt = ft.gp().addx(xs, 'pred').predfromdata({'y': y}, 'pred')
    np.testing.assert_allclose(pt.mean.numpy(), np.asarray(pj.mean),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(pt.sdev.numpy(), np.asarray(pj.sdev),
                               rtol=1e-5)


def test_load_jax_save(fits, tmp_path):
    fj, ft = fits
    path = tmp_path / 'fit.npz'
    fj.save(path)
    state = lt.empbayes_fit.load(path)
    np.testing.assert_array_equal(state['pmean'].numpy(),
                                  np.asarray(fj.pmean.buf))
    np.testing.assert_array_equal(state['w'].numpy(), np.asarray(fj.w))
    assert state['p'].keys() == list(HYPERPRIOR)
    np.testing.assert_allclose(state['p']['scale'].mean.numpy(),
                               float(fj.pmean['scale']), rtol=1e-14)
    np.testing.assert_allclose(state['p'].buf.cov().numpy(),
                               np.asarray(fj.pcov), rtol=1e-10,
                               atol=1e-14)
    # and the port's own save/load round trip, same format
    ft.save(tmp_path / 'fit2.npz')
    again = ltpu.empbayes_fit.load(tmp_path / 'fit2.npz')
    np.testing.assert_array_equal(np.asarray(again['pmean']),
                                  ft.pmean.buf.numpy())


def test_bufferdict_from_numpy(fits, data):
    """Both packages run at the same hyperparameters: the JAX fit's MAP
    handed to the port gives the same marginal likelihood."""
    x, y = data
    fj, _ = fits
    hp = lt.uncert.bufferdict_from_numpy(
        {k: np.asarray(v) for k, v in fj.pmean.items()})
    assert hp.keys() == list(HYPERPRIOR)
    np.testing.assert_allclose(float(hp['scale']), float(fj.pmean['scale']),
                               rtol=1e-15)
    mt = _factory(lt, x)(hp).marginal_likelihood({'y': y})
    mj = _factory(ltpu, x)(fj.pmean).marginal_likelihood({'y': y})
    np.testing.assert_allclose(float(mt), float(mj), rtol=1e-10)


@pytest.mark.parametrize('covariance', ['none', 'prior'])
def test_nograd(data, covariance):
    x, y = data
    fj = ltpu.empbayes_fit(HYPERPRIOR, _factory(ltpu, x), {'y': y},
                           method='nograd', covariance=covariance)
    ft = lt.empbayes_fit(HYPERPRIOR, _factory(lt, x), {'y': y},
                         method='nograd', covariance=covariance)
    np.testing.assert_allclose(ft.pmean.buf.numpy(),
                               np.asarray(fj.pmean.buf), rtol=1e-6)
    np.testing.assert_allclose(ft.pcov.numpy(), np.asarray(fj.pcov),
                               rtol=1e-10, atol=1e-14)


def test_uncert_transformed_keys():
    bj = ltpu.BufferDict({'log(a)': ltpu.uncert.normal(0.3, 0.2),
                          'b': ltpu.uncert.normal([1., 2.], [0.5, 0.1])})
    bt = lt.BufferDict({'log(a)': lt.uncert.normal(0.3, 0.2),
                        'b': lt.uncert.normal([1., 2.], [0.5, 0.1])})
    assert 'a' in bt and 'log(a)' in bt and 'c' not in bt
    for key in ('a', 'log(a)', 'b'):
        np.testing.assert_allclose(bt[key].mean.numpy(),
                                   np.asarray(bj[key].mean), rtol=1e-15)
        np.testing.assert_allclose(bt[key].sdev.numpy(),
                                   np.asarray(bj[key].sdev), rtol=1e-15)
    np.testing.assert_allclose(bt.buf.cov().numpy(), np.asarray(bj.buf.cov()))
