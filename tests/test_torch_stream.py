"""The port's streaming solver and halfmatrix path on the CPU against the
JAX package on the same inputs (made from a seed with numpy), in
float64: kernel D's plain version `schur_update_gram_plain`, kernel E's
`gram_sym` with its gradient, the streaming likelihood, posterior and
exact gradient (`linalg.chol_nll_stream`, `chol_pred_stream`,
`chol_nll_stream_grad`), ``GP(solver='chol-stream')`` with
``empbayes_fit``, and ``GP(halfmatrix=True)``.  The JAX package runs as
its own tests run it: the Pallas kernels in interpret mode, the
streaming functions through their reference branches off the TPU.

n = 300 with ``block=128`` pads to 384, so the factorization has three
blocks and runs the Gram-fused Schur update.  Tolerances: both sides run
the same float64 algorithms with sums in another order (at p > 1 the
JAX kernels take the centered norm expansion for r², the port the
direct sum, which differ by a few roundings of the coordinates' scale);
the Grams here have condition numbers up to ~1e5, so rtol 1e-9 leaves a
wide margin unless a test says otherwise."""

import numpy as np
import pytest
import torch
import jax
from jax import numpy as jnp

import lsqfitgp_tpu as ltpu
from lsqfitgp_tpu import linalg as jlinalg
from lsqfitgp_tpu import ops as jops
import lsqfitgp_torch as lt
from lsqfitgp_torch import linalg, ops

pytestmark = pytest.mark.x64only

N, NS = 300, 25
STREAMKW = dict(solver='chol-stream', block=128, b1=128)
RTOL = 1e-9


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


@pytest.fixture(scope='module')
def data():
    rng = np.random.default_rng(20261016)
    x = np.sort(rng.uniform(-5, 5, N))
    y = np.sin(1.5 * x) + 0.1 * rng.standard_normal(N)
    return x, y, np.linspace(-4.5, 4.5, NS)


def _jprofile(r2, amp):
    return amp * jnp.exp(-0.5 * r2)


def _tiles(size, tile):
    nt = size // tile
    return np.tril(np.ones((nt, nt), bool)).repeat(tile, 0).repeat(tile, 1)


# -- kernels D and E (plain versions) ----------------------------------------

@pytest.mark.parametrize('p', [1, 3])
@pytest.mark.parametrize('with_eps', [True, False])
def test_schur_update_gram(p, with_eps):
    rng = np.random.default_rng(p + 2 * with_eps)
    tile, size, offset = 128, 256, 128
    npad = offset + size
    nreal = npad - 40
    X = rng.standard_normal((npad, p)) * 2
    X[nreal:] = X[nreal - 1]
    A = rng.standard_normal((size, 128)) / 4
    eps = 0.25 if with_eps else None
    ref = jops._syrk.schur_update_gram(
        _jprofile, jnp.asarray(X), jnp.sum(jnp.asarray(X) ** 2, -1,
                                           keepdims=True),
        jnp.asarray(A), params=(1.7,), eps=eps, nreal=nreal, size=size,
        offset=offset, tile=tile, kchunk=tile, precision='highest',
        interpret='pallas')
    got = ops.schur_update_gram('expquad', torch.as_tensor(X),
                                torch.as_tensor(A), post=(('mul', 1.7),),
                                eps=eps, nreal=nreal, size=size,
                                offset=offset, tile=tile)
    keep = _tiles(size, tile)
    np.testing.assert_allclose(got.numpy()[keep], np.asarray(ref)[keep],
                               rtol=RTOL, atol=1e-12)
    assert np.all(got.numpy()[~keep] == 0)
    # the pad tail is exactly the identity
    pad = got.numpy()[nreal - offset:, nreal - offset:] \
        + (np.asarray(A) @ np.asarray(A).T)[nreal - offset:, nreal - offset:]
    np.testing.assert_allclose(pad, np.eye(npad - nreal), atol=1e-13)


@pytest.mark.parametrize('p', [1, 3])
def test_gram_sym(p):
    """Kernel E's plain version and its autograd gradient (points, post
    scalar, nugget) against the JAX gram_sym with jax.grad."""
    rng = np.random.default_rng(p)
    x = rng.standard_normal((150, p)) * 2
    G = rng.standard_normal((150, 150))

    def jfun(x, amp, noise):
        K = jops.gram_sym(_jprofile, x, params=(amp,), noise=noise,
                          tile=128, interpret=True)
        return jnp.sum(K * G), K

    (vj, Kj), gj = jax.value_and_grad(jfun, argnums=(0, 1, 2),
                                      has_aux=True)(jnp.asarray(x), 1.3, 0.2)
    leaves = [torch.as_tensor(v).requires_grad_() for v in (x, 1.3, 0.2)]
    K = ops.gram_sym('expquad', leaves[0], post=(('mul', leaves[1]),),
                     noise=leaves[2])
    assert torch.equal(K, K.T)
    np.testing.assert_allclose(K.detach().numpy(), np.asarray(Kj),
                               rtol=1e-12, atol=1e-12)
    for g, r in zip(torch.autograd.grad((K * torch.as_tensor(G)).sum(),
                                        leaves), gj):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-10,
                                   atol=1e-10)
    torch.testing.assert_close(
        K, ops.gram_sym_plain('expquad', leaves[0],
                              post=(('mul', leaves[1]),), noise=leaves[2]))


# -- streaming linalg ----------------------------------------------------------

@pytest.mark.parametrize('vector_eps', [False, True])
def test_chol_nll_and_pred_stream(data, vector_eps):
    x, y, xs = data
    eps = np.random.default_rng(1).uniform(0.005, 0.05, N) if vector_eps \
        else 0.01
    kw = dict(block=128, b1=128)
    xj, xsj = x / 1.7, xs / 1.7
    vj = jlinalg.chol_nll_stream(_jprofile, xj, y, params=(1.4,),
                                 epsabs=jnp.asarray(eps), precision='highest',
                                 **kw)
    vt = linalg.chol_nll_stream('expquad', xj, y, post=(('mul', 1.4),),
                                epsabs=eps, **kw)
    np.testing.assert_allclose(float(vt), float(vj), rtol=RTOL)
    for what in ('var', 'cov'):
        ref = jlinalg.chol_pred_stream(
            _jprofile, xj, y, xsj, params=(1.4,), epsabs=jnp.asarray(eps),
            precision='highest', return_nll=True,
            **{'return_' + what: True}, **kw)
        got = linalg.chol_pred_stream(
            'expquad', xj, y, xsj, post=(('mul', 1.4),), epsabs=eps,
            return_nll=True, **{'return_' + what: True}, **kw)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=RTOL,
                                       atol=1e-11)
    mean = linalg.chol_pred_stream('expquad', xj, y, xsj,
                                   post=(('mul', 1.4),), epsabs=eps, **kw)
    np.testing.assert_allclose(mean.numpy(), got[0].numpy(), rtol=1e-14)


@pytest.mark.parametrize('vector_eps', [False, True])
def test_chol_nll_stream_grad(data, vector_eps):
    """Value and exact gradient in the post-chain scalar, the length
    scale and the nugget (a scalar, or a vector with per-element
    gradients), and in y, against jax.grad of the JAX rule."""
    x, y, _ = data
    eps = np.random.default_rng(2).uniform(0.005, 0.05, N) if vector_eps \
        else 0.01

    def jfun(amp, ls, e, y):
        return jlinalg.chol_nll_stream_grad(
            _jprofile, x, y, params=(amp,), lenscale=ls, epsabs=e,
            block=128, b1=128, precision='highest')

    vj, gj = jax.value_and_grad(jfun, argnums=(0, 1, 2, 3))(
        1.4, 1.7, jnp.asarray(eps), jnp.asarray(y))
    leaves = [torch.as_tensor(v).requires_grad_()
              for v in (1.4, 1.7, eps, y)]
    vt = linalg.chol_nll_stream_grad(
        'expquad', x, leaves[3], post=(('mul', leaves[0]),),
        lenscale=leaves[1], epsabs=leaves[2], block=128, b1=128)
    np.testing.assert_allclose(float(vt.detach()), float(vj), rtol=RTOL)
    for g, r in zip(torch.autograd.grad(vt, leaves), gj):
        assert g.shape == np.shape(r)
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-8,
                                   atol=1e-10)


def test_chol_nll_stream_grad_options(data):
    x, y, _ = data
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        linalg.chol_nll_stream_grad('expquad', x, y, exact=False)
    # the strip width does not change the result, and the backward
    # consumes the factor once
    a = torch.tensor(1.4, requires_grad=True)
    outs = []
    for gb in (128, 256, None):
        v = linalg.chol_nll_stream_grad('expquad', x, y, post=(('mul', a),),
                                        epsabs=0.01, block=128, b1=128,
                                        gradblock=gb)
        g, = torch.autograd.grad(v, a, retain_graph=True)
        outs.append(float(g))
    np.testing.assert_allclose(outs, outs[0], rtol=1e-11)
    with pytest.raises(RuntimeError, match='once per forward'):
        torch.autograd.grad(v, a)


# -- GP(solver='chol-stream') --------------------------------------------------

def _stream_gps(mod, k, x, xs):
    return (mod.GP(k, **STREAMKW).addx(x, 'd').addx(xs, 's'),
            mod.GP(k).addx(x, 'd').addx(xs, 's'))


@pytest.mark.parametrize('noise', ['kernel', 'scalar', 'vector'])
def test_gp_stream_matches_jax(data, noise):
    """The cases of the JAX package's streaming GP tests: the noise in
    the kernel (White), as a scalar givencov, or as a per-point variance
    vector; marginal likelihood and posterior against the JAX streaming
    GP, and against the port's own dense solver (to the streaming
    solver's eps anchor: rtol 1e-6)."""
    x, y, xs = data
    nv = np.random.default_rng(7).uniform(0.005, 0.05, N)
    gcov = {'kernel': None, 'scalar': 0.01, 'vector': nv}[noise]
    dense_cov = {'kernel': None, 'scalar': 0.01 * np.eye(N),
                 'vector': np.diag(nv)}[noise]
    out = {}
    for mod in (ltpu, lt):
        k = 1.4 * mod.ExpQuad(scale=1.7)
        if noise == 'kernel':
            k = k + 0.01 * mod.White()
        gps, gpd = _stream_gps(mod, k, x, xs)
        ml = float(gps.marginal_likelihood({'d': y}, gcov))
        post = gps.predfromdata({'d': y}, 's', gcov)
        out[mod] = ml, np.asarray(post.mean), np.asarray(post.sdev)
        if mod is lt:
            dcov = None if dense_cov is None else {('d', 'd'): dense_cov}
            mld = float(gpd.marginal_likelihood({'d': y}, dcov))
            postd = gpd.predfromdata({'d': y}, 's', dcov)
    for g, r in zip(out[lt], out[ltpu]):
        np.testing.assert_allclose(g, r, rtol=RTOL, atol=1e-11)
    np.testing.assert_allclose(out[lt][0], mld, rtol=1e-6)
    np.testing.assert_allclose(out[lt][1], postd.mean.numpy(), atol=1e-6)
    np.testing.assert_allclose(out[lt][2], postd.sdev.numpy(), atol=1e-6)


def test_gp_stream_raw_and_multi_key(data):
    x, y, xs = data
    out = {}
    for mod in (ltpu, lt):
        k = 1.2 * mod.ExpQuad(scale=1.5) + 0.02 * mod.White()
        gp = mod.GP(k, **STREAMKW).addx(x, 'd').addx(xs[:10], 'a') \
            .addx(xs[10:], 'b')
        mean, cov = gp.predfromdata({'d': y}, 'a', raw=True)
        means, covs = gp.predfromdata({'d': y}, ['a', 'b'], raw=True)
        post = gp.predfromdata({'d': y}, ['a', 'b'])
        out[mod] = [mean, cov, means['b'], covs['a', 'b'],
                    post['a'].mean, post['b'].sdev]
    assert out[lt][0].shape == (10,) and out[lt][3].shape == (10, 15)
    for g, r in zip(out[lt], out[ltpu]):
        np.testing.assert_allclose(np.asarray(g), np.asarray(r), rtol=RTOL,
                                   atol=1e-11)


def test_gp_stream_gradient(data):
    """d(log ML)/d(amp, scale, noise) through the GP object, against
    jax.grad through the JAX streaming GP."""
    x, y, _ = data

    def ml(mod, w):
        k = w[0] * mod.ExpQuad(scale=w[1]) + w[2] * mod.White()
        gp = mod.GP(k, checkpos=False, checksym=False, **STREAMKW)
        return gp.addx(x, 'd').marginal_likelihood({'d': y})

    w0 = np.array([1.4, 1.7, 0.02])
    vj, gj = jax.value_and_grad(lambda w: ml(ltpu, w))(jnp.asarray(w0))
    w = torch.as_tensor(w0).requires_grad_()
    v = ml(lt, w)
    g, = torch.autograd.grad(v, w)
    np.testing.assert_allclose(float(v.detach()), float(vj), rtol=RTOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), rtol=1e-8)


def test_gp_stream_diagnostics(data):
    x, y, _ = data
    gp0 = lt.GP(lt.ExpQuad(), **STREAMKW).addx(x, 'a').addx(x + 1.0, 'b')
    with pytest.raises(ValueError, match='need exactly 1'):
        gp0.marginal_likelihood({'a': y, 'b': y})
    gp = lt.GP(lt.ExpQuad() * lt.ExpQuad(), **STREAMKW).addx(x, 'd')
    with pytest.raises(ValueError, match='fast-Gram spec'):
        gp.marginal_likelihood({'d': y})
    gp2 = lt.GP(lt.ExpQuad(), **STREAMKW).addx(x, 'd')
    with pytest.raises(ValueError, match='vector'):
        gp2.marginal_likelihood({'d': y}, 0.01 * np.eye(N))
    with pytest.raises(ValueError, match='length'):
        gp2.marginal_likelihood({'d': y}, np.ones(N + 3))
    gp4 = gp2.addx(x[:5] + 0.5, 's')
    with pytest.raises(ValueError, match='predfromdata only'):
        gp4.predfromfit({'d': y}, 's', 0.01)
    with pytest.raises(ValueError, match='keepcorr'):
        gp4.predfromdata({'d': y}, 's', 0.01, keepcorr=True)
    with pytest.raises(RuntimeError, match='no dense decomposition'):
        gp4._solver_for(['d'])


HYPERPRIOR = {'log(amp)': (0.0, 1.0), 'log(scale)': (0.0, 1.0),
              'log(noise)': (np.log(0.01), 1.0)}


def _stream_factory(mod, x):
    def gpfactory(hp):
        k = hp['amp'] * mod.ExpQuad(scale=hp['scale']) \
            + hp['noise'] * mod.White()
        return mod.GP(k, **STREAMKW).addx(x, 'd')
    return gpfactory


@pytest.fixture(scope='module')
def stream_fits(data):
    x, y, _ = data
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        fj = ltpu.empbayes_fit(HYPERPRIOR, _stream_factory(ltpu, x),
                               {'d': y}, raises=False)
        ft = lt.empbayes_fit(HYPERPRIOR, _stream_factory(lt, x), {'d': y},
                             raises=False)
    finally:
        torch.set_default_dtype(old)
    return fj, ft


def test_gp_stream_fit(stream_fits, data):
    """A streaming fit through gpfactory/data: BFGS walks the same
    iterates on both sides (objectives equal to ~1e-12), so the MAP
    agrees to rtol 1e-6 and the inverse-Hessian covariance to 1e-5."""
    x, y, xs = data
    fj, ft = stream_fits
    np.testing.assert_allclose(ft.pmean.buf.numpy(),
                               np.asarray(fj.pmean.buf), rtol=1e-6)
    np.testing.assert_allclose(ft.pcov.numpy(), np.asarray(fj.pcov),
                               rtol=1e-5, atol=1e-10)
    assert 0.004 < float(ft.pmean['noise']) < 0.03
    pt = ft.gp().addx(xs, 's').predfromdata({'d': y}, 's')
    pj = fj.gp().addx(xs, 's').predfromdata({'d': y}, 's')
    np.testing.assert_allclose(pt.mean.numpy(), np.asarray(pj.mean),
                               rtol=1e-5, atol=1e-7)
    with pytest.raises(NotImplementedError, match='fisher'):
        lt.empbayes_fit(HYPERPRIOR, _stream_factory(lt, x), {'d': y},
                        covariance='fisher')


def test_gp_stream_carried_state(stream_fits, data, tmp_path):
    """The JAX fit's MAP handed to the port gives the same streaming
    likelihood, and the JAX fit's saved state loads in the port."""
    x, y, _ = data
    fj, _ = stream_fits
    hp = lt.uncert.bufferdict_from_numpy(
        {k: np.asarray(v) for k, v in fj.pmean.items()})
    mt = _stream_factory(lt, x)(hp).marginal_likelihood({'d': y})
    mj = _stream_factory(ltpu, x)(fj.pmean).marginal_likelihood({'d': y})
    np.testing.assert_allclose(float(mt), float(mj), rtol=RTOL)
    fj.save(tmp_path / 'fit.npz')
    state = lt.empbayes_fit.load(tmp_path / 'fit.npz')
    np.testing.assert_array_equal(state['pmean'].numpy(),
                                  np.asarray(fj.pmean.buf))
    np.testing.assert_allclose(state['p'].buf.cov().numpy(),
                               np.asarray(fj.pcov), rtol=1e-10, atol=1e-14)


# -- GP(halfmatrix=True) -------------------------------------------------------

@pytest.mark.parametrize('gram', ['tiled', 'broadcast'])
def test_halfmatrix(data, gram):
    """halfmatrix=True (kernel E's path when tiled, the packed upper
    triangle when broadcast) against halfmatrix=False and against the
    JAX GP with halfmatrix, with the hyperparameter gradient."""
    x, y, xs = data
    noise = {('d', 'd'): 0.01 * np.eye(N)}

    def jml(p, hm):
        k = jnp.exp(p[0]) * ltpu.ExpQuad(scale=jnp.exp(p[1]))
        gp = ltpu.GP(k, halfmatrix=hm, gram=gram).addx(x, 'd')
        return gp.marginal_likelihood({'d': y}, noise)

    p0 = np.array([0.3, 0.5])
    vj, gj = jax.value_and_grad(jml)(jnp.asarray(p0), True)
    out = []
    for hm in (True, False):
        p = torch.as_tensor(p0).requires_grad_()
        k = p[0].exp() * lt.ExpQuad(scale=p[1].exp())
        gp = lt.GP(k, halfmatrix=hm, gram=gram).addx(x, 'd').addx(xs, 's')
        v = gp.marginal_likelihood({'d': y}, noise)
        g, = torch.autograd.grad(v, p)
        prior = gp.prior(['d', 's'], raw=True)
        out.append((float(v.detach()), g.numpy(), prior['d', 'd'].detach(),
                    prior['d', 's'].detach()))
    np.testing.assert_allclose(out[0][0], float(vj), rtol=RTOL)
    np.testing.assert_allclose(out[0][1], np.asarray(gj), rtol=1e-8)
    np.testing.assert_allclose(out[0][0], out[1][0], rtol=1e-12)
    np.testing.assert_allclose(out[0][1], out[1][1], rtol=1e-10)
    assert torch.equal(out[0][2], out[0][2].T)
    torch.testing.assert_close(out[0][2], out[1][2], rtol=1e-14,
                               atol=1e-15)
    torch.testing.assert_close(out[0][3], out[1][3], rtol=0, atol=0)


def test_halfmatrix_uses_kernel_e(data, monkeypatch):
    x, y, _ = data
    calls = []
    orig = lt.ops.gram_sym
    monkeypatch.setattr(lt.ops, 'gram_sym',
                        lambda *a, **k: calls.append(a[0]) or orig(*a, **k))
    lt.GP(lt.ExpQuad(), halfmatrix=True, gram='tiled').addx(x, 'd') \
        .prior('d', raw=True)
    assert calls == ['expquad']


# -- the default device --------------------------------------------------------

def test_default_device(data, monkeypatch):
    """Array-likes land on the device the caller asked for; with no
    request and no card, the first placement raises and names the
    call that asks for the CPU."""
    x, y, _ = data
    hp = {'log(amp)': (0.0, 1.0)}

    def factory(hp):
        return lt.GP(hp['amp'] * lt.ExpQuad(), **STREAMKW).addx(x, 'd')

    gp = lt.GP(lt.ExpQuad()).addx(x, 'd')
    assert gp._elements['d'].x.device.type == 'cpu'
    fit = lt.empbayes_fit(hp, factory, {'d': y}, minkw={'maxiter': 1},
                          raises=False)
    assert fit.pmean.buf.device.type == 'cpu'
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with lt.using_device(None):
        with pytest.raises(RuntimeError, match='set_default_device'):
            lt.GP(lt.ExpQuad()).addx(x, 'd')
        with pytest.raises(RuntimeError, match='set_default_device'):
            lt.empbayes_fit(hp, factory, {'d': y})
        monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
        assert lt.default_device() == torch.device('cuda')
    assert lt.default_device() == torch.device('cpu')
