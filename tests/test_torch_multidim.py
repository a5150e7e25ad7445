"""lsqfitgp_torch on multi-dimensional points against lsqfitgp_tpu, on
the CPU, in float64, on the same inputs made from a seed with numpy.

The model is `chip_smoke.py`'s multidim phase cut to size: the Friedman
#1 response (10 sin(π x₁x₂) + 20 (x₃ − ½)² + 10 x₄ + 5 x₅ + N(0, 1),
standardized) at n = 200 points uniform on [0, 1]^10, held as one
structured field with a (10,) tail, so the kernel sees p = 10
coordinates; ``amp * ExpQuad(scale)`` with the noise through
``givencov`` (a scalar in the port, its matrix in the JAX package).
The port's point blocks come from kernel C's plain
version ('tiled', the route of kernel C at p = 10 on the card) and from
the broadcast core ('broadcast'); the JAX package's from its own
default route.

Tolerances: the same float64 algorithms with sums in another order.
A Gram entry is a sum of 10 squares (the JAX Pallas kernel expands
‖x‖² + ‖y‖² − 2 x·y) and one exp: 1e-12 relative and absolute.  The
n = 200 model's K has a condition number below 1e4 (checked), so the
marginal likelihood agrees to 1e-9 relative, its gradient to 1e-8 and
the posterior mean to 1e-9 (atol 1e-11), as in
``tests/test_torch_gp.py``; the gradient of ⟨G, K⟩ through kernel C's
backward at p = 10 to 1e-10, as in ``tests/test_torch_ops.py``.
"""

import numpy as np
import pytest
import torch
import jax
from jax import numpy as jnp

import lsqfitgp_tpu as ltpu
from lsqfitgp_tpu import ops as jops
import lsqfitgp_torch as lt
from lsqfitgp_torch import ops

pytestmark = pytest.mark.x64only

SEED = 20261016
N, NPRED, P = 200, 16, 10


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


def friedman1(X):
    return (10 * np.sin(np.pi * X[:, 0] * X[:, 1])
            + 20 * (X[:, 2] - 0.5) ** 2 + 10 * X[:, 3] + 5 * X[:, 4])


@pytest.fixture(scope='module')
def data():
    """(x, y, xs, noise): the training points and the held-out ones as
    structured arrays with one (P,)-tailed field, the standardized
    response and its noise variance."""
    rng = np.random.default_rng(SEED)
    X = rng.uniform(0, 1, (N + NPRED, P))
    y = friedman1(X[:N]) + rng.standard_normal(N)
    sd = y.std(ddof=1)
    pts = np.empty(N + NPRED, dtype=[('x', float, (P,))])
    pts['x'] = X
    return pts[:N], (y - y.mean()) / sd, pts[N:], 1 / sd ** 2


def _gp(mod, hp, x, xs, **kw):
    gp = mod.GP(hp['amp'] * mod.ExpQuad(scale=hp['scale']), **kw)
    return gp.addx(x, 'y').addx(xs, 'pred')


@pytest.mark.parametrize('gram', ['tiled', 'broadcast'])
def test_prior_gram(data, gram):
    """The prior covariance of the training and held-out points: p = 10
    coordinates from one structured field."""
    x, _, xs, _ = data
    hp = {'amp': 1.3, 'scale': 0.8}
    Kj = np.asarray(_gp(ltpu, hp, x, xs).prior(['y', 'pred'], raw=True)
                    ['y', 'pred'])
    Kt = _gp(lt, hp, x, xs, gram=gram).prior(['y', 'pred'], raw=True)[
        'y', 'pred']
    assert Kt.shape == (N, NPRED)
    np.testing.assert_allclose(Kt.numpy(), Kj, rtol=1e-12, atol=1e-12)
    K = _gp(lt, hp, x, xs, gram=gram).prior('y', raw=True).numpy()
    np.testing.assert_allclose(
        K, np.asarray(_gp(ltpu, hp, x, xs).prior('y', raw=True)),
        rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize('gram', ['tiled', 'broadcast'])
def test_likelihood_gradient_and_mean(data, gram):
    """The marginal likelihood with ``givencov`` and its gradient in
    (log scale, log amp), torch autograd through chol_nll's rule and
    kernel C's backward at p = 10 against jax.value_and_grad, and
    predfromdata's mean at the held-out points."""
    x, y, xs, noise = data
    p0 = np.array([0.1, 0.3])

    def fj(p):
        hp = {'scale': jnp.exp(p[0]), 'amp': jnp.exp(p[1])}
        return _gp(ltpu, hp, x, xs).marginal_likelihood({'y': y},
                                                        noise * np.eye(N))

    vj, gj = jax.value_and_grad(fj)(jnp.asarray(p0))
    p = torch.as_tensor(p0).requires_grad_()
    gp = _gp(lt, {'scale': p[0].exp(), 'amp': p[1].exp()}, x, xs,
             gram=gram)
    K = gp.prior('y', raw=True).detach().numpy() + noise * np.eye(N)
    assert np.linalg.cond(K) < 1e4
    v = gp.marginal_likelihood({'y': y}, noise)
    v.backward()
    np.testing.assert_allclose(float(v.detach()), float(vj), rtol=1e-9)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(gj), rtol=1e-8)

    hp = {'scale': float(np.exp(p0[0])), 'amp': float(np.exp(p0[1]))}
    mj = _gp(ltpu, hp, x, xs).predfromdata({'y': y}, 'pred',
                                           noise * np.eye(N)).mean
    mt = _gp(lt, hp, x, xs, gram=gram).predfromdata({'y': y}, 'pred',
                                                   noise).mean
    assert mt.shape == (NPRED,)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), rtol=1e-9,
                               atol=1e-11)


def test_gram_p10(data):
    """Kernel C's plain version at p = 10 (the points' coordinates as an
    (n, 10) matrix) against the JAX package's Pallas kernel in interpret
    mode: the Gram, and the gradient of ⟨G, K⟩ in the points, the amp
    and the nugget through the fused backward's plain version against
    jax.grad through the JAX rule."""
    x, _, xs, _ = data
    X, Y = x['x'][:120], xs['x']
    G = np.random.default_rng(SEED).standard_normal((len(X), len(Y)))
    amp, noise = 1.3, 0.2

    def jfun(X, Y, amp, noise):
        K = jops.gram(lambda r2, a: a * jnp.exp(-0.5 * r2), X, Y,
                      params=(amp,), noise=noise, tile=128, interpret=True)
        return jnp.sum(K * G), K

    (_, Kj), ref = jax.value_and_grad(jfun, argnums=(0, 1, 2, 3),
                                      has_aux=True)(
        jnp.asarray(X), jnp.asarray(Y), amp, noise)
    leaves = [torch.as_tensor(v).requires_grad_() for v in (X, Y, amp, noise)]
    K = ops.gram('expquad', leaves[0], leaves[1],
                 post=(('mul', leaves[2]),), noise=leaves[3])
    np.testing.assert_allclose(K.detach().numpy(), np.asarray(Kj),
                               rtol=1e-12, atol=1e-12)
    (K * torch.as_tensor(G)).sum().backward()
    for r, leaf in zip(ref, leaves):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(r),
                                   rtol=1e-10, atol=1e-10)
