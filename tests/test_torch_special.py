"""The rest of ``special``: the inverse incomplete gamma and beta
functions, the regularized incomplete beta under them, ``taylor`` and
``expm1x``, on the CPU, against the JAX package on the same inputs
(made from a seed with numpy), in float64; and the package's exports.

- ``gammaincinv``, ``gammainccinv``: values, and gradients in a and y
  (the implicit-function rule, ∂P/∂a from the port's own series and
  continued fraction), across shapes a from 0.3 to 30 and both tails (p
  and q from 1e-10 to 1 − 1e-9), against the JAX functions and
  ``jax.grad``; forward mode along y;
- ``betaincinv``: values and its y-gradient in both tails, against the
  JAX function and ``scipy.special``; the port's incomplete beta
  against ``jax.scipy.special.betainc``;
- ``taylor`` (the exponential series at derivative orders 0 to 2) and
  ``expm1x`` on both sides of |x| = 1: values and first and second
  derivatives against ``jax.grad``.

Tolerances: the same rootfinds to convergence, 1e-12 relative for the
inverses (1e-10 where the tails' bracket ends the bisection at a
different last bit) and 1e-10 for their gradients; ``betaincinv``'s
gradient 1e-8 against scipy's (near x = 1, 1 − x carries x's 1e-12
error ~1e3 times larger, times b − 1) and 1e-6 against the JAX
package's, whose ``betaln`` errs by 4.7e-7 at (0.7, 9); the
incomplete beta 1e-13 absolute.
"""

import numpy as np
import pytest
import scipy.special as sps
import torch
import torch.autograd.forward_ad as fwAD
import jax
from jax import numpy as jnp

from lsqfitgp_tpu import special as jspecial
import lsqfitgp_tpu
import lsqfitgp_torch as lt
from lsqfitgp_torch import special
from lsqfitgp_torch.special import _invinc

pytestmark = pytest.mark.x64only

SEED = 20261024


@pytest.fixture(autouse=True)
def torch_f64():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    torch.set_num_threads(2)
    yield
    torch.set_default_dtype(old)


def close(a, b, rtol=1e-12, atol=0.0):
    a, b = (v.detach().numpy() if isinstance(v, torch.Tensor)
            else np.asarray(v) for v in (a, b))
    np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


def test_exports():
    """``special`` exports what the JAX package's does, the top level
    the Zeta family and AR/MA, ``linalg`` toeplitz and seqalg."""
    assert set(special.__all__) >= {
        n for n in dir(jspecial) if not n.startswith('_')
        and callable(getattr(jspecial, n))}
    for name in ('Zeta', 'ZetaFourier', 'CrossZetaFourier', 'AR', 'MA'):
        assert getattr(lt, name) is getattr(lt.kernels, name)
        assert name in lt.__all__
        assert hasattr(lsqfitgp_tpu, name)
    assert lt.linalg.toeplitz.solve and lt.linalg.seqalg.sequential_algorithm


# the shapes and levels: both tails and the middle, a few shapes each
A = np.array([0.3, 0.3, 1.0, 2.5, 2.5, 7.0, 7.0, 30.0, 30.0, 0.8])
Y = np.array([1e-10, 0.6, 0.2, 1e-6, 0.5, 0.9, 1 - 1e-9, 0.01, 0.999, 0.6])


@pytest.mark.parametrize('name', ['gammaincinv', 'gammainccinv'])
def test_gammaincinv(name):
    ft, fj = getattr(special, name), getattr(jspecial, name)
    a = torch.tensor(A, requires_grad=True)
    y = torch.tensor(Y, requires_grad=True)
    x = ft(a, y)
    close(x, fj(jnp.asarray(A), jnp.asarray(Y)), rtol=1e-10)
    ga, gy = torch.autograd.grad(x.sum(), [a, y])
    close(ga, jax.vmap(jax.grad(fj, 0))(jnp.asarray(A), jnp.asarray(Y)),
          rtol=1e-10)
    close(gy, jax.vmap(jax.grad(fj, 1))(jnp.asarray(A), jnp.asarray(Y)),
          rtol=1e-10)
    # forward mode along y and a together
    da, dy = np.linspace(-1, 1, A.size), np.linspace(0.5, -0.3, A.size)
    with fwAD.dual_level():
        xd = ft(fwAD.make_dual(torch.tensor(A), torch.tensor(da)),
                fwAD.make_dual(torch.tensor(Y), torch.tensor(dy)))
        tangent = fwAD.unpack_dual(xd).tangent
    close(tangent, ga.numpy() * da + gy.numpy() * dy, rtol=1e-12)


def test_dgammainc_da():
    """∂P/∂a on both branches (the series below x = a + 1, the
    continued fraction above) against the JAX package's gradient of
    ``gammainc``."""
    rng = np.random.default_rng(SEED)
    a = rng.uniform(0.2, 40, 40)
    x = a * np.exp(rng.uniform(-3, 1.5, 40))
    got = _invinc._dgammainc_da(torch.tensor(a), torch.tensor(x))
    want = jax.vmap(jax.grad(jax.scipy.special.gammainc, 0))(
        jnp.asarray(a), jnp.asarray(x))
    close(got, want, rtol=1e-9, atol=1e-300)


def test_betainc():
    rng = np.random.default_rng(SEED + 1)
    a, b = rng.uniform(0.3, 40, 30), rng.uniform(0.3, 40, 30)
    x = rng.uniform(0, 1, 30)
    close(_invinc._betainc(torch.tensor(a), torch.tensor(b), torch.tensor(x)),
          jax.scipy.special.betainc(a, b, x), rtol=0, atol=1e-13)


def test_betaincinv():
    a = np.array([0.5, 2.0, 5.0, 30.0, 0.7, 3.0])
    b = np.array([0.5, 3.0, 1.5, 40.0, 9.0, 3.0])
    y = np.array([1e-8, 0.3, 0.5, 0.9, 0.2, 1 - 1e-8])
    yt = torch.tensor(y, requires_grad=True)
    x = special.betaincinv(a, b, yt)
    close(x, jspecial.betaincinv(jnp.asarray(a), jnp.asarray(b),
                                 jnp.asarray(y)), rtol=1e-12)
    close(x, sps.betaincinv(a, b, y), rtol=1e-10)
    g, = torch.autograd.grad(x.sum(), yt)
    xs = sps.betaincinv(a, b, y)
    pdf = np.exp((a - 1) * np.log(xs) + (b - 1) * np.log1p(-xs)
                 - sps.betaln(a, b))
    close(g, 1 / pdf, rtol=1e-8)
    close(g, jax.vmap(jax.grad(jspecial.betaincinv, 2))(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(y)), rtol=1e-6)


def _exp_coefs(start, end, scale):
    """The exponential series' coefficients scale^k / k!."""
    k = np.arange(start, end)
    return scale ** k / np.exp(sps.gammaln(k + 1.0))


def _exp_coefs_j(start, end, scale):
    k = jnp.arange(start, end)
    return scale ** k / jnp.exp(jax.scipy.special.gammaln(k + 1.0))


def test_taylor():
    """The exponential series e^{sx} by 25 terms: the n-th derivative's
    series, and autograd's first and second derivatives (each the
    series one order up), against the JAX package and s^n e^{sx}."""
    x = np.linspace(-1.5, 1.5, 13)
    s = 0.7
    xt = torch.tensor(x, requires_grad=True)
    v = special.taylor(_exp_coefs, (s,), 0, 25, xt)
    fj = lambda u: jspecial.taylor(_exp_coefs_j, (s,), 0, 25, u)
    close(v, jax.vmap(fj)(jnp.asarray(x)), rtol=1e-13)
    close(v, np.exp(s * x), rtol=1e-13)
    for order in (1, 2):
        v, = torch.autograd.grad(v.sum(), xt, create_graph=True)
        fj = jax.grad(fj)
        close(v, jax.vmap(fj)(jnp.asarray(x)), rtol=1e-12)
        close(v, s ** order * np.exp(s * x), rtol=1e-11)
        close(special.taylor(_exp_coefs, (s,), order, 25, xt), v,
              rtol=1e-13)


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
def test_expm1x(dtype):
    """Values on both sides of |x| = 1 and the derivatives by the JAX
    rule, d/dx = expm1(x) (then e^x), against ``jax.grad``; float32
    against the float64 value within 4 eps32 relative."""
    x = np.concatenate([np.linspace(-3, 3, 25), [-1 - 1e-12, -1, 1 - 1e-12,
                                                  1, 1e-9, 0.0]])
    xt = torch.tensor(x, dtype=dtype, requires_grad=True)
    v = special.expm1x(xt)
    assert v.dtype == dtype
    fj = jspecial.expm1x
    if dtype == torch.float32:
        ref = np.asarray(fj(jnp.asarray(x.astype(np.float32), jnp.float64)))
        close(v.double(), ref, rtol=4 * np.finfo(np.float32).eps, atol=1e-37)
        return
    close(v, fj(jnp.asarray(x)), rtol=1e-15, atol=1e-300)
    for order in (1, 2):
        v, = torch.autograd.grad(v.sum(), xt, create_graph=True)
        fj = jax.grad(fj)
        close(v, jax.vmap(fj)(jnp.asarray(x)), rtol=1e-15, atol=1e-300)
    close(v, np.exp(x), rtol=1e-15)
