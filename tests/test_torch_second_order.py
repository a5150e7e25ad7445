"""lsqfitgp_torch's forward-mode and second-order derivatives on the CPU
(the kernels' plain versions) against the JAX package on the same
inputs, made from a seed with numpy, in float64: the tangent Gram (C′,
E′) against ``jax.jvp`` of the JAX gram (Pallas in interpret mode), the
tangent of its backward (C″, E″) against ``jax.jvp(jax.grad(<G, K>))``
of the JAX package's plain Gram (its Pallas JVP rule cannot be
differentiated twice in interpret mode), `gradgradcheck` of the
autograd Functions, `chol_nll`'s tangent and Hessian against
``jax.jvp`` and ``jax.jacfwd(jax.grad(chol_nll))``, and `Chol.fisher`
and `Chol.fishvec_cotangent` on the inputs of the JAX package's own
tests.

Tolerances: both sides compute the same float64 expressions in another
order, rtol 1e-8 (atol 1e-10 times the entries' scale) for kernels and
matrices; `gradgradcheck` at its float64 defaults."""

import numpy as np
import pytest
import torch
import jax
from jax import numpy as jnp
from torch.autograd import gradgradcheck

import lsqfitgp_tpu as ltpu
from lsqfitgp_tpu import ops as jops
import lsqfitgp_torch as lt
from lsqfitgp_torch import linalg, ops

pytestmark = pytest.mark.x64only

CLOSE = dict(rtol=1e-8, atol=1e-10)


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


PARAMS, DPARAMS = (1.3, 0.4, 0.7), (0.2, -0.5, 0.3)
NOISE, DNOISE = 0.2, 0.7
POST = (('mul', PARAMS[0]), ('add', PARAMS[1]), ('mul', PARAMS[2]))


def _jchain(r2, a, c, b):
    """The JAX side of the post chain (('mul', a), ('add', c), ('mul', b))
    on the ExpQuad core."""
    return (a * jnp.exp(-0.5 * r2) + c) * b


def _jplain(x, y, params, noise):
    """The JAX package's Gram by broadcasting (its plain route)."""
    r2 = jnp.sum((x[:, None, :] - y[None, :, :]) ** 2, -1)
    return _jchain(r2, *params) + noise * jnp.eye(*r2.shape)


def _inputs(p, given_y, coincident):
    rng = np.random.default_rng(100 + 10 * p + given_y)
    x = rng.standard_normal((60, p)) * 2
    if coincident:
        x[7] = x[3]   # the weights are zero at r² = 0
    y = rng.standard_normal((40, p)) * 2 if given_y else None
    dx = rng.standard_normal(x.shape)
    dy = rng.standard_normal(y.shape) if given_y else None
    G = rng.standard_normal((60, 40 if given_y else 60))
    return x, y, dx, dy, G


def _t(a):
    return None if a is None else torch.as_tensor(a)


def _jtuple(v):
    return tuple(map(jnp.asarray, v))


@pytest.mark.parametrize('given_y', [True, False])
@pytest.mark.parametrize('p', [1, 3])
def test_gram_jvp(p, given_y):
    """C′ (and E′ for y = x) against jax.jvp of the JAX gram through its
    custom_jvp rule (Pallas in interpret mode): the points', the chain's
    and the nugget's tangents, coincident points included."""
    x, y, dx, dy, _ = _inputs(p, given_y, True)
    if given_y:
        _, ref = jax.jvp(
            lambda x, y, pr, nz: jops.gram(_jchain, x, y, params=pr,
                                           noise=nz, tile=128,
                                           interpret=True),
            (jnp.asarray(x), jnp.asarray(y), _jtuple(PARAMS),
             jnp.asarray(NOISE)),
            (jnp.asarray(dx), jnp.asarray(dy), _jtuple(DPARAMS),
             jnp.asarray(DNOISE)))
    else:
        _, ref = jax.jvp(
            lambda x, pr, nz: jops.gram(_jchain, x, None, params=pr,
                                        noise=nz, tile=128, interpret=True),
            (jnp.asarray(x), _jtuple(PARAMS), jnp.asarray(NOISE)),
            (jnp.asarray(dx), _jtuple(DPARAMS), jnp.asarray(DNOISE)))
    kw = dict(post=POST, noise=NOISE, dpost=DPARAMS, dnoise=DNOISE)
    got = ops.gram_jvp('expquad', _t(x), _t(y), _t(dx), _t(dy), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **CLOSE)
    np.testing.assert_allclose(
        ops.gram_jvp_plain('expquad', _t(x), _t(y), _t(dx), _t(dy),
                           **kw).numpy(), np.asarray(ref), **CLOSE)
    if not given_y:
        sym = ops.gram_sym_jvp('expquad', _t(x), _t(dx), **kw)
        np.testing.assert_allclose(sym.numpy(), np.asarray(ref), **CLOSE)


def _jax_backward_tangent(x, y, dx, dy, G):
    """jax.jvp of jax.grad(<G, K>) in (x, y, params, noise) through the
    JAX package's plain Gram, y = x when y is None."""
    Gj = jnp.asarray(G)
    if y is None:
        def grad(x, pr, nz):
            return jax.grad(lambda x, pr, nz: jnp.sum(
                _jplain(x, x, pr, nz) * Gj), argnums=(0, 1, 2))(x, pr, nz)
        _, (tx, tp, tn) = jax.jvp(
            grad, (jnp.asarray(x), _jtuple(PARAMS), jnp.asarray(NOISE)),
            (jnp.asarray(dx), _jtuple(DPARAMS), jnp.asarray(DNOISE)))
        ty = None
    else:
        def grad(x, y, pr, nz):
            return jax.grad(lambda x, y, pr, nz: jnp.sum(
                _jplain(x, y, pr, nz) * Gj), argnums=(0, 1, 2, 3))(
                    x, y, pr, nz)
        _, (tx, ty, tp, tn) = jax.jvp(
            grad, (jnp.asarray(x), jnp.asarray(y), _jtuple(PARAMS),
                   jnp.asarray(NOISE)),
            (jnp.asarray(dx), jnp.asarray(dy), _jtuple(DPARAMS),
             jnp.asarray(DNOISE)))
    return tx, ty, np.array([*map(float, tp), float(tn)])


@pytest.mark.parametrize('fn', ['plain', 'wrapper'])
@pytest.mark.parametrize('given_y', [True, False])
@pytest.mark.parametrize('p', [1, 3])
def test_gram_backward_jvp(p, given_y, fn):
    """C″ (and E″ for y = x) against jax.jvp(jax.grad(<G, gram>)): the
    tangents of the points' gradients and of the chain's and nugget's
    (the nugget's gradient, tr G, has a zero tangent)."""
    x, y, dx, dy, G = _inputs(p, given_y, False)
    tx, ty, tp = _jax_backward_tangent(x, y, dx, dy, G)
    kw = dict(post=POST, noise=NOISE, dpost=DPARAMS)
    f = ops.gram_backward_jvp if fn == 'wrapper' \
        else ops.gram_backward_jvp_plain
    gx, gy, gp = f(_t(G), 'expquad', _t(x), _t(y), _t(dx), _t(dy), **kw)
    np.testing.assert_allclose(gp.numpy(), tp, **CLOSE)
    if given_y:
        np.testing.assert_allclose(gx.numpy(), np.asarray(tx), **CLOSE)
        np.testing.assert_allclose(gy.numpy(), np.asarray(ty), **CLOSE)
        return
    # y = x: K's two arguments apart, whose tangents add
    np.testing.assert_allclose((gx + gy).numpy(), np.asarray(tx), **CLOSE)
    f = ops.gram_sym_backward_jvp if fn == 'wrapper' \
        else ops.gram_sym_backward_jvp_plain
    sx, sp = f(_t(G), 'expquad', _t(x), _t(dx), **kw)
    np.testing.assert_allclose(sx.numpy(), np.asarray(tx), **CLOSE)
    np.testing.assert_allclose(sp.numpy(), tp, **CLOSE)


def _leaves(gen, p):
    x = torch.as_tensor(gen.standard_normal((11, p)) * 2).requires_grad_()
    y = torch.as_tensor(gen.standard_normal((8, p)) * 2).requires_grad_()
    scalars = [torch.tensor(v, requires_grad=True) for v in (1.3, 0.4, 0.2)]
    return x, y, scalars


@pytest.mark.parametrize('p', [1, 2])
def test_gram_gradgradcheck(p):
    """Second derivatives of kernel C's autograd Function (C′ and C″ on
    CUDA, their plain versions here), y given and y = x, a chain with
    'mul' and 'add' steps and the nugget."""
    x, y, (a, c, nz) = _leaves(np.random.default_rng(7 + p), p)

    def f(x, y, a, c, nz):
        return ops.gram('expquad', x, y, post=(('mul', a), ('add', c),
                                               ('mul', a)), noise=nz)

    assert gradgradcheck(f, (x, y, a, c, nz))
    assert gradgradcheck(lambda x, a, c, nz: f(x, None, a, c, nz),
                         (x, a, c, nz))


@pytest.mark.parametrize('p', [1, 2])
def test_gram_sym_gradgradcheck(p):
    """Second derivatives of kernel E's autograd Function (E′ and E″)."""
    x, _, (a, c, nz) = _leaves(np.random.default_rng(17 + p), p)

    def f(x, a, c, nz):
        return ops.gram_sym('expquad', x, post=(('mul', a), ('add', c)),
                            noise=nz)

    assert gradgradcheck(f, (x, a, c, nz))


def test_gram_forward_ad():
    """Forward-mode AD through `gram` and `gram_sym` (their ``jvp``, C′
    and E′) against autograd's numerical check."""
    x, y, (a, c, nz) = _leaves(np.random.default_rng(3), 2)
    post = lambda a, c: (('mul', a), ('add', c))
    assert torch.autograd.gradcheck(
        lambda x, y, a, c, nz: ops.gram('expquad', x, y, post=post(a, c),
                                        noise=nz),
        (x, y, a, c, nz), check_forward_ad=True, check_backward_ad=False,
        check_undefined_grad=False)
    assert torch.autograd.gradcheck(
        lambda x, a, c, nz: ops.gram_sym('expquad', x, post=post(a, c),
                                         noise=nz),
        (x, a, c, nz), check_forward_ad=True, check_backward_ad=False,
        check_undefined_grad=False)


def test_gram_third_derivative_raises():
    """A third derivative is not implemented: asking for the second
    derivative's graph raises, never a graph that differentiates to
    zero."""
    x = torch.linspace(-1, 1, 9).requires_grad_()
    v = ops.gram('expquad', x).sum()
    g, = torch.autograd.grad(v, x, create_graph=True)
    torch.autograd.grad(g.sum(), x, retain_graph=True)
    with pytest.raises(RuntimeError, match='third derivative'):
        torch.autograd.grad(g.sum(), x, create_graph=True)


def _chol_inputs(n=30):
    rng = np.random.default_rng(4)
    A = rng.standard_normal((n, n))
    K0 = A @ A.T + n * np.eye(n)
    r0 = rng.standard_normal(n)
    dK = rng.standard_normal((n, n))
    return K0, r0, dK + dK.T, rng.standard_normal(n)


def test_chol_nll_jvp():
    """chol_nll's forward mode against jax.jvp of the JAX chol_nll (its
    custom_jvp rule)."""
    K0, r0, dK, dr = _chol_inputs()
    v, t = jax.jvp(ltpu.linalg.chol_nll, (jnp.asarray(K0), jnp.asarray(r0)),
                   (jnp.asarray(dK), jnp.asarray(dr)))
    import torch.autograd.forward_ad as fwAD
    with fwAD.dual_level():
        out = linalg.chol_nll(fwAD.make_dual(_t(K0), _t(dK)),
                              fwAD.make_dual(_t(r0), _t(dr)))
        pv, pt = fwAD.unpack_dual(out)
    np.testing.assert_allclose(float(pv), float(v), rtol=1e-12)
    np.testing.assert_allclose(float(pt), float(t), **CLOSE)


def test_chol_nll_hessian():
    """chol_nll's Hessian (inside linalg.second_order, the closed-form
    second derivative) against jax.jacfwd(jax.grad(chol_nll)), in (K, r)
    with K symmetrized."""
    K0, r0, _, _ = _chol_inputs(12)
    n = len(r0)

    def jflat(z):
        K = z[:n * n].reshape(n, n)
        return ltpu.linalg.chol_nll(0.5 * (K + K.T), z[n * n:])

    z0 = np.concatenate([K0.reshape(-1), r0])
    ref = np.asarray(jax.jacfwd(jax.grad(jflat))(jnp.asarray(z0)))
    z = _t(z0).requires_grad_()
    with linalg.second_order():
        K = z[:n * n].reshape(n, n)
        v = linalg.chol_nll(0.5 * (K + K.T), z[n * n:])
    g, = torch.autograd.grad(v, z, create_graph=True)
    H = torch.stack([torch.autograd.grad(g[k], z, retain_graph=True)[0]
                     for k in range(len(z0))])
    np.testing.assert_allclose(H.numpy(), ref, rtol=1e-8,
                               atol=1e-10 * np.abs(ref).max())


def test_chol_nll_gradgradcheck():
    """Second derivatives of _CholNLL (through _CholNLLGrad)."""
    K0, r0, _, _ = _chol_inputs(8)

    def f(K, r):
        with linalg.second_order():
            return linalg.chol_nll(0.5 * (K + K.T), r)

    assert gradgradcheck(f, (_t(K0).requires_grad_(),
                             _t(r0).requires_grad_()))


def test_chol_nll_second_order_needs_context():
    """Outside linalg.second_order, chol_nll does not keep K for a
    Hessian: a backward with create_graph raises, never returns a
    first derivative that differentiates to zero."""
    K0, r0, _, _ = _chol_inputs(8)
    K = _t(K0).requires_grad_()
    v = linalg.chol_nll(K, _t(r0))
    with pytest.raises(RuntimeError, match='second_order'):
        torch.autograd.grad(v, K, create_graph=True)


def _random_psd(rng, n):
    A = rng.standard_normal((n, n))
    return A @ A.T


def _jax_test_rng(name):
    """The generator the JAX package's tests/conftest.py gives its test
    ``name`` in tests/linalg/test_decomp.py (seeded from the node id), so
    that these tests take that test's inputs."""
    node = f'tests/linalg/test_decomp.py::{name}'.encode()
    return np.random.default_rng(np.concatenate(
        [[2026], np.frombuffer(node, dtype=np.uint8)]))


def test_chol_fisher():
    """Chol.fisher on the inputs of the JAX package's test_fisher
    (tests/linalg/test_decomp.py), against the JAX Chol.fisher and the
    explicit formula."""
    rng = _jax_test_rng('test_fisher')
    n, P = 6, 3
    K0 = _random_psd(rng, n) + 5 * np.eye(n)
    dK = np.stack([_random_psd(rng, n) for _ in range(P)])
    dr = rng.standard_normal((P, n))
    ref = np.asarray(ltpu.linalg.Chol(jnp.asarray(K0), epsrel=0).fisher(
        jnp.asarray(dK), jnp.asarray(dr)))
    got = linalg.Chol(_t(K0), epsrel=0).fisher(_t(dK), _t(dr))
    np.testing.assert_allclose(got.numpy(), ref, **CLOSE)
    Ki = np.linalg.inv(K0)
    want = np.array([[0.5 * np.trace(Ki @ dK[i] @ Ki @ dK[j])
                      + dr[i] @ Ki @ dr[j] for j in range(P)]
                     for i in range(P)])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-8)


def test_chol_fishvec_cotangent():
    """Chol.fishvec_cotangent on the inputs of the JAX package's
    test_fishvec_cotangent: the cotangents against the JAX ones, and
    pulled back through the vjp of p -> (K, r) equal to F v."""
    rng = _jax_test_rng('test_fishvec_cotangent')
    n, P = 8, 5
    K0 = _random_psd(rng, n) + 5 * np.eye(n)
    Vs = np.stack([_random_psd(rng, n) for _ in range(P)])
    W = rng.standard_normal((P, n))
    r0 = rng.standard_normal(n)
    p0 = 0.1 * rng.standard_normal(P)
    v = rng.standard_normal(P)
    K = K0 + np.einsum('i,iab->ab', p0, Vs)
    dKv, drv = np.einsum('i,iab->ab', v, Vs), v @ W
    CKj, crj = ltpu.linalg.Chol(jnp.asarray(K), epsrel=0).fishvec_cotangent(
        jnp.asarray(dKv), jnp.asarray(drv))
    d = linalg.Chol(_t(K), epsrel=0)
    CK, cr = d.fishvec_cotangent(_t(dKv), _t(drv))
    np.testing.assert_allclose(CK.numpy(), np.asarray(CKj), **CLOSE)
    np.testing.assert_allclose(cr.numpy(), np.asarray(crj), **CLOSE)
    Fv = np.einsum('iab,ab->i', Vs, CK.numpy()) + W @ cr.numpy()
    F = d.fisher(_t(Vs), _t(W)).numpy()
    np.testing.assert_allclose(Fv, F @ v, **CLOSE)


def test_solve_batched():
    rng = np.random.default_rng(13)
    L = np.tril(rng.standard_normal((6, 6))) + 6 * np.eye(6)
    B = rng.standard_normal((6, 4))
    Bp = rng.standard_normal((3, 6))
    B3 = rng.standard_normal((2, 6, 5))
    for b in (B, Bp, B3):
        ref = ltpu.linalg._decomp.solve_batched_triangular(jnp.asarray(L),
                                                           jnp.asarray(b))
        got = linalg.solve_batched_triangular(_t(L), _t(b))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **CLOSE)
    K = L @ L.T
    np.testing.assert_allclose(
        linalg.solve_batched(linalg.Chol(_t(K), epsrel=0), _t(B)).numpy(),
        np.linalg.solve(K, B), **CLOSE)
