"""lsqfitgp_torch.ops on the CPU (the kernels' plain versions) against
the JAX package's Pallas kernels run in interpret mode, on the same
inputs made from a seed with numpy, in float64.

Tolerances: both sides compute the same float64 sums in another order,
so entries agree to a few units of roundoff of their magnitude
(rtol 1e-11, atol 1e-11 times the entries' scale)."""

import functools

import numpy as np
import pytest
import torch
from jax import numpy as jnp
import jax

from lsqfitgp_tpu import ops as jops
import lsqfitgp_torch as lt
from lsqfitgp_torch import ops

pytestmark = pytest.mark.x64only


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


def _tiles(size, tile):
    nt = size // tile
    return np.tril(np.ones((nt, nt), bool)).repeat(tile, 0).repeat(tile, 1)


@pytest.mark.parametrize('with_b,with_s,with_eps,offset,nreal', [
    (True, True, True, 128, 400),
    (True, False, True, 0, None),
    (True, True, False, 128, None),
    (False, False, True, 0, 300),
])
def test_schur_update(rng, with_b, with_s, with_eps, offset, nreal):
    tile = 128
    size = 384
    mb = offset + size
    A = rng.standard_normal((size, 256))
    B = rng.standard_normal((mb, mb)) if with_b else None
    s = rng.uniform(0.5, 2.0, mb) if with_s else None
    eps = 0.25 if with_eps else None
    j = lambda a: None if a is None else jnp.asarray(a)
    t = lambda a: None if a is None else torch.as_tensor(a)
    ref = jops.schur_update(j(B), j(A), s=j(s), eps=eps, size=size,
                            offset=offset, tile=tile, kchunk=tile,
                            precision='highest', interpret='pallas',
                            nreal=nreal)
    got = ops.schur_update(t(B), t(A), s=t(s), eps=eps, size=size,
                           offset=offset, tile=tile, precision='highest',
                           nreal=nreal)
    keep = _tiles(size, tile)
    # only the i >= j tiles are defined; the plain version zeroes the rest
    np.testing.assert_allclose(got.numpy()[keep], np.asarray(ref)[keep],
                               rtol=1e-11, atol=1e-11 * 256)
    assert np.all(got.numpy()[~keep] == 0)


@pytest.mark.parametrize('n,inplace', [
    pytest.param(384, False, id='384'), pytest.param(300, False, id='300'),
    pytest.param(384, True, id='384-inplace'),
    pytest.param(300, True, id='300-inplace')])
def test_syrk_t_full(rng, n, inplace):
    """`syrk_t_full`, and `syrk_t_full_`, which leaves the result in
    W's own storage and returns W."""
    W = np.tril(rng.standard_normal((n, n)))
    ref = jops.syrk_t_full(jnp.asarray(W), tile=128, kchunk=128,
                           precision='highest', interpret='pallas')
    Wt = torch.tensor(W)
    got = (ops.syrk_t_full_ if inplace else ops.syrk_t_full)(Wt)
    assert (got is Wt) == inplace
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-11,
                               atol=1e-11 * n)
    assert torch.equal(got, got.T)


def _jprofile(r2, amp):
    return amp * jnp.exp(-0.5 * r2)


@pytest.mark.parametrize('p', [1, 3])
@pytest.mark.parametrize('noise', [None, 0.09])
def test_gram(rng, p, noise):
    x = rng.standard_normal((150, p)) * 3
    y = rng.standard_normal((70, p)) * 3
    amp = 1.3
    for yy in (None, y):
        ref = jops.gram(_jprofile, jnp.asarray(x),
                        None if yy is None else jnp.asarray(yy),
                        params=(amp,), noise=noise, tile=128,
                        interpret=True)
        got = ops.gram('expquad', torch.as_tensor(x),
                       None if yy is None else torch.as_tensor(yy),
                       post=(('mul', amp),), noise=noise)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                   rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize('p', [1, 3])
def test_gram_gradient(rng, p):
    """Gradient of <G, K> with respect to the points, the post-chain
    scalar and the nugget, against jax.grad through the JAX gram's
    custom_jvp rule."""
    x = rng.standard_normal((120, p)) * 2
    y = rng.standard_normal((60, p)) * 2
    G = rng.standard_normal((120, 60))
    amp, noise = 1.3, 0.2

    def jfun(x, y, amp, noise):
        K = jops.gram(_jprofile, x, y, params=(amp,), noise=noise,
                      tile=128, interpret=True)
        return jnp.sum(K * G)

    ref = jax.grad(jfun, argnums=(0, 1, 2, 3))(
        jnp.asarray(x), jnp.asarray(y), amp, noise)
    leaves = [torch.as_tensor(v).requires_grad_()
              for v in (x, y, amp, noise)]
    K = ops.gram('expquad', leaves[0], leaves[1],
                 post=(('mul', leaves[2]),), noise=leaves[3])
    (K * torch.as_tensor(G)).sum().backward()
    for r, leaf in zip(ref, leaves):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(r),
                                   rtol=1e-10, atol=1e-10)


def test_gram_post_chain_gradient(rng):
    """A chain mixing 'mul' and 'add' steps: the kernel path's backward
    against autograd through the plain version."""
    x = torch.as_tensor(rng.standard_normal(40)).requires_grad_()
    a = torch.tensor(1.3, requires_grad=True)
    c = torch.tensor(0.4, requires_grad=True)
    post = (('mul', a), ('add', c), ('mul', a))
    G = torch.as_tensor(rng.standard_normal((40, 40)))
    got = torch.autograd.grad((ops.gram('expquad', x, post=post) * G).sum(),
                              (x, a, c))
    ref = torch.autograd.grad(
        (ops.gram_plain('expquad', x, post=post) * G).sum(), (x, a, c))
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=1e-12, atol=1e-12)


def _jchain(r2, a, c, b):
    """The JAX side of the post chain (('mul', a), ('add', c), ('mul', b))
    on the ExpQuad core."""
    return (a * jnp.exp(-0.5 * r2) + c) * b


@functools.lru_cache(maxsize=None)
def _jax_gram_grads(p, given_y, noise):
    """Inputs made from a seed and jax.grad of <G, K> through the JAX
    gram's custom_jvp rule (Pallas in interpret mode) with respect to x,
    y (when given), the chain's scalars and the nugget (when given)."""
    rng = np.random.default_rng(10 * p + given_y)
    x = rng.standard_normal((90, p)) * 2
    x[7] = x[3]   # coincident points: the weight is zero at r² = 0
    y = rng.standard_normal((50, p)) * 2 if given_y else None
    G = rng.standard_normal((90, 50 if given_y else 90))
    params = (1.3, 0.4, 0.7)

    def jfun(x, y, params, noise):
        K = jops.gram(_jchain, x, y, params=params, noise=noise, tile=128,
                      interpret=True)
        return jnp.sum(K * G)

    argnums = (0, 2) + ((1,) if given_y else ()) + \
        ((3,) if noise is not None else ())
    grads = jax.grad(jfun, argnums=argnums)(
        jnp.asarray(x), None if y is None else jnp.asarray(y),
        tuple(map(jnp.asarray, params)), noise)
    ref = dict(zip(argnums, grads))
    return x, y, G, params, ref


@pytest.mark.parametrize('need_xy,need_p', [(True, True), (True, False),
                                            (False, True)])
@pytest.mark.parametrize('noise', [None, 0.2])
@pytest.mark.parametrize('given_y', [True, False])
@pytest.mark.parametrize('p', [1, 3])
def test_gram_backward_plain(p, given_y, noise, need_xy, need_p):
    """Kernel C's plain backward, `gram_backward_plain`, against jax.grad
    through the JAX gram: y given and y = x (the two arguments' gradients
    add), a chain mixing 'mul' and 'add' steps, with and without the
    nugget, and only some outputs asked for."""
    x, y, G, params, ref = _jax_gram_grads(p, given_y, noise)
    a, c, b = params
    gx, gy, gp = ops.gram_backward_plain(
        torch.as_tensor(G), 'expquad', torch.as_tensor(x),
        None if y is None else torch.as_tensor(y),
        post=(('mul', a), ('add', c), ('mul', b)), noise=noise,
        need_xy=need_xy, need_p=need_p)
    close = dict(rtol=1e-10, atol=1e-10)
    if need_xy:
        if given_y:
            np.testing.assert_allclose(gx.numpy(), np.asarray(ref[0]),
                                       **close)
            np.testing.assert_allclose(gy.numpy(), np.asarray(ref[1]),
                                       **close)
        else:
            np.testing.assert_allclose((gx + gy).numpy(),
                                       np.asarray(ref[0]), **close)
    else:
        assert gx is None and gy is None
    if need_p:
        np.testing.assert_allclose(gp[:3].numpy(),
                                   np.asarray(ref[2]), **close)
        np.testing.assert_allclose(
            float(gp[3]), 0.0 if noise is None else float(ref[3]), **close)
    else:
        assert gp is None


@pytest.mark.parametrize('wrt', ['x', 'post'])
def test_gram_gradient_some_inputs(wrt):
    """Autograd through `gram` with only the points or only the chain's
    scalars requiring grad (the backward computes only what autograd
    asks for) against jax.grad through the JAX gram."""
    x, y, G, params, ref = _jax_gram_grads(1, True, 0.2)
    xt = torch.as_tensor(x).requires_grad_(wrt == 'x')
    pt = [torch.tensor(v, requires_grad=wrt == 'post') for v in params]
    K = ops.gram('expquad', xt, torch.as_tensor(y),
                 post=(('mul', pt[0]), ('add', pt[1]), ('mul', pt[2])),
                 noise=0.2)
    leaves = [xt] if wrt == 'x' else pt
    got = torch.autograd.grad((K * torch.as_tensor(G)).sum(), leaves)
    want = ref[0] if wrt == 'x' else ref[2]
    np.testing.assert_allclose(
        got[0].numpy() if wrt == 'x' else torch.stack(got).numpy(),
        np.asarray(want), rtol=1e-10, atol=1e-10)
