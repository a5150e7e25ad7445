"""lsqfitgp_torch.GP on the CPU against lsqfitgp_tpu.GP on the same
model and data (made from a seed with numpy), in float64: the README's
``amp * ExpQuad(scale)`` + explicit noise + ``addlintransf`` model at
n = 200, with point blocks from kernel C's plain version ('tiled') and
from the broadcast core ('broadcast').

Tolerances: identical float64 algorithms with sums in another order;
the n = 200 Gram has cond ~ 1e3, so 1e-9 relative leaves a wide
margin."""

import numpy as np
import pytest
import torch
import jax
from jax import numpy as jnp

import lsqfitgp_tpu as ltpu
import lsqfitgp_torch as lt

pytestmark = pytest.mark.x64only

N = 200


@pytest.fixture(autouse=True)
def torch_f64():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    torch.set_num_threads(2)
    yield
    torch.set_default_dtype(old)


@pytest.fixture
def data(rng):
    x = rng.uniform(-5, 5, N)
    y = np.sin(x) + 0.3 * rng.standard_normal(N)
    return x, y, np.linspace(-6, 6, 9)


def _model(mod, hp, gram, x, xs):
    gp = mod.GP(hp['amp'] * mod.ExpQuad(scale=hp['scale']), gram=gram)
    gp = gp.addx(x, 'f').addcov(0.09 * np.eye(len(x)), 'e')
    gp = gp.addlintransf(lambda f, e: f + e, ['f', 'e'], 'y')
    return gp.addx(xs, 'pred')


@pytest.mark.parametrize('gram', ['tiled', 'broadcast'])
def test_prior_pred_likelihood(data, gram):
    x, y, xs = data
    hp = {'amp': 1.3, 'scale': 0.8}
    gj = _model(ltpu, hp, gram, x, xs)
    gt = _model(lt, hp, gram, x, xs)
    np.testing.assert_allclose(gt.prior('pred', raw=True).numpy(),
                               np.asarray(gj.prior('pred', raw=True)),
                               rtol=1e-12, atol=1e-14)
    pj = gj.prior(['pred', 'y'])
    pt = gt.prior(['pred', 'y'])
    np.testing.assert_allclose(pt['y'].sdev.numpy(),
                               np.asarray(pj['y'].sdev), rtol=1e-9)
    np.testing.assert_allclose(
        float(gt.marginal_likelihood({'y': y})),
        float(gj.marginal_likelihood({'y': y})), rtol=1e-9)
    uj = gj.predfromdata({'y': y}, 'pred')
    ut = gt.predfromdata({'y': y}, 'pred')
    np.testing.assert_allclose(ut.mean.numpy(), np.asarray(uj.mean),
                               rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(ut.cov().numpy(), np.asarray(uj.cov()),
                               rtol=1e-8, atol=1e-11)
    mj, cj = gj.predfromdata({'y': y}, ['pred'], raw=True)
    mt, ct = gt.predfromdata({'y': y}, ['pred'], raw=True)
    np.testing.assert_allclose(mt['pred'].numpy(), np.asarray(mj['pred']),
                               rtol=1e-9, atol=1e-11)


@pytest.mark.parametrize('gram', ['tiled', 'broadcast'])
def test_hyperparameter_gradient(data, gram):
    """d(log marginal likelihood)/d(log amp, log scale): torch autograd
    through chol_nll's rule and kernel C's backward, against jax.grad."""
    x, y, xs = data
    p0 = np.array([0.2, -0.1])

    def fj(p):
        hp = {'amp': jnp.exp(p[0]), 'scale': jnp.exp(p[1])}
        return _model(ltpu, hp, gram, x, xs).marginal_likelihood({'y': y})

    vj, gj = jax.value_and_grad(fj)(jnp.asarray(p0))
    p = torch.as_tensor(p0).requires_grad_()
    hp = {'amp': p[0].exp(), 'scale': p[1].exp()}
    v = _model(lt, hp, gram, x, xs).marginal_likelihood({'y': y})
    v.backward()
    np.testing.assert_allclose(float(v.detach()), float(vj), rtol=1e-9)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(gj), rtol=1e-8)


def test_tiled_uses_kernel_path(data, monkeypatch):
    """gram='tiled' assembles the point blocks through ops.gram;
    'auto' keeps the broadcast path, as the JAX package does off TPU."""
    x, y, xs = data
    calls = []
    orig = lt.ops.gram
    monkeypatch.setattr(lt.ops, 'gram',
                        lambda *a, **k: calls.append(a[0]) or orig(*a, **k))
    hp = {'amp': 1.3, 'scale': 0.8}
    _model(lt, hp, 'auto', x, xs).prior('y', raw=True)
    assert calls == []
    _model(lt, hp, 'tiled', x, xs).prior('y', raw=True)
    assert calls == ['expquad']


def test_posdef_check(data):
    x, _, _ = data
    gp = lt.GP(lt.ExpQuad()).addx(x, 'f')
    bad = lt.GP(lt.ExpQuad()).addcov(-np.eye(3), 'c')
    gp.prior('f', raw=True)
    with pytest.raises(ValueError, match='not positive definite'):
        bad.prior('c', raw=True)
    with lt.disable_checks():
        bad.prior('c', raw=True)


def test_pred_uarray_data(data):
    """Data given as correlated Gaussians (UArray): the joint
    representation keeps the posterior correlated with the data."""
    x, y, xs = data
    hp = {'amp': 1.3, 'scale': 0.8}
    cov = 0.01 * np.eye(N)
    uj = _model(ltpu, hp, 'tiled', x, xs).predfromdata(
        {'y': ltpu.uncert.from_cov(y, cov)}, 'pred')
    ut = _model(lt, hp, 'tiled', x, xs).predfromdata(
        {'y': lt.uncert.from_cov(y, cov)}, 'pred')
    np.testing.assert_allclose(ut.mean.numpy(), np.asarray(uj.mean),
                               rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(ut.cov().numpy(), np.asarray(uj.cov()),
                               rtol=1e-8, atol=1e-11)


def test_objective_leaves_no_cycles(rng):
    """One value+gradient of the fit objective frees its n × n blocks by
    reference counting alone: nothing waits in a reference cycle for
    the garbage collector (at n in the tens of thousands each such
    block is gigabytes on the card).  n = 1100 takes the blocked
    factorization and trtri_blocked."""
    import gc
    n = 1100
    x = torch.as_tensor(rng.uniform(-20, 20, n))
    y = torch.sin(x)
    noise = 0.09 * torch.eye(n)

    def value_grad():
        p = torch.tensor([0.2, -0.1], requires_grad=True)
        with lt.disable_checks():
            gp = lt.GP(p[0].exp() * lt.ExpQuad(scale=p[1].exp()),
                       gram='tiled').addx(x, 'f').addcov(noise, 'e')
            gp = gp.addlintransf(lambda f, e: f + e, ['f', 'e'], 'y')
            v = -gp.marginal_likelihood({'y': y})
        torch.autograd.grad(v, p)

    gc.collect()
    gc.disable()
    try:
        value_grad()
        left = [tuple(o.shape) for o in gc.get_objects()
                if isinstance(o, torch.Tensor) and o.numel() >= n * n
                and o is not noise]
    finally:
        gc.enable()
    assert left == []
