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


@pytest.mark.parametrize('form', ['scalar', 'vector'])
def test_dense_givencov_forms(data, form):
    """The dense solver takes ``givencov`` as a scalar (σ² I) or a
    length-n vector (diag(v)), as the streaming solver does: the NLL, its
    gradient and the posteriors equal those with the explicit matrix, and
    agree with the JAX package's dense GP given that matrix (but for
    ``predfromfit``, whose noise-free prior Gram is singular here)."""
    x, y, xs = data
    v = 0.09 if form == 'scalar' else np.linspace(0.05, 0.15, N)
    M = np.diag(np.broadcast_to(v, (N,)))
    p0 = np.array([0.2, -0.1])

    def port(cov):
        p = torch.as_tensor(p0).requires_grad_()
        gp = lt.GP(p[0].exp() * lt.ExpQuad(scale=p[1].exp()), gram='tiled')
        gp = gp.addx(x, 'f').addx(xs, 'pred')
        ml = gp.marginal_likelihood({'f': y}, cov)
        g, = torch.autograd.grad(ml, p)
        with torch.no_grad():
            u = gp.predfromdata({'f': y}, 'pred', cov)
            fit = gp.predfromfit({'f': y}, 'pred', cov)
        return [float(ml.detach()), g.numpy(), u.mean.numpy(),
                u.cov().numpy(), fit.cov().numpy()]

    def jax_dense(p):
        gp = ltpu.GP(jnp.exp(p[0]) * ltpu.ExpQuad(scale=jnp.exp(p[1])),
                     gram='tiled')
        return gp.addx(x, 'f').addx(xs, 'pred')

    short, full = port(v), port(M)
    for a, b in zip(short, full):
        np.testing.assert_allclose(a, b, rtol=1e-14, atol=1e-15)
    vj, gj = jax.value_and_grad(
        lambda p: jax_dense(p).marginal_likelihood({'f': y}, M))(
        jnp.asarray(p0))
    gpj = jax_dense(jnp.asarray(p0))
    uj = gpj.predfromdata({'f': y}, 'pred', M)
    np.testing.assert_allclose(short[0], float(vj), rtol=1e-9)
    np.testing.assert_allclose(short[1], np.asarray(gj), rtol=1e-8)
    np.testing.assert_allclose(short[2], np.asarray(uj.mean), rtol=1e-9,
                               atol=1e-11)
    np.testing.assert_allclose(short[3], np.asarray(uj.cov()), rtol=1e-8,
                               atol=1e-11)


@pytest.mark.parametrize('solver', ['chol', 'chol-stream'])
def test_objective_leaves_no_cycles(rng, solver):
    """One value+gradient of the fit objective frees its large blocks by
    reference counting alone: nothing waits in a reference cycle for
    the garbage collector (at n in the tens of thousands each such
    block is gigabytes on the card).  n = 1100 takes the blocked
    factorization and trtri_blocked on the dense solver; the streaming
    solver's largest blocks are its factor tree's panels and Schur
    complements, so there the bound is a quarter of n²."""
    import gc
    n = 1100
    x = torch.as_tensor(rng.uniform(-20, 20, n))
    y = torch.sin(x)
    noise = 0.09 * torch.eye(n)

    def value_grad():
        p = torch.tensor([0.2, -0.1], requires_grad=True)
        with lt.disable_checks():
            k = p[0].exp() * lt.ExpQuad(scale=p[1].exp())
            if solver == 'chol':
                gp = lt.GP(k, gram='tiled').addx(x, 'f').addcov(noise, 'e')
                gp = gp.addlintransf(lambda f, e: f + e, ['f', 'e'], 'y')
                v = -gp.marginal_likelihood({'y': y})
            else:
                gp = lt.GP(k + 0.09 * lt.White(), solver=solver, block=128)
                v = -gp.addx(x, 'y').marginal_likelihood({'y': y})
        torch.autograd.grad(v, p)

    size = n * n if solver == 'chol' else n * n // 4
    gc.collect()
    gc.disable()
    try:
        value_grad()
        left = [tuple(o.shape) for o in gc.get_objects()
                if isinstance(o, torch.Tensor) and o.numel() >= size
                and o is not noise]
    finally:
        gc.enable()
    assert left == []


def test_objective_forward_keeps_no_intermediates(rng, monkeypatch):
    """At the dense objective's memory peak in its forward pass (the
    dense factor just assembled from its tree), the only n × n tensors
    alive are the caller's noise matrix, K_yy, the factor and what the
    backward saves: the assembly's K_ff, `addlintransf` columns and zero
    blocks are gone (zero blocks are never materialized), and none of
    them entered the GP's cache."""
    import gc
    n = 1100
    x = torch.as_tensor(rng.uniform(-20, 20, n))
    y = torch.sin(x)
    noise = 0.09 * torch.eye(n)
    itemsize = noise.element_size()

    def big_storages(objs):
        return {o.untyped_storage().data_ptr() for o in objs
                if isinstance(o, torch.Tensor)
                and o.untyped_storage().nbytes() >= n * n * itemsize}

    seen = []
    orig = lt.linalg._blocked._tree_assemble

    def spy(tree, m):
        L = orig(tree, m)
        seen.append(big_storages(gc.get_objects()))
        return L

    monkeypatch.setattr(lt.linalg._blocked, '_tree_assemble', spy)
    saved = []

    def pack(t):
        saved.append(t)
        return t

    p = torch.tensor([0.2, -0.1], requires_grad=True)
    with lt.disable_checks(), \
            torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        k = p[0].exp() * lt.ExpQuad(scale=p[1].exp())
        gp = lt.GP(k, gram='tiled').addx(x, 'f').addcov(noise, 'e')
        gp = gp.addlintransf(lambda f, e: f + e, ['f', 'e'], 'y')
        v = -gp.marginal_likelihood({'y': y})
    live, = seen
    others = live - big_storages([noise]) - big_storages(saved)
    # K_yy and the factor
    assert len(others) == 2
    assert big_storages(gp._covblock_cache.values()) == \
        big_storages([noise])
    torch.autograd.grad(v, p)
