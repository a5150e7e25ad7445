"""lsqfitgp_torch.linalg on the CPU against lsqfitgp_tpu.linalg on the
same inputs (made from a seed with numpy), in float64.

Tolerances: the blocked factorization runs the same algorithm in both
packages with the products summed in another order; on these
well-conditioned matrices (cond ~ 1e2) results agree to ~1e-12
relative, checked at rtol 1e-9."""

import numpy as np
import pytest
import torch
import jax
from jax import numpy as jnp

import lsqfitgp_tpu as ltpu
import lsqfitgp_torch as lt
from lsqfitgp_torch import linalg

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


def _problem(rng, n):
    x = np.sort(rng.uniform(0, 10, n))
    K = 1.7 * np.exp(-0.5 * (x[:, None] - x[None, :]) ** 2) \
        + 0.1 * np.eye(n)
    return K, rng.standard_normal(n)


@pytest.mark.parametrize('n', [300, 1100])
def test_chol_blocked(rng, n):
    K, r = _problem(rng, n)
    B = rng.standard_normal((n, 3))
    dj = ltpu.linalg.Chol(jnp.asarray(K), blocked=True, block=128)
    dt = linalg.Chol(torch.as_tensor(K), blocked=True, block=128)
    np.testing.assert_allclose(float(dt.logdet()), float(dj.logdet()),
                               rtol=1e-9)
    np.testing.assert_allclose(
        dt.ginv_linear(torch.as_tensor(B)).numpy(),
        np.asarray(dj.ginv_linear(jnp.asarray(B))), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(
        float(dt.minus_log_normal_density(torch.as_tensor(r))),
        float(dj.minus_log_normal_density(jnp.asarray(r))), rtol=1e-9)
    assert not dt._escalated


def test_chol_unblocked(rng):
    K, r = _problem(rng, 200)
    dj = ltpu.linalg.Chol(jnp.asarray(K))
    dt = linalg.Chol(torch.as_tensor(K))
    np.testing.assert_allclose(
        float(dt.minus_log_normal_density(torch.as_tensor(r))),
        float(dj.minus_log_normal_density(jnp.asarray(r))), rtol=1e-9)
    np.testing.assert_allclose(dt.matrix().numpy(), np.asarray(dj.matrix()),
                               rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize('n,kw', [(300, dict(blocked=True, block=128)),
                                  (200, {})])
def test_chol_nll_gradient(rng, n, kw):
    """Value and gradient with respect to K and r of the fused NLL
    against jax.grad of lsqfitgp_tpu.linalg.chol_nll (both the
    hand-derived rule, the blocked one through trtri + syrk)."""
    K, r = _problem(rng, n)
    val, (gK, gr) = jax.value_and_grad(
        lambda K, r: ltpu.linalg.chol_nll(K, r, **kw), argnums=(0, 1))(
            jnp.asarray(K), jnp.asarray(r))
    Kt = torch.as_tensor(K).requires_grad_()
    rt = torch.as_tensor(r).requires_grad_()
    v = linalg.chol_nll(Kt, rt, **kw)
    v.backward()
    np.testing.assert_allclose(float(v.detach()), float(val), rtol=1e-9)
    np.testing.assert_allclose(Kt.grad.numpy(), np.asarray(gK), rtol=1e-8,
                               atol=1e-9 * np.abs(np.asarray(gK)).max())
    np.testing.assert_allclose(rt.grad.numpy(), np.asarray(gr), rtol=1e-8,
                               atol=1e-10)


def test_chol_nll_float32_gradient(rng):
    """A float32 K through the blocked rule, whose carrier K⁻¹ is formed
    in float64 from the float32 factor, against the JAX package's
    float64 gradient.  The float32 factor's own error bounds the agreement:
    ~cond eps32 (cond ~ 1e2 here) relative to the largest entry, checked
    at 1e-4."""
    K, r = _problem(rng, 300)
    kw = dict(blocked=True, block=128)
    gK = np.asarray(jax.grad(lambda K: ltpu.linalg.chol_nll(
        K, jnp.asarray(r), **kw))(jnp.asarray(K)))
    Kt = torch.as_tensor(K, dtype=torch.float32).requires_grad_()
    linalg.chol_nll(Kt, torch.as_tensor(r, dtype=torch.float32),
                    **kw).backward()
    assert Kt.grad.dtype == torch.float32
    np.testing.assert_allclose(Kt.grad.numpy(), gK, rtol=0,
                               atol=1e-4 * np.abs(gK).max())


def test_chol_nll_backward_runs_once(rng):
    """The backward frees the factor it inverts in place: a second
    backward through the same graph raises instead of reading it."""
    K, r = _problem(rng, 300)
    Kt = torch.as_tensor(K).requires_grad_()
    v = linalg.chol_nll(Kt, torch.as_tensor(r), blocked=True, block=128)
    v.backward(retain_graph=True)
    with pytest.raises(RuntimeError, match='once per forward'):
        v.backward()


def test_singular_escalates_float32(rng):
    """A noiseless smooth Gram is singular at float32: the ladder
    refactors with the bound-scaled eps, as the JAX package's does.
    With the float32 rescue off (df=False) that is the result, and it
    warns; by default the rescue then tries float64 at the primary eps,
    and this Gram, rounded to float32, is indefinite even there, so the
    ladder's result stays and the warning says so."""
    x = np.linspace(0, 10, 1100)
    K = torch.as_tensor(np.exp(-0.5 * (x[:, None] - x[None, :]) ** 2),
                        dtype=torch.float32)
    y = torch.ones(1100, dtype=torch.float32)
    dt = linalg.Chol(K, df=False)
    assert dt._escalated
    assert bool(torch.isfinite(dt._L).all())
    with pytest.warns(UserWarning, match='numerically singular'):
        dt.logdet(), dt.minus_log_normal_density(y)
    dr = linalg.Chol(K)
    assert dr._escalated and dr._df_failed and float(dr.eps) == float(dt.eps)
    with pytest.warns(UserWarning, match='float64 rescue was attempted'):
        dr.minus_log_normal_density(y)


def test_trtri_and_solves(rng):
    K, _ = _problem(rng, 700)
    L, Dinv = linalg._blocked.chol_factor_scaled(
        torch.as_tensor(K), torch.ones(700), 0.0, block=128)
    Lref = torch.linalg.cholesky(torch.as_tensor(K))
    torch.testing.assert_close(L, Lref, rtol=1e-10, atol=1e-12)
    W = linalg._blocked.trtri_blocked(L.clone(), Dinv, 128)
    torch.testing.assert_close(W @ L, torch.eye(700), rtol=0, atol=1e-10)
    B = torch.as_tensor(rng.standard_normal((700, 2)))
    torch.testing.assert_close(
        linalg._blocked.solve_lower(L, B, block=128, Dinv=Dinv),
        torch.linalg.solve_triangular(L, B, upper=False))
    torch.testing.assert_close(
        linalg._blocked.solve_lower_t(L, B, block=128, Dinv=Dinv),
        torch.linalg.solve_triangular(L.T, B, upper=True))


@pytest.mark.parametrize('n', [512, 700])
def test_trtri_reuses_l(rng, n):
    """trtri_blocked forms L⁻¹ in L's own buffer when n is a block
    multiple, and otherwise in a new one, leaving L alone."""
    K, _ = _problem(rng, n)
    L, Dinv = linalg._blocked.chol_factor_scaled(
        torch.as_tensor(K), torch.ones(n), 0.0, block=128)
    L2 = L.clone()
    W = linalg._blocked.trtri_blocked(L2, Dinv, 128)
    torch.testing.assert_close(W @ L, torch.eye(n), rtol=0, atol=1e-10)
    assert (W.data_ptr() == L2.data_ptr()) == (n % 128 == 0)
    if n % 128:
        torch.testing.assert_close(L2, L, rtol=0, atol=0)


@pytest.mark.parametrize('case', ['well-posed', 'rung 1 fails',
                                  'rungs 1 and 2 fail'])
def test_ladder_rungs_in_jax_order(rng, monkeypatch, case):
    """The float32 'auto' factorization climbs the JAX package's rungs
    (lsqfitgp_tpu/linalg/_blocked.py, chol_factor_scaled_ladder):
    'high' with eps and no lift; on a non-finite factor 'highest' with
    the same eps and no lift; on a non-finite factor again 'highest'
    with eps2 and the lift, the only rung that counts as escalated.  On
    the CPU 'high' is IEEE like 'highest', so the failure of rung 1 that
    rung 2 repairs (a TF32 rounding on the card) is made by poisoning
    rung 1's factor; a noiseless smooth Gram fails rungs 1 and 2 by
    itself."""
    calls = []
    orig = linalg._blocked._chol_tree_impl

    def spy(K, s, eps, block, b1, prec, lift):
        calls.append((prec, float(eps), lift))
        tree, dinvs = orig(K, s, eps, block, b1, prec, lift)
        if case == 'rung 1 fails' and prec == 'high':
            dinvs = [d * float('nan') for d in dinvs]
        return tree, dinvs

    monkeypatch.setattr(linalg._blocked, '_chol_tree_impl', spy)
    if case == 'rungs 1 and 2 fail':
        x = np.linspace(0, 10, 1100)
        K = np.exp(-0.5 * (x[:, None] - x[None, :]) ** 2)
    else:
        K, _ = _problem(rng, 1100)
    dt = linalg.Chol(torch.as_tensor(K, dtype=torch.float32))
    eps1 = calls[0][1]
    escalates = case == 'rungs 1 and 2 fail'
    rungs = [('high', eps1, False), ('highest', eps1, False),
             ('highest', float(dt.eps), True)]
    nrungs = {'well-posed': 1, 'rung 1 fails': 2, 'rungs 1 and 2 fail': 3}
    # an escalated ladder is followed by the float32 rescue's float64
    # refactor at the first rung's eps, without the lift (which fails on
    # this Gram, so the ladder's eps2 stays)
    rescue = [('highest', eps1, False)] if escalates else []
    assert calls == rungs[:nrungs[case]] + rescue
    assert dt._escalated == escalates
    assert dt._df_failed == escalates
    assert (float(dt.eps) == eps1) == (case != 'rungs 1 and 2 fail')
    assert bool(torch.isfinite(dt._L).all())
