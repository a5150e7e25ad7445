"""The float32 rescue of lsqfitgp_torch's `Chol` (``df``): a native
float64 refactor, on the JAX package's triggers, against a float64
truth computed with numpy and against the JAX package's ``df='auto'``
(its emulated double-precision refactor) on the same float32 inputs.

These mirror ``tests/linalg/test_df.py``'s ``TestCholRescue`` and
``TestDfGram::test_gp_df_gram_end_to_end`` with the same ``_illcond``
inputs and that file's tolerances: NLL 1e-4 relative, logdet 1e-2
absolute, the solve 1e-4 relative to its largest entry, the gradient of
the fused NLL 1e-1 relative, the GP's NLL 1e-6 relative.  The JAX side
runs on explicit float32 arrays, so it rescues in either test lane."""

import warnings

import numpy as np
import pytest
import torch
import jax
from jax import numpy as jnp

from lsqfitgp_tpu.linalg._decomp import Chol as JChol
from lsqfitgp_tpu.linalg._decomp import chol_nll as jchol_nll
import lsqfitgp_torch as lt
from lsqfitgp_torch.linalg import Chol, chol_nll
from lsqfitgp_torch.linalg import _decomp


@pytest.fixture(scope='module', autouse=True)
def cpu_device():
    """The package computes on the CUDA card unless asked for the CPU."""
    with lt.using_device('cpu'):
        yield


@pytest.fixture(autouse=True)
def torch_f32():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float32)
    torch.set_num_threads(2)
    yield
    torch.set_default_dtype(old)


def _illcond(n, *, scale=2.0, noise=1e-4, seed=0, span=10.0):
    """float32 smooth Gram + small nugget: cond ~ bound/noise >> 1/eps32
    (the inputs of ``tests/linalg/test_df.py``)."""
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(0, span, n))
    d2 = (x[:, None] - x[None, :]) ** 2
    K64 = np.exp(-0.5 * d2 / scale ** 2) + noise * np.eye(n)
    y64 = np.linalg.cholesky(K64 + 1e-12 * np.eye(n)) \
        @ rng.standard_normal(n)
    return K64.astype(np.float32), y64, d2


def _quiet(fn, *args, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        return fn(*args, **kw)


def _reg(K32, dec):
    """The float64 matrix the rescue factors: the float32-rounded K plus
    the primary eps (unscaled)."""
    s = np.asarray(dec._s, np.float64)
    return K32.astype(np.float64) + np.diag(float(np.asarray(dec._eps))
                                            / s ** 2)


def _truth(Kreg, y64):
    n = Kreg.shape[0]
    L = np.linalg.cholesky(Kreg)
    z = np.linalg.solve(L, y64)
    nll = 0.5 * z @ z + np.sum(np.log(np.diag(L))) \
        + 0.5 * n * np.log(2 * np.pi)
    return nll, np.linalg.slogdet(Kreg)[1], np.linalg.solve(Kreg, y64)


def _outputs(dec, y32):
    """NLL, logdet and K⁻¹y of a decomposition from either package."""
    return tuple(np.asarray(v, np.float64) for v in _quiet(
        lambda: (dec.minus_log_normal_density(y32), dec.logdet(),
                 dec.ginv_linear(y32))))


def _check(got, ref):
    nll, ld, sol = got
    nll_r, ld_r, sol_r = ref
    assert abs(nll - nll_r) < 1e-4 * abs(nll_r)
    assert abs(ld - ld_r) < 1e-2 * max(1.0, abs(ld_r))
    assert np.max(np.abs(sol - sol_r)) / np.max(np.abs(sol_r)) < 1e-4


@pytest.mark.parametrize('n', [384, 1100])
def test_rescue_triggers_and_values(n):
    """The rescue fires (on the condition estimate) and its NLL, logdet
    and solve agree with the float64 truth of the matrix it factors;
    n = 1100 takes the blocked path."""
    K32, y64, _ = _illcond(n)
    dec = _quiet(Chol, torch.as_tensor(K32))
    assert dec._df_rescued and not dec._df_failed and not dec._escalated
    assert (dec._wide[1] is not None) == (n >= 1024)
    y32 = torch.as_tensor(y64, dtype=torch.float32)
    got = _outputs(dec, y32)
    assert all(v.dtype == torch.float32 for v in _quiet(
        lambda: (dec.minus_log_normal_density(y32), dec.logdet(),
                 dec.ginv_linear(y32))))
    _check(got, _truth(_reg(K32, dec), y64))


@pytest.mark.parametrize('n,noise', [(384, 1e-4), (256, 0.0)])
def test_rescue_matches_jax(n, noise):
    """The same inputs through the JAX package's rescue: the same
    decision, the same primary eps to the bit, and outputs that agree at
    the tolerances each is held to against the truth."""
    K32, y64, _ = _illcond(n, noise=noise)
    dec = _quiet(Chol, torch.as_tensor(K32))
    jdec = _quiet(JChol, jnp.asarray(K32))
    assert bool(jdec._df_rescued) and dec._df_rescued
    assert float(np.asarray(jdec._eps)) == float(dec._eps)
    np.testing.assert_array_equal(np.asarray(jdec._s), dec._s.numpy())
    got = _outputs(dec, torch.as_tensor(y64, dtype=torch.float32))
    ref = _outputs(jdec, jnp.asarray(y64, jnp.float32))
    _check(got, ref)


def test_rescue_warns_and_df_false_disables():
    n = 384
    K32, y64, _ = _illcond(n)
    y32 = torch.as_tensor(y64, dtype=torch.float32)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter('always')
        dec = Chol(torch.as_tensor(K32))
        dec.minus_log_normal_density(y32)
    assert any('rescued by a float64 refactorization' in str(x.message)
               for x in w)
    dec2 = _quiet(Chol, torch.as_tensor(K32), df=False)
    assert dec2._wide is None and not dec2._df_rescued
    # past DF_MAX 'auto' leaves it off; True forces it at any size
    assert _decomp.DF_MAX == 4096
    with pytest.raises(ValueError, match='df must be'):
        Chol(torch.as_tensor(K32), df='yes')


def test_rescue_size_limit(monkeypatch):
    """df='auto' rescues up to DF_MAX only; df=True at any size."""
    K32, _, _ = _illcond(300)
    monkeypatch.setattr(_decomp, 'DF_MAX', 299)
    assert not _quiet(Chol, torch.as_tensor(K32))._df_rescued
    assert _quiet(Chol, torch.as_tensor(K32), df=True)._df_rescued


def test_wellposed_untouched():
    """Big noise: cond within float32 reach, no rescue, and the same
    bits as with df=False, through Chol and through chol_nll with its
    gradient."""
    n = 200
    K32, y64, _ = _illcond(n, noise=1e-1)
    Kt = torch.as_tensor(K32)
    y32 = torch.as_tensor(y64, dtype=torch.float32)
    dec = Chol(Kt)
    assert not dec._df_rescued and dec._wide is None
    a = dec.minus_log_normal_density(y32)
    b = Chol(Kt, df=False).minus_log_normal_density(y32)
    assert torch.equal(a, b)
    out = []
    for df in ('auto', False):
        K = Kt.clone().requires_grad_(True)
        v = chol_nll(K, y32, df=df)
        out += [v, *torch.autograd.grad(v, K)]
    assert torch.equal(out[0], out[2]) and torch.equal(out[1], out[3])


def test_escalated_singular_rescued():
    """Noiseless smooth Gram: the float32 small-eps rung fails; the
    rescue factors at the primary (diagonal-anchored) eps, not at the
    bound-scaled eps2."""
    n = 256
    K32, y64, _ = _illcond(n, noise=0.0)
    dec = _quiet(Chol, torch.as_tensor(K32))
    assert dec._escalated and dec._df_rescued
    mach = float(np.finfo(np.float32).eps)
    assert float(dec._eps) < 8 * mach
    ld = float(_quiet(dec.logdet))
    ld64 = float(np.linalg.slogdet(_reg(K32, dec))[1])
    assert abs(ld - ld64) < 1e-2 * max(1.0, abs(ld64))


def _nll64(d2, y64, scale, noise, epsdiag):
    """float64 NLL of exp(-d2/(2 scale²)) + noise I + diag(epsdiag) and
    its derivative in scale, by autograd in float64."""
    sc = torch.tensor(scale, dtype=torch.float64, requires_grad=True)
    d2t = torch.as_tensor(d2, dtype=torch.float64)
    K = torch.exp(-0.5 * d2t / sc ** 2) + torch.diag(
        torch.as_tensor(noise + epsdiag, dtype=torch.float64))
    L = torch.linalg.cholesky(K)
    z = torch.linalg.solve_triangular(
        L, torch.as_tensor(y64, dtype=torch.float64)[:, None], upper=False)
    v = 0.5 * (z ** 2).sum() + torch.log(torch.diagonal(L)).sum() \
        + 0.5 * len(y64) * np.log(2 * np.pi)
    g, = torch.autograd.grad(v, sc)
    return float(v.detach()), float(g)


def test_gradients_finite_and_accurate():
    """The fused NLL's value and its gradient in the kernel's scale, in
    the rescue regime, against the float64 truth of the regularized
    model (and the JAX package's fused gradient, at the same bound)."""
    n = 384
    K32, y64, d2 = _illcond(n)
    scale0 = 2.0
    dec = _quiet(Chol, torch.as_tensor(K32))
    s = dec._s.double().numpy()
    v64, g64 = _nll64(d2, y64, scale0, 1e-4, float(dec._eps) / s ** 2)
    d232 = torch.as_tensor(d2, dtype=torch.float32)
    eye32 = torch.as_tensor(1e-4 * np.eye(n), dtype=torch.float32)
    sc = torch.tensor(scale0, dtype=torch.float32, requires_grad=True)
    y32 = torch.as_tensor(y64, dtype=torch.float32)
    v = _quiet(chol_nll, torch.exp(-0.5 * d232 / sc ** 2) + eye32, y32)
    g, = torch.autograd.grad(v, sc)
    assert v.dtype == torch.float32 and np.isfinite(float(g))
    assert abs(float(v) - v64) < 1e-4 * abs(v64)
    assert abs(float(g) - g64) < 1e-1 * abs(g64)
    jd2, jeye = jnp.asarray(d2, jnp.float32), jnp.asarray(1e-4 * np.eye(n),
                                                          jnp.float32)
    gj = float(_quiet(jax.grad(lambda sc: jchol_nll(
        jnp.exp(-0.5 * jd2 / sc ** 2) + jeye,
        jnp.asarray(y64, jnp.float32))), jnp.float32(scale0)))
    # each within 1e-1 |g64| of the truth, so within twice that apart
    assert abs(float(g) - gj) < 2e-1 * abs(g64)


def test_chol_nll_carrier_accuracy():
    """The fused NLL's ∂/∂K carrier ½ S (K_s⁻¹ − z̃ z̃ᵀ) S from the
    float64 factor, against the float64 truth ½ (K⁻¹ − α αᵀ) of the
    regularized matrix: the float32 result's own rounding."""
    n = 384
    K32, y64, _ = _illcond(n)
    dec = _quiet(Chol, torch.as_tensor(K32))
    Kreg = _reg(K32, dec)
    Kinv = np.linalg.inv(Kreg)
    alpha = Kinv @ y64
    Kbar = 0.5 * (Kinv - np.outer(alpha, alpha))
    K = torch.tensor(K32, requires_grad=True)
    v = _quiet(chol_nll, K, torch.as_tensor(y64, dtype=torch.float32))
    g, = torch.autograd.grad(v, K)
    err = np.abs(g.double().numpy() - Kbar).max() / np.abs(Kbar).max()
    assert err < 1e-5


def test_gp_df_gram_end_to_end():
    """GP surface: a cond ≈ 3e6 ExpQuad model in float32 is rescued with
    its Gram assembled in float64 (kernel C's plain version here), and
    its marginal likelihood matches the float64 NLL to 1e-6 relative."""
    rng = np.random.default_rng(4)
    n = 500
    x = np.sort(rng.uniform(0, 10, n)).astype(np.float32)
    noise = 1e-4
    x64 = np.asarray(x, np.float64)
    K64 = np.exp(-0.5 * (x64[:, None] - x64[None, :]) ** 2 / 4.0) \
        + noise * np.eye(n)
    y = np.linalg.cholesky(K64) @ rng.standard_normal(n)
    nll64 = 0.5 * (y @ np.linalg.solve(K64, y)
                   + np.linalg.slogdet(K64)[1] + n * np.log(2 * np.pi))
    gp = lt.GP(lt.ExpQuad(scale=2.0)).addx(x, 'a')
    cov = {('a', 'a'): noise * np.eye(n, dtype=np.float32)}
    with warnings.catch_warnings(record=True) as rec:
        warnings.simplefilter('always')
        ml = gp.marginal_likelihood({'a': y}, cov)
    assert ml.dtype == torch.float32
    assert abs(-float(ml) - nll64) < 1e-6 * abs(nll64)
    assert any('rescued' in str(r.message) for r in rec)
    # the Gram the rescue factored: float64, from the float64 points
    extra = torch.as_tensor(cov['a', 'a'])
    G = gp._df_gram_maker(['a'], extra)()
    assert G.dtype == torch.float64
    np.testing.assert_allclose(
        G.numpy(), K64 - noise * np.eye(n)
        + np.float64(np.float32(noise)) * np.eye(n), rtol=1e-14, atol=1e-15)
    dec = _quiet(gp._solver_for, ['a'], extra)
    assert dec._df_gram_used and dec._df_rescued


def test_gp_without_fast_gram_takes_float32_gram():
    """A model kernel C cannot assemble (a sum of two profiled kernels)
    has no float64 Gram: the rescue refactors its float32 Gram."""
    rng = np.random.default_rng(4)
    x = np.sort(rng.uniform(0, 10, 300)).astype(np.float32)
    gp = lt.GP(lt.ExpQuad(scale=2.0) + lt.ExpQuad(scale=3.0)).addx(x, 'a')
    assert gp._df_gram_maker(['a'], None) is None
    cov = 1e-4 * torch.eye(300)
    dec = _quiet(gp._solver_for, ['a'], cov)
    assert dec._df_rescued and not dec._df_gram_used


def test_warning_distinguishes_model_singular():
    """Rescue attempted and failed: the warning names the cause, 'MODEL
    itself is singular' when the Gram came in float64, 'may still be
    rescuable' when it did not."""
    rng = np.random.default_rng(5)
    n = 64
    x = np.sort(rng.uniform(0, 1, n))
    K64 = np.exp(-0.5 * (x[:, None] - x[None, :]) ** 2)
    # a float64 Gram indefinite beyond any float64 factorization
    Kbad = torch.as_tensor(K64 - 1e-3 * (np.eye(n, k=1) + np.eye(n, k=-1)))
    K32 = torch.as_tensor(K64.astype(np.float32))
    y32 = torch.as_tensor(rng.standard_normal(n), dtype=torch.float32)
    with warnings.catch_warnings(record=True) as w1:
        warnings.simplefilter('always')
        dec = Chol(K32, df_gram=lambda: Kbad)
        dec.minus_log_normal_density(y32)
    assert dec._df_failed and not dec._df_rescued and dec._wide is None
    assert any('MODEL itself is singular' in str(x.message) for x in w1)
    with warnings.catch_warnings(record=True) as w2:
        warnings.simplefilter('always')
        dec2 = Chol(K32)
        dec2.minus_log_normal_density(y32)
    if dec2._df_failed:
        assert any('may still be rescuable' in str(x.message) for x in w2)
