"""The AR and MA kernels, the Toeplitz solvers and the row-sequential
framework, on the CPU, against the JAX package on the same inputs (made
from a seed with numpy), in float64.

- ``MA`` (with ``norm``) and ``AR`` in each parametrization (``phi`` and
  ``gamma`` with ``maxlag``, the log-roots ``slnr``/``lnc``), repeated
  real and complex roots and a real "complex" root, lags past ``maxlag``
  (nan) and rounded lags, and the class methods, after
  ``tests/kernels/test_arma.py``; four of them in float32 against the
  JAX package's float64 values with ``tests/conftest.py``'s float32
  tolerances;
- the log-root kernel's gradient in the roots (its block recomputed in
  the backward) against ``jax.grad``;
- the smoke's AR model (``amp * AR(slnr=[], lnc=[a + ib], norm=True)``)
  at n = 80: NLL and gradient in (log amp, log a, b) and a 3-iteration
  ``empbayes_fit`` against the JAX package's;
- ``linalg.toeplitz``'s functions against dense float64 linear algebra
  and the JAX functions, and ``linalg.seqalg``'s pipeline of
  ``ToeplitzRows``, ``SolveTriLowerColByFull``, ``SumLogDiag``,
  ``MatMulRowByFull`` and ``Stack``; ``examples/toeplitz_path.py`` run
  against the port with its own assertions.

Tolerances: the same formulas, 1e-12 relative unless said (the
log-root basis 1e-10: its linear solve; a real "complex" root 1e-8, the
ill-conditioned power-doubled columns in both packages); GP likelihoods
and gradients 1e-9 and 1e-8 as in ``tests/test_torch_gp.py``, the
fit's end point 1e-6 as in ``tests/test_torch_timeseries.py``.
"""

import math
import os

import numpy as np
import pytest
import scipy.linalg
import torch
import jax
from jax import numpy as jnp

import lsqfitgp_tpu as ltpu
from lsqfitgp_tpu.linalg import toeplitz as jtoeplitz
from lsqfitgp_tpu.linalg import seqalg as jseqalg
import lsqfitgp_torch as lt
from lsqfitgp_torch.linalg import toeplitz, seqalg

pytestmark = pytest.mark.x64only

SEED = 20261023
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def close(a, b, rtol=1e-12, atol=1e-13):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol)


# -- the kernels -------------------------------------------------------------------

LC = np.log(2.0) + 0.7j
KERNELS = {
    'MA': ('MA', dict(w=[1.0, 0.5, 0.25]), 1e-12),
    'MA-norm': ('MA', dict(w=[2.0, 1.0, -0.3, 0.1], norm=True), 1e-12),
    'MA-empty': ('MA', dict(w=np.zeros(0)), 1e-12),
    'AR-phi': ('AR', dict(phi=[0.5, -0.3, 0.1], maxlag=12), 1e-12),
    'AR-phi-norm': ('AR', dict(phi=[0.6], maxlag=12, norm=True), 1e-12),
    'AR-gamma': ('AR', dict(gamma=[1.4, 0.6, 0.1], maxlag=12), 1e-12),
    'AR-roots': ('AR', dict(slnr=[math.log(1.5)], lnc=[LC]), 1e-10),
    'AR-roots-norm': ('AR', dict(slnr=[-0.4], lnc=[LC], norm=True), 1e-10),
    'AR-rep-real': ('AR', dict(slnr=[0.7, 0.7, -0.3], lnc=np.zeros(0, complex)),
                    1e-10),
    'AR-rep-complex': ('AR', dict(slnr=[], lnc=[0.3 + 0.5j, 0.3 + 0.5j]),
                       1e-10),
    'AR-real-complex': ('AR', dict(slnr=[-0.4], lnc=[0.3 + 0j]), 1e-8),
    'AR2': ('AR', dict(slnr=[], lnc=[0.05 + 2j * math.pi / 50], norm=True),
            1e-10),
}


def _jaxkw(kw):
    return {k: jnp.asarray(v) if isinstance(v, (list, np.ndarray)) else v
            for k, v in kw.items()}


@pytest.mark.parametrize('name', sorted(KERNELS))
def test_kernel(name):
    """Values at integer lags (past maxlag: nan), at lags off the
    integers by float error (rounded) and at both signs."""
    cls, kw, rtol = KERNELS[name]
    lags = np.concatenate([np.arange(-3, 16), [4 - 1e-9, 7 + 1e-9]])
    x, y = lags[:, None], np.array([[0.0, 2.0]])
    got = getattr(lt, cls)(**kw)(torch.tensor(x), torch.tensor(y))
    ref = getattr(ltpu, cls)(**_jaxkw(kw))(jnp.asarray(x), jnp.asarray(y))
    close(got, ref, rtol=rtol, atol=rtol)


@pytest.mark.parametrize('name', ['MA-norm', 'AR-phi', 'AR-roots-norm',
                                  'AR2'])
def test_kernel_float32(name):
    """Float32 (the port's default dtype: float32 parameters, lags and
    complex64 roots) against the JAX package in float64 with
    ``tests/conftest.py``'s float32 tolerances (2e-4 relative, 1e-5
    absolute)."""
    cls, kw, _ = KERNELS[name]
    lags = np.arange(0, 40.0)[:, None]
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float32)
    try:
        got = getattr(lt, cls)(**kw)(torch.tensor(lags, dtype=torch.float32),
                                     torch.zeros(1, 1))
    finally:
        torch.set_default_dtype(old)
    assert got.dtype == torch.float32
    ref = getattr(ltpu, cls)(**_jaxkw(kw))(jnp.asarray(lags),
                                           jnp.zeros((1, 1)))
    close(got, ref, rtol=2e-4, atol=1e-5)


def test_ar_roots_gradient():
    """The log-root kernel's gradient in (a, b) and in a real root
    through the recomputed block, against ``jax.grad``."""
    x = np.arange(30.0)
    w = np.cos(x[:, None] - 0.3 * x[None, :])

    def loss_t(p):
        k = lt.AR(slnr=p[2:], lnc=torch.complex(p[0], p[1])[None], norm=True)
        K = k(torch.tensor(x)[:, None], torch.tensor(x)[None, :])
        return (K * torch.tensor(w)).sum()

    def loss_j(p):
        k = ltpu.AR(slnr=p[2:], lnc=(p[0] + 1j * p[1])[None], norm=True)
        return (k(jnp.asarray(x)[:, None], jnp.asarray(x)[None, :]) * w).sum()

    p0 = np.array([0.05, 2 * math.pi / 50, 0.3])
    p = torch.tensor(p0, requires_grad=True)
    g, = torch.autograd.grad(loss_t(p), p)
    close(g, jax.grad(loss_j)(jnp.asarray(p0)), rtol=1e-9, atol=1e-10)


def test_class_methods():
    """tests/kernels/test_arma.py: Yule-Walker both ways, the recursion,
    the roots' coefficients."""
    phi = np.array([0.5, -0.3, 0.1])
    g = lt.AR.gamma_from_phi(phi)
    close(g, ltpu.AR.gamma_from_phi(jnp.asarray(phi)))
    close(lt.AR.phi_from_gamma(g), phi, rtol=1e-10)
    close(lt.AR.extend_gamma(g, phi, 10),
          ltpu.AR.extend_gamma(jnp.asarray(g.numpy()), jnp.asarray(phi), 10))
    for slnr, lnc in (([math.log(2.0)], np.zeros(0, complex)),
                      ([-math.log(2.0)], np.zeros(0, complex)),
                      ([], [LC]), ([0.7, 0.7], [LC, 0.2 - 1j])):
        close(lt.AR.phi_from_roots(slnr, lnc),
              ltpu.AR.phi_from_roots(jnp.asarray(slnr, float),
                                     jnp.asarray(lnc, complex)))


def test_ar_psd():
    K = lt.AR(phi=[0.5, -0.3], maxlag=50)(torch.arange(20.)[:, None],
                                           torch.arange(20.)[None, :])
    eigs = torch.linalg.eigvalsh(K)
    assert float(eigs.min()) > -1e-10 * float(eigs.max())


def test_ar_model():
    """The smoke's AR model at n = 80 (noise 0.09): NLL and gradient in
    (log amp, log a, b) against the JAX package's."""
    rng = np.random.default_rng(SEED)
    t = np.arange(80.0)
    y = np.sin(2 * math.pi * t / 50) + 0.3 * rng.standard_normal(t.size)
    lp0 = np.array([0.1, math.log(0.06), 2 * math.pi / 48])

    def nll_t(lp):
        k = lp[0].exp() * lt.AR(
            slnr=[], lnc=torch.complex(lp[1].exp(), lp[2])[None], norm=True)
        return -lt.GP(k).addx(torch.tensor(t), 'y').marginal_likelihood(
            {'y': torch.tensor(y)}, 0.09)

    def nll_j(lp):
        k = jnp.exp(lp[0]) * ltpu.AR(
            slnr=jnp.zeros(0), lnc=(jnp.exp(lp[1]) + 1j * lp[2])[None],
            norm=True)
        return -ltpu.GP(k).addx(jnp.asarray(t), 'y').marginal_likelihood(
            {'y': jnp.asarray(y)}, 0.09 * jnp.eye(t.size))

    lp = torch.tensor(lp0, requires_grad=True)
    v = nll_t(lp)
    g, = torch.autograd.grad(v, lp)
    vj, gj = jax.value_and_grad(nll_j)(jnp.asarray(lp0))
    close(v, vj, rtol=1e-9, atol=1e-9)
    close(g, gj, rtol=1e-8, atol=1e-9)


def test_ar_fit():
    """A 3-iteration empbayes_fit of the smoke's AR model at n = 80 ends
    at the JAX package's hyperparameters."""
    rng = np.random.default_rng(SEED + 1)
    t = np.arange(80.0)
    y = np.sin(2 * math.pi * t / 50) + 0.3 * rng.standard_normal(t.size)
    prior = {'log(amp)': (0., 1.), 'log(a)': (math.log(0.05), 1.),
             'b': (2 * math.pi / 50, 1.)}
    kw = dict(minkw={'options': {'maxiter': 3}}, raises=False)

    def gp_t(hp):
        lnc = torch.complex(hp['a'], hp['b'])[None]
        k = hp['amp'] * lt.AR(slnr=[], lnc=lnc, norm=True)
        return lt.GP(k).addx(torch.tensor(t), 'y')

    def gp_j(hp):
        lnc = (hp['a'] + 1j * hp['b'])[None]
        k = hp['amp'] * ltpu.AR(slnr=jnp.zeros(0), lnc=lnc, norm=True)
        return ltpu.GP(k).addx(jnp.asarray(t), 'y')

    fj = ltpu.empbayes_fit(prior, gp_j,
                           ({'y': y}, 0.09 * jnp.eye(t.size)), **kw)
    ft = lt.empbayes_fit(prior, gp_t, ({'y': y}, 0.09), **kw)
    close(ft.pmean.buf, fj.pmean.buf, rtol=1e-6, atol=1e-9)


def test_no_fast_gram():
    """Neither package has a fast-Gram spec for AR or MA: the streaming
    solver refuses them with the same words."""
    t = np.arange(8.0)
    for mod in (lt, ltpu):
        for k in (mod.AR(phi=np.asarray([0.5]), maxlag=10),
                  mod.MA(w=np.asarray([1.0, 0.5]))):
            gp = mod.GP(k, solver='chol-stream').addx(t, 'x')
            with pytest.raises(ValueError,
                               match='carries no fast-Gram spec'):
                gp.marginal_likelihood({"x": np.sin(t)}, 0.1 * np.ones(8))


# -- the Toeplitz solvers --------------------------------------------------------


def _toeplitz_system(n, seed):
    rng = np.random.default_rng(seed)
    t = np.exp(-0.3 * np.arange(n)) * np.cos(0.4 * np.arange(n))
    t[0] += 0.2
    return t, rng.standard_normal(n), rng.standard_normal((n, 3))


@pytest.mark.parametrize('n', [1, 2, 13])
def test_toeplitz(n):
    """chol, chol_matmul, chol_solve (with diageps), logdet, solve
    (vector and matrix) and eigv_bound against dense float64 and the
    JAX functions."""
    t, b, B = _toeplitz_system(n, SEED + n)
    T = scipy.linalg.toeplitz(t)
    L = np.linalg.cholesky(T)
    close(toeplitz.chol(t), L, atol=1e-14)
    close(toeplitz.chol(t), jtoeplitz.chol(jnp.asarray(t)), atol=1e-14)
    close(toeplitz.chol_matmul(t, B), L @ B, atol=1e-14)
    close(toeplitz.chol_solve(t, b), np.linalg.solve(L, b), rtol=1e-11)
    Te = scipy.linalg.toeplitz(np.concatenate([[t[0] + 0.5], t[1:]]))
    close(toeplitz.chol_solve(t, B, diageps=0.5),
          np.linalg.solve(np.linalg.cholesky(Te), B), rtol=1e-11)
    close(toeplitz.logdet(t), np.linalg.slogdet(T)[1], rtol=1e-12)
    for rhs in (b, B):
        close(toeplitz.solve(t, rhs), np.linalg.solve(T, rhs), rtol=1e-10,
              atol=1e-12)
        close(toeplitz.solve(t, rhs), jtoeplitz.solve(jnp.asarray(t),
                                                      jnp.asarray(rhs)),
              rtol=1e-10, atol=1e-12)
    close(toeplitz.eigv_bound(t), jtoeplitz.eigv_bound(jnp.asarray(t)))
    assert float(toeplitz.eigv_bound(t)) >= np.linalg.eigvalsh(T).max()


def test_toeplitz_gradient():
    """solve and logdet differentiate through the loop as the JAX
    functions through fori_loop."""
    t0, b, _ = _toeplitz_system(9, SEED)
    t = torch.tensor(t0, requires_grad=True)
    v = toeplitz.solve(t, b).sum() + toeplitz.logdet(t)
    g, = torch.autograd.grad(v, t)
    gj = jax.grad(lambda u: jtoeplitz.solve(u, jnp.asarray(b)).sum()
                  + jtoeplitz.logdet(u))(jnp.asarray(t0))
    close(g, gj, rtol=1e-9, atol=1e-11)


def test_sequential_algorithm():
    """A Toeplitz matrix's rows through forward substitution with its
    lower triangle, Σ log diag, a product and a stack, in one pass,
    against dense float64 and the JAX pipeline."""
    t, b, B = _toeplitz_system(11, SEED + 7)
    T = scipy.linalg.toeplitz(t)
    outs = []
    for mod, arr in ((seqalg, np.asarray), (jseqalg, jnp.asarray)):
        rows = mod.ToeplitzRows(arr(t))
        ops = [rows, mod.SolveTriLowerColByFull(rows, arr(B)),
               mod.SumLogDiag(rows), mod.MatMulRowByFull(rows, arr(B)),
               mod.Stack(rows)]
        outs.append(mod.sequential_algorithm(t.size, ops)[1:])
    x, logd, prod, stack = outs[0]
    close(x, scipy.linalg.solve_triangular(np.tril(T), B, lower=True),
          rtol=1e-10, atol=1e-12)
    close(logd, t.size * np.log(t[0]))
    close(prod, T @ B)
    close(stack, T)
    for got, ref in zip(outs[0], outs[1]):
        close(got, ref, rtol=1e-10, atol=1e-12)
    dense = seqalg.sequential_algorithm(t.size, [
        r := seqalg.Rows(T), seqalg.SumLogDiag(r)])[1]
    close(dense, logd)


def test_example_toeplitz_path():
    """examples/toeplitz_path.py against lsqfitgp_torch with its own
    assertions (the Toeplitz solvers against the dense factor at n =
    400): its imports swapped in memory, ``jax.numpy`` by ``torch``."""
    path = os.path.join(ROOT, 'examples', 'toeplitz_path.py')
    src = open(path).read()
    for old, new in (('import lsqfitgp_tpu as lgp',
                      'import lsqfitgp_torch as lgp'),
                     ('from lsqfitgp_tpu.linalg import toeplitz',
                      'from lsqfitgp_torch.linalg import toeplitz'),
                     ('import jax.numpy as jnp', 'import torch as jnp')):
        assert old in src
        src = src.replace(old, new)
    ns = {'__name__': 'example'}
    exec(compile(src, path, 'exec'), ns)
    ns['main']()
