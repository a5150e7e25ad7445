"""The real-order Matérn's tables (``lsqfitgp_torch/ops/_mtable.py``) on
the CPU: the plain table builder and evaluator, which the CUDA kernels'
table and Clenshaw evaluation repeat, against a 40-digit truth (mpmath)
and against the JAX package's ``kvmodx2`` and its JVP on the same inputs
(made from a seed with numpy), and a small Matérn-ν Gram through the
table against ``lsqfitgp_tpu.Matern``.

The contract (``ops/_mtable.py``), at seeded points for ν in `NUS` (up
to the largest order with tables, ``NU_MAX`` = 8), the value and the
first x²-derivative:
- float64: within 2e-14 relative of the truth wherever f ≥ 1e-290;
  within 2e-14 + 1.5 (x + ν |log x|) eps relative of the JAX package's
  float64 quadrature, whose exponent (−x cosh t, with cosh t − 1 formed
  by a subtraction, plus log cosh νt and the prefactor's ν log x, which
  cancel) rounds to about (x + ν |log x|) eps;
- float32 (coefficients rounded, the evaluation in float32): within 4
  eps relative of the float64 table at the same float32 argument
  wherever f is a normal float32.
Below the table (x < 2^E_LO) the kernels and `matern_parts_plain` take
the quadrature, which `tests/test_torch_zoo.py` holds; so they do for the
orders of `NUS_HIGH`, above ``NU_MAX``, which have no tables (there the
fixed layout would miss the contract: float64 about 3e-11 at ν = 20).
"""

import math

import mpmath
import numpy as np
import pytest
import torch
import jax
from jax import numpy as jnp

import lsqfitgp_tpu as ltpu
from lsqfitgp_tpu.special import _kv as jkv
import lsqfitgp_torch as lt
from lsqfitgp_torch import ops
from lsqfitgp_torch.ops import _gram, _mtable

pytestmark = pytest.mark.x64only

SEED = 20261018
NUS = [0.3, 0.5, 0.7, 1.0, 1.5, 1.7, 2.5, 3.7, 7.3, 8.0]
# orders above NU_MAX: no tables, the quadrature
NUS_HIGH = [10.0, 20.0, 50.0]
# (order, kind): the value tables, and the raw derivative's where ν ≤ 1
# (of order ν > 1 the derivative is the value table of order ν − 1)
TABLES = [(nu, 0) for nu in NUS] + [(nu, 1) for nu in NUS if nu <= 1]
HIGH = [(nu, 0) for nu in NUS_HIGH]
EPS64 = float(np.finfo(np.float64).eps)
EPS32 = float(np.finfo(np.float32).eps)


@pytest.fixture(scope='module', autouse=True)
def cpu_device():
    """The package computes on the CUDA card unless asked for the CPU."""
    with lt.using_device('cpu'):
        yield


def _gen(*key):
    return np.random.default_rng([SEED, *key])


def _xs(gen, n, lo, hi):
    """n points log-uniform on [lo, hi]."""
    return np.exp(gen.uniform(np.log(lo), np.log(hi), n))


def _truth(nu, x2, kind):
    """f_ν (kind 0) or its raw first x²-derivative (kind 1) at x² in 40
    digits."""
    with mpmath.workdps(40):
        x = mpmath.sqrt(mpmath.mpf(float(x2)))
        c = mpmath.mpf(2) ** (1 - nu) / mpmath.gamma(nu)
        if kind == 0:
            return float(c * x ** nu * mpmath.besselk(nu, x))
        return float(-c / 2 * x ** (nu - 1) * mpmath.besselk(abs(nu - 1), x))


def _quadrature_route(nu, t):
    """An order above NU_MAX: no table, and the core as the kernels
    evaluate it is the quadrature's plain version, value and first
    derivative."""
    assert not _mtable.tabulated(nu)
    for kind in (0, 1):
        with pytest.raises(ValueError):
            _mtable.matern_table_plain(nu, kind, t.dtype)
    with pytest.raises(ValueError):
        _mtable.matern_tables(nu, t.dtype, 'cpu')
    for j in (0, 1):
        ref = _gram._matern_parts(t, torch.tensor(nu, dtype=t.dtype), j)
        assert torch.equal(_mtable.matern_parts_plain(t, nu, j), ref)


@pytest.mark.parametrize('nu,kind', TABLES + HIGH)
def test_table_truth(nu, kind):
    """The float64 table (value, and the raw derivative where ν ≤ 1)
    within 2e-14 relative of the truth from 2^E_LO to the underflow
    point; above NU_MAX no table (`_quadrature_route`)."""
    elo = _mtable.layout(torch.float64)[0]
    x2 = _xs(_gen(int(nu * 10), kind), 60, 2.0 ** elo, 720.0) ** 2
    if nu > _mtable.NU_MAX:
        _quadrature_route(nu, torch.tensor(x2 / (2 * nu)))
        return
    tab = _mtable.matern_table_plain(nu, kind, torch.float64)
    got = _mtable.matern_table_eval_plain(tab, torch.tensor(x2)).numpy()
    ref = np.array([_truth(nu, v, kind) for v in x2])
    ok = np.abs(ref) >= 1e-290
    assert ok.sum() > 40
    rel = np.abs(got - ref)[ok] / np.abs(ref[ok])
    assert rel.max() <= 2e-14, rel.max()


def _jax_value_deriv(nu, x2):
    f, df = jax.jvp(lambda a: jkv.kvmodx2(nu, a), (jnp.asarray(x2),),
                    (jnp.ones_like(jnp.asarray(x2)),))
    return np.asarray(f), np.asarray(df)


@pytest.mark.parametrize('nu', NUS)
def test_core_vs_jax(nu):
    """The Matérn-ν core as the kernels evaluate it (`matern_parts_plain`:
    the tables from 2^E_LO on, the quadrature below), value and first
    x²-derivative, against the JAX package's ``kvmodx2`` and its JVP in
    float64 for x from 1e-6 to the underflow point: within 2e-14 + 1.5
    (x + ν |log x|) eps relative wherever f ≥ 1e-290."""
    x = _xs(_gen(int(nu * 10), 7), 400, 1e-6, 720.0)
    x2 = x * x
    f, df = _jax_value_deriv(nu, x2)
    t = torch.tensor(x2 / (2 * nu))
    g0 = _mtable.matern_parts_plain(t, nu, 0).numpy()
    g1 = _mtable.matern_parts_plain(t, nu, 1).numpy() / (2 * nu)
    for got, ref in ((g0, f), (g1, df)):
        ok = np.abs(ref) >= 1e-290
        tol = (2e-14 + 1.5 * (x + nu * np.abs(np.log(x))) * EPS64) \
            * np.abs(ref)
        assert np.all(np.abs(got - ref)[ok] <= tol[ok]), \
            np.max((np.abs(got - ref) / tol)[ok])


@pytest.mark.parametrize('nu,kind', TABLES + HIGH)
def test_table_float32(nu, kind):
    """The float32 table, evaluated in float32, within 4 eps (float32's)
    relative of the float64 table at the same float32 argument wherever
    f is a normal float32; above NU_MAX no table (`_quadrature_route`)."""
    elo = _mtable.layout(torch.float32)[0]
    x2 = torch.tensor(_xs(_gen(int(nu * 10), kind, 32), 2000, 2.0 ** elo,
                          100.0) ** 2, dtype=torch.float32)
    if nu > _mtable.NU_MAX:
        _quadrature_route(nu, x2 / (2 * nu))
        return
    t32 = _mtable.matern_table_plain(nu, kind, torch.float32)
    t64 = _mtable.matern_table_plain(nu, kind, torch.float64)
    got = _mtable.matern_table_eval_plain(t32, x2).double()
    ref = _mtable.matern_table_eval_plain(t64, x2.double())
    ok = ref.abs() >= torch.finfo(torch.float32).tiny
    assert int(ok.sum()) > 1000
    rel = ((got - ref).abs() / ref.abs())[ok]
    assert float(rel.max()) <= 4 * EPS32, float(rel.max())


@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
def test_locate_nodes(dtype):
    """Each panel's Chebyshev nodes map back to their panel and their
    variable y (the device's exponent-and-mantissa lookup)."""
    x, _ = _mtable._nodes(dtype)
    elo, ehi, nc, npan = _mtable.layout(dtype)
    xt = torch.tensor(x, dtype=dtype)
    panel, y, _ = _mtable._locate(xt, dtype)
    assert torch.equal(panel, torch.arange(npan)[:, None].expand(npan, nc))
    ref = torch.cos(math.pi * (torch.arange(nc, dtype=torch.float64) + 0.5)
                    / nc)
    assert float((y.double() - ref).abs().max()) <= 64 * \
        torch.finfo(dtype).eps
    assert x.min() >= 2.0 ** elo and x.max() < 2.0 ** ehi


@pytest.mark.parametrize('p', [1, 3])
@pytest.mark.parametrize('nu', [0.7, 1.7])
def test_gram_vs_jax(nu, p):
    """A Matérn-ν Gram (n = 64 by 48, p coordinates, scale 1.3) through
    the table's plain evaluator, amplitude 1.4, against
    ``lsqfitgp_tpu.Matern(nu, scale)`` in float64 on the same points
    (two coincident pairs: x² = 0 gives 1), within 1e-13 of the largest
    entry (the contract's 2e-14 relative; at x below 2^E_LO the
    quadrature)."""
    gen = _gen(int(nu * 10), p, 64)
    x = gen.standard_normal((64, p)) * 2
    y = gen.standard_normal((48, p)) * 2
    y[3] = x[5]
    y[7] = x[11] + 1e-5
    scale, amp = 1.3, 1.4
    kj = amp * ltpu.Matern(nu=nu, scale=scale)
    if p == 1:
        ref = np.asarray(kj(x[:, 0][:, None], y[:, 0][None, :]))
    else:
        # p coordinates: one structured field with a (p,) tail
        dt = np.dtype([('x', float, (p,))])
        xs, ys = np.empty(64, dt), np.empty(48, dt)
        xs['x'], ys['x'] = x, y
        ref = np.asarray(kj(xs[:, None], ys[None, :]))
    t = _gram._sqdist_plain(torch.tensor(x), torch.tensor(y)) / scale ** 2
    got = amp * _mtable.matern_parts_plain(t, nu, 0).numpy()
    assert np.max(np.abs(got - ref)) <= 1e-13 * np.max(np.abs(ref))


def test_tables_cached_and_plumbed():
    """A Matérn-ν term's order rides the description's structure; the
    launch's table pointers (value table, then first derivative, per
    term; null for other terms) come from the cache, built once: the
    CPU's plain tables here."""
    T, S = ops.Term, ops.Terms
    P = ops.PROFILES
    desc = S((T(P['expquad']), T(P['matern'], args=(1.7,), scale=2.0)))
    st = _gram._struct(desc)
    assert [s.order for s in _gram._leaves(st)] == [None, 1.7]
    x = torch.zeros(3, 1, dtype=torch.float64)
    ptrs = _gram._mtabs(st, x)
    f, d = _mtable.matern_tables(1.7, torch.float64, 'cpu')
    assert list(ptrs) == [None, f.data_ptr(), None, None,
                          None, d.data_ptr(), None, None]
    assert d is _mtable.matern_table(0.7, 0, torch.float64, 'cpu')
    f32, _ = _mtable.matern_tables(float(np.float32(1.7)), torch.float32,
                                   'cpu')
    ptrs32 = _gram._mtabs(st, x.float())
    assert ptrs32[1] == f32.data_ptr()
    assert _gram._mtabs(_gram._struct(T(P['expquad'])), x) is None


@pytest.mark.parametrize('nu', NUS_HIGH)
def test_high_order_passes_no_tables(nu):
    """A Matérn-ν term above NU_MAX gets null table pointers (the
    kernels' quadrature) beside a term with tables, and a launch of it
    alone is not tallied as reading tables."""
    T, S = ops.Term, ops.Terms
    P = ops.PROFILES
    desc = S((T(P['matern'], args=(nu,)), T(P['matern'], args=(2.5,))))
    st = _gram._struct(desc)
    x = torch.zeros(3, 1, dtype=torch.float64)
    f, d = _mtable.matern_tables(2.5, torch.float64, 'cpu')
    assert list(_gram._mtabs(st, x)) == [None, f.data_ptr(), None, None,
                                         None, d.data_ptr(), None, None]
    alone = _gram._struct(T(P['matern'], args=(nu,)))
    assert _gram._mtabs(alone, x) is None

    class Fn:
        launches = 0
        by_profile = {}
    _gram._count(Fn, 'launches', alone)
    _gram._count(Fn, 'launches', st)
    assert Fn.by_profile == {('launches', 'matern'): 1,
                             ('launches', 'matern+matern'): 1,
                             ('launches', 'tables'): 1}
