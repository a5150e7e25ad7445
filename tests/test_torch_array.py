"""lsqfitgp_torch's StructuredArray on the CPU against lsqfitgp_tpu's on
the same inputs (made from a seed with numpy), in float64: construction
from dicts, numpy structured arrays (tails, nested fields) and 2-D
arrays, indexing and broadcasting as the kernels' cores use them,
reshaping, concatenation, field updates, the recfunctions helpers, and
the isotropic and stationary cores' reductions over fields.

Tolerances: the array operations move values without arithmetic, so
they agree exactly (field dtypes included); a kernel on structured
points sums the same squares in the same order, so 1e-14 relative."""

import numpy as np
import pytest
import torch

import lsqfitgp_tpu as ltpu
import lsqfitgp_torch as lt
from lsqfitgp_torch import _array

pytestmark = pytest.mark.x64only

SEED = 20261016


@pytest.fixture(scope='module', autouse=True)
def cpu_device():
    """The package computes on the CUDA card unless asked for the CPU."""
    with lt.using_device('cpu'):
        yield


@pytest.fixture(autouse=True)
def torch_f64():
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    yield
    torch.set_default_dtype(old)


@pytest.fixture
def gen():
    return np.random.default_rng(SEED)


def assert_same(t, j):
    """The port's StructuredArray (or tensor) ``t`` equals the JAX
    package's ``j``: shape, fields, tails, dtypes and values."""
    if isinstance(j, ltpu.StructuredArray):
        assert isinstance(t, lt.StructuredArray)
        assert t.shape == j.shape
        assert t.fields == j.fields
        assert t._tails == j._tails
        assert t.dtype == j.dtype
        for name in j.fields:
            assert_same(t[name], j[name])
    else:
        assert isinstance(t, torch.Tensor)
        a, b = t.numpy(), np.asarray(j)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _tailed(gen, n=6):
    x = np.empty(n, dtype=[('a', float), ('b', float, (2,))])
    x['a'] = gen.standard_normal(n)
    x['b'] = gen.standard_normal((n, 2))
    return x


def _nested(gen, n=3):
    x = np.empty(n, dtype=[('u', [('p', float), ('q', float)]),
                           ('v', float), ('k', int), ('b', bool)])
    x['u']['p'] = gen.standard_normal(n)
    x['u']['q'] = gen.standard_normal(n)
    x['v'] = gen.standard_normal(n)
    x['k'] = gen.integers(0, 9, n)
    x['b'] = gen.integers(0, 2, n).astype(bool)
    return x


@pytest.mark.parametrize('make', ['dict', 'tailed', 'nested', 'dict2d'])
def test_construction(gen, make):
    """asarray of dicts and numpy structured arrays, with tails, nested
    fields and mixed dtypes (bool, int and float keep their kinds)."""
    if make == 'dict':
        src = {'a': gen.standard_normal(5), 'b': np.ones(5)}
    elif make == 'tailed':
        src = _tailed(gen)
    elif make == 'nested':
        src = _nested(gen)
    else:
        src = {'a': gen.standard_normal((2, 3)), 'b': np.zeros((2, 3, 4))}
    t, j = lt.asarray(src), ltpu.asarray(src)
    assert_same(t, j)
    if not isinstance(src, dict):
        back = np.asarray(t)
        assert back.dtype == src.dtype
        for name in src.dtype.names:
            np.testing.assert_array_equal(back[name], src[name])
        assert_same(lt.StructuredArray(src), ltpu.StructuredArray(src))
    assert _array.nscalars(t) == ltpu._array.nscalars(j)


def test_indexing_and_broadcast(gen):
    """x[:, None], y[None, :], broadcast_to, integer and Ellipsis
    indexing, field lists, as test_array.py:46 and :113."""
    src = {'a': gen.standard_normal((2, 3)), 'c': gen.standard_normal(
        (2, 3))}
    t, j = lt.asarray(src), ltpu.asarray(src)
    for key in [(slice(None), None), 0, (Ellipsis, 1), (None, Ellipsis),
                (slice(1, None), slice(None, None, 2))]:
        assert_same(t[key], j[key])
    assert_same(lt.broadcast_to(t[:, None], (2, 4, 3)),
                ltpu.broadcast_to(j[:, None], (2, 4, 3)))
    assert_same(t[['c']], j[['c']])
    bt = lt.broadcast_arrays(t[:, None], t[None, :])
    bj = ltpu.broadcast_arrays(j[:, None], j[None, :])
    for u, v in zip(bt, bj):
        assert_same(u, v)
    assert lt.broadcast_shapes((2, 1), (1, 3)) == (2, 3)


def test_reshape_squeeze(gen):
    x = _tailed(gen)
    t, j = lt.asarray(x), ltpu.asarray(x)
    assert_same(t.reshape(2, 3), j.reshape(2, 3))
    assert_same(t.reshape(2, 3).reshape(-1), j.reshape(2, 3).reshape(-1))
    assert_same(t[None].squeeze(0), j[None].squeeze(0))
    assert_same(t.reshape(1, 6).squeeze(), j.reshape(1, 6).squeeze())


def test_concatenate_set_append(gen):
    """concatenate, at[...].set / set_field (broadcasting the value) and
    append_fields, as test_array.py:89, :96 and :189."""
    a, b = _tailed(gen, 3), _tailed(gen, 4)
    assert_same(lt.concatenate([lt.asarray(a), lt.asarray(b)]),
                ltpu.concatenate([ltpu.asarray(a), ltpu.asarray(b)]))
    t, j = lt.asarray(a), ltpu.asarray(a)
    c = gen.standard_normal(3)
    assert_same(t.at['c'].set(c), j.at['c'].set(c))
    assert t.fields == ('a', 'b')
    assert_same(_array.set_field(t, 'a', 2.0),
                ltpu._array.set_field(j, 'a', 2.0))
    assert_same(lt.append_fields(t, 'c', c), ltpu.append_fields(j, 'c', c))
    with pytest.raises(ValueError):
        lt.append_fields(lt.append_fields(t, 'c', c), 'c', c)


def test_unstructured_to_structured(gen):
    """As test_array.py:103, and the inverse (test_array.py:179)."""
    x = gen.standard_normal((4, 3))
    assert_same(lt.unstructured_to_structured(x),
                ltpu.unstructured_to_structured(x))
    dt = np.dtype([('a', float), ('b', float, (2,))])
    st, sj = (lt.unstructured_to_structured(x, dtype=dt),
              ltpu.unstructured_to_structured(x, dtype=dt))
    assert_same(st, sj)
    assert_same(lt.structured_to_unstructured(st),
                ltpu.structured_to_unstructured(sj))
    nested = lt.asarray(_nested(gen))
    u = lt.structured_to_unstructured(nested[['u', 'v']])
    np.testing.assert_array_equal(
        u.numpy(), np.asarray(ltpu.structured_to_unstructured(
            ltpu.asarray(np.asarray(nested))[['u', 'v']])))


def test_errors():
    """As test_array.py:129 and :225."""
    with pytest.raises(ValueError):
        lt.StructuredArray({'a': torch.zeros(3), 'b': torch.zeros(4)})
    with pytest.raises(ValueError):
        lt.StructuredArray(np.zeros((2, 3)))
    s = lt.asarray({'a': np.zeros(3)})
    with pytest.raises(AttributeError):
        s.x = 1


@pytest.mark.parametrize('kernel', ['ExpQuad', 'White', 'forcekron'])
def test_kernel_on_structured(gen, kernel):
    """A kernel on structured points with a tail field sums over the
    fields and the tail (ExpQuad), compares points field by field
    (White, with repeated points), or multiplies over fields
    (forcekron)."""
    x = _tailed(gen, 7)
    x[3] = x[1]

    def make(mod):
        if kernel == 'forcekron':
            return mod.ExpQuad(scale=1.5, forcekron=True)
        return getattr(mod, kernel)()

    t, j = lt.asarray(x), ltpu.asarray(x)
    Kt = make(lt)(t[:, None], t[None, :])
    Kj = make(ltpu)(j[:, None], j[None, :])
    np.testing.assert_allclose(Kt.numpy(), np.asarray(Kj), rtol=1e-14,
                               atol=1e-15)
