"""Scalar predicates and structured-field reductions for kernel cores.

Counterpart of ``lsqfitgp_tpu/kernelalg/_util.py``.
"""

from __future__ import annotations

import numbers
import operator

import numpy
import torch

from .. import _config
from .._array import StructuredArray, map_leaves

__all__ = [
    'is_numerical_scalar',
    'is_nonnegative_integer_scalar',
    'is_scalar_cond_trueontracer',
    'is_nonnegative_scalar_trueontracer',
    'sum_recurse_fields',
    'prod_recurse_fields',
    'map_recurse_fields',
    'is_structured',
]


def is_structured(x):
    return isinstance(x, StructuredArray)


def _is_0d_number(x):
    if isinstance(x, numpy.ndarray):
        return x.ndim == 0 and numpy.issubdtype(x.dtype, numpy.number)
    if isinstance(x, torch.Tensor):
        return x.dim() == 0 and x.dtype != torch.bool
    return False


def is_numerical_scalar(x):
    if isinstance(x, numbers.Number):
        return True
    return _is_0d_number(x)


def is_nonnegative_integer_scalar(x):
    if isinstance(x, bool):
        return False
    if isinstance(x, numbers.Integral):
        return x >= 0
    if isinstance(x, numpy.ndarray) and x.ndim == 0 \
            and numpy.issubdtype(x.dtype, numpy.integer):
        return x.item() >= 0
    if isinstance(x, torch.Tensor) and x.dim() == 0 \
            and not x.is_floating_point() and not x.is_complex() \
            and x.dtype != torch.bool:
        return x.item() >= 0
    return False


def is_scalar_cond_trueontracer(x, cond):
    """``cond(x)`` for a numerical scalar; True for a tensor while checks
    are off (inside `empbayes_fit`'s objective, where the JAX package
    sees a tracer), so that reading it costs no host sync."""
    if isinstance(x, numbers.Number):
        return bool(cond(x))
    if _is_0d_number(x):
        if isinstance(x, torch.Tensor) and not _config.checks_enabled():
            return True
        return bool(cond(x.item()))
    return False


def is_nonnegative_scalar_trueontracer(x):
    return is_scalar_cond_trueontracer(x, lambda v: v >= 0)


def _reduce_recurse(fun, args, combine, reduce, **kw):
    x = args[0]
    if not is_structured(x):
        return fun(*args, **kw)
    acc = None
    for name in x.fields:
        res = _reduce_recurse(fun, tuple(a[name] for a in args), combine,
                              reduce, **kw)
        tail = x._tails[name]
        if tail:
            res = reduce(res, tuple(range(-len(tail), 0)))
        acc = res if acc is None else combine(acc, res)
    return acc


def _prod(v, axes):
    for _ in axes:
        v = v.prod(-1)
    return v


def sum_recurse_fields(fun, *args, **kw):
    """Reduce ``fun`` over all leaf fields with +, summing tail axes."""
    return _reduce_recurse(fun, args, operator.add,
                           lambda v, axes: v.sum(axes), **kw)


def prod_recurse_fields(fun, *args, **kw):
    """Reduce ``fun`` over all leaf fields with *, multiplying tail
    axes."""
    return _reduce_recurse(fun, args, operator.mul, _prod, **kw)


def map_recurse_fields(fun, x, *args):
    """Apply ``fun`` to all leaf fields (ufunc semantics)."""
    if is_structured(x):
        return map_leaves(fun, x, *args)
    return fun(x, *args)
