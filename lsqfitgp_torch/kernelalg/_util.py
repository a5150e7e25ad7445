"""Scalar predicates for kernel algebra.

Counterpart of ``lsqfitgp_tpu/kernelalg/_util.py``, for plain (not
structured) inputs: the structured-field reductions wait for the port
of ``_array.py``.
"""

from __future__ import annotations

import numbers

import numpy
import torch

from .. import _config

__all__ = [
    'is_numerical_scalar',
    'is_scalar_cond_trueontracer',
    'is_nonnegative_scalar_trueontracer',
]


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
