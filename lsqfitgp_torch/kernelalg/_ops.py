"""Linear-operator transformations on kernels.

Counterpart of the part of ``lsqfitgp_tpu/kernelalg/_ops.py`` that
`CrossKernel.__new__` applies: ``scale``, ``loc``, ``derivable``,
``maxdim`` and ``dim``.  Inputs are plain tensors in this version, so
``dim`` (a field of a structured input) always raises, and
``derivable`` only validates its argument: nothing in this version
differentiates a kernel with respect to its inputs, so there is no
derivative count to limit.
"""

from __future__ import annotations

import math
import numbers

import torch

from .. import _torchutil
from ._core import CrossKernel

__all__ = []


def _value(v):
    return float(v.detach()) if isinstance(v, torch.Tensor) else float(v)


@CrossKernel.register_xtransf
def derivable(derivable):
    """Declare the degree of derivability of the process.

    xderivable, yderivable : int, bool, or None
    """
    if isinstance(derivable, bool):
        return None
    if not isinstance(derivable, numbers.Integral) or derivable < 0:
        raise ValueError(f'invalid derivability degree {derivable!r}')
    return None


@CrossKernel.register_xtransf
def dim(dim):
    """Restrict the process to a field of structured input:
    T(f)(x) = f(x[dim]).  Structured inputs are not in this version."""
    if not isinstance(dim, (str, list)):
        raise TypeError(f'dim must be a (list of) string, found {dim!r}')

    def fun(x):
        raise ValueError(f'cannot take dim={dim!r} of non-structured input')

    return fun


@CrossKernel.register_xtransf
def maxdim(maxdim):
    """Restrict the process to a maximum input dimensionality.

    xmaxdim, ymaxdim : None or int
    """
    if not isinstance(maxdim, numbers.Integral) or maxdim < 0:
        raise ValueError(f'invalid maximum dimensionality {maxdim!r}')

    def fun(x):
        if maxdim < 1:
            raise ValueError(f'kernel applied to input with 1 fields > '
                             f'maxdim={maxdim}')
        return x

    return fun


@CrossKernel.register_xtransf
def loc(loc):
    r"""Translate the process input: T(f)(x) = f(x - loc).

    xloc, yloc : None or number
    """
    def check():
        if not -math.inf < _value(loc) < math.inf:
            raise ValueError(f'loc must be finite, got {loc!r}')
    _torchutil.check(check)
    return lambda x: x - loc


@CrossKernel.register_xtransf
def scale(scale):
    r"""Rescale the process input: T(f)(x) = f(x / scale).

    xscale, yscale : None or number
    """
    def check():
        if not 0 < _value(scale) < math.inf:
            raise ValueError(f'scale must be positive and finite, got '
                             f'{scale!r}')
    _torchutil.check(check)
    return lambda x: x / scale
