"""Linear-operator transformations on kernels.

Counterpart of ``lsqfitgp_tpu/kernelalg/_ops.py``: ``rescale``,
``derivable``, ``diff``, ``xtransf``, ``dim``, ``maxdim``, ``loc``,
``scale``, ``normalize``, ``cond``, and the `AffineSpan` overrides of
``loc`` and ``scale``.

``diff`` differentiates the kernel core with respect to its inputs by
`_torchutil.elementwise_grad` (reverse mode with a ones cotangent and
``create_graph``, where the JAX package takes a jvp with a ones
tangent): the derivative blocks stay plain autograd, differentiable in
the hyperparameters to any order, and keep no graph once formed
(`_torchutil.recompute` builds it again in the backward).  ``derivable``
puts `_torchutil.limit_derivatives` on each floating leaf of the input,
so that a derivative past the declared degree raises.
"""

from __future__ import annotations

import functools
import math
import numbers
import sys

import torch

from .. import _array, _config, _deriv, _torchutil
from . import _util
from ._core import CrossKernel, Kernel, AffineSpan

__all__ = []


def _value(v):
    return float(v.detach()) if isinstance(v, torch.Tensor) else float(v)


def _rescale_argparser(fun):
    if not callable(fun):
        raise ValueError("argument to 'rescale' must be a function")
    return fun


@functools.partial(CrossKernel.register_corelinop,
                   argparser=_rescale_argparser)
def rescale(core, xfun, yfun):
    r"""Rescale the process output: T(f)(x) = fun(x) f(x).

    xfun, yfun : callable or None
        Functions from the input domain to scalars.
    """
    if not xfun:
        return lambda x, y, **kw: core(x, y, **kw) * yfun(y)
    elif not yfun:
        return lambda x, y, **kw: xfun(x) * core(x, y, **kw)
    return lambda x, y, **kw: xfun(x) * core(x, y, **kw) * yfun(y)


@CrossKernel.register_xtransf
def derivable(derivable):
    """Declare the degree of derivability of the process.

    xderivable, yderivable : int, bool, or None
        Number of guaranteed derivatives; True means infinite, None
        unknown.  Taking more derivatives of the kernel (`diff`) raises.
    """
    if isinstance(derivable, bool):
        derivable = sys.maxsize if derivable else 0
    elif not isinstance(derivable, numbers.Integral) or derivable < 0:
        raise ValueError(f'invalid derivability degree {derivable!r}')

    def limit(v):
        if isinstance(v, torch.Tensor) and v.is_floating_point():
            return _torchutil.limit_derivatives(v, derivable)
        return v

    return lambda x: _util.map_recurse_fields(limit, x)


def _asfloat(x):
    return x if x.is_floating_point() else x.to(_config.default_float())


def _diff_argparser(deriv):
    d = _deriv.Deriv(deriv)
    return d if d else None


def _deriv_targets(deriv):
    """A Deriv as (field, order) derivation steps; ``field`` is None for
    a derivative with respect to a plain (not structured) input."""
    if deriv.implicit:
        return [(None, deriv.order)] if deriv.order else []
    return [(dim, deriv[dim]) for dim in deriv]


def _validate_diff_input(v, deriv, side):
    if _util.is_structured(v):
        missing = [dim for dim in deriv if dim not in v.fields]
        if missing:
            raise ValueError(f'derivative along missing field '
                             f'{missing[0]!r} on {side} argument')
        nested = [dim for dim in deriv if _util.is_structured(v[dim])]
        if nested:
            raise TypeError(
                f'derivative along non-numeric field {nested[0]!r}')
    elif not deriv.implicit:
        raise ValueError(f'derivative on named fields with non-structured '
                         f'array on {side} argument')
    elif not isinstance(v, torch.Tensor) or v.dtype == torch.bool \
            or v.is_complex():
        raise TypeError(f'derivative along non-numeric {side} argument')


def _derive_along(core, side, field, order):
    """One derivation step: d^order core / d (arg[side][field])^order,
    elementwise.  Both arguments are broadcast to the block's full shape
    (`elementwise_grad` differentiates entry by entry), the targeted
    leaf is pulled out and floated, and the input rebuilt around it
    inside the differentiated closure, so steps compose freely (mixed
    fields, both sides, any orders)."""

    def stepped(x, y, **kw):
        x, y = _array.broadcast_arrays(x, y)
        inp = (x, y)[side]
        leaf = _asfloat(inp if field is None else inp[field])

        def with_leaf(leaf):
            v = leaf if field is None else _array.set_field(inp, field, leaf)
            return core(v, y, **kw) if side == 0 else core(x, v, **kw)

        g = with_leaf
        for _ in range(order):
            g = _torchutil.elementwise_grad(g)
        return g(leaf)

    return stepped


@functools.partial(CrossKernel.register_corelinop, argparser=_diff_argparser)
def diff(core, xderiv, yderiv):
    r"""Derive the process: T(f)(x) = ∂ⁿf/∂xⁿ (x).

    xderiv, yderiv : Deriv-like
        Per-side derivative specifications (see `Deriv`).
    """
    xderiv = _deriv.Deriv(xderiv)
    yderiv = _deriv.Deriv(yderiv)

    derived = core
    for field, order in _deriv_targets(xderiv):
        derived = _derive_along(derived, 0, field, order)
    for field, order in _deriv_targets(yderiv):
        derived = _derive_along(derived, 1, field, order)

    def newcore(x, y, **kw):
        _validate_diff_input(x, xderiv, 'left')
        _validate_diff_input(y, yderiv, 'right')
        return _torchutil.recompute(lambda: derived(x, y, **kw))

    return newcore


@CrossKernel.register_xtransf
def xtransf(fun):
    r"""Transform the process input: T(f)(x) = f(fun(x)).

    xfun, yfun : callable or None
        Map from the new input domain to the kernel's input domain.
    """
    if not callable(fun):
        raise ValueError("argument to 'xtransf' must be a function")
    return fun


@CrossKernel.register_xtransf
def dim(dim):
    """Restrict the process to a field of structured input:
    T(f)(x) = f(x[dim]).

    xdim, ydim : None, str, or list of str
    """
    if not isinstance(dim, (str, list)):
        raise TypeError(f'dim must be a (list of) string, found {dim!r}')

    def fun(x):
        if not _util.is_structured(x):
            raise ValueError(
                f'cannot take dim={dim!r} of non-structured input')
        wanted = [dim] if isinstance(dim, str) else dim
        missing = [d for d in wanted if d not in x.fields]
        if missing:
            raise ValueError(
                f'dim={missing!r} not among input fields {x.fields!r}')
        if isinstance(dim, str) and x._tails[dim]:
            return x[[dim]]
        return x[dim]

    return fun


@CrossKernel.register_xtransf
def maxdim(maxdim):
    """Restrict the process to a maximum input dimensionality.

    xmaxdim, ymaxdim : None or int
    """
    if not isinstance(maxdim, numbers.Integral) or maxdim < 0:
        raise ValueError(f'invalid maximum dimensionality {maxdim!r}')

    def fun(x):
        nd = _array.nscalars(x)
        if nd > maxdim:
            raise ValueError(f'kernel applied to input with {nd} fields > '
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
    return lambda x: _util.map_recurse_fields(lambda v: v - loc, x)


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
    return lambda x: _util.map_recurse_fields(lambda v: v / scale, x)


def _normalize_argparser(do):
    return do if do else None


@functools.partial(CrossKernel.register_corelinop,
                   argparser=_normalize_argparser)
def normalize(core, dox, doy):
    r"""Rescale the process to unit variance:
    T(f)(x) = f(x) / sqrt(kernel(x, x)).

    dox, doy : bool
    """
    if dox and doy:
        return lambda x, y, **kw: core(x, y, **kw) / torch.sqrt(
            core(x, x, **kw) * core(y, y, **kw))
    elif dox:
        return lambda x, y, **kw: core(x, y, **kw) / torch.sqrt(
            core(x, x, **kw))
    return lambda x, y, **kw: core(x, y, **kw) / torch.sqrt(core(y, y, **kw))


@CrossKernel.register_corelinop
def cond(core, cond1, cond2, other):
    r"""Switch between two independent processes on a condition:
    T(f, g)(x) = f(x) if cond(x) else g(x).

    cond1, cond2 : callable
        Boolean functions of the input.
    other : CrossKernel
        Kernel used where the condition is false.
    """
    def newcore(x, y, **kw):
        xc = cond1(x)
        yc = cond2(y)
        r = torch.where(xc & yc, core(x, y, **kw), other(x, y, **kw))
        return torch.where(xc ^ yc, torch.zeros((), dtype=r.dtype,
                                                device=r.device), r)

    return newcore


# symmetric diff/xtransf keep Kernel class when both sides are equal
Kernel.inherit_transf('xtransf')
Kernel.inherit_transf('diff')

# AffineSpan: loc/scale preserve the class and update the affine record
AffineSpan.inherit_transf('maxdim')
AffineSpan.inherit_transf('derivable')


@functools.partial(AffineSpan.register_linop, transfname='loc')
def _affine_loc(tcls, self, xloc, yloc):
    dynkw = dict(self.dynkw)
    new = tcls.super_transf('loc', self, xloc, yloc)
    if xloc is not None:
        dynkw['lloc'] = dynkw['lloc'] + xloc * dynkw['lscale']
    if yloc is not None:
        dynkw['rloc'] = dynkw['rloc'] + yloc * dynkw['rscale']
    return new._clone(self.__class__, dynkw=dynkw)


@functools.partial(AffineSpan.register_linop, transfname='scale')
def _affine_scale(tcls, self, xscale, yscale):
    dynkw = dict(self.dynkw)
    new = tcls.super_transf('scale', self, xscale, yscale)
    if xscale is not None:
        dynkw['lscale'] = dynkw['lscale'] * xscale
    if yscale is not None:
        dynkw['rscale'] = dynkw['rscale'] * yscale
    return new._clone(self.__class__, dynkw=dynkw)
