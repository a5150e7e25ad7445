"""Stationary kernel classes.

Counterpart of ``lsqfitgp_tpu/kernelalg/_stationary.py``.
"""

from __future__ import annotations

import torch

from . import _core, _fastgram, _util

__all__ = ['CrossStationaryKernel', 'StationaryKernel']


def _abs(x):
    """|x| with the derivative 1 at 0, as ``jnp.abs``'s (torch's abs has
    0 there, which zeroes the derivatives of a kernel of |x − y| at
    coincident points)."""
    return torch.where(x >= 0, x, -x)


def softabs(x):
    """|x| offset away from zero, for cores singular at 0."""
    eps = torch.finfo(x.dtype if x.is_floating_point()
                      else torch.get_default_dtype()).eps
    return _abs(x) + eps


class CrossStationaryKernel(_core.CrossKernel):
    """Kernel depending only on x - y (field by field).

    The core takes ``delta = x - y`` as its only positional argument.
    ``input`` selects the preprocessing: 'signed' (bare difference),
    'abs' (absolute value), 'posabs' (absolute value, zero shifted to a
    tiny positive number).
    """

    def __new__(cls, core, *, input='signed', **kw):
        if input == 'posabs':
            dist = lambda x, y: softabs(x - y)
        elif input == 'signed':
            dist = lambda x, y: x - y
        elif input == 'abs':
            dist = lambda x, y: _abs(x - y)
        else:
            raise KeyError(input)

        def newcore(x, y, **kwargs):
            return core(_util.map_recurse_fields(dist, x, y), **kwargs)

        self = super().__new__(cls, newcore, **kw)
        if not self._dynkw:
            # in one dimension a stationary kernel of |Δ| is isotropic;
            # a symmetric 'signed' kernel is even in Δ
            mode = input
            if input == 'signed':
                mode = 'abs' if issubclass(cls, _core.Kernel) else None
            if mode is not None:
                spec = _fastgram.make_spec(core, mode, kw)
                if spec is not None:
                    md = spec.maxdim
                    spec = spec._replace(
                        maxdim=1 if md is None else min(md, 1))
                self._fastgram = spec
        return self


class StationaryKernel(CrossStationaryKernel, _core.Kernel):
    pass


StationaryKernel.inherit_transf('dim', intermediates=True)
