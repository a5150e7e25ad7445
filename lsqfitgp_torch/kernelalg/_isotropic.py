"""Isotropic kernel classes and the Constant/Zero kernels.

Counterpart of ``lsqfitgp_tpu/kernelalg/_isotropic.py``.  The squared
distance sums ``(x − y)²`` over the fields of structured points and
their tails.
"""

from __future__ import annotations

import torch

from . import _core, _fastgram, _stationary, _util

__all__ = [
    'CrossIsotropicKernel', 'IsotropicKernel',
    'CrossConstant', 'Constant', 'Zero',
]


class CrossIsotropicKernel(_stationary.CrossStationaryKernel):
    """Kernel depending only on the Euclidean distance between arguments.

    The core takes the squared distance ``r2``; ``input`` selects
    'squared' (default), 'abs' (distance), 'posabs' (distance, zero
    shifted), or 'raw' (the two points, like a generic kernel).
    """

    def __new__(cls, core, *, input='squared', **kw):
        if input == 'raw':
            self = _core.CrossKernel.__new__(cls, core, **kw)
            if any(core is c for c in _fastgram.NOISE_CORES) \
                    and not self._dynkw:
                self._fastgram = _fastgram.make_noise_spec(kw)
            return self

        if input in ('squared', 'abs'):
            dist = lambda x, y: torch.square(x - y)
        elif input == 'posabs':
            dist = lambda x, y: torch.square(_stationary.softabs(x - y))
        else:
            raise KeyError(input)

        transf = torch.sqrt if input in ('abs', 'posabs') \
            else (lambda ss: ss)

        def newcore(x, y, **kwargs):
            return core(transf(_util.sum_recurse_fields(dist, x, y)),
                        **kwargs)

        self = _core.CrossKernel.__new__(cls, newcore, **kw)
        if not self._dynkw:
            # remember the scalar profile so the GP can assemble point
            # blocks with kernel C; later transformations drop it
            self._fastgram = _fastgram.make_spec(core, input, kw)
        return self


class IsotropicKernel(CrossIsotropicKernel, _stationary.StationaryKernel):
    pass


IsotropicKernel.inherit_all_algops(intermediates=True)
for _name in ('rescale', 'loc', 'scale', 'maxdim', 'derivable',
              'normalize', 'cond'):
    IsotropicKernel.inherit_transf(_name, intermediates=True)


class CrossConstant(CrossIsotropicKernel):
    pass


class Constant(CrossConstant, IsotropicKernel):
    pass


class Zero(IsotropicKernel):
    """Kernel that unconditionally yields zero."""

    def __new__(cls):
        def zero(x, y):
            return torch.zeros(torch.broadcast_shapes(x.shape, y.shape),
                               dtype=torch.get_default_dtype(),
                               device=x.device)
        return super().__new__(cls, zero, input='raw')


# resolve forward references in the registry logic
_core.IsotropicKernel = IsotropicKernel
_core.CrossIsotropicKernel = CrossIsotropicKernel
_core.Constant = Constant
_core.CrossConstant = CrossConstant
