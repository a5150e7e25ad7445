"""Decorators turning plain core functions into kernel subclasses.

Counterpart of ``lsqfitgp_tpu/kernelalg/_decorators.py``.
"""

from __future__ import annotations

import types
import warnings

from . import _core, _stationary, _isotropic

__all__ = [
    'crosskernel', 'kernel',
    'crossstationarykernel', 'stationarykernel',
    'crossisotropickernel', 'isotropickernel',
]


def _make_subclass(core, bases, **prekw):
    named = getattr(core, 'pyfunc', core)
    name = getattr(named, '__name__', 'DecoratedKernel')
    bases = tuple(bases)

    def exec_body(ns):
        def __new__(cls, **kw):
            kwargs = dict(prekw)
            kwargs.update(kw)
            if len(kwargs) < len(prekw) + len(kw):
                shared = set(prekw) & set(kw)
                warnings.warn(
                    f'overriding init argument(s) {shared} of kernel {name}')
            self = super(newclass, cls).__new__(cls, core, **kwargs)
            if isinstance(self, bases[-1]) and set(kw) <= set(self.initkw):
                self = self._clone(cls)
            return self

        ns['__new__'] = __new__
        ns['__wrapped__'] = named
        ns['__doc__'] = named.__doc__

    newclass = types.new_class(name, bases, exec_body=exec_body)
    return newclass


def crosskernel(*args, bases=None, **kw):
    """Decorator converting ``core(x, y, **kw)`` to a CrossKernel
    subclass; extra keyword arguments become default constructor
    arguments of the new class."""
    if bases is None:
        bases = (_core.CrossKernel,)
    make = lambda core: _make_subclass(core, bases, **kw)
    if len(args) == 0:
        return make
    elif len(args) == 1:
        return make(args[0])
    raise ValueError(len(args))


def kernel(*args, **kw):
    """Like `crosskernel`, subclassing `Kernel`."""
    return crosskernel(*args, bases=(_core.Kernel,), **kw)


def crossstationarykernel(*args, **kw):
    """Like `crosskernel`, subclassing `CrossStationaryKernel`."""
    return crosskernel(*args, bases=(_stationary.CrossStationaryKernel,),
                       **kw)


def stationarykernel(*args, **kw):
    """Like `crosskernel`, subclassing `StationaryKernel`."""
    return crosskernel(*args, bases=(_stationary.StationaryKernel,), **kw)


def crossisotropickernel(*args, **kw):
    """Like `crosskernel`, subclassing `CrossIsotropicKernel`."""
    return crosskernel(*args, bases=(_isotropic.CrossIsotropicKernel,),
                       **kw)


def isotropickernel(*args, **kw):
    """Like `crosskernel`, subclassing `IsotropicKernel`."""
    return crosskernel(*args, bases=(_isotropic.IsotropicKernel,), **kw)
