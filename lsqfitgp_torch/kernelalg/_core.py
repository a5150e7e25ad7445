"""Kernel class lattice and transformation registry.

Counterpart of ``lsqfitgp_tpu/kernelalg/_core.py`` with the same
semantics:

- A kernel wraps a ``core(x, y, **initkw, **dynkw)``; objects are
  immutable, transformations return new objects.
- *linop* transformations act per side with 1 or 2 arguments; ``None``
  is the identity; the result class is demoted to the class defining
  the transformation, and further to the first non-symmetric class when
  the two sides' arguments differ.
- *algop* transformations promote the result class to the least common
  superclass of the operand classes, scalars counting as ``Constant``
  (nonnegative) or ``CrossConstant``.
- Transformations are looked up along the MRO up to `CrossKernel`.

Not in this version: ``forcekron``, ``batch``, ``_nary`` (processes
defined as linear maps of processes), linop families, ``AffineSpan``
and ``PreservedBySwap``; they wait for the rest of the kernel zoo and
the GP surface.
"""

from __future__ import annotations

import collections
import functools
import types

import torch

from .. import _torchutil
from . import _util

__all__ = [
    'CrossKernel',
    'Kernel',
    'least_common_superclass',
]

# forward references, assigned by sibling modules at import time
Kernel = None
Constant = None
CrossConstant = None


@functools.lru_cache(maxsize=None)
def least_common_superclass(*classes):
    """Most specific class that every argument is a subclass of: among
    the candidates of the arguments' MROs accepted by ``issubclass``,
    the one deepest in its owner's MRO."""
    def depth_in_owner(candidate):
        for c in classes:
            if candidate in c.__mro__:
                return c.__mro__.index(candidate)
        return 0

    acceptable = [
        candidate
        for c in classes
        for candidate in c.__mro__
        if all(issubclass(other, candidate) for other in classes)
    ]
    return min(acceptable, key=depth_in_owner)


_Transf = collections.namedtuple('_Transf', ['func', 'doc', 'kind'])

_LINOP = 'linop'
_ALGOP = 'algop'


class CrossKernel:
    r"""A covariance function between two (possibly different) processes:

    .. math:: \mathrm{kernel}(x, y) = \mathrm{Cov}[f(x), g(y)].

    Callable as ``k(x, y)`` on broadcastable tensors; supports ``+`` and
    ``*`` with kernels and scalars, and named transformations via
    `transf`, `linop`, `algop`.
    """

    __slots__ = '_initkw', '_dynkw', '_core', '_fastgram'

    @property
    def initkw(self):
        return types.MappingProxyType(self._initkw)

    @property
    def dynkw(self):
        return types.MappingProxyType(self._dynkw)

    @property
    def core(self):
        return self._core

    def __new__(cls, core, *, scale=None, loc=None, derivable=None,
                maxdim=None, dim=None, dynkw={}, **initkw):
        self = super().__new__(cls)
        self._initkw = initkw
        self._dynkw = dict(dynkw)
        self._core = lambda x, y, **dkw: core(x, y, **initkw, **dkw)
        self._fastgram = None

        for name, arg in (
            ('scale', scale), ('loc', loc), ('derivable', derivable),
            ('maxdim', maxdim), ('dim', dim),
        ):
            if callable(arg):
                arg = arg(**initkw)
            if isinstance(arg, tuple):
                self = self.linop(name, *arg)
            else:
                self = self.linop(name, arg)
        return self

    def __call__(self, x, y):
        x = _torchutil.asarray(x)
        y = _torchutil.asarray(y)
        shape = torch.broadcast_shapes(x.shape, y.shape)
        result = self.core(x, y, **self.dynkw)
        if result.shape != shape:
            raise RuntimeError(f'kernel core returned shape {result.shape}'
                               f', expected {shape}')
        return result

    def _clone(self, cls=None, *, initkw=None, dynkw=None, core=None):
        new = object.__new__(self.__class__ if cls is None else cls)
        new._initkw = self._initkw if initkw is None else dict(initkw)
        new._dynkw = {} if dynkw is None else dict(dynkw)
        new._core = self._core if core is None else core
        # the fast-Gram spec survives only pure reclassing clones
        new._fastgram = self._fastgram if (
            core is None and initkw is None and dynkw is None
        ) else None
        return new

    def _swap(self):
        """Transpose the kernel (swap arguments); demotes to CrossKernel."""
        core = self.core
        return self._clone(
            CrossKernel, core=lambda x, y, **kw: core(y, x, **kw),
        )

    # -- operators ---------------------------------------------------------

    def __add__(self, other):
        return self.algop('add', other)

    __radd__ = __add__

    def __mul__(self, other):
        return self.algop('mul', other)

    __rmul__ = __mul__

    # -- registry ------------------------------------------------------------

    _transf = {}

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        cls._transf = {}
        cls.__slots__ = ()

    @classmethod
    def _transfmro(cls):
        for c in cls.mro():  # pragma: no branch
            yield c
            if c is CrossKernel:
                break

    @classmethod
    def _crossmro(cls):
        """MRO iterator skipping symmetric (Kernel) classes."""
        for c in cls.mro():  # pragma: no branch
            if not issubclass(c, Kernel):
                yield c
            if c is CrossKernel:
                break

    @classmethod
    def _settransf(cls, name, transf):
        if name in cls._transf:
            raise KeyError(
                f'transformation {name!r} already registered for '
                f'{cls.__name__}')
        cls._transf[name] = _Transf(*transf)

    @classmethod
    def _gettransf(cls, name, mro=None):
        for c in cls._transfmro() if mro is None else mro:
            if name in c._transf:
                return c, c._transf[name]
        raise KeyError(name)

    @classmethod
    def _alltransf(cls):
        out = {}
        for c in cls._transfmro():
            for name, tr in c._transf.items():
                out.setdefault(name, (c, tr))
        return out

    @classmethod
    def has_transf(cls, name):
        try:
            cls._gettransf(name)
        except KeyError as exc:
            if exc.args == (name,):
                return False
            raise  # pragma: no cover
        return True

    @classmethod
    def inherit_transf(cls, name, *, intermediates=False):
        tcls, tr = cls._gettransf(name)
        cls._settransf(name, tr)
        if intermediates:
            for c in cls.mro()[1:]:  # pragma: no branch
                if c is tcls:
                    break
                c._settransf(name, tr)

    @classmethod
    def inherit_all_algops(cls, intermediates=False):
        mro = cls._transfmro()
        next(mro)
        for name, (_, tr) in next(mro)._alltransf().items():
            if tr.kind is _ALGOP:
                cls.inherit_transf(name, intermediates=intermediates)

    # -- application ---------------------------------------------------------

    def transf(self, name, *args, **kw):
        """Apply a registered transformation by name."""
        tcls, tr = self._gettransf(name)
        return tr.func(tcls, self, *args, **kw)

    @classmethod
    def super_transf(cls, name, self, *args, **kw):
        """Apply a transformation as defined above ``cls`` in the MRO."""
        mro = list(self._transfmro())
        idx = mro.index(cls)
        tcls, tr = self._gettransf(name, mro[idx + 1:])
        return tr.func(tcls, self, *args, **kw)

    def linop(self, name, *args, **kw):
        """Apply a linear-operator transformation (see the module
        docstring for the class demotion rules)."""
        tcls, tr = self._gettransf(name)
        if tr.kind is not _LINOP:
            raise ValueError(f'transformation {name!r} is not a linop')
        return tr.func(tcls, self, *args)

    def algop(self, name, *operands, **kw):
        """Apply an algebraic (PSD-preserving) operation; the result
        class is the least common superclass of the operands."""
        tcls, tr = self._gettransf(name)
        if tr.kind is not _ALGOP:
            raise ValueError(f'transformation {name!r} is not an algop')
        return tr.func(tcls, self, *operands, **kw)

    # -- registration --------------------------------------------------------

    @classmethod
    def register_transf(cls, func, transfname=None, doc=None, kind=None):
        if transfname is None:
            transfname = func.__name__
        if doc is None:
            doc = func.__doc__
        cls._settransf(transfname, (func, doc, kind))
        return func

    @classmethod
    def register_linop(cls, op, transfname=None, doc=None, argparser=None):
        if transfname is None:
            transfname = op.__name__

        @functools.wraps(op)
        def func(tcls, self, *allargs):
            # leading CrossKernel args are extra operands, the 1 or 2
            # trailing args are the per-side operator arguments
            pos = len(allargs)
            for i, a in enumerate(allargs):
                if not isinstance(a, CrossKernel):
                    pos = i
                    break
            operands, args = allargs[:pos], allargs[pos:]

            if len(args) not in (1, 2):
                raise ValueError(
                    f'expected 1 or 2 non-kernel arguments, got {len(args)}')

            conv = (
                (lambda a: None if a is None else argparser(a))
                if argparser else (lambda a: a)
            )

            if len(args) == 1:
                arg1 = arg2 = conv(args[0])
                different = False
            else:
                raw1, raw2 = args
                different = raw1 is not raw2
                arg1, arg2 = conv(raw1), conv(raw2)
                different &= arg1 is not arg2

            if arg1 is None and arg2 is None:
                return self

            result = op(tcls, self, arg1, arg2, *operands)

            if not isinstance(result, CrossKernel):
                raise TypeError(
                    f'linop {transfname!r} returned non-kernel '
                    f'{type(result).__name__}')

            rcls = result.__class__
            if issubclass(rcls, tcls):
                rcls = tcls
            all_sym = all(isinstance(o, Kernel) for o in operands)
            if isinstance(self, Kernel) and all_sym and different:
                rcls = next(rcls._crossmro())
            if rcls is not result.__class__:
                result = result._clone(rcls)
            return result

        cls.register_transf(func, transfname, doc, _LINOP)
        return op

    @classmethod
    def register_corelinop(cls, corefunc, transfname=None, doc=None,
                           argparser=None):
        @functools.wraps(corefunc)
        def op(_, self, arg1, arg2, *operands):
            cores = (o.core for o in operands)
            core = corefunc(self.core, arg1, arg2, *cores)
            return self._clone(core=core)

        cls.register_linop(op, transfname, doc, argparser)
        return corefunc

    @classmethod
    def register_xtransf(cls, xfunc, transfname=None, doc=None):
        @functools.wraps(xfunc)
        def corefunc(core, xfun, yfun):
            if not xfun:
                return lambda x, y, **kw: core(x, yfun(y), **kw)
            elif not yfun:
                return lambda x, y, **kw: core(xfun(x), y, **kw)
            return lambda x, y, **kw: core(xfun(x), yfun(y), **kw)

        cls.register_corelinop(corefunc, transfname, doc, xfunc)
        return xfunc

    @classmethod
    def register_algop(cls, op, transfname=None, doc=None):
        if transfname is None:
            transfname = op.__name__

        @functools.wraps(op)
        def func(tcls, *operands, **kw):
            result = op(tcls, *operands, **kw)
            if result is NotImplemented:
                return result
            if not isinstance(result, CrossKernel):
                raise TypeError(
                    f'algop {transfname!r} returned non-kernel '
                    f'{type(result).__name__}')

            classes = [tcls]
            for o in operands:
                if isinstance(o, CrossKernel):
                    classes.append(o.__class__)
                elif _util.is_nonnegative_scalar_trueontracer(o):
                    classes.append(Constant)
                elif _util.is_numerical_scalar(o):
                    classes.append(CrossConstant)
                else:
                    raise TypeError(
                        f'operands to algop {transfname!r} must be kernels '
                        f'or numbers, found {o!r}')
            classes.append(result.__class__)
            lcs = least_common_superclass(*classes)
            return result._clone(lcs)

        cls.register_transf(func, transfname, doc, _ALGOP)
        return op


class Kernel(CrossKernel):
    r"""Symmetric kernel of a single process:
    :math:`\mathrm{kernel}(x,y) = \mathrm{Cov}[f(x), f(y)]`."""

    def _swap(self):
        return self

