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

Kernels take tensors or `StructuredArray` points.  ``_nary`` builds
the cross-kernels of processes defined as linear maps of processes
(``GP.deflintransf``); `make_linop_family`, `AffineSpan` and
`PreservedBySwap` are the class machinery of kernel families.  Not in
this version: ``batch`` (chunked evaluation).
"""

from __future__ import annotations

import abc
import collections
import enum
import functools
import types
import warnings

from .. import _array
from . import _util

__all__ = [
    'CrossKernel',
    'Kernel',
    'AffineSpan',
    'PreservedBySwap',
    'least_common_superclass',
]

# forward references, assigned by sibling modules at import time
Kernel = None
Constant = None
CrossConstant = None
IsotropicKernel = None
CrossIsotropicKernel = None


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


class _Side(enum.Enum):
    LEFT = 0
    RIGHT = 1


class CrossKernel:
    r"""A covariance function between two (possibly different) processes:

    .. math:: \mathrm{kernel}(x, y) = \mathrm{Cov}[f(x), g(y)].

    Callable as ``k(x, y)`` on broadcastable (structured) arrays;
    supports ``+ * **`` with kernels and scalars, and named
    transformations via `transf`, `linop`, `algop`.
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
                maxdim=None, dim=None, forcekron=False, dynkw={},
                **initkw):
        self = super().__new__(cls)
        self._initkw = initkw
        self._dynkw = dict(dynkw)
        self._core = lambda x, y, **dkw: core(x, y, **initkw, **dkw)
        self._fastgram = None

        if forcekron:
            self = self.transf('forcekron')

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
        x = _array.asarray(x)
        y = _array.asarray(y)
        shape = _array.broadcast_shapes(tuple(x.shape), tuple(y.shape))
        result = self.core(x, y, **self.dynkw)
        if tuple(result.shape) != shape:
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

    @classmethod
    def _nary(cls, op, kernels, side):
        """Process-level linear map: ``op`` combines the kernels seen as
        single-argument functions of the ``side`` argument."""
        if side is _Side.LEFT:
            wrap = lambda c, x, y, **kw: (lambda x_: c(x_, y, **kw))
            pick = lambda x, y: x
        else:
            wrap = lambda c, x, y, **kw: (lambda y_: c(x, y_, **kw))
            pick = lambda x, y: y
        cores = [k.core for k in kernels]

        def core(x, y, **kw):
            fns = [wrap(c, x, y, **kw) for c in cores]
            return op(*fns)(pick(x, y))

        return CrossKernel(core)

    _side = _Side

    # -- operators ---------------------------------------------------------

    def __add__(self, other):
        return self.algop('add', other)

    __radd__ = __add__

    def __mul__(self, other):
        return self.algop('mul', other)

    __rmul__ = __mul__

    def __pow__(self, other):
        return self.algop('pow', exponent=other)

    def __rpow__(self, other):
        return self.algop('rpow', base=other)

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

    @classmethod
    def register_ufuncalgop(cls, ufunc, transfname=None, doc=None):
        @functools.wraps(ufunc)
        def op(_, self, *operands, **kw):
            cores = tuple(
                o.core if isinstance(o, CrossKernel)
                else (lambda x, y, _o=o: _o)
                for o in (self, *operands))

            def core(x, y, **kw):
                return ufunc(*(c(x, y, **kw) for c in cores), **kw)

            return self._clone(core=core)

        cls.register_algop(op, transfname, doc)
        return ufunc

    # -- linop families -------------------------------------------------------

    @classmethod
    def make_linop_family(cls, transfname, bothker, leftker, rightker=None,
                          *, doc=None, argparser=None, argnames=None,
                          translkw=None):
        """Register a linop linking this seed class to transformed-domain
        classes (both/left/right); the transposed cross class is generated
        if not given."""

        if rightker is None:
            rightname = f'Cross{cls.__name__}{bothker.__name__}'

            def exec_body(ns):
                if leftker.__doc__:
                    ns['__doc__'] = (
                        'Automatically generated transposed version of:\n\n'
                        + leftker.__doc__)

                def __new__(rcls_, *args, **kw):
                    self = super(rightker, rcls_).__new__(rcls_, *args, **kw)
                    if self.__class__ is rcls_:
                        self = self._swap()
                        if not isinstance(self, leftker):
                            raise TypeError(
                                f'transposed {rightker.__name__} is not a '
                                f'{leftker.__name__}')
                        return self._clone(rcls_)
                    return self._swap()

                ns['__new__'] = __new__

            rightker = types.new_class(rightname, (leftker,),
                                       exec_body=exec_body)

        sym = tuple(issubclass(c, Kernel)
                    for c in (cls, bothker, leftker, rightker))
        if sym != (True, True, False, False):
            warnings.warn(f'make_linop_family({transfname!r}): unexpected '
                          f'symmetry pattern {sym}')

        if translkw is None:
            def translkw(*, dynkw, **initkw):
                if dynkw:
                    raise ValueError(
                        'non-empty dynkw unsupported by default translkw')
                return initkw

        def makekw(self, arg1, arg2):
            kw = dict(dynkw=self.dynkw, **self.initkw)
            if argnames is not None:
                if arg1 is not None:
                    kw[argnames[0]] = arg1
                if arg2 is not None:
                    kw[argnames[1]] = arg2
            return translkw(**kw)

        regkw = dict(transfname=transfname, doc=doc, argparser=argparser)

        @functools.partial(cls.register_linop, **regkw)
        def seed_to_family(_, self, arg1, arg2):
            kw = makekw(self, arg1, arg2)
            if arg2 is None:
                return leftker(**kw)
            elif arg1 is None:
                return rightker(**kw)
            return bothker(**kw)

        @functools.partial(leftker.register_linop, **regkw)
        def left_to_both(_, self, arg1, arg2):
            if arg1 is None:
                return bothker(**makekw(self, arg1, arg2))
            raise ValueError(f'cannot transform {leftker.__name__} again on '
                             f'the left with {transfname!r}')

        @functools.partial(rightker.register_linop, **regkw)
        def right_to_both(_, self, arg1, arg2):
            if arg2 is None:
                return bothker(**makekw(self, arg1, arg2))
            raise ValueError(f'cannot transform {rightker.__name__} again on '
                             f'the right with {transfname!r}')

        return rightker


class Kernel(CrossKernel):
    r"""Symmetric kernel of a single process:
    :math:`\mathrm{kernel}(x,y) = \mathrm{Cov}[f(x), f(y)]`."""

    def _swap(self):
        return self


@Kernel.register_transf
def forcekron(tcls, self):
    r"""Make the kernel a separate product over input fields:
    newkernel(x, y) = prod_i kernel(x_i, y_i)."""
    core = self.core
    newcore = lambda x, y, **kw: _util.prod_recurse_fields(core, x, y, **kw)
    return self._clone(tcls, core=newcore)


class AffineSpan(CrossKernel, abc.ABC):
    """Kernel mixin tracking the cumulative affine transformation applied
    to inputs and output through 'loc', 'scale' and scalar 'add'/'mul'."""

    _affine_dynkw = dict(lloc=0, rloc=0, lscale=1, rscale=1, offset=0,
                         ampl=1)

    def __new__(cls, *args, dynkw={}, **kw):
        if cls is AffineSpan:
            raise TypeError('cannot instantiate AffineSpan directly')
        new_dynkw = dict(cls._affine_dynkw)
        new_dynkw.update(dynkw)
        return super().__new__(cls, *args, dynkw=new_dynkw, **kw)

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        for name in AffineSpan._transf:
            cls.inherit_transf(name)

    def _clone(self, *args, **kw):
        new = super()._clone(*args, **kw)
        if isinstance(new, AffineSpan):
            for name in self._affine_dynkw:
                new._dynkw[name] = self._dynkw[name]
        return new

    @classmethod
    def __subclasshook__(cls, sub):
        if cls is AffineSpan:
            return NotImplemented
        if issubclass(cls, Kernel):
            if Constant is not None and issubclass(sub, Constant):
                return True
            return NotImplemented
        elif CrossConstant is not None and issubclass(sub, CrossConstant):
            return True
        return NotImplemented


class PreservedBySwap(CrossKernel):
    """Marker: subclasses keep their class through `_swap`."""

    def __new__(cls, *args, **kw):
        if cls is PreservedBySwap:
            raise TypeError('cannot instantiate PreservedBySwap directly')
        return super().__new__(cls, *args, **kw)

    def _swap(self):
        return super()._swap()._clone(self.__class__)

