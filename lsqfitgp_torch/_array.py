"""Structured (multi-field) input arrays.

Counterpart of ``lsqfitgp_tpu/_array.py``: an immutable container of
named fields, each a tensor or a nested ``StructuredArray``, all
sharing a leading *base shape* (the shape of the structured array); a
field may carry a trailing "tail" shape, as a numpy structured dtype
with subarray fields does.  Fields keep their own dtypes (bool, int,
float); `asarray` gives floating fields the working float dtype and
puts every field on one device, as the package's other entry points
do.  Indexing, ``reshape`` and ``broadcast_to`` act on the base shape,
so kernel cores broadcast structured points as they do tensors
(``x[:, None]``, ``y[None, :]``).

numpy interop (``numpy.asarray(s)``, construction from numpy structured
arrays, dicts and DataFrames) happens at the boundary, in `asarray` and
``__array__``.
"""

from __future__ import annotations

import math

import numpy
import torch

from . import _torchutil

__all__ = [
    'StructuredArray',
    'asarray',
    'broadcast_to',
    'broadcast_arrays',
    'broadcast_shapes',
    'concatenate',
    'unstructured_to_structured',
    'structured_to_unstructured',
    'append_fields',
    'set_field',
    'nscalars',
    'map_leaves',
]


def _is_structured_dtype(dtype):
    return getattr(dtype, 'names', None) is not None


def _numpy_dtype(t):
    """The numpy dtype of a tensor's elements."""
    return torch.empty((), dtype=t.dtype).numpy().dtype


class StructuredArray:
    """Immutable named-field array container.

    Parameters
    ----------
    fields : dict[str, tensor or StructuredArray], or a numpy structured
        array
        Field values, sharing a common leading base shape.
    tails : dict[str, tuple[int, ...]], optional
        Per-field trailing shapes (default: none).
    shape : tuple, optional
        The base shape (default: the first field's shape less its tail).
    """

    __slots__ = ('_fields', '_tails', '_shape')

    def __init__(self, fields, tails=None, shape=None):
        if isinstance(fields, StructuredArray):
            tails = fields._tails if tails is None else tails
            shape = fields._shape if shape is None else shape
            fields = fields._fields
        elif isinstance(fields, numpy.ndarray):
            if fields.dtype.names is None:
                raise ValueError(
                    'plain (unstructured) arrays cannot become a '
                    'StructuredArray; use a structured dtype')
            src = _from_numpy_structured(fields, None, None)
            fields, tails, shape = src._fields, src._tails, src._shape
        if not fields:
            raise ValueError('StructuredArray needs at least one field')
        fields = dict(fields)
        if tails is None:
            tails = {name: () for name in fields}
        else:
            tails = {name: tuple(tails.get(name, ())) for name in fields}
        if shape is None:
            name0 = next(iter(fields))
            v0 = fields[name0]
            shape = tuple(v0.shape[:len(v0.shape) - len(tails[name0])])
        shape = tuple(shape)
        for name, v in fields.items():
            expected = shape + tails[name]
            if tuple(v.shape) != expected:
                raise ValueError(
                    f'field {name!r} has shape {tuple(v.shape)}, expected '
                    f'base {shape} + tail {tails[name]} = {expected}')
        object.__setattr__(self, '_fields', fields)
        object.__setattr__(self, '_tails', tails)
        object.__setattr__(self, '_shape', shape)

    def __setattr__(self, name, value):
        raise AttributeError('StructuredArray is immutable')

    # -- introspection ---------------------------------------------------------

    @property
    def shape(self):
        return self._shape

    @property
    def ndim(self):
        return len(self._shape)

    @property
    def size(self):
        return math.prod(self._shape)

    def __len__(self):
        if not self._shape:
            raise TypeError('len() of 0-d StructuredArray')
        return self._shape[0]

    @property
    def dtype(self):
        """The equivalent numpy structured dtype."""
        descr = []
        for name, v in self._fields.items():
            sub = v.dtype if isinstance(v, StructuredArray) \
                else _numpy_dtype(v)
            tail = self._tails[name]
            descr.append((name, sub, tail) if tail else (name, sub))
        return numpy.dtype(descr)

    @property
    def fields(self):
        return tuple(self._fields)

    @property
    def device(self):
        v = next(iter(self._fields.values()))
        return v.device

    # -- field and positional access ---------------------------------------

    def __getitem__(self, key):
        if isinstance(key, str):
            return self._fields[key]
        if isinstance(key, list) and key \
                and all(isinstance(k, str) for k in key):
            return StructuredArray({k: self._fields[k] for k in key},
                                   {k: self._tails[k] for k in key},
                                   self._shape)
        return self._index(key)

    def _index(self, key):
        if not isinstance(key, tuple):
            key = (key,)
        # expand the Ellipsis against the base ndim, and fill the base
        # axes the key leaves out, so the tails stay untouched
        if sum(1 for k in key if k is Ellipsis) > 1:
            raise IndexError('only one Ellipsis allowed')
        n_idx = sum(1 for k in key if k is not None and k is not Ellipsis)
        if any(k is Ellipsis for k in key):
            i = key.index(Ellipsis)
            key = key[:i] + (slice(None),) * (self.ndim - n_idx) \
                + key[i + 1:]
        elif n_idx < self.ndim:
            key = key + (slice(None),) * (self.ndim - n_idx)
        newfields = {}
        for name, v in self._fields.items():
            fullkey = key + (slice(None),) * len(self._tails[name])
            newfields[name] = v._index(fullkey) \
                if isinstance(v, StructuredArray) else v[fullkey]
        name0 = next(iter(newfields))
        v0 = newfields[name0]
        base = tuple(v0.shape[:len(v0.shape) - len(self._tails[name0])])
        return StructuredArray(newfields, self._tails, base)

    @property
    def at(self):
        return _At(self)

    # -- shape manipulation --------------------------------------------------

    def reshape(self, *shape):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        if -1 in shape:
            known = math.prod(s for s in shape if s != -1)
            shape = tuple(self.size // known if s == -1 else s
                          for s in shape)
        shape = tuple(shape)
        return StructuredArray(
            {name: v.reshape(shape + self._tails[name])
             for name, v in self._fields.items()}, self._tails, shape)

    def squeeze(self, axis=None):
        shape = self._shape
        if axis is None:
            return self.reshape(tuple(s for s in shape if s != 1))
        if not isinstance(axis, tuple):
            axis = (axis,)
        axis = tuple(a % len(shape) for a in axis)
        return self.reshape(tuple(s for i, s in enumerate(shape)
                                  if i not in axis))

    def broadcast_to(self, shape):
        shape = tuple(shape)
        newfields = {}
        for name, v in self._fields.items():
            target = shape + self._tails[name]
            newfields[name] = v.broadcast_to(target) \
                if isinstance(v, StructuredArray) else v.expand(target)
        return StructuredArray(newfields, self._tails, shape)

    def to(self, device=None, dtype=None):
        """Every field moved to ``device``; the floating fields take
        ``dtype``."""
        return map_leaves(lambda v: _tensor_leaf(v, dtype, device), self)

    # -- numpy interop -------------------------------------------------------

    def __array__(self, dtype=None, copy=None):
        out = numpy.empty(self._shape, self.dtype)
        self._fill_numpy(out)
        return out

    def _fill_numpy(self, out):
        for name, v in self._fields.items():
            if isinstance(v, StructuredArray):
                v._fill_numpy(out[name])
            else:
                out[name] = v.detach().cpu().numpy()

    def __repr__(self):
        inner = ', '.join(f'{name}={v!r}' for name, v in self._fields.items())
        return f'StructuredArray(shape={self._shape}, {inner})'

    def __eq__(self, other):
        return NotImplemented

    def __hash__(self):
        return object.__hash__(self)


class _At:
    """Functional field update: ``x.at['f'].set(v)``."""

    def __init__(self, arr):
        self._arr = arr

    def __getitem__(self, name):
        return _AtField(self._arr, name)


class _AtField:
    def __init__(self, arr, name):
        self._arr = arr
        self._name = name

    def set(self, value):
        return set_field(self._arr, self._name, value)


def map_leaves(fun, x, *others):
    """``fun`` applied to each leaf tensor of ``x`` (with the matching
    leaves of ``others``), the structure kept; on a plain tensor,
    ``fun(x, *others)``."""
    if not isinstance(x, StructuredArray):
        return fun(x, *others)
    return StructuredArray(
        {name: map_leaves(fun, v, *(o[name] for o in others))
         for name, v in x._fields.items()}, x._tails, x._shape)


def set_field(arr, name, value):
    """A copy of ``arr`` with field ``name`` set (or added) to ``value``,
    broadcast to the base shape."""
    fields = dict(arr._fields)
    tails = dict(arr._tails)
    if isinstance(value, dict):
        value = asarray(value)
    if not isinstance(value, StructuredArray):
        if not isinstance(value, torch.Tensor):
            value = _leaf(numpy.asarray(value), None, arr.device)
    nd = len(arr.shape)
    tail = tuple(value.shape[nd:])
    if tuple(value.shape[:nd]) != arr.shape:
        target = arr.shape + tail
        value = value.broadcast_to(target) \
            if isinstance(value, StructuredArray) else value.expand(target)
    fields[name] = value
    tails[name] = tail
    return StructuredArray(fields, tails, arr.shape)


# -- constructors ------------------------------------------------------------


def _leaf(a, dtype, device):
    """A tensor from the numpy array ``a``: floating arrays take ``dtype``
    (default: the working float dtype), others keep their kind."""
    return _torchutil.asarray(a, dtype=dtype if a.dtype.kind in 'fc'
                              else None, device=device)


def _tensor_leaf(v, dtype, device):
    if v.is_floating_point() and dtype is not None:
        v = v.to(dtype)
    return v if device is None else v.to(device)


def _from_numpy_structured(x, dtype, device):
    fields, tails = {}, {}
    for name in x.dtype.names:
        sub = x[name]
        ft = x.dtype.fields[name][0]
        tails[name] = ft.shape if ft.subdtype is not None else ()
        fields[name] = _from_numpy_structured(sub, dtype, device) \
            if _is_structured_dtype(sub.dtype) else _leaf(sub, dtype, device)
    return StructuredArray(fields, tails, x.shape)


def asarray(x, dtype=None, device=None):
    """``x`` as a StructuredArray (a StructuredArray, a numpy structured
    array, a dict of array-likes, possibly nested, or a pandas
    DataFrame) or as a tensor (plain array-likes, as
    ``_torchutil.asarray``).  Floating fields take ``dtype`` (default:
    the working float dtype when converted from numpy; tensors keep
    theirs unless ``dtype`` is given) and every field goes to
    ``device`` (default: the default device for non-tensors).  String
    and object arrays stay host numpy arrays."""
    if isinstance(x, StructuredArray):
        if dtype is None and device is None:
            return x
        return map_leaves(lambda v: _tensor_leaf(v, dtype, device), x)
    if isinstance(x, dict):
        fields = {name: asarray(v, dtype, device) for name, v in x.items()}
        shapes = [tuple(f.shape) for f in fields.values()]
        # a common base shape: the full broadcast if there is one (all
        # fields scalar), else the trailing axes are per-field tails
        try:
            base = broadcast_shapes(*shapes)
            tails = {name: () for name in fields}
        except (ValueError, RuntimeError):
            nd = min(len(s) for s in shapes)
            base = broadcast_shapes(*(s[:nd] for s in shapes))
            tails = {n: tuple(f.shape[nd:]) for n, f in fields.items()}
        return StructuredArray(
            {name: v.broadcast_to(base + tails[name])
             if isinstance(v, StructuredArray)
             else v.expand(base + tails[name])
             for name, v in fields.items()}, tails, base)
    if hasattr(x, 'columns') and hasattr(x, 'to_numpy'):  # a DataFrame
        return StructuredArray({str(c): _leaf(numpy.asarray(x[c]), dtype,
                                              device) for c in x.columns})
    if isinstance(x, torch.Tensor):
        return _tensor_leaf(x, dtype, device)
    a = numpy.asarray(x)
    if _is_structured_dtype(a.dtype):
        return _from_numpy_structured(a, dtype, device)
    if a.dtype.kind in 'USO':
        return a
    return _leaf(a, dtype, device)


def nscalars(x):
    """The number of scalars per point of ``x``: 1 for a tensor, the
    count over the fields and their tails for a StructuredArray."""
    if not isinstance(x, StructuredArray):
        return 1
    total = 0
    for name, v in x._fields.items():
        size = math.prod(x._tails[name])
        total += size * nscalars(v) if isinstance(v, StructuredArray) \
            else size
    return total


def broadcast_shapes(*shapes):
    return tuple(torch.broadcast_shapes(*shapes))


def broadcast_to(x, shape):
    if isinstance(x, StructuredArray):
        return x.broadcast_to(shape)
    if isinstance(x, numpy.ndarray):
        return numpy.broadcast_to(x, shape)
    return x.expand(tuple(shape))


def broadcast_arrays(*arrays):
    base = broadcast_shapes(*(tuple(a.shape) for a in arrays))
    return tuple(broadcast_to(a, base) for a in arrays)


def concatenate(arrays, axis=0):
    arrays = list(arrays)
    if not arrays:
        raise ValueError('need at least one array')
    if not isinstance(arrays[0], StructuredArray):
        return torch.cat(arrays, axis)
    names = arrays[0].fields
    if any(a.fields != names for a in arrays):
        raise ValueError('field mismatch in concatenate')
    return StructuredArray(
        {name: concatenate([a[name] for a in arrays], axis)
         for name in names}, arrays[0]._tails)


def unstructured_to_structured(x, dtype=None, names=None):
    """The last axis of ``x`` packed into named fields: ``names``
    (default 'f0', 'f1', ...), or the fields and tails of the numpy
    structured ``dtype``."""
    if not isinstance(x, torch.Tensor):
        x = _leaf(numpy.asarray(x), None, None)
    n = x.shape[-1]
    base = tuple(x.shape[:-1])
    if dtype is not None:
        dtype = numpy.dtype(dtype)
        fields, tails = {}, {}
        i = 0
        for name in dtype.names:
            ft = dtype.fields[name][0]
            tail = ft.shape if ft.subdtype is not None else ()
            size = math.prod(tail)
            fields[name] = x[..., i:i + size].reshape(base + tail)
            tails[name] = tail
            i += size
        if i != n:
            raise ValueError(f'dtype consumes {i} columns, array has {n}')
        return StructuredArray(fields, tails, base)
    if names is None:
        names = [f'f{i}' for i in range(n)]
    return StructuredArray({name: x[..., i] for i, name in enumerate(names)},
                           None, base)


def structured_to_unstructured(x, dtype=None):
    """All leaf fields (tails and nested fields included, in field order)
    flattened into a trailing axis."""
    cols = []

    def visit(v):
        if isinstance(v, StructuredArray):
            for name in v.fields:
                visit(v[name])
        else:
            cols.append(v.reshape(tuple(x.shape) + (-1,)))

    visit(x)
    if dtype is None:
        dtype = cols[0].dtype
        for c in cols[1:]:
            dtype = torch.promote_types(dtype, c.dtype)
    return torch.cat([c.to(dtype) for c in cols], -1)


def append_fields(base, names, data):
    """A new StructuredArray with the fields ``names`` (one name, or a
    list) of values ``data`` appended."""
    if isinstance(names, str):
        names, data = [names], [data]
    out = base
    for name, v in zip(names, data):
        if name in out.fields:
            raise ValueError(f'field {name!r} already present')
        out = out.at[name].set(v)
    return out
