"""BufferDict: a dict packed into one flat buffer, with transformed keys.

Counterpart of ``lsqfitgp_tpu/uncert/_bufferdict.py``.  A key like
``'log(sigma)'`` stores the variable ``log(sigma)`` in the buffer;
reading ``bd['sigma']`` applies the inverse transformation (``exp``).
Transformations are registered with `add_distribution`; 'log', 'sqrt'
and 'erfinv' are predefined.  The buffer holds a tensor or a `UArray`.
"""

from __future__ import annotations

import re

import torch

from .. import _torchutil
from ._uarray import UArray, uconcatenate

__all__ = ['BufferDict', 'add_distribution', 'has_distribution',
           'bufferdict_from_numpy']

_distributions = {}


def add_distribution(name, invfcn, *, derivative=None):
    """Register a transformation: a key ``'name(x)'`` stores ``v`` and
    ``bd['x']`` returns ``invfcn(v)`` (a torch function)."""
    if not re.fullmatch(r'[A-Za-z_][\w.]*', name):
        raise ValueError(f'invalid distribution name {name!r}')
    _distributions[name] = (invfcn, derivative)


def has_distribution(name):
    return name in _distributions


add_distribution('log', torch.exp)
add_distribution('sqrt', torch.square)
add_distribution('erfinv', torch.special.erf)

_KEYPAT = re.compile(r'^([A-Za-z_][\w.]*)\((.+)\)$')


def _parse_key(key):
    """Return (transf_name, inner_key) or (None, key)."""
    if isinstance(key, str):
        m = _KEYPAT.match(key)
        if m and m.group(1) in _distributions:
            return m.group(1), m.group(2)
    return None, key


def _apply_inv(name, v):
    invfcn, _ = _distributions[name]
    if isinstance(v, UArray):
        # first-order propagation J_out = (df/dv) J, one jvp per column
        push = lambda t: torch.func.jvp(invfcn, (v.mean,), (t,))[1]
        jac = {k: torch.func.vmap(push, in_dims=-1, out_dims=-1)(J)
               for k, J in v.jac.items()}
        return UArray(invfcn(v.mean), jac)
    return invfcn(v)


class BufferDict:
    """Ordered dict of arrays packed in one flat buffer."""

    def __init__(self, data=None, *, keys=None, shapes=None, buf=None):
        if data is not None:
            self._keys = []
            self._shapes = []
            vals = []
            for k, v in dict(data).items():
                if not isinstance(v, UArray):
                    v = _torchutil.asarray(v)
                self._keys.append(k)
                self._shapes.append(tuple(v.shape))
                vals.append(v.reshape(-1))
            if any(isinstance(v, UArray) for v in vals):
                self._buf = uconcatenate(vals)
            else:
                self._buf = torch.cat(vals) if vals else torch.zeros(0)
        else:
            self._keys = list(keys)
            self._shapes = [tuple(s) for s in shapes]
            self._buf = buf
        self._slices = {}
        i = 0
        for k, s in zip(self._keys, self._shapes):
            n = 1
            for d in s:
                n *= d
            self._slices[k] = (slice(i, i + n), s)
            i += n

    # -- mapping interface ----------------------------------------------------

    def __contains__(self, key):
        if key in self._slices:
            return True
        for stored in self._keys:
            name, inner = _parse_key(stored)
            if name is not None and inner == key:
                return True
        return False

    def __getitem__(self, key):
        if key in self._slices:
            sl, shape = self._slices[key]
            return self._buf[sl].reshape(shape)
        for stored in self._keys:
            name, inner = _parse_key(stored)
            if name is not None and inner == key:
                return _apply_inv(name, self[stored])
        raise KeyError(key)

    def __iter__(self):
        return iter(self._keys)

    def __len__(self):
        return len(self._keys)

    def keys(self):
        return list(self._keys)

    def values(self):
        return [self[k] for k in self._keys]

    def items(self):
        return [(k, self[k]) for k in self._keys]

    @property
    def buf(self):
        return self._buf

    def replace_buf(self, buf):
        """New BufferDict with the same layout and a different buffer."""
        return BufferDict(keys=self._keys, shapes=self._shapes, buf=buf)

    def __repr__(self):
        inner = ', '.join(f'{k!r}: {self[k]!r}' for k in self._keys)
        return f'BufferDict({{{inner}}})'


def bufferdict_from_numpy(arrays, *, dtype=None, device=None):
    """The port's BufferDict of plain tensors from a dict of numpy
    arrays (for example ``{k: numpy.asarray(v) for k, v in
    jax_bufferdict.items()}``), so that both packages can be run at the
    same hyperparameters.  Keys keep their transformation names."""
    return BufferDict({k: _torchutil.asarray(v, dtype=dtype, device=device)
                       for k, v in arrays.items()})
