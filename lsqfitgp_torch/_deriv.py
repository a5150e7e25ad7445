"""Derivative specifications.

Counterpart of ``lsqfitgp_tpu/_deriv.py`` (``Deriv``): an
immutable multiset of (variable name, derivative order) pairs, plus an
"implicit" mode where the variable is unnamed (for unstructured inputs).
"""

from __future__ import annotations

import collections.abc

__all__ = ['Deriv']


class Deriv(collections.abc.Mapping):
    """A derivative specification: mapping variable name -> order.

    Accepted initializers (same surface as the reference):

    - ``None`` or ``0`` or ``()``: no derivative
    - ``int n``: n-th implicit derivative (unnamed variable)
    - ``str 'x'``: first derivative w.r.t. field 'x'
    - iterable mixing ints and strs: each int n multiplies the order of the
      following variable name, e.g. ``(2, 'x', 'y')`` = d²/dx² d/dy
    - ``dict {var: order}``
    - a ``Deriv`` (returned as-is)
    """

    __slots__ = ('_orders',)

    def __new__(cls, spec=None):
        if isinstance(spec, Deriv):
            return spec
        self = object.__new__(cls)
        orders = {}
        if spec is None:
            pass
        elif isinstance(spec, bool):
            raise TypeError('bool is not a valid deriv spec')
        elif isinstance(spec, int):
            if spec < 0:
                raise ValueError('negative derivative order')
            if spec:
                orders[None] = spec
        elif isinstance(spec, str):
            orders[spec] = 1
        elif isinstance(spec, dict):
            for k, v in spec.items():
                if not isinstance(v, int) or v < 0:
                    raise ValueError(f'invalid order {v!r} for {k!r}')
                if v:
                    orders[k] = orders.get(k, 0) + v
        elif isinstance(spec, collections.abc.Iterable):
            # an int acts as a multiplier for the next variable name;
            # consecutive or trailing ints are errors (reference
            # ``_Deriv.py:75-93`` semantics)
            pending = None
            for item in spec:
                if isinstance(item, str):
                    mult = 1 if pending is None else pending
                    if mult:
                        orders[item] = orders.get(item, 0) + mult
                    pending = None
                elif isinstance(item, int) and not isinstance(item, bool):
                    if item < 0:
                        raise ValueError('negative derivative order')
                    if pending is not None:
                        raise ValueError('consecutive integers in deriv spec')
                    pending = int(item)
                else:
                    raise TypeError(f'invalid deriv item {item!r}')
            if pending is not None:
                raise ValueError('dangling derivative order')
        else:
            raise TypeError(f'cannot interpret {spec!r} as Deriv')
        object.__setattr__(self, '_orders', dict(orders))
        return self

    def __setattr__(self, *_):
        raise AttributeError('Deriv is immutable')

    # Mapping interface -------------------------------------------------

    def __getitem__(self, key):
        return self._orders[key]

    def __iter__(self):
        return iter(self._orders)

    def __len__(self):
        return len(self._orders)

    # properties ---------------------------------------------------------

    @property
    def implicit(self):
        """True if the only variable is unnamed (or there is no derivative)."""
        return set(self._orders) <= {None}

    @property
    def order(self):
        """Total derivative order."""
        return sum(self._orders.values())

    @property
    def max(self):
        """Maximum single-variable order."""
        return max(self._orders.values(), default=0)

    def __bool__(self):
        return bool(self._orders)

    def __eq__(self, other):
        if isinstance(other, Deriv):
            return self._orders == other._orders
        return NotImplemented

    def __hash__(self):
        return hash(frozenset(self._orders.items()))

    def __repr__(self):
        return f'Deriv({self._orders!r})'
