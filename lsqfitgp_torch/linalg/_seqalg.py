"""Row-sequential O(n)-memory algorithm framework.

Counterpart of ``lsqfitgp_tpu/linalg/_seqalg.py``: operations that
consume a matrix one row at a time, composed into one loop, bounding
memory to O(n) per operation, for structured matrices whose rows are
made on the fly (e.g. Toeplitz).  The JAX package runs the loop under
``lax.fori_loop``; here it is a Python loop on the rows' device, with
the states updated out of place so that autograd sees every step.
"""

from __future__ import annotations

import abc

import torch

from ._toeplitz import _float

__all__ = [
    'SequentialOperation', 'Producer', 'Consumer',
    'Rows', 'ToeplitzRows', 'MatMulRowByFull', 'SolveTriLowerColByFull',
    'SumLogDiag', 'Stack', 'sequential_algorithm',
]


def _set(state, i, value):
    """``state`` with row i replaced by ``value``, out of place."""
    out = state.clone()
    out[i] = value
    return out


class SequentialOperation(abc.ABC):
    """One step of a row-sequential computation.

    Subclasses define ``init(n) -> state``, ``iter(i, state, *inputs) ->
    state`` and ``finalize(state) -> value``; ``inputs`` lists the
    operations of the pipeline whose row outputs this one consumes.
    """

    inputs = ()

    @abc.abstractmethod
    def init(self, n):
        ...

    @abc.abstractmethod
    def iter(self, i, state, *inputs):
        ...

    def output(self, state):
        """Per-row output visible to downstream operations."""
        return None

    def finalize(self, state):
        return None


class Producer(SequentialOperation):
    """Operation producing a row per iteration, no final output."""


class Consumer(SequentialOperation):
    """Operation consuming rows and producing a final value."""


class Rows(Producer):
    """Produce the rows of a dense matrix."""

    def __init__(self, m):
        self.m = _float(m)

    def init(self, n):
        return self.m.new_zeros(self.m.shape[1])

    def iter(self, i, state):
        return self.m[i]

    def output(self, state):
        return state


class ToeplitzRows(Producer):
    """Produce the rows of a symmetric Toeplitz matrix from its first
    row, without forming the matrix."""

    def __init__(self, t):
        self.t = _float(t)

    def init(self, n):
        return self.t.new_zeros(self.t.shape[0])

    def iter(self, i, state):
        idx = (torch.arange(self.t.shape[0], device=self.t.device) - i).abs()
        return self.t[idx]

    def output(self, state):
        return state


class MatMulRowByFull(Consumer):
    """Accumulate A @ B consuming A row by row (A from the input op)."""

    def __init__(self, input_op, b):
        self.inputs = (input_op,)
        self.b = _float(b)

    def init(self, n):
        return self.b.new_zeros((n, self.b.shape[1]))

    def iter(self, i, state, row):
        return _set(state, i, row @ self.b)

    def finalize(self, state):
        return state


class SolveTriLowerColByFull(Consumer):
    """Forward substitution L⁻¹ B with L's rows produced one by one (the
    entries above the diagonal meet rows of the solution not yet
    computed, which are zero)."""

    def __init__(self, input_op, b):
        self.inputs = (input_op,)
        self.b = _float(b)

    def init(self, n):
        return torch.zeros_like(self.b)

    def iter(self, i, state, row):
        # x_i = (b_i - L[i,:i] x[:i]) / L[i,i]
        partial = row @ state
        xi = (self.b[i] - partial + row[i] * state[i]) / row[i]
        return _set(state, i, xi)

    def finalize(self, state):
        return state


class SumLogDiag(Consumer):
    """Σ log diag of the input rows (e.g. log det of a Cholesky)."""

    def __init__(self, input_op):
        self.inputs = (input_op,)

    def init(self, n):
        return 0.0

    def iter(self, i, state, row):
        return state + torch.log(row[i])

    def finalize(self, state):
        return state


class Stack(Consumer):
    """Collect the input rows into a dense matrix."""

    def __init__(self, input_op):
        self.inputs = (input_op,)

    def init(self, n):
        return []

    def iter(self, i, state, row):
        return state + [row]

    def finalize(self, state):
        return torch.stack(state)


def sequential_algorithm(n, ops):
    """Run a pipeline of sequential operations for n rows in one loop;
    returns the tuple of finalized values."""
    ops = list(ops)
    states = [op.init(n) for op in ops]
    for i in range(n):
        outputs = {}
        for k, op in enumerate(ops):
            ins = [outputs[id(o)] for o in op.inputs]
            states[k] = op.iter(i, states[k], *ins)
            outputs[id(op)] = op.output(states[k])
    return tuple(op.finalize(s) for op, s in zip(ops, states))
