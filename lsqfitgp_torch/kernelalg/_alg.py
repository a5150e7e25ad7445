"""Algebraic (PSD-preserving) operations on kernels: sum and product.

Counterpart of ``lsqfitgp_tpu/kernelalg/_alg.py`` (``add``, ``mul``).
A scalar ``mul``/``add`` extends the tiled-Gram spec's post chain, so
``amp * ExpQuad(...)`` keeps the kernel-C dispatch; a kernel sum
combines the specs (`_fastgram.add_specs`).  ``pow``, ``rpow`` and the
ufunc algops wait for the rest of the zoo.
"""

from __future__ import annotations

from . import _fastgram, _util
from ._core import CrossKernel


@CrossKernel.register_algop
def add(tcls, self, other):
    r"""Sum of kernels: newkernel(x, y) = kernel(x, y) + other(x, y)."""
    core = self.core
    if _util.is_numerical_scalar(other):
        new = self._clone(core=lambda x, y, **kw: core(x, y, **kw) + other)
        new._fastgram = _fastgram.post_spec(self._fastgram, 'add', other)
        return new
    if isinstance(other, CrossKernel):
        ocore = other.core
        new = self._clone(
            core=lambda x, y, **kw: core(x, y, **kw) + ocore(x, y, **kw))
        new._fastgram = _fastgram.add_specs(self._fastgram, other._fastgram)
        return new
    return NotImplemented


@CrossKernel.register_algop
def mul(tcls, self, other):
    r"""Product of kernels: newkernel(x, y) = kernel(x, y) * other(x, y)."""
    core = self.core
    if _util.is_numerical_scalar(other):
        new = self._clone(core=lambda x, y, **kw: core(x, y, **kw) * other)
        new._fastgram = _fastgram.post_spec(self._fastgram, 'mul', other)
        return new
    if isinstance(other, CrossKernel):
        ocore = other.core
        return self._clone(
            core=lambda x, y, **kw: core(x, y, **kw) * ocore(x, y, **kw))
    return NotImplemented
