"""Algebraic (PSD-preserving) operations on kernels.

Counterpart of ``lsqfitgp_tpu/kernelalg/_alg.py``: ``add``, ``mul``,
``pow``, ``rpow``, the ufunc algops (functions with nonnegative Taylor
coefficients, which map PSD kernels to PSD kernels) and the
`AffineSpan` overrides of the scalar ``add`` and ``mul``.  A scalar
``mul``/``add`` extends the tiled-Gram spec's post chain, so ``amp *
ExpQuad(...)`` keeps the kernel-C dispatch; a kernel sum combines the
specs (`_fastgram.add_specs`); every other operation drops the spec.
"""

from __future__ import annotations

import functools

import torch

from ..special._exp import expm1x
from . import _fastgram, _util
from ._core import CrossKernel, AffineSpan


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


@CrossKernel.register_algop
def pow(tcls, self, *, exponent):
    r"""Power of the kernel, nonnegative integer exponent."""
    if _util.is_nonnegative_integer_scalar(exponent):
        core = self.core
        return self._clone(core=lambda x, y, **kw: core(x, y, **kw)
                           ** exponent)
    return NotImplemented


@CrossKernel.register_algop
def rpow(tcls, self, *, base):
    r"""Exponentiation base**kernel(x, y), base >= 1."""
    if _util.is_scalar_cond_trueontracer(base, lambda v: v >= 1):
        core = self.core
        return self._clone(core=lambda x, y, **kw: base
                           ** core(x, y, **kw))
    return NotImplemented


# functions with nonnegative Taylor coefficients: map PSD -> PSD
CrossKernel.register_ufuncalgop(torch.tan)
CrossKernel.register_ufuncalgop(lambda x: 1 / torch.cos(x), '1/cos')
CrossKernel.register_ufuncalgop(torch.arcsin)
CrossKernel.register_ufuncalgop(lambda x: 1 / torch.arccos(x), '1/arccos')
CrossKernel.register_ufuncalgop(lambda x: 1 / (1 - x), '1/(1-x)')
CrossKernel.register_ufuncalgop(torch.exp)
CrossKernel.register_ufuncalgop(lambda x: -torch.log1p(-x), '-log1p(-x)')
CrossKernel.register_ufuncalgop(torch.expm1)
CrossKernel.register_ufuncalgop(expm1x)
CrossKernel.register_ufuncalgop(torch.sinh)
CrossKernel.register_ufuncalgop(torch.cosh)
CrossKernel.register_ufuncalgop(torch.arctanh)
CrossKernel.register_ufuncalgop(torch.special.i0, 'i0')
CrossKernel.register_ufuncalgop(torch.special.i1, 'i1')


@functools.partial(AffineSpan.register_algop, transfname='add')
def _affine_add(tcls, self, other):
    new = AffineSpan.super_transf('add', self, other)
    if _util.is_numerical_scalar(other):
        dynkw = dict(self.dynkw)
        dynkw['offset'] = dynkw['offset'] + other
        return new._clone(self.__class__, dynkw=dynkw)
    return new


@functools.partial(AffineSpan.register_algop, transfname='mul')
def _affine_mul(tcls, self, other):
    new = AffineSpan.super_transf('mul', self, other)
    if _util.is_numerical_scalar(other):
        dynkw = dict(self.dynkw)
        dynkw['offset'] = other * dynkw['offset']
        dynkw['ampl'] = other * dynkw['ampl']
        return new._clone(self.__class__, dynkw=dynkw)
    return new
