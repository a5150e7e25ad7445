"""Basic kernels: Constant, White and ExpQuad.

Counterpart of the same three kernels of ``lsqfitgp_tpu/kernels/_basic.py``;
the rest of the zoo waits.
"""

from __future__ import annotations

import torch

from ..kernelalg import isotropickernel, _fastgram, _util

__all__ = ['Constant', 'White', 'ExpQuad']


@isotropickernel(derivable=True, input='raw')
def Constant(x, y):
    r"""Constant kernel: k(x, y) = 1 (all points fully correlated)."""
    return torch.ones(torch.broadcast_shapes(x.shape, y.shape),
                      dtype=torch.get_default_dtype(), device=x.device)


@isotropickernel(derivable=False, input='raw')
def White(x, y):
    r"""White noise kernel: k(x, y) = 1 if x == y else 0."""
    return _util.prod_recurse_fields(lambda x, y: x == y, x, y).to(
        torch.get_default_dtype())


# White's instances carry a pure-noise fast-Gram spec
_fastgram.NOISE_CORES.append(White.__wrapped__)


@isotropickernel(derivable=True)
def ExpQuad(r2):
    r"""Exponential quadratic (squared-exponential / RBF) kernel:
    k(r) = exp(-r²/2)."""
    return torch.exp(-0.5 * r2)


# kernel C evaluates ExpQuad's profile (ops.PROFILES['expquad'])
_fastgram.GRAM_PROFILES[ExpQuad.__wrapped__] = 'expquad'
