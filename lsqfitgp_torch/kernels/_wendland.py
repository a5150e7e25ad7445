"""Compact-support kernels.

Counterpart of ``lsqfitgp_tpu/kernels/_wendland.py``.  Both cores carry
a CUDA profile: Wendland's k ∈ {0..3} rides the profile's static
integer and α its argument (the polynomial's coefficients, polynomials
in ν = k + α, are formed from it where the profile is evaluated).
"""

from __future__ import annotations

import math

import torch

from .. import _torchutil
from ..kernelalg import stationarykernel, isotropickernel, _fastgram
from ..ops._gram import WENDLAND_POLY, _polyval

__all__ = ['Wendland', 'Circular']


def _wendland_derivable(k=0, **_):
    return k


def _wendland_maxdim(k=0, alpha=1):
    if isinstance(alpha, torch.Tensor):
        alpha = float(alpha.detach())
    return int(math.floor(2 * alpha - 1))


@isotropickernel(input='posabs', derivable=_wendland_derivable,
                 maxdim=_wendland_maxdim)
def Wendland(r, k=0, alpha=1):
    r"""Wendland compact-support kernel: polynomial × (1-r)_+^{ν+k} with
    ν = k + α; zero for r ≥ 1; k ∈ {0..3} sets differentiability, usable
    up to ⌊2α-1⌋ dimensions."""
    def check():
        assert _wendland_maxdim(k, alpha) >= 1
    _torchutil.check(check)
    try:
        poly = WENDLAND_POLY[k]
    except KeyError:
        raise NotImplementedError(f'Wendland k={k} not implemented')
    nu = k + alpha
    coeffs = [_polyval(pj, nu) for pj in poly]
    polyval = torch.zeros_like(r)
    for c in coeffs:
        polyval = polyval * r + c
    # the base clamped at 0: outside the support (1 - r)^(ν + k) would be
    # nan, and so would its derivative under the where
    return torch.where(r < 1, torch.clamp(1 - r, min=0) ** (nu + k) * polyval,
                       torch.zeros_like(r))


def _wendland_gram(k=0, alpha=1):
    if not isinstance(k, int) or k not in WENDLAND_POLY:
        return None
    return 'wendland', k, (alpha,)


_fastgram.GRAM_PROFILES[Wendland.__wrapped__] = _wendland_gram


@stationarykernel(derivable=1, maxdim=1, input='posabs')
def Circular(delta, tau=4, c=1 / 2):
    r"""Circular kernel: periodic with period 1,
    W_c(t) = (1 + τt/c)(1 - t/c)_+^τ on geodesic distance."""
    def check():
        assert tau >= 4, tau
        assert 0 < c <= 1 / 2, c
    _torchutil.check(check)
    x = delta % 1
    t = torch.minimum(x, 1 - x)
    return (1 + tau * t / c) * torch.clamp(1 - t / c, min=0) ** tau


_fastgram.GRAM_PROFILES[Circular.__wrapped__] = \
    lambda tau=4, c=1 / 2: ('circular', 0, (tau, c))
