"""Matérn-family kernels.

Counterpart of ``lsqfitgp_tpu/kernels/_matern.py``: `Maternp`
(half-integer order, the closed-form polynomial; kernels C, D and E
evaluate it on the card for a static p up to ``ops.MATERNP_MAX``), the
real-ν `Matern` and `Bessel` (special functions of real order; kernels
C, D and E evaluate them for a static ν, the profiles 'matern' and
'bessel', whose order rides the term's argument slot without a
gradient).
"""

from __future__ import annotations

import math

import torch

from .. import _torchutil
from ..kernelalg import isotropickernel, _fastgram
from ..special import kvmodx2_hi, kvmodx2, jvmodx2

__all__ = ['Maternp', 'Matern', 'Bessel']


def _maternp_derivable(p=None):
    return p


@isotropickernel(derivable=_maternp_derivable)
def Maternp(r2, p=None):
    r"""Matérn kernel of half-integer order ν = p + 1/2:

    k(r) = exp(-x) p!/(2p)! Σ_{i=0}^p (p+i)!/(i!(p-i)!) (2x)^{p-i},
    x = sqrt(2ν) r.

    Derivable p times.
    """
    def check():
        assert int(p) == p and p >= 0, p
    _torchutil.check(check)
    return kvmodx2_hi((2 * p + 1) * r2, int(p))


def _maternp_gram(p=None):
    from ..ops import MATERNP_MAX
    if isinstance(p, torch.Tensor) or p is None or int(p) != p \
            or not 0 <= p <= MATERNP_MAX:
        # a dynamic or larger order: no CUDA profile (ops.MATERNP_MAX)
        return None
    return 'maternp', int(p), ()


_fastgram.GRAM_PROFILES[Maternp.__wrapped__] = _maternp_gram


def _matern_derivable(nu=None):
    try:
        return int(max(0, math.ceil(float(nu)) - 1))
    except (TypeError, ValueError):
        return None


@isotropickernel(derivable=_matern_derivable)
def Matern(r2, nu=None):
    r"""Matérn kernel of real order ν ≥ 0:
    k(r) = 2^{1-ν}/Γ(ν) x^ν K_ν(x), x = √(2ν) r.
    ⌈ν⌉−1 times derivable."""
    def check():
        assert 0 <= nu < math.inf, nu
    _torchutil.check(check)
    return kvmodx2(nu, 2 * (nu if nu else 1) * r2)


def _bessel_derivable(nu=0):
    try:
        return int(float(nu) // 2)
    except (TypeError, ValueError):
        return None


def _bessel_maxdim(nu=0):
    try:
        return 2 * int(math.floor(float(nu)) + 1)
    except (TypeError, ValueError):
        return None


def _static_order(name):
    """The resolver of a real-order core: a static ν gives the profile
    ``name`` with ν as its argument; a tensor ν takes the broadcast
    path (the JAX package's special functions take a concrete order)."""
    def resolve(nu=None):
        if nu is None or isinstance(nu, torch.Tensor):
            return None
        return name, 0, (float(nu),)
    return resolve


_fastgram.GRAM_PROFILES[Matern.__wrapped__] = _static_order('matern')


@isotropickernel(derivable=_bessel_derivable, maxdim=_bessel_maxdim)
def Bessel(r2, nu=0):
    r"""Bessel kernel: k(r) = Γ(ν+1) 2^ν (sr)^{-ν} J_ν(sr), s = 2 + ν/2;
    usable up to 2(⌊ν⌋+1) dimensions, ⌊ν/2⌋ times derivable."""
    def check():
        assert 0 <= nu < math.inf, nu
    _torchutil.check(check)
    return jvmodx2(nu, r2 * (2 + nu / 2) ** 2)


_fastgram.GRAM_PROFILES[Bessel.__wrapped__] = _static_order('bessel')
