"""Band-limited and power-law spectrum kernels.

Counterpart of ``lsqfitgp_tpu/kernels/_spectral.py``.  Each kernel
carries a CUDA profile: kernels C, D and E evaluate `Pink` (two cosine
integrals, δω an argument) and `Color` (Re E_n(−iΔ) by its series and
continued fraction, n the static integer) on the card, as `Cos` and
`Sinc`.
"""

from __future__ import annotations

import torch

from ..kernelalg import stationarykernel, _fastgram
from ..special import ci, expn_imag_real

__all__ = ['Cos', 'Pink', 'Color', 'Sinc']


@stationarykernel(derivable=True, maxdim=1)
def Cos(delta):
    r"""Cosine kernel: k(Δ) = cos(Δ); samples are harmonic functions."""
    return torch.cos(delta)


_fastgram.GRAM_PROFILES[Cos.__wrapped__] = 'cos'


@stationarykernel(maxdim=1, derivable=1, input='abs')
def Pink(delta, dw=1):
    r"""Pink-noise kernel: spectrum 1/ω truncated to [1, 1+δω]:
    k(Δ) = (Ci(Δ(1+δω)) - Ci(Δ)) / log1p(δω)."""
    l = ci(delta)
    r = ci(delta * (1 + dw))
    mean = delta * (1 + dw / 2)
    norm = torch.log1p(torch.as_tensor(dw, dtype=delta.dtype,
                                       device=delta.device))
    tol = torch.finfo(torch.get_default_dtype()).eps ** 0.5
    return torch.where(delta * dw < tol, torch.cos(mean), (r - l) / norm)


_fastgram.GRAM_PROFILES[Pink.__wrapped__] = lambda dw=1: ('pink', 0, (dw,))


def _color_derivable(n=2):
    return n // 2 - 1


@stationarykernel(maxdim=1, derivable=_color_derivable, input='abs')
def Color(delta, n=2):
    r"""Colored-noise kernel: spectrum 1/ωⁿ truncated below ω=1:
    k(Δ) = (n-1) Re Eₙ(-iΔ), integer n ≥ 2."""
    assert int(n) == n and n >= 2, n
    return (n - 1) * expn_imag_real(int(n), delta)


def _color_gram(n=2):
    if isinstance(n, torch.Tensor) or int(n) != n or n < 2:
        return None
    return 'color', int(n), ()


_fastgram.GRAM_PROFILES[Color.__wrapped__] = _color_gram


@stationarykernel(derivable=True, input='posabs', maxdim=1)
def Sinc(delta):
    r"""Sinc kernel: k(Δ) = sin(πΔ)/(πΔ) (Tobar 2019)."""
    return torch.sinc(delta)


_fastgram.GRAM_PROFILES[Sinc.__wrapped__] = 'sinc'
