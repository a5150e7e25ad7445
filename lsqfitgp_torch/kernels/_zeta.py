"""Zeta kernel and its Fourier-domain linop family.

Counterpart of ``lsqfitgp_tpu/kernels/_zeta.py``: the Zeta kernel is
the prior of a zero-mean Fourier series of period 1 with coefficient
variances 1/(ζ(s) k^s), s = 1 + 2ν; the registered ``'fourier'`` linop
family maps the process to its Fourier coefficients
(``ZetaFourier``/``CrossZetaFourier``), for inference directly in the
coefficient domain.  Built on `AffineSpan` so accumulated loc/scale
transforms are known to the transformed-domain kernels.  No CUDA
profile, as the JAX package has no fast-Gram spec for it: the Gram is
the broadcast core's, `special.periodic_zeta` on the n × m differences.
"""

from __future__ import annotations

import math

import torch

from .. import _torchutil
from ..kernelalg import (
    AffineSpan, CrossKernel, PreservedBySwap, StationaryKernel,
    crosskernel, kernel,
)
from ..special import periodic_zeta, zeta_real

__all__ = ['Zeta', 'ZetaFourier', 'CrossZetaFourier']


def _check_nu(nu):
    def check():
        assert bool(0 <= nu) and bool(nu < math.inf), nu
    _torchutil.check(check)


def _zeta_derivable(*, nu):
    _check_nu(nu)
    try:
        return int(max(0, math.ceil(float(nu)) - 1))
    except (TypeError, ValueError):
        return None


@crosskernel(bases=(AffineSpan, StationaryKernel), maxdim=1,
             derivable=_zeta_derivable)
def Zeta(delta, *, nu, **_):
    r"""Zeta kernel: k(Δ) = Re F(Δ, s)/ζ(s), s = 1 + 2ν ≥ 1.

    Equivalent to a Fourier series of period 1 with independent
    zero-mean priors of variance 1/(ζ(s) k^s) on the k-th pair of
    coefficients; ⌈ν⌉−1 times derivable.  The k = 0 term is excluded,
    so the process has zero mean over one period."""
    _check_nu(nu)
    s = 1 + 2 * nu
    zero = lambda: torch.where(delta % 1 != 0, 0.0, 1.0).to(delta.dtype)
    if not isinstance(nu, torch.Tensor):
        # a static order: one branch
        return periodic_zeta(delta, s) / zeta_real(s) if s > 1 else zero()
    return torch.where(s > 1, periodic_zeta(delta, s) / zeta_real(s),
                       zero())


@kernel(maxdim=1, derivable=False)
def ZetaFourier(k, q, *, nu, lloc, rloc, lscale, rscale, offset, ampl):
    r"""Prior covariance of the Fourier coefficients of a Zeta process:
    diagonal with variance ampl/(ζ(s)·order^s); accounts for the
    accumulated affine transformations of the process.

    Coefficient indexing: even k ≥ 2 ↔ cos(2π(k/2)x) terms, odd
    k ↔ sin(2π((k+1)/2)x) terms, k = 0 ↔ the offset."""
    _check_nu(nu)
    s = 1 + 2 * nu
    lorder = torch.ceil(k / 2)
    rorder = torch.ceil(q / 2)
    lodd = k % 2
    rodd = q % 2
    var = ampl / (lorder ** s * zeta_real(s))
    arg = 2 * math.pi * lorder * (lloc / lscale - rloc / rscale)
    return torch.where(
        lorder == rorder,
        torch.where(
            lodd == rodd,
            torch.where(lorder != 0, var * torch.cos(arg), offset),
            var * torch.sin(arg) * torch.where(lodd != 0, 1.0, -1.0),
        ),
        0.0,
    )


def _crosszeta_derivable(*, nu, **_):
    return 0, _zeta_derivable(nu=nu)


@crosskernel(bases=(PreservedBySwap, CrossKernel), maxdim=1,
             derivable=_crosszeta_derivable)
def CrossZetaFourier(k, y, *, nu, lloc, rloc, lscale, rscale, offset, ampl):
    r"""Cross covariance between the Fourier coefficients and the Zeta
    process itself."""
    _check_nu(nu)
    s = 1 + 2 * nu
    order = torch.ceil(k / 2)
    odd = k % 2
    var = ampl / (order ** s * zeta_real(s))
    arg = 2 * math.pi * order * (lloc / lscale + (y - rloc) / rscale)
    return torch.where(
        odd != 0,
        var * torch.sin(arg),
        torch.where(order != 0, var * torch.cos(arg), offset),
    )


def _fourier_argparser(do):
    return do if do else None


def _translkw(*, dynkw, **initkw):
    return dict(**dynkw, **initkw)


Zeta.make_linop_family(
    'fourier', ZetaFourier, CrossZetaFourier,
    translkw=_translkw, argparser=_fourier_argparser,
    doc="""Fourier-series transform of the process: T(f)(k) are the
cosine (even k) / sine (odd k) coefficients of the period-1 series.""",
)
