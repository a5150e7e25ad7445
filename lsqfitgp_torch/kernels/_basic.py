"""Basic kernel zoo.

Counterpart of ``lsqfitgp_tpu/kernels/_basic.py``: the same covariance
functions in PyTorch, `BagOfWords` a host computation on strings.  The
isotropic cores that kernels C, D and E evaluate on the card register a
resolver in ``_fastgram.GRAM_PROFILES``: it maps the constructor's
arguments to a profile of ``ops.PROFILES``, its static integer and its
arguments, or to None (the broadcast path) where no CUDA profile takes
them.
"""

from __future__ import annotations

import collections
import math
import re

import numpy
import torch

from .. import _config, _torchutil
from ..kernelalg import (kernel, stationarykernel, isotropickernel,
                         _fastgram, _util)

__all__ = [
    'Constant', 'White', 'ExpQuad', 'Linear', 'GammaExp', 'NNKernel',
    'Gibbs', 'Periodic', 'Categorical', 'Rescaling', 'Expon', 'BagOfWords',
    'HoleEffect', 'Cauchy', 'CausalExpQuad', 'Decaying', 'Log', 'Taylor',
]


def _static(v):
    return not isinstance(v, torch.Tensor)


def _tiny(x):
    dtype = x.dtype if isinstance(x, torch.Tensor) and x.is_floating_point() \
        else torch.get_default_dtype()
    return torch.finfo(dtype).tiny


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


_fastgram.GRAM_PROFILES[ExpQuad.__wrapped__] = 'expquad'


def _dot(x, y):
    return _util.sum_recurse_fields(lambda x, y: x * y, x, y)


@kernel(derivable=True)
def Linear(x, y):
    r"""Dot-product kernel: k(x, y) = x · y."""
    return _dot(x, y)


@isotropickernel(derivable=lambda gamma=1: _static(gamma) and gamma == 2)
def GammaExp(r2, gamma=1):
    r"""Gamma exponential kernel: k(r) = exp(-r^γ), γ ∈ (0, 2]."""
    def check():
        assert 0 < gamma <= 2, gamma
    _torchutil.check(check)
    # the γ = 2 branch apart: d²/dr2² of r2^(γ/2) at 0 is nan for a
    # floating γ even at γ = 2; a static γ = 2 emits only the smooth
    # branch.  The tiny offset keeps d/dr2 finite at r2 = 0 for γ < 2.
    if _static(gamma) and gamma == 2:
        return torch.exp(-r2)
    nondiff = torch.exp(-((r2 + _tiny(r2)) ** (gamma / 2)))
    return torch.where(torch.as_tensor(gamma == 2, device=r2.device),
                       torch.exp(-r2), nondiff)


def _gammaexp_gram(gamma=1):
    if _static(gamma) and gamma == 2:
        return 'gammaexp2', 0, ()
    return 'gammaexp', 0, (gamma,)


_fastgram.GRAM_PROFILES[GammaExp.__wrapped__] = _gammaexp_gram


@kernel(derivable=True)
def NNKernel(x, y, sigma0=1):
    r"""Neural-network kernel (infinite hidden layer, erf response):
    k(x,y) = 2/π asin(2(q + x·y) / ((1+2(q+x·x))(1+2(q+y·y)))), q=σ₀²."""
    def check():
        assert 0 < sigma0 < math.inf
    _torchutil.check(check)
    bias2 = sigma0 ** 2
    gxy = bias2 + _dot(x, y)
    gxx = bias2 + _dot(x, x)
    gyy = bias2 + _dot(y, y)
    return 2 / math.pi * torch.asin(2 * gxy / ((1 + 2 * gxx) * (1 + 2 * gyy)))


@kernel
def Gibbs(x, y, scalefun=lambda x: 1):
    r"""Gibbs kernel: a Gaussian kernel with pointwise-varying scale
    s = scalefun(x)."""
    sx = torch.as_tensor(scalefun(x))
    sy = torch.as_tensor(scalefun(y))
    def check():
        assert bool((sx > 0).all())
        assert bool((sy > 0).all())
    _torchutil.check(check)
    ms2 = sx ** 2 + sy ** 2
    norm = torch.sqrt(2 * sx * sy / ms2)
    d2 = _util.sum_recurse_fields(lambda x, y: (x - y) ** 2, x, y)
    return norm * torch.exp(-d2 / ms2)


@stationarykernel(derivable=True, maxdim=1)
def Periodic(delta, outerscale=1):
    r"""Periodic Gaussian kernel: k(Δ) = exp(-2 (sin(Δ/2)/outerscale)²);
    period 2π under the default scale."""
    def check():
        assert 0 < outerscale < math.inf
    _torchutil.check(check)
    return torch.exp(-2 * (torch.sin(delta / 2) / outerscale) ** 2)


_fastgram.GRAM_PROFILES[Periodic.__wrapped__] = \
    lambda outerscale=1: ('periodic', 0, (outerscale,))


@kernel(derivable=False, maxdim=1)
def Categorical(x, y, cov=None):
    r"""Categorical kernel over integers 0..N-1: k(x, y) = cov[x, y]."""
    assert not x.is_floating_point() and not x.is_complex()
    cov = _torchutil.asarray(cov, device=x.device)
    assert cov.dim() == 2 and cov.shape[0] == cov.shape[1]
    def check():
        assert torch.allclose(cov, cov.T)
    _torchutil.check(check)
    return cov[x, y]


@kernel
def Rescaling(x, y, stdfun=None):
    r"""Outer-product kernel: k(x, y) = stdfun(x) stdfun(y); modulates the
    variance of other kernels."""
    if stdfun is None:
        stdfun = lambda x: torch.ones(x.shape, device=x.device)
    return stdfun(x) * stdfun(y)


@stationarykernel(derivable=False, input='abs', maxdim=1)
def Expon(delta):
    r"""Exponential kernel: k(Δ) = exp(-|Δ|) (Matérn 1/2 in 1D)."""
    return torch.exp(-delta)


_fastgram.GRAM_PROFILES[Expon.__wrapped__] = 'expon'

# word separators: whitespace and punctuation, the hyphen last in the
# class (written mid-class after ':' it would form a range)
_bow_regexp = re.compile(r'\s|[!«»"“”‘’/()\'?¡¿„‚<>,;.:–—-]')


@numpy.vectorize
def _bow(x, y):
    xbag = collections.Counter(_bow_regexp.split(x))
    ybag = collections.Counter(_bow_regexp.split(y))
    xbag[''] = 0
    ybag[''] = 0
    common = set(xbag) & set(ybag)
    return float(sum(xbag[k] * ybag[k] for k in common))


@kernel(derivable=False, maxdim=1)
def BagOfWords(x, y):
    r"""Bag-of-words kernel over strings: k(x, y) = Σ_w c_w(x) c_w(y).
    A host computation (strings are not device data); the result is a
    tensor on the default device."""
    return torch.as_tensor(_bow(x, y), dtype=torch.get_default_dtype(),
                           device=_config.default_device())


@stationarykernel(derivable=False, input='abs', maxdim=1)
def HoleEffect(delta):
    r"""Hole-effect kernel: k(Δ) = (1 - Δ) exp(-Δ)."""
    return (1 - delta) * torch.exp(-delta)


_fastgram.GRAM_PROFILES[HoleEffect.__wrapped__] = 'holeeffect'


def _cauchy_derivable(alpha=2, **_):
    # a dynamic α sits at a generic value: not derivable
    return _static(alpha) and alpha == 2


@isotropickernel(derivable=_cauchy_derivable)
def Cauchy(r2, alpha=2, beta=2):
    r"""Generalized Cauchy kernel: k(r) = (1 + r^α/β)^(-β/α),
    α ∈ (0, 2], β > 0 (rational quadratic for α=2)."""
    def check():
        assert 0 < alpha <= 2, alpha
        assert 0 < beta, beta
    _torchutil.check(check)
    if _static(alpha) and alpha == 2:
        power = r2
    else:
        power = torch.where(torch.as_tensor(alpha == 2, device=r2.device),
                            r2, (r2 + _tiny(r2)) ** (alpha / 2))
    return (1 + power / beta) ** (-beta / alpha)


def _cauchy_gram(alpha=2, beta=2):
    if _static(alpha) and alpha == 2:
        return 'cauchy2', 0, (beta,)
    return 'cauchy', 0, (alpha, beta)


_fastgram.GRAM_PROFILES[Cauchy.__wrapped__] = _cauchy_gram


@isotropickernel(derivable=lambda alpha=1: alpha == 0, input='posabs')
def CausalExpQuad(r, alpha=1):
    r"""Causal exponential quadratic kernel:
    k(r) = erfc(αr/4) exp(-r²/2)."""
    def check():
        assert alpha >= 0, alpha
    _torchutil.check(check)
    return torch.special.erfc(alpha / 4 * r) * torch.exp(-0.5 * r * r)


_fastgram.GRAM_PROFILES[CausalExpQuad.__wrapped__] = \
    lambda alpha=1: ('causalexpquad', 0, (alpha,))


@kernel(derivable=True, maxdim=1)
def Decaying(x, y, alpha=1):
    r"""Decaying kernel: k(x, y) = 1/(x + y + 1)^α for x, y ≥ 0."""
    def check():
        assert bool((x >= 0).all())
        assert bool((y >= 0).all())
    _torchutil.check(check)
    return 1 / (x + y + 1) ** alpha


@isotropickernel(derivable=False, input='posabs')
def Log(r):
    r"""Log kernel: k(r) = log1p(r)/r."""
    return torch.log1p(r) / r


_fastgram.GRAM_PROFILES[Log.__wrapped__] = 'log'


@kernel(derivable=True, maxdim=1)
def Taylor(x, y):
    r"""Taylor-series kernel: k(x, y) = Σ_k (xy)^k/(k!)² = I₀(2√(xy))."""
    from ..special import j0
    mul = x * y
    val = 2 * torch.sqrt(mul.abs())
    return torch.where(mul >= 0, torch.special.i0(val), j0(val))
