"""Random-walk family kernels.

Counterpart of ``lsqfitgp_tpu/kernels/_randomwalk.py``.  Only
`StationaryFracBrownian` carries a fast-Gram spec (a symmetric
stationary core: mode 'abs'); kernels C, D and E evaluate it on the card
as the profile 'sfb', with H an argument (dynamic when a tensor).  Its
core is the profile's value, which sums a series at large lags where
the JAX expression cancels (float32 loses the value there).  The other
kernels are not stationary and take the broadcast path, as in the JAX
package.
"""

from __future__ import annotations

import torch

from .. import _torchutil
from ..kernelalg import kernel, stationarykernel, _fastgram
from ..kernelalg._stationary import _abs

__all__ = [
    'Wiener', 'FracBrownian', 'WienerIntegral', 'OrnsteinUhlenbeck',
    'BrownianBridge', 'StationaryFracBrownian',
]


def _static(v):
    return not isinstance(v, torch.Tensor)


def _nonneg(*xs):
    def check():
        for x in xs:
            assert bool((x >= 0).all())
    _torchutil.check(check)


@kernel(derivable=False, maxdim=1)
def Wiener(x, y):
    r"""Wiener process kernel: k(x, y) = min(x, y), x, y ≥ 0."""
    _nonneg(x, y)
    return torch.minimum(x, y)


def _fracbrownian_derivable(H=1 / 2, K=1):
    # a tensor H or K sits at a generic value: not derivable
    return _static(H) and _static(K) and H == 1 and K == 1


@kernel(derivable=_fracbrownian_derivable, maxdim=1)
def FracBrownian(x, y, H=1 / 2, K=1):
    r"""Bifractional Brownian motion kernel:
    k(x, y) = ((|x|^{2H} + |y|^{2H})^K - |x-y|^{2HK}) / 2^K, H, K ∈ (0, 1]."""
    def check():
        assert 0 < H <= 1, H
        assert 0 < K <= 1, K
    _torchutil.check(check)
    H2 = 2 * H
    return 2.0 ** -K * ((_abs(x) ** H2 + _abs(y) ** H2) ** K
                        - _abs(x - y) ** (H2 * K))


# min and max whose derivative at ties goes wholly to one side, as the
# JAX package's custom JVPs (torch, like jnp, splits it in halves there,
# which breaks the positivity of the derivative kernels at ties)

def _reduce(g, like):
    return None if g is None else g.sum_to_size(like.shape)


class _Minimum(torch.autograd.Function):
    """min(x, y) with the tangent dx where x < y, else dy."""

    @staticmethod
    def forward(ctx, x, y):
        ctx.save_for_backward(x, y)
        ctx.save_for_forward(x, y)
        return torch.minimum(x, y)

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        lt = x < y
        zero = torch.zeros((), dtype=g.dtype, device=g.device)
        return (_reduce(torch.where(lt, g, zero), x),
                _reduce(torch.where(lt, zero, g), y))

    @staticmethod
    def jvp(ctx, dx, dy):
        x, y = ctx.saved_tensors
        return _select(x < y, dx, dy, x, y)


class _Maximum(torch.autograd.Function):
    """max(x, y) with the tangent dx where x >= y, else dy."""

    @staticmethod
    def forward(ctx, x, y):
        ctx.save_for_backward(x, y)
        ctx.save_for_forward(x, y)
        return torch.maximum(x, y)

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        ge = x >= y
        zero = torch.zeros((), dtype=g.dtype, device=g.device)
        return (_reduce(torch.where(ge, g, zero), x),
                _reduce(torch.where(ge, zero, g), y))

    @staticmethod
    def jvp(ctx, dx, dy):
        x, y = ctx.saved_tensors
        return _select(x >= y, dx, dy, x, y)


def _select(mask, dx, dy, x, y):
    """where(mask, dx, dy) with a missing tangent taken as zero."""
    dx = torch.zeros_like(x) if dx is None else dx
    dy = torch.zeros_like(y) if dy is None else dy
    return torch.where(mask, dx, dy)


def _minimum(x, y):
    return _Minimum.apply(x, y)


def _maximum(x, y):
    return _Maximum.apply(x, y)


@kernel(derivable=1, maxdim=1)
def WienerIntegral(x, y):
    r"""Integrated Wiener process kernel:
    k(x, y) = a²(b - a/3)/2 with a = min(x,y), b = max(x,y)."""
    _nonneg(x, y)
    a = _minimum(x, y)
    b = _maximum(x, y)
    return 0.5 * a ** 2 * (b - a / 3)


@kernel(derivable=False, maxdim=1)
def OrnsteinUhlenbeck(x, y):
    r"""Ornstein-Uhlenbeck (non-stationary start at 0):
    k(x, y) = exp(-|x-y|) - exp(-(x+y)), x, y ≥ 0."""
    _nonneg(x, y)
    return torch.exp(-_abs(x - y)) - torch.exp(-(x + y))


@kernel(derivable=False, maxdim=1)
def BrownianBridge(x, y):
    r"""Brownian bridge kernel: k(x, y) = min(x, y) - xy on [0, 1]."""
    def check():
        assert bool(((x >= 0) & (x <= 1)).all())
        assert bool(((y >= 0) & (y <= 1)).all())
    _torchutil.check(check)
    return torch.minimum(x, y) - x * y


def _sfb_derivable(H=1 / 2):
    return _static(H) and H == 1


@stationarykernel(derivable=_sfb_derivable, input='signed', maxdim=1)
def StationaryFracBrownian(delta, H=1 / 2):
    r"""Stationary fractional Brownian motion kernel:
    k(Δ) = (|Δ+1|^{2H} + |Δ-1|^{2H} - 2|Δ|^{2H})/2, H ∈ (0, 1].

    From |Δ| = 2 on, its binomial series (the profile 'sfb' of
    ``ops.PROFILES``): the three powers cancel to about H(2H−1)|Δ|^{2H−2},
    which the expression as written loses to rounding at large lags."""
    def check():
        assert 0 < H <= 1, H
    _torchutil.check(check)
    from ..ops._gram import _sfb_parts
    return _sfb_parts(_abs(delta), H, (0,))[0]


_fastgram.GRAM_PROFILES[StationaryFracBrownian.__wrapped__] = \
    lambda H=1 / 2: ('sfb', 0, (H,))
