"""Celerite-family kernels (damped oscillators).

Counterpart of ``lsqfitgp_tpu/kernels/_celerite.py``.  Both cores carry
a CUDA profile (kernels C, D and E evaluate them on the card): the
resolvers below map the constructor's arguments to it.
"""

from __future__ import annotations

import math

import torch

from .. import _torchutil
from ..kernelalg import stationarykernel, _fastgram
from ..kernelalg._stationary import _abs
from ._basic import _static

__all__ = ['Celerite', 'Harmonic']


def _celerite_derivable(**kw):
    # derivable only on the measure-zero ridge B == gamma; a dynamic
    # parameter sits at a generic value: not derivable
    gamma = kw.get('gamma', 1)
    B = kw.get('B', 0)
    return 1 if _static(gamma) and _static(B) and B == gamma else False


@stationarykernel(derivable=_celerite_derivable, input='abs', maxdim=1)
def Celerite(delta, gamma=1, B=0):
    r"""Celerite kernel: k(Δ) = exp(-γ|Δ|)(cos Δ + B sin |Δ|), |B| ≤ γ.
    Covariance of an AR(2) process with complex roots (Foreman-Mackey et
    al.)."""
    def check():
        assert 0 <= gamma < math.inf, gamma
        assert abs(B) <= gamma, (B, gamma)
    _torchutil.check(check)
    return torch.exp(-gamma * delta) * (torch.cos(delta)
                                        + B * torch.sin(delta))


_fastgram.GRAM_PROFILES[Celerite.__wrapped__] = \
    lambda gamma=1, B=0: ('celerite', 0, (gamma, B))


class _Matern32(torch.autograd.Function):
    """(1 + x) e^{-x} with the derivative -x e^{-x} (the JAX custom JVP):
    plain torch of the saved x, so it differentiates again."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        ctx.save_for_forward(x)
        return (1 + x) * torch.exp(-x)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        return g * -x * torch.exp(-x)

    @staticmethod
    def jvp(ctx, dx):
        x, = ctx.saved_tensors
        return dx * -x * torch.exp(-x)


def _matern32(x):
    return _Matern32.apply(x)


def _harmonic_q1(x, Q):
    # continuous in Q around Q = 1, by the Matérn-3/2 profile
    return _matern32(x / Q) + torch.exp(-x / Q) * (1 - Q) * x * x * (
        1 + x / 3)


@stationarykernel(derivable=1, maxdim=1)
def Harmonic(delta, Q=1):
    r"""Damped stochastically-driven harmonic oscillator kernel; solution
    of f'' + 2/Q f' + f = white noise.  Q-regime branches keep the
    expression numerically stable and once-derivable, including the Q=1
    Matérn-3/2 limit."""
    def check():
        assert 0 < Q < math.inf, Q
    _torchutil.check(check)

    tau = _abs(delta)

    if isinstance(Q, (int, float)):
        # a static Q picks its branch; the near-1 window in the working
        # dtype (|Q − 1| < √eps: there sqrt(Q² − 1) would collapse to 0)
        # takes the first-order-in-(1 − Q) Matérn-3/2 formulation
        dt = torch.promote_types(tau.dtype, torch.float32)
        if abs(Q - 1) < math.sqrt(torch.finfo(dt).eps):
            return _harmonic_q1(tau, Q)
        if Q < 1 / 2:
            etaQ = math.sqrt((1 - Q) * (1 + Q))
            tauQ = tau / Q
            pexp = torch.exp(math.expm1(0.5 * math.log1p(-Q * Q)) * tauQ)
            mexp = torch.exp(-(1 + etaQ) * tauQ)
            return (pexp + mexp + (pexp - mexp) / etaQ) / 2
        elif Q < 1:
            etaQ = math.sqrt(1 - Q * Q)
            tauQ = tau / Q
            etatau = etaQ * tauQ
            return torch.exp(-tauQ) * (torch.cosh(etatau)
                                       + torch.sinh(etatau) / etaQ)
        else:
            etaQ = math.sqrt(Q * Q - 1)
            tauQ = tau / Q
            etatau = etaQ * tauQ
            return torch.exp(-tauQ) * (torch.cos(etatau)
                                       + torch.sin(etatau) / etaQ)

    # a tensor Q: every branch evaluated, the where picks
    Q = torch.as_tensor(Q, device=tau.device)
    tauQ = tau / Q
    eps = torch.finfo(tauQ.dtype).eps
    safe_lo = torch.clamp(Q, max=1 - eps)
    eta_lo = torch.sqrt((1 - safe_lo) * (1 + safe_lo))
    lo = torch.exp(-tauQ) * (
        torch.cosh(eta_lo * tauQ) + torch.sinh(eta_lo * tauQ) / eta_lo)
    safe_hi = torch.clamp(Q, min=1 + eps)
    eta_hi = torch.sqrt(safe_hi * safe_hi - 1)
    hi = torch.exp(-tau / safe_hi) * (
        torch.cos(eta_hi * tau / safe_hi)
        + torch.sin(eta_hi * tau / safe_hi) / eta_hi)
    mid = _harmonic_q1(tau, Q)
    near1 = (Q - 1).abs() < math.sqrt(eps)
    return torch.where(near1, mid, torch.where(Q < 1, lo, hi))


def _harmonic_gram(Q=1):
    # one profile for every form: the device evaluates the branch the
    # value of Q and the working dtype select (the JAX package's static
    # and dynamic forms are the same functions on each side of 1; its
    # static Q < 1/2 and 1/2 <= Q < 1 branches are two expressions of
    # one function); its overflow-free expressions in ops.PROFILES
    return 'harmonic', 0, (Q,)


_fastgram.GRAM_PROFILES[Harmonic.__wrapped__] = _harmonic_gram
