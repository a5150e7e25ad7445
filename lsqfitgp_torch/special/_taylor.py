"""Taylor-series evaluator with exact derivative chaining.

Counterpart of ``lsqfitgp_tpu/special/_taylor.py``: the JAX custom JVP
rule, which calls the series again one derivative order higher, as a
`torch.autograd.Function`, so derivatives of any order are themselves
truncated series.
"""

from __future__ import annotations

import torch

from ._expint import _float

__all__ = ['taylor']


def _taylor_value(coefgen, args, n, m, x):
    c = torch.as_tensor(coefgen(n, n + m, *args), dtype=x.dtype,
                        device=x.device)
    k = torch.arange(n, n + m, dtype=x.dtype, device=x.device)
    c = c * torch.exp(torch.lgamma(1 + k) - torch.lgamma(1 + k - n))
    out = torch.zeros_like(x)
    for ck in c.flip(0):
        out = out * x + ck
    return out


class _Taylor(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, coefgen, args, n, m):
        ctx.save_for_backward(x)
        ctx.save_for_forward(x)
        ctx.spec = coefgen, args, n, m
        return _taylor_value(coefgen, args, n, m, x)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        coefgen, args, n, m = ctx.spec
        return g * taylor(coefgen, args, n + 1, m, x), None, None, None, None

    @staticmethod
    def jvp(ctx, t, *_):
        x, = ctx.saved_tensors
        coefgen, args, n, m = ctx.spec
        return t * taylor(coefgen, args, n + 1, m, x)


def taylor(coefgen, args, n, m, x):
    """Evaluate the n-th derivative of the series with coefficients
    ``coefgen(start, end, *args)`` (powers start..end-1), using m terms:

    d^n/dx^n Σ_k c_k x^k = Σ_k c_{k} k!/(k−n)! x^{k−n}.
    """
    return _Taylor.apply(_float(x), coefgen, args, n, m)
