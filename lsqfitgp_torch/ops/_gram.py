"""Tiled Gram-matrix evaluators for isotropic kernels (kernels C and E).

Counterpart of ``lsqfitgp_tpu/ops/_gram.py`` (``gram``, ``gram_sym``).
The Gram

    K[i, j] = post(g(‖x_i − y_j‖²)) (+ noise if i == j)

is evaluated by the hand-written CUDA kernels of ``csrc/gram.cu`` for
CUDA tensors and by their plain PyTorch versions, `gram_plain` and
`gram_sym_plain`, for CPU tensors.  Kernel C (`gram`) replaces
``lsqfitgp_tpu/ops/_gram.py::_gram_kernel``; kernel E (`gram_sym`, y =
x) replaces ``_gram_sym_kernel``: it evaluates the upper-triangle tile
pairs only and writes each tile and its mirror, half the profile
evaluations of C.  On the H100 both are bound by writing the output (one
exp per entry); they write each entry once, coalesced, and mask the
ragged edge instead of padding the points.

A Pallas kernel traces any profile callable; a CUDA kernel cannot, so
the profile ``g`` is chosen from a registry, `PROFILES`, whose ids match
the device code (``csrc/profiles.cuh``).  ``post`` is the spec's chain
of scalar ``('mul', a)`` / ``('add', c)`` steps (``amp * k``,
``k + c``), applied in the kernel's epilogue from a parameter vector
that stays on the device.

Differentiation mirrors the JAX ``_gram_d`` / ``_gram_d_jvp`` (and
``_gram_sym_d`` / ``_gram_sym_d_jvp``) rules as
`torch.autograd.Function`s: the backward launches the kernel for the
r²-derivative weights ``Wr = post'(g'(r²))`` (zero at r² = 0) and, when
a 'mul' step needs it, for the bare core ``g``, then contracts with the
output gradient ``G`` in plain torch: with ``C = G ∘ Wr``,
``dX = 2 Σ_j C_ij (x_i − y_j)``, exactly as an outer difference at
p = 1 (the JAX rule's exact branch) and as ``2 (rowsum(C) X − C Y)``
at p > 1; the same for Y; and scalar sums for the post chain and the
nugget.  The symmetric version contracts ``G + Gᵀ`` (both of K's
arguments are x) with kernel E's weights.
"""

from __future__ import annotations

import collections

import torch

from . import _build
from ._syrk import _device_kind, _ptr, _stream, _suffix

__all__ = ['gram', 'gram_plain', 'gram_sym', 'gram_sym_plain', 'Profile',
           'PROFILES']

Profile = collections.namedtuple('Profile', ['name', 'id', 'value',
                                             'deriv'])
Profile.__doc__ = """A registered isotropic profile: ``id`` is its
number in ``csrc/profiles.cuh`` (PROFILE_*), ``value`` and ``deriv`` are the
plain torch ``g(r²)`` and ``g'(r²)``."""

PROFILES = {
    'expquad': Profile('expquad', 0, lambda r2: torch.exp(-0.5 * r2),
                       lambda r2: -0.5 * torch.exp(-0.5 * r2)),
}

# evaluation modes (csrc/profiles.cuh MODE_*)
_VALUE, _DERIV, _BARE = 0, 1, 2


def _prep(x):
    x = torch.as_tensor(x)
    if x.dim() == 1:
        x = x[:, None]
    if not x.is_floating_point():
        x = x.to(torch.get_default_dtype())
    return x.contiguous()


def _profile(profile):
    return PROFILES[profile] if isinstance(profile, str) else profile


def _paramvec(post, noise, x):
    vals = [v for _, v in post] + [0.0 if noise is None else noise]
    return torch.stack([
        torch.as_tensor(v, dtype=x.dtype, device=x.device).reshape(())
        for v in vals])


def _eval_plain(profile, ops, x, y, pvec, with_noise, mode):
    n, p = x.shape
    m = y.shape[0]
    r2 = None
    for d in range(p):
        dl = x[:, d, None] - y[None, :, d]
        r2 = dl * dl if r2 is None else r2 + dl * dl
    if mode == _BARE:
        return profile.value(r2)
    if mode == _DERIV:
        v = profile.deriv(r2)
        for k, op in enumerate(ops):
            if op == 'mul':
                v = v * pvec[k]
        return torch.where(r2 <= 0, torch.zeros((), dtype=v.dtype,
                                                device=v.device), v)
    v = profile.value(r2)
    for k, op in enumerate(ops):
        v = v * pvec[k] if op == 'mul' else v + pvec[k]
    if with_noise:
        v = v + pvec[len(ops)] * torch.eye(n, m, dtype=v.dtype,
                                           device=v.device)
    return v


def _postadd(ops):
    return sum(1 << k for k, op in enumerate(ops) if op == 'add')


def _eval_cuda(profile, ops, x, y, pvec, with_noise, mode):
    suffix = _suffix(x.dtype)
    if y.dtype != x.dtype or pvec.dtype != x.dtype:
        raise ValueError('x, y and the parameters must share one dtype')
    n, p = x.shape
    m, py = y.shape
    if py != p:
        raise ValueError(f'x has {p} coordinates, y has {py}')
    pvec = pvec.contiguous()
    postadd = _postadd(ops)
    out = torch.empty((n, m), dtype=x.dtype, device=x.device)
    err = getattr(_build.lib(), 'lsq_gram' + suffix)(
        _ptr(x), _ptr(y), n, m, p, _ptr(pvec), len(ops), postadd,
        int(with_noise), profile.id, mode, _ptr(out), _stream(x.device))
    _build.check(err, 'gram')
    gram.launches += 1
    return out


def _eval(profile, ops, x, y, pvec, with_noise, mode):
    if _device_kind(x, y, pvec) == 'cpu':
        return _eval_plain(profile, ops, x, y, pvec, with_noise, mode)
    return _eval_cuda(profile, ops, x, y, pvec, with_noise, mode)


def _eval_sym_cuda(profile, ops, x, pvec, with_noise, mode):
    suffix = _suffix(x.dtype)
    if pvec.dtype != x.dtype:
        raise ValueError('x and the parameters must share one dtype')
    n, p = x.shape
    pvec = pvec.contiguous()
    out = torch.empty((n, n), dtype=x.dtype, device=x.device)
    err = getattr(_build.lib(), 'lsq_gram_sym' + suffix)(
        _ptr(x), n, p, _ptr(pvec), len(ops), _postadd(ops), int(with_noise),
        profile.id, mode, _ptr(out), _stream(x.device))
    _build.check(err, 'gram_sym')
    gram_sym.launches += 1
    return out


def _eval_sym(profile, ops, x, pvec, with_noise, mode):
    """K(x, x) in ``mode``: kernel E for CUDA tensors; for CPU ones the
    plain full evaluation, which equals the mirrored upper triangle
    exactly (r² is computed symmetrically)."""
    if _device_kind(x, pvec) == 'cpu':
        return _eval_plain(profile, ops, x, x, pvec, with_noise, mode)
    return _eval_sym_cuda(profile, ops, x, pvec, with_noise, mode)


def _param_grads(G, bare, ops, pvec, with_noise):
    """Gradient of <G, K> with respect to the post-chain scalars and the
    nugget.  Before step k the chain's value is α_k g + β_k, and the
    steps after k scale by γ_k (the product of their 'mul' scalars)."""
    one = torch.ones((), dtype=G.dtype, device=G.device)
    zero = torch.zeros((), dtype=G.dtype, device=G.device)
    sum_g = G.sum()
    sum_gk = (G * bare()).sum() if 'mul' in ops else None
    gammas = [None] * len(ops)
    acc = one
    for k in reversed(range(len(ops))):
        gammas[k] = acc
        if ops[k] == 'mul':
            acc = acc * pvec[k]
    alpha, beta = one, zero
    out = []
    for k, op in enumerate(ops):
        if op == 'mul':
            out.append(gammas[k] * (alpha * sum_gk + beta * sum_g))
            alpha = alpha * pvec[k]
            beta = beta * pvec[k]
        else:
            out.append(gammas[k] * sum_g)
            beta = beta + pvec[k]
    out.append(G.diagonal().sum() if with_noise else zero)
    return torch.stack(out)


class _Gram(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, y, pvec, profile, ops, with_noise):
        ctx.save_for_backward(x, y, pvec)
        ctx.meta = profile, ops, with_noise
        return _eval(profile, ops, x, y, pvec, with_noise, _VALUE)

    @staticmethod
    def backward(ctx, G):
        x, y, pvec = ctx.saved_tensors
        profile, ops, with_noise = ctx.meta
        need_x, need_y, need_p = ctx.needs_input_grad[:3]
        gx = gy = gp = None
        if need_x or need_y:
            C = G * _eval(profile, ops, x, y, pvec, False, _DERIV)
            if x.shape[1] == 1:
                C.mul_(x - y.T)
                gx = 2 * C.sum(1, keepdim=True)
                gy = -2 * C.sum(0)[:, None]
            else:
                gx = 2 * (C.sum(1, keepdim=True) * x - C @ y)
                gy = 2 * (C.sum(0)[:, None] * y - C.T @ x)
            del C   # n × m: not alive with the bare core below
        if need_p:
            gp = _param_grads(
                G, lambda: _eval(profile, ops, x, y, pvec, False, _BARE),
                ops, pvec, with_noise)
        return gx, gy, gp, None, None, None


class _GramSym(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, pvec, profile, ops, with_noise):
        ctx.save_for_backward(x, pvec)
        ctx.meta = profile, ops, with_noise
        return _eval_sym(profile, ops, x, pvec, with_noise, _VALUE)

    @staticmethod
    def backward(ctx, G):
        x, pvec = ctx.saved_tensors
        profile, ops, with_noise = ctx.meta
        gx = gp = None
        if ctx.needs_input_grad[0]:
            # both arguments of K are x: the y-gradient of `_Gram`
            # transposed lands on x too, so G enters symmetrized
            C = G + G.T
            C.mul_(_eval_sym(profile, ops, x, pvec, False, _DERIV))
            if x.shape[1] == 1:
                C.mul_(x - x.T)
                gx = 2 * C.sum(1, keepdim=True)
            else:
                gx = 2 * (C.sum(1, keepdim=True) * x - C @ x)
            del C
        if ctx.needs_input_grad[1]:
            gp = _param_grads(
                G, lambda: _eval_sym(profile, ops, x, pvec, False, _BARE),
                ops, pvec, with_noise)
        return gx, gp, None, None, None


def _args(profile, x, y, post, noise):
    profile = _profile(profile)
    x = _prep(x)
    y = x if y is None else _prep(y)
    ops = tuple(op for op, _ in post)
    for op in ops:
        if op not in ('mul', 'add'):
            raise ValueError(f'unknown post step {op!r}')
    return profile, x, y, ops, _paramvec(post, noise, x)


def gram(profile, x, y=None, *, post=(), noise=None):
    """Tiled Gram matrix ``K[i, j] = post(g(‖x_i − y_j‖²))`` (+ noise·I).

    Parameters
    ----------
    profile : str or Profile
        A registered profile (`PROFILES`), e.g. ``'expquad'``.
    x, y : (n, p), (m, p) tensors
        Input points (y defaults to x); 1-D inputs are p = 1.
    post : tuple of ('mul' | 'add', scalar)
        Scalar chain applied to g in order; scalars may be tensors and
        are differentiable.
    noise : scalar, optional
        Nugget on the global diagonal; differentiable.
    """
    profile, x, y, ops, pvec = _args(profile, x, y, post, noise)
    return _Gram.apply(x, y, pvec, profile, ops, noise is not None)


gram.launches = 0


def gram_plain(profile, x, y=None, *, post=(), noise=None):
    """Plain PyTorch version of `gram` on any device, differentiable by
    autograd; the reference the kernel is held against."""
    profile, x, y, ops, pvec = _args(profile, x, y, post, noise)
    return _eval_plain(profile, ops, x, y, pvec, noise is not None, _VALUE)


def gram_sym(profile, x, *, post=(), noise=None):
    """Symmetric Gram matrix ``K(x, x)`` (+ noise·I) evaluated on the
    upper-triangle tiles only and mirrored (kernel E on CUDA): half the
    profile evaluations of `gram`.  Arguments as for `gram`."""
    profile, x, _, ops, pvec = _args(profile, x, None, post, noise)
    return _GramSym.apply(x, pvec, profile, ops, noise is not None)


gram_sym.launches = 0


def gram_sym_plain(profile, x, *, post=(), noise=None):
    """Plain PyTorch version of `gram_sym` on any device, differentiable
    by autograd."""
    profile, x, _, ops, pvec = _args(profile, x, None, post, noise)
    return _eval_plain(profile, ops, x, x, pvec, noise is not None, _VALUE)
