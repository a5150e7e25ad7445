"""Tiled Gram-matrix evaluators for isotropic kernels (kernels C and E)
and their fused backward passes.

Counterpart of ``lsqfitgp_tpu/ops/_gram.py`` (``gram``, ``gram_sym``).
The Gram

    K[i, j] = post(g(‖x_i − y_j‖²)) (+ noise if i == j)

is evaluated by the hand-written CUDA kernels of ``csrc/gram.cu`` for
CUDA tensors and by their plain PyTorch versions, `gram_plain` and
`gram_sym_plain`, for CPU tensors.  Kernel C (`gram`) replaces
``lsqfitgp_tpu/ops/_gram.py::_gram_kernel``; kernel E (`gram_sym`, y =
x) replaces ``_gram_sym_kernel``: it evaluates the upper-triangle tile
pairs only and writes each tile and its mirror, half the profile
evaluations of C.  On the H100 both are bound by writing the output;
each thread writes 16 bytes of a row at once, and the ragged edge is
masked instead of padding the points.  Both evaluate an entry by the
same expression, so they write identical matrices.

A Pallas kernel traces any profile callable; a CUDA kernel cannot, so
the profile ``g`` is chosen from a registry, `PROFILES`, whose ids match
the device code (``csrc/profiles.cuh``).  ``post`` is the spec's chain
of scalar ``('mul', a)`` / ``('add', c)`` steps (``amp * k``,
``k + c``), applied in the kernel's epilogue from a parameter vector
that stays on the device.

Differentiation replaces the JAX ``_gram_d_jvp`` (and
``_gram_sym_d_jvp``) rules with `torch.autograd.Function`s whose
backward, `gram_backward` (`gram_sym_backward`), is one more kernel of
``csrc/gram.cu`` on CUDA tensors: it reads the output gradient ``G``
once, recomputes g and g' per entry, and sums what the gradients need,
with ``Wr = post'(g'(r²))`` (zero at r² = 0) and ``C = G ∘ Wr``:
``dX = 2 Σ_j C_ij (x_i − y_j)``, ``dY = −2 Σ_i C_ij (x_i − y_j)``, and
the sums of ``G``, ``G ∘ g`` and G's trace, from which `_param_grads`
forms the post chain's and the nugget's gradients.  Each kernel block
writes its partial sums to its own slots of a small scratch buffer,
summed here over the slots: no atomics, so the gradient is the same to
the bit from run to run, and no n × m buffer.  The symmetric version
contracts ``G + Gᵀ`` (both of K's arguments are x) and reads the
mirrored tiles of ``G`` in the same pass.  The plain versions,
`gram_backward_plain` and `gram_sym_backward_plain`, evaluate ``Wr``
and ``g`` as whole matrices and contract them in plain torch; CPU
tensors take them.
"""

from __future__ import annotations

import collections

import torch

from . import _build
from ._syrk import _device_kind, _ptr, _stream, _suffix

__all__ = ['gram', 'gram_plain', 'gram_sym', 'gram_sym_plain',
           'gram_backward', 'gram_backward_plain', 'gram_sym_backward',
           'gram_sym_backward_plain', 'Profile', 'PROFILES']

Profile = collections.namedtuple('Profile', ['name', 'id', 'value',
                                             'deriv'])
Profile.__doc__ = """A registered isotropic profile: ``id`` is its
number in ``csrc/profiles.cuh`` (PROFILE_*), ``value`` and ``deriv`` are the
plain torch ``g(r²)`` and ``g'(r²)``."""

PROFILES = {
    'expquad': Profile('expquad', 0, lambda r2: torch.exp(-0.5 * r2),
                       lambda r2: -0.5 * torch.exp(-0.5 * r2)),
}

# the backward kernels' tiling (csrc/gram.cu): the tile edge, the rows a
# block of C's backward covers (TILE * CROWS) and the coordinates one
# launch takes at p > 1 (PCHUNK)
_TILE, _BWD_ROWS, _PCHUNK = 64, 256, 4


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


def _postadd(ops):
    return sum(1 << k for k, op in enumerate(ops) if op == 'add')


def _cdiv(a, b):
    return -(-a // b)


# -- plain versions -----------------------------------------------------------

def _sqdist_plain(x, y):
    r2 = None
    for d in range(x.shape[1]):
        dl = x[:, d, None] - y[None, :, d]
        r2 = dl * dl if r2 is None else r2 + dl * dl
    return r2


def _eval_plain(profile, ops, x, y, pvec, with_noise):
    v = profile.value(_sqdist_plain(x, y))
    for k, op in enumerate(ops):
        v = v * pvec[k] if op == 'mul' else v + pvec[k]
    if with_noise:
        v = v + pvec[len(ops)] * torch.eye(*v.shape, dtype=v.dtype,
                                           device=v.device)
    return v


def _deriv_plain(profile, ops, x, y, pvec):
    """The r²-derivative weights ``Wr`` of K: g'(r²) times the chain's
    'mul' steps, zero at r² <= 0 where the true tangent vanishes."""
    r2 = _sqdist_plain(x, y)
    v = profile.deriv(r2)
    for k, op in enumerate(ops):
        if op == 'mul':
            v = v * pvec[k]
    return torch.where(r2 <= 0, torch.zeros((), dtype=v.dtype,
                                            device=v.device), v)


def _param_grads(sums, ops, pvec, with_noise):
    """Gradient of <G, K> with respect to the post-chain scalars and the
    nugget from ``sums`` = (Σ G, Σ G ∘ g, tr G).  Before step k the
    chain's value is α_k g + β_k, and the steps after k scale by γ_k
    (the product of their 'mul' scalars)."""
    sum_g, sum_gk, trace = sums
    one = torch.ones((), dtype=sum_g.dtype, device=sum_g.device)
    zero = torch.zeros((), dtype=sum_g.dtype, device=sum_g.device)
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
    out.append(trace if with_noise else zero)
    return torch.stack(out)


def _sums_plain(G, profile, ops, x, y):
    """(Σ G, Σ G ∘ g, tr G), the core g evaluated only when a 'mul' step
    needs it."""
    sum_gk = (G * profile.value(_sqdist_plain(x, y))).sum() \
        if 'mul' in ops else G.new_zeros(())
    return G.sum(), sum_gk, G.diagonal().sum()


def _backward_plain(G, profile, ops, x, y, pvec, with_noise, need_xy,
                    need_p):
    gx = gy = gp = None
    if need_xy:
        C = G * _deriv_plain(profile, ops, x, y, pvec)
        if x.shape[1] == 1:
            C.mul_(x - y.T)
            gx = 2 * C.sum(1, keepdim=True)
            gy = -2 * C.sum(0)[:, None]
        else:
            gx = 2 * (C.sum(1, keepdim=True) * x - C @ y)
            gy = 2 * (C.sum(0)[:, None] * y - C.T @ x)
        del C   # n × m: not alive with the core below
    if need_p:
        gp = _param_grads(_sums_plain(G, profile, ops, x, y), ops, pvec,
                          with_noise)
    return gx, gy, gp


def _sym_backward_plain(G, profile, ops, x, pvec, with_noise, need_x,
                        need_p):
    gx = gp = None
    if need_x:
        # both arguments of K are x: the y-gradient of C's backward
        # transposed lands on x too, so G enters symmetrized
        C = G + G.T
        C.mul_(_deriv_plain(profile, ops, x, x, pvec))
        if x.shape[1] == 1:
            C.mul_(x - x.T)
            gx = 2 * C.sum(1, keepdim=True)
        else:
            gx = 2 * (C.sum(1, keepdim=True) * x - C @ x)
        del C
    if need_p:
        gp = _param_grads(_sums_plain(G, profile, ops, x, x), ops, pvec,
                          with_noise)
    return gx, gp


# -- the CUDA kernels ---------------------------------------------------------

def _check_dtypes(*tensors):
    if any(t.dtype != tensors[0].dtype for t in tensors):
        raise ValueError('the points, the parameters and the output '
                         'gradient must share one dtype')
    return _suffix(tensors[0].dtype)


def _eval_cuda(profile, ops, x, y, pvec, with_noise):
    suffix = _check_dtypes(x, y, pvec)
    n, p = x.shape
    m, py = y.shape
    if py != p:
        raise ValueError(f'x has {p} coordinates, y has {py}')
    pvec = pvec.contiguous()
    out = torch.empty((n, m), dtype=x.dtype, device=x.device)
    err = getattr(_build.lib(), 'lsq_gram' + suffix)(
        _ptr(x), _ptr(y), n, m, p, _ptr(pvec), len(ops), _postadd(ops),
        int(with_noise), profile.id, _ptr(out), _stream(x.device))
    _build.check(err, 'gram')
    gram.launches += 1
    return out


def _eval(profile, ops, x, y, pvec, with_noise):
    if _device_kind(x, y, pvec) == 'cpu':
        return _eval_plain(profile, ops, x, y, pvec, with_noise)
    return _eval_cuda(profile, ops, x, y, pvec, with_noise)


def _eval_sym_cuda(profile, ops, x, pvec, with_noise):
    suffix = _check_dtypes(x, pvec)
    n, p = x.shape
    pvec = pvec.contiguous()
    out = torch.empty((n, n), dtype=x.dtype, device=x.device)
    err = getattr(_build.lib(), 'lsq_gram_sym' + suffix)(
        _ptr(x), n, p, _ptr(pvec), len(ops), _postadd(ops), int(with_noise),
        profile.id, _ptr(out), _stream(x.device))
    _build.check(err, 'gram_sym')
    gram_sym.launches += 1
    return out


def _eval_sym(profile, ops, x, pvec, with_noise):
    """K(x, x): kernel E for CUDA tensors; for CPU ones the plain full
    evaluation, which equals the mirrored upper triangle exactly (r² is
    computed symmetrically)."""
    if _device_kind(x, pvec) == 'cpu':
        return _eval_plain(profile, ops, x, x, pvec, with_noise)
    return _eval_sym_cuda(profile, ops, x, pvec, with_noise)


def _wide(G, ncols):
    """Whether G's rows are 16-byte aligned (the kernels' wide loads)."""
    return int(G.data_ptr() % 16 == 0 and ncols % (16 // G.element_size())
               == 0)


def _chunks(p, need_xy):
    """The first coordinate of each backward launch: one launch takes
    every coordinate at p = 1 and up to _PCHUNK at p > 1."""
    return range(0, p, 1 if p == 1 else _PCHUNK) if need_xy else range(1)


def _backward_cuda(G, profile, ops, x, y, pvec, with_noise, need_xy,
                   need_p):
    G = G.contiguous()
    suffix = _check_dtypes(G, x, y, pvec)
    n, p = x.shape
    m = y.shape[0]
    if G.shape != (n, m):
        raise ValueError(f'G has shape {tuple(G.shape)}, K {(n, m)}')
    pvec = pvec.contiguous()
    nbj, nbi = _cdiv(m, _TILE), _cdiv(n, _BWD_ROWS)
    # each block's partial sums: over its columns for its rows, over its
    # rows for its columns, and its scalars
    rowpart = x.new_empty((nbj, n, p)) if need_xy else None
    colpart = x.new_empty((nbi, m, p)) if need_xy else None
    scal = x.new_empty((nbi * nbj, 3)) if need_p else None
    fn = getattr(_build.lib(), 'lsq_gram_bwd' + suffix)
    for d0 in _chunks(p, need_xy):
        err = fn(_ptr(G), _ptr(x), _ptr(y), n, m, p, d0, _ptr(pvec),
                 len(ops), _postadd(ops), int(with_noise), profile.id,
                 int(need_xy), int(need_p and d0 == 0), _wide(G, m),
                 _ptr(rowpart), _ptr(colpart), _ptr(scal),
                 _stream(x.device))
        _build.check(err, 'gram backward')
        gram.launches_bwd += 1
    gx = gy = gp = None
    if need_xy:
        gx = 2 * rowpart.sum(0)
        gy = -2 * colpart.sum(0)
    if need_p:
        gp = _param_grads(scal.sum(0), ops, pvec, with_noise)
    return gx, gy, gp


def _sym_backward_cuda(G, profile, ops, x, pvec, with_noise, need_x,
                       need_p):
    G = G.contiguous()
    suffix = _check_dtypes(G, x, pvec)
    n, p = x.shape
    if G.shape != (n, n):
        raise ValueError(f'G has shape {tuple(G.shape)}, K {(n, n)}')
    pvec = pvec.contiguous()
    nt = _cdiv(n, _TILE)
    # rows of tile I: one slot per other tile J (the pair (I, J) or
    # (J, I) writes it); the scalars per upper tile pair
    part = x.new_empty((nt, n, p)) if need_x else None
    scal = x.new_empty((nt * (nt + 1) // 2, 3)) if need_p else None
    fn = getattr(_build.lib(), 'lsq_gram_sym_bwd' + suffix)
    for d0 in _chunks(p, need_x):
        err = fn(_ptr(G), _ptr(x), n, p, d0, _ptr(pvec), len(ops),
                 _postadd(ops), int(with_noise), profile.id, int(need_x),
                 int(need_p and d0 == 0), _wide(G, n), _ptr(part),
                 _ptr(scal), _stream(x.device))
        _build.check(err, 'gram_sym backward')
        gram_sym.launches_bwd += 1
    gx = 2 * part.sum(0) if need_x else None
    gp = _param_grads(scal.sum(0), ops, pvec, with_noise) if need_p \
        else None
    return gx, gp


def _backward(G, profile, ops, x, y, pvec, with_noise, need_xy, need_p):
    if _device_kind(G, x, y, pvec) == 'cpu':
        return _backward_plain(G, profile, ops, x, y, pvec, with_noise,
                               need_xy, need_p)
    return _backward_cuda(G, profile, ops, x, y, pvec, with_noise, need_xy,
                          need_p)


def _sym_backward(G, profile, ops, x, pvec, with_noise, need_x, need_p):
    if _device_kind(G, x, pvec) == 'cpu':
        return _sym_backward_plain(G, profile, ops, x, pvec, with_noise,
                                   need_x, need_p)
    return _sym_backward_cuda(G, profile, ops, x, pvec, with_noise, need_x,
                              need_p)


# -- differentiable wrappers --------------------------------------------------

class _Gram(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, y, pvec, profile, ops, with_noise):
        ctx.save_for_backward(x, y, pvec)
        ctx.meta = profile, ops, with_noise
        return _eval(profile, ops, x, y, pvec, with_noise)

    @staticmethod
    def backward(ctx, G):
        x, y, pvec = ctx.saved_tensors
        profile, ops, with_noise = ctx.meta
        need_x, need_y, need_p = ctx.needs_input_grad[:3]
        if not (need_x or need_y or need_p):
            return None, None, None, None, None, None
        gx, gy, gp = _backward(G, profile, ops, x, y, pvec, with_noise,
                               need_x or need_y, need_p)
        return gx, gy, gp, None, None, None


class _GramSym(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, pvec, profile, ops, with_noise):
        ctx.save_for_backward(x, pvec)
        ctx.meta = profile, ops, with_noise
        return _eval_sym(profile, ops, x, pvec, with_noise)

    @staticmethod
    def backward(ctx, G):
        x, pvec = ctx.saved_tensors
        profile, ops, with_noise = ctx.meta
        need_x, need_p = ctx.needs_input_grad[:2]
        if not (need_x or need_p):
            return None, None, None, None, None
        gx, gp = _sym_backward(G, profile, ops, x, pvec, with_noise, need_x,
                               need_p)
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


gram.launches = gram.launches_bwd = 0


def gram_plain(profile, x, y=None, *, post=(), noise=None):
    """Plain PyTorch version of `gram` on any device, differentiable by
    autograd; the reference the kernel is held against."""
    profile, x, y, ops, pvec = _args(profile, x, y, post, noise)
    return _eval_plain(profile, ops, x, y, pvec, noise is not None)


def gram_backward(G, profile, x, y=None, *, post=(), noise=None,
                  need_xy=True, need_p=True):
    """The backward of `gram`: the gradients of ``<G, K>``, K =
    ``gram(profile, x, y, post=post, noise=noise)``, as ``(gx, gy, gp)``:
    with respect to x and y (of their (n, p) and (m, p) shapes; with y
    None, K's two arguments apart), and to the parameter vector, the
    post chain's scalars then the nugget (0 without one).  ``need_xy``
    and ``need_p`` say which are computed; the others are None.  One
    launch of the fused kernel for CUDA tensors (one per 4 coordinates
    at p > 4), `gram_backward_plain` for CPU ones."""
    profile, x, y, ops, pvec = _args(profile, x, y, post, noise)
    return _backward(G, profile, ops, x, y, pvec, noise is not None,
                     need_xy, need_p)


def gram_backward_plain(G, profile, x, y=None, *, post=(), noise=None,
                        need_xy=True, need_p=True):
    """Plain PyTorch version of `gram_backward` on any device: the
    derivative weights and the core as n × m matrices, contracted with G
    in torch."""
    profile, x, y, ops, pvec = _args(profile, x, y, post, noise)
    return _backward_plain(G, profile, ops, x, y, pvec, noise is not None,
                           need_xy, need_p)


def gram_sym(profile, x, *, post=(), noise=None):
    """Symmetric Gram matrix ``K(x, x)`` (+ noise·I) evaluated on the
    upper-triangle tiles only and mirrored (kernel E on CUDA): half the
    profile evaluations of `gram`.  Arguments as for `gram`."""
    profile, x, _, ops, pvec = _args(profile, x, None, post, noise)
    return _GramSym.apply(x, pvec, profile, ops, noise is not None)


gram_sym.launches = gram_sym.launches_bwd = 0


def gram_sym_plain(profile, x, *, post=(), noise=None):
    """Plain PyTorch version of `gram_sym` on any device, differentiable
    by autograd."""
    profile, x, _, ops, pvec = _args(profile, x, None, post, noise)
    return _eval_plain(profile, ops, x, x, pvec, noise is not None)


def gram_sym_backward(G, profile, x, *, post=(), noise=None, need_x=True,
                      need_p=True):
    """The backward of `gram_sym`: the gradients of ``<G, K(x, x)>`` with
    respect to x and the parameter vector, ``(gx, gp)``, as for
    `gram_backward`.  The fused kernel for CUDA tensors (upper tile pairs
    only, G and its mirror read in one pass), `gram_sym_backward_plain`
    for CPU ones."""
    profile, x, _, ops, pvec = _args(profile, x, None, post, noise)
    return _sym_backward(G, profile, ops, x, pvec, noise is not None,
                         need_x, need_p)


def gram_sym_backward_plain(G, profile, x, *, post=(), noise=None,
                            need_x=True, need_p=True):
    """Plain PyTorch version of `gram_sym_backward` on any device."""
    profile, x, _, ops, pvec = _args(profile, x, None, post, noise)
    return _sym_backward_plain(G, profile, ops, x, pvec, noise is not None,
                               need_x, need_p)
