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

Second-order and forward-mode derivatives run on four more kernels.
Kernel C′ (`gram_jvp`, E′ `gram_sym_jvp`) is the forward direction of
``_gram_d_jvp``, fused into one pass: the tangent Gram

    dK = α g'(r²) dr² + dα g + dβ (+ dnoise·I),  dr² = 2 (x_i − y_j)·(dx_i − dy_j),

with the weight zero at r² = 0, where post(g) = α g + β is the folded
chain.  It is `_Gram.jvp` (torch forward AD) and, since the backward is
linear in G with transpose J_K, the G-cotangent of the backward's own
backward.  Kernel C″ (`gram_backward_jvp`, E″ `gram_sym_backward_jvp`)
is the tangent of C's backward at a fixed G, the counterpart of JAX's
second differentiation of the ``_elemgrad_*`` Pallas calls: with g, g'
and g'' per entry it sums ``G ((dα g' + α g'' dr²)(x_i − y_j) + α g'
(dx_i − dy_j))`` over rows and columns, and ``Σ G g' dr²``, into the
backward's per-block slots (no atomics, the same bits in two calls).
Under ``create_graph`` the Functions' backward is itself a Function
(`_GramBackward`, `_GramSymBackward`) whose backward sends the
cotangent of G through C′ (E′) and those of the points and α through
C″ (E″): the backward's Hessian is symmetric, so its transpose is its
tangent.  Without ``create_graph`` the first-order path is unchanged.
A third derivative raises.
"""

from __future__ import annotations

import collections

import torch

from . import _build
from ._syrk import _device_kind, _ptr, _stream, _suffix

__all__ = ['gram', 'gram_plain', 'gram_sym', 'gram_sym_plain',
           'gram_backward', 'gram_backward_plain', 'gram_sym_backward',
           'gram_sym_backward_plain', 'gram_jvp', 'gram_jvp_plain',
           'gram_sym_jvp', 'gram_sym_jvp_plain', 'gram_backward_jvp',
           'gram_backward_jvp_plain', 'gram_sym_backward_jvp',
           'gram_sym_backward_jvp_plain', 'Profile', 'PROFILES']

Profile = collections.namedtuple('Profile', ['name', 'id', 'value',
                                             'deriv', 'deriv2'])
Profile.__doc__ = """A registered isotropic profile: ``id`` is its
number in ``csrc/profiles.cuh`` (PROFILE_*), ``value``, ``deriv`` and
``deriv2`` are the plain torch ``g(r²)``, ``g'(r²)`` and ``g''(r²)``."""

PROFILES = {
    'expquad': Profile('expquad', 0, lambda r2: torch.exp(-0.5 * r2),
                       lambda r2: -0.5 * torch.exp(-0.5 * r2),
                       lambda r2: 0.25 * torch.exp(-0.5 * r2)),
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


def _fold(ops, pvec, dpvec=None):
    """The chain folded to post(g) = α g + β, and the tangents dα, dβ
    along ``dpvec``: ``(α, β, dα, dβ)``, differentiable in pvec."""
    zero = pvec.new_zeros(())
    a, b, da, db = pvec.new_ones(()), zero, zero, zero
    for k, op in enumerate(ops):
        v = pvec[k]
        dv = zero if dpvec is None else dpvec[k]
        if op == 'mul':
            da, db = da * v + a * dv, db * v + b * dv
            a, b = a * v, b * v
        else:
            b, db = b + v, db + dv
    return a, b, da, db


def _coef(ops, pvec, dpvec, with_noise):
    """The tangent kernels' coefficient vector [α, dα, dβ, dnoise]."""
    a, _, da, db = _fold(ops, pvec, dpvec)
    dn = dpvec[len(ops)] if with_noise else pvec.new_zeros(())
    return torch.stack([a, da, db, dn])


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
    """(gx, gy, sums): the points' gradients and (Σ G, Σ G ∘ g, tr G)."""
    gx = gy = sums = None
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
        sums = torch.stack(_sums_plain(G, profile, ops, x, y))
    return gx, gy, sums


def _sym_backward_plain(G, profile, ops, x, pvec, with_noise, need_x,
                        need_p):
    gx = sums = None
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
        sums = torch.stack(_sums_plain(G, profile, ops, x, x))
    return gx, sums


def _dsqdist_plain(x, y, dx, dy):
    """dr² = 2 Σ_d (x_d − y_d)(dx_d − dy_d), from exact differences."""
    t = None
    for d in range(x.shape[1]):
        dl = (x[:, d, None] - y[None, :, d]) * (dx[:, d, None]
                                                - dy[None, :, d])
        t = dl if t is None else t + dl
    return 2 * t


def _tangent_plain(profile, x, y, dx, dy, coef, with_noise):
    """C′: dK = α g'(r²) dr² (zero at r² <= 0) + dα g + dβ (+ dnoise
    on the diagonal), coef = [α, dα, dβ, dnoise]."""
    r2 = _sqdist_plain(x, y)
    w = torch.where(r2 <= 0, r2.new_zeros(()), coef[0] * profile.deriv(r2))
    v = w * _dsqdist_plain(x, y, dx, dy) + coef[1] * profile.value(r2) \
        + coef[2]
    if with_noise:
        v = v + coef[3] * torch.eye(*v.shape, dtype=v.dtype, device=v.device)
    return v


def _tangent_weights_plain(profile, x, y, dx, dy, alpha, dalpha):
    """(w1, w2, dr², r²): the weights of (x_i − y_j) and (dx_i − dy_j)
    in the tangent of the backward, zero at r² <= 0."""
    r2 = _sqdist_plain(x, y)
    dr2 = _dsqdist_plain(x, y, dx, dy)
    zero = r2.new_zeros(())
    d1 = profile.deriv(r2)
    w1 = torch.where(r2 <= 0, zero,
                     dalpha * d1 + alpha * profile.deriv2(r2) * dr2)
    w2 = torch.where(r2 <= 0, zero, alpha * d1)
    return w1, w2, dr2, r2


def _tangent_scalars_plain(G, profile, r2, dr2):
    """(Σ G g' dr², Σ G, Σ G g), the scalar slots of C″ and E″."""
    return torch.stack([(G * profile.deriv(r2) * dr2).sum(), G.sum(),
                        (G * profile.value(r2)).sum()])


def _bwd_tangent_plain(G, profile, x, y, dx, dy, coef, need_xy, need_s):
    """C″: the tangent of C's backward at fixed G along (dx, dy, dα),
    coef = [α, dα]: (dgx, dgy, scalars) with scalars (Σ G g' dr², Σ G,
    Σ G g)."""
    gx = gy = sc = None
    w1, w2, dr2, r2 = _tangent_weights_plain(profile, x, y, dx, dy, coef[0],
                                             coef[1])
    if need_xy:
        w1 = G * w1
        w2 = G * w2
        gx = 2 * (w1.sum(1, keepdim=True) * x - w1 @ y
                  + w2.sum(1, keepdim=True) * dx - w2 @ dy)
        gy = 2 * (w1.sum(0)[:, None] * y - w1.T @ x
                  + w2.sum(0)[:, None] * dy - w2.T @ dx)
    if need_s:
        sc = _tangent_scalars_plain(G, profile, r2, dr2)
    return gx, gy, sc


def _sym_bwd_tangent_plain(G, profile, x, dx, coef, need_x, need_s):
    """E″: C″ for y = x, dy = dx; G enters as G + Gᵀ."""
    gx = sc = None
    w1, w2, dr2, r2 = _tangent_weights_plain(profile, x, x, dx, dx, coef[0],
                                             coef[1])
    if need_x:
        S = G + G.T
        w1 = S * w1
        w2 = S * w2
        gx = 2 * (w1.sum(1, keepdim=True) * x - w1 @ x
                  + w2.sum(1, keepdim=True) * dx - w2 @ dx)
    if need_s:
        sc = _tangent_scalars_plain(G, profile, r2, dr2)
    return gx, sc


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
    gx = gy = None
    if need_xy:
        gx = 2 * rowpart.sum(0)
        gy = -2 * colpart.sum(0)
    return gx, gy, scal.sum(0) if need_p else None


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
    return gx, scal.sum(0) if need_p else None


def _backward_sums(G, profile, ops, x, y, pvec, with_noise, need_xy,
                   need_p):
    """(gx, gy, sums): C's backward, with (Σ G, Σ G ∘ g, tr G) for the
    parameters' gradients."""
    fn = _backward_plain if _device_kind(G, x, y, pvec) == 'cpu' \
        else _backward_cuda
    return fn(G, profile, ops, x, y, pvec, with_noise, need_xy, need_p)


def _sym_backward_sums(G, profile, ops, x, pvec, with_noise, need_x,
                       need_p):
    fn = _sym_backward_plain if _device_kind(G, x, pvec) == 'cpu' \
        else _sym_backward_cuda
    return fn(G, profile, ops, x, pvec, with_noise, need_x, need_p)


def _backward(G, profile, ops, x, y, pvec, with_noise, need_xy, need_p):
    gx, gy, sums = _backward_sums(G, profile, ops, x, y, pvec, with_noise,
                                  need_xy, need_p)
    gp = _param_grads(sums, ops, pvec, with_noise) if need_p else None
    return gx, gy, gp


def _sym_backward(G, profile, ops, x, pvec, with_noise, need_x, need_p):
    gx, sums = _sym_backward_sums(G, profile, ops, x, pvec, with_noise,
                                  need_x, need_p)
    gp = _param_grads(sums, ops, pvec, with_noise) if need_p else None
    return gx, gp


# -- the tangent kernels (C′, C″, E′, E″) ----------------------------------------

def _tangent_cuda(profile, x, y, dx, dy, coef, with_noise):
    suffix = _check_dtypes(x, y, dx, dy, coef)
    n, p = x.shape
    m = y.shape[0]
    if y.shape[1] != p or dx.shape != x.shape or dy.shape != y.shape:
        raise ValueError('the points and their tangents must have shapes '
                         f'(n, p), (m, p): {tuple(x.shape)}, '
                         f'{tuple(y.shape)}, {tuple(dx.shape)}, '
                         f'{tuple(dy.shape)}')
    dx, dy, coef = dx.contiguous(), dy.contiguous(), coef.contiguous()
    out = torch.empty((n, m), dtype=x.dtype, device=x.device)
    err = getattr(_build.lib(), 'lsq_gram_jvp' + suffix)(
        _ptr(x), _ptr(y), _ptr(dx), _ptr(dy), n, m, p, _ptr(coef),
        int(with_noise), profile.id, _ptr(out), _stream(x.device))
    _build.check(err, 'gram tangent')
    gram.launches_jvp += 1
    return out


def _sym_tangent_cuda(profile, x, dx, coef, with_noise):
    suffix = _check_dtypes(x, dx, coef)
    n, p = x.shape
    if dx.shape != x.shape:
        raise ValueError(f'dx has shape {tuple(dx.shape)}, x '
                         f'{tuple(x.shape)}')
    dx, coef = dx.contiguous(), coef.contiguous()
    out = torch.empty((n, n), dtype=x.dtype, device=x.device)
    err = getattr(_build.lib(), 'lsq_gram_sym_jvp' + suffix)(
        _ptr(x), _ptr(dx), n, p, _ptr(coef), int(with_noise), profile.id,
        _ptr(out), _stream(x.device))
    _build.check(err, 'gram_sym tangent')
    gram_sym.launches_jvp += 1
    return out


def _bwd_tangent_cuda(G, profile, x, y, dx, dy, coef, need_xy, need_s):
    G = G.contiguous()
    suffix = _check_dtypes(G, x, y, dx, dy, coef)
    n, p = x.shape
    m = y.shape[0]
    if G.shape != (n, m):
        raise ValueError(f'G has shape {tuple(G.shape)}, K {(n, m)}')
    dx, dy, coef = dx.contiguous(), dy.contiguous(), coef.contiguous()
    nbj, nbi = _cdiv(m, _TILE), _cdiv(n, _BWD_ROWS)
    rowpart = x.new_empty((nbj, n, p)) if need_xy else None
    colpart = x.new_empty((nbi, m, p)) if need_xy else None
    scal = x.new_empty((nbi * nbj, 3)) if need_s else None
    fn = getattr(_build.lib(), 'lsq_gram_bwd_jvp' + suffix)
    for d0 in _chunks(p, need_xy):
        err = fn(_ptr(G), _ptr(x), _ptr(y), _ptr(dx), _ptr(dy), n, m, p, d0,
                 _ptr(coef), profile.id, int(need_xy), int(need_s and d0 == 0),
                 _wide(G, m), _ptr(rowpart), _ptr(colpart), _ptr(scal),
                 _stream(x.device))
        _build.check(err, 'gram backward tangent')
        gram.launches_bwd_jvp += 1
    gx = gy = None
    if need_xy:
        gx = 2 * rowpart.sum(0)
        gy = -2 * colpart.sum(0)
    return gx, gy, scal.sum(0) if need_s else None


def _sym_bwd_tangent_cuda(G, profile, x, dx, coef, need_x, need_s):
    G = G.contiguous()
    suffix = _check_dtypes(G, x, dx, coef)
    n, p = x.shape
    if G.shape != (n, n):
        raise ValueError(f'G has shape {tuple(G.shape)}, K {(n, n)}')
    dx, coef = dx.contiguous(), coef.contiguous()
    nt = _cdiv(n, _TILE)
    part = x.new_empty((nt, n, p)) if need_x else None
    scal = x.new_empty((nt * (nt + 1) // 2, 3)) if need_s else None
    fn = getattr(_build.lib(), 'lsq_gram_sym_bwd_jvp' + suffix)
    for d0 in _chunks(p, need_x):
        err = fn(_ptr(G), _ptr(x), _ptr(dx), n, p, d0, _ptr(coef),
                 profile.id, int(need_x), int(need_s and d0 == 0),
                 _wide(G, n), _ptr(part), _ptr(scal), _stream(x.device))
        _build.check(err, 'gram_sym backward tangent')
        gram_sym.launches_bwd_jvp += 1
    gx = 2 * part.sum(0) if need_x else None
    return gx, scal.sum(0) if need_s else None


def _tangent(profile, x, y, dx, dy, coef, with_noise):
    fn = _tangent_plain if _device_kind(x, y, dx, dy, coef) == 'cpu' \
        else _tangent_cuda
    return fn(profile, x, y, dx, dy, coef, with_noise)


def _sym_tangent(profile, x, dx, coef, with_noise):
    """E′: the tangent of K(x, x); for CPU tensors the plain full
    evaluation, equal to the mirrored upper triangle."""
    if _device_kind(x, dx, coef) == 'cpu':
        return _tangent_plain(profile, x, x, dx, dx, coef, with_noise)
    return _sym_tangent_cuda(profile, x, dx, coef, with_noise)


def _bwd_tangent(G, profile, x, y, dx, dy, coef, need_xy, need_s):
    fn = _bwd_tangent_plain if _device_kind(G, x, y, dx, dy, coef) == 'cpu' \
        else _bwd_tangent_cuda
    return fn(G, profile, x, y, dx, dy, coef, need_xy, need_s)


def _sym_bwd_tangent(G, profile, x, dx, coef, need_x, need_s):
    fn = _sym_bwd_tangent_plain if _device_kind(G, x, dx, coef) == 'cpu' \
        else _sym_bwd_tangent_cuda
    return fn(G, profile, x, dx, coef, need_x, need_s)


# -- differentiable wrappers --------------------------------------------------

_THIRD = ('the Gram kernels are differentiable twice in lsqfitgp_torch: '
          'a third derivative is not implemented')


def _zeros_if_none(t, like):
    return torch.zeros_like(like) if t is None else t


class _Gram(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, y, pvec, profile, ops, with_noise):
        ctx.save_for_backward(x, y, pvec)
        ctx.save_for_forward(x, y, pvec)
        ctx.meta = profile, ops, with_noise
        return _eval(profile, ops, x, y, pvec, with_noise)

    @staticmethod
    def jvp(ctx, dx, dy, dpvec, *_):
        x, y, pvec = ctx.saved_tensors
        profile, ops, with_noise = ctx.meta
        coef = _coef(ops, pvec, _zeros_if_none(dpvec, pvec), with_noise)
        return _tangent(profile, x, y, _zeros_if_none(dx, x),
                        _zeros_if_none(dy, y), coef, with_noise)

    @staticmethod
    def backward(ctx, G):
        x, y, pvec = ctx.saved_tensors
        profile, ops, with_noise = ctx.meta
        need_x, need_y, need_p = ctx.needs_input_grad[:3]
        if not (need_x or need_y or need_p):
            return None, None, None, None, None, None
        if torch.is_grad_enabled():
            # create_graph: the backward as a Function of its own, with
            # the parameters' gradients formed from its sums by
            # differentiable torch
            alpha = _fold(ops, pvec)[0]
            gx, gy, sums = _GramBackward.apply(G, x, y, alpha, profile,
                                               need_x or need_y, need_p)
            gp = _param_grads(sums, ops, pvec, with_noise) if need_p \
                else None
        else:
            gx, gy, gp = _backward(G, profile, ops, x, y, pvec, with_noise,
                                   need_x or need_y, need_p)
        return gx, gy, gp, None, None, None


class _GramBackward(torch.autograd.Function):
    """C's backward as a function of (G, x, y, α): (gx, gy, (Σ G, Σ G g,
    tr G)).  Its backward is C′ for G (the backward is linear in G, with
    transpose J_K) and C″ for x, y and α (the backward is a gradient, so
    its Jacobian in them is a symmetric Hessian: the transpose is the
    tangent)."""

    @staticmethod
    def forward(ctx, G, x, y, alpha, profile, need_xy, need_s):
        ctx.save_for_backward(G, x, y, alpha)
        ctx.meta = profile, need_xy, need_s
        ctx.set_materialize_grads(False)
        return _backward_sums(G, profile, ('mul',), x, y,
                              torch.stack([alpha, alpha.new_zeros(())]),
                              True, need_xy, need_s)

    @staticmethod
    def backward(ctx, ugx, ugy, us):
        if torch.is_grad_enabled():
            raise RuntimeError(_THIRD)
        G, x, y, alpha = ctx.saved_tensors
        profile, need_xy, need_s = ctx.meta
        need_G, need_x, need_y, need_a = ctx.needs_input_grad[:4]
        dx = _zeros_if_none(ugx, x)
        dy = _zeros_if_none(ugy, y)
        u0, u1, u2 = _zeros_if_none(us, alpha.new_zeros(3)).unbind()
        gG = gx = gy = ga = None
        if need_G:
            coef = torch.stack([alpha, u1, u0, u2])
            gG = _tangent(profile, x, y, dx, dy, coef, True)
        if need_x or need_y or need_a:
            gx, gy, sc = _bwd_tangent(G, profile, x, y, dx, dy,
                                      torch.stack([alpha, u1]),
                                      need_x or need_y, need_a)
            ga = sc[0] if need_a else None
        return gG, gx, gy, ga, None, None, None


class _GramSym(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, pvec, profile, ops, with_noise):
        ctx.save_for_backward(x, pvec)
        ctx.save_for_forward(x, pvec)
        ctx.meta = profile, ops, with_noise
        return _eval_sym(profile, ops, x, pvec, with_noise)

    @staticmethod
    def jvp(ctx, dx, dpvec, *_):
        x, pvec = ctx.saved_tensors
        profile, ops, with_noise = ctx.meta
        coef = _coef(ops, pvec, _zeros_if_none(dpvec, pvec), with_noise)
        return _sym_tangent(profile, x, _zeros_if_none(dx, x), coef,
                            with_noise)

    @staticmethod
    def backward(ctx, G):
        x, pvec = ctx.saved_tensors
        profile, ops, with_noise = ctx.meta
        need_x, need_p = ctx.needs_input_grad[:2]
        if not (need_x or need_p):
            return None, None, None, None, None
        if torch.is_grad_enabled():
            alpha = _fold(ops, pvec)[0]
            gx, sums = _GramSymBackward.apply(G, x, alpha, profile, need_x,
                                              need_p)
            gp = _param_grads(sums, ops, pvec, with_noise) if need_p \
                else None
        else:
            gx, gp = _sym_backward(G, profile, ops, x, pvec, with_noise,
                                   need_x, need_p)
        return gx, gp, None, None, None


class _GramSymBackward(torch.autograd.Function):
    """E's backward as a function of (G, x, α): (gx, (Σ G, Σ G g, tr G));
    its backward is E′ for G and E″ for x and α."""

    @staticmethod
    def forward(ctx, G, x, alpha, profile, need_x, need_s):
        ctx.save_for_backward(G, x, alpha)
        ctx.meta = profile, need_x, need_s
        ctx.set_materialize_grads(False)
        return _sym_backward_sums(G, profile, ('mul',), x,
                                  torch.stack([alpha, alpha.new_zeros(())]),
                                  True, need_x, need_s)

    @staticmethod
    def backward(ctx, ugx, us):
        if torch.is_grad_enabled():
            raise RuntimeError(_THIRD)
        G, x, alpha = ctx.saved_tensors
        profile, need_xo, need_s = ctx.meta
        need_G, need_x, need_a = ctx.needs_input_grad[:3]
        dx = _zeros_if_none(ugx, x)
        u0, u1, u2 = _zeros_if_none(us, alpha.new_zeros(3)).unbind()
        gG = gx = ga = None
        if need_G:
            gG = _sym_tangent(profile, x, dx,
                              torch.stack([alpha, u1, u0, u2]), True)
        if need_x or need_a:
            gx, sc = _sym_bwd_tangent(G, profile, x, dx,
                                      torch.stack([alpha, u1]), need_x,
                                      need_a)
            ga = sc[0] if need_a else None
        return gG, gx, ga, None, None, None


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
gram.launches_jvp = gram.launches_bwd_jvp = 0


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
    gx, gy, sums = _backward_plain(G, profile, ops, x, y, pvec,
                                   noise is not None, need_xy, need_p)
    gp = _param_grads(sums, ops, pvec, noise is not None) if need_p \
        else None
    return gx, gy, gp


def gram_sym(profile, x, *, post=(), noise=None):
    """Symmetric Gram matrix ``K(x, x)`` (+ noise·I) evaluated on the
    upper-triangle tiles only and mirrored (kernel E on CUDA): half the
    profile evaluations of `gram`.  Arguments as for `gram`."""
    profile, x, _, ops, pvec = _args(profile, x, None, post, noise)
    return _GramSym.apply(x, pvec, profile, ops, noise is not None)


gram_sym.launches = gram_sym.launches_bwd = 0
gram_sym.launches_jvp = gram_sym.launches_bwd_jvp = 0


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
    gx, sums = _sym_backward_plain(G, profile, ops, x, pvec,
                                   noise is not None, need_x, need_p)
    gp = _param_grads(sums, ops, pvec, noise is not None) if need_p \
        else None
    return gx, gp


# -- tangents -----------------------------------------------------------------

def _tangent_args(profile, x, y, dx, dy, post, noise, dpost, dnoise):
    """(profile, x, y, dx, dy, ops, pvec, dpvec): `_args` and the
    tangents, zeros where not given; with y None, dy is dx."""
    profile, xx, yy, ops, pvec = _args(profile, x, y, post, noise)
    dx = torch.zeros_like(xx) if dx is None else _prep(dx).to(xx.dtype)
    if y is None:
        dy = dx
    else:
        dy = torch.zeros_like(yy) if dy is None else _prep(dy).to(yy.dtype)
    dpost = [0.0] * len(ops) if dpost is None else list(dpost)
    if len(dpost) != len(ops):
        raise ValueError(f'{len(dpost)} chain tangents for {len(ops)} steps')
    dpvec = _paramvec(tuple(zip(ops, dpost)),
                      None if noise is None else
                      (0.0 if dnoise is None else dnoise), xx)
    return profile, xx, yy, dx, dy, ops, pvec, dpvec


def _param_grads_tangent(sc, ops, pvec, dpvec, with_noise):
    """The tangent of `_param_grads` from C″'s scalars (Σ G g' dr², Σ G,
    Σ G g): Σ G and tr G are constant, Σ G g moves by Σ G g' dr², and
    the chain's scalars by dpvec."""
    zero = sc.new_zeros(())
    sums = torch.stack([sc[1], sc[2], zero])
    dsums = torch.stack([zero, sc[0], zero])
    return torch.func.jvp(
        lambda s, p: _param_grads(s, ops, p, with_noise), (sums, pvec),
        (dsums, dpvec))[1]


def gram_jvp(profile, x, y=None, dx=None, dy=None, *, post=(), noise=None,
             dpost=None, dnoise=None):
    """The tangent of `gram` along the points' tangents ``dx``, ``dy``
    (zeros if None; with y None, K(x, x) and dy = dx), the chain's
    scalars' ``dpost`` and the nugget's ``dnoise``: ``dK = α g'(r²) dr²
    + dα g + dβ (+ dnoise·I)``, zero weight at r² = 0.  Kernel C′ for
    CUDA tensors, `gram_jvp_plain` for CPU ones."""
    profile, x, y, dx, dy, ops, pvec, dpvec = _tangent_args(
        profile, x, y, dx, dy, post, noise, dpost, dnoise)
    with_noise = noise is not None
    return _tangent(profile, x, y, dx, dy,
                    _coef(ops, pvec, dpvec, with_noise), with_noise)


def gram_jvp_plain(profile, x, y=None, dx=None, dy=None, *, post=(),
                   noise=None, dpost=None, dnoise=None):
    """Plain PyTorch version of `gram_jvp` on any device."""
    profile, x, y, dx, dy, ops, pvec, dpvec = _tangent_args(
        profile, x, y, dx, dy, post, noise, dpost, dnoise)
    with_noise = noise is not None
    return _tangent_plain(profile, x, y, dx, dy,
                          _coef(ops, pvec, dpvec, with_noise), with_noise)


def gram_sym_jvp(profile, x, dx=None, *, post=(), noise=None, dpost=None,
                 dnoise=None):
    """The tangent of `gram_sym` (kernel E′ on CUDA: the upper tile
    pairs, mirrored; the same entries as `gram_jvp`)."""
    profile, x, _, dx, _, ops, pvec, dpvec = _tangent_args(
        profile, x, None, dx, None, post, noise, dpost, dnoise)
    with_noise = noise is not None
    return _sym_tangent(profile, x, dx, _coef(ops, pvec, dpvec, with_noise),
                        with_noise)


def gram_sym_jvp_plain(profile, x, dx=None, *, post=(), noise=None,
                       dpost=None, dnoise=None):
    """Plain PyTorch version of `gram_sym_jvp` on any device."""
    return gram_jvp_plain(profile, x, None, dx, None, post=post, noise=noise,
                          dpost=dpost, dnoise=dnoise)


def _backward_jvp(fn, G, profile, x, y, dx, dy, post, noise, dpost, need_xy,
                  need_p):
    profile, x, y, dx, dy, ops, pvec, dpvec = _tangent_args(
        profile, x, y, dx, dy, post, noise, dpost, None)
    a, _, da, _ = _fold(ops, pvec, dpvec)
    gx, gy, sc = fn(G, profile, x, y, dx, dy, torch.stack([a, da]), need_xy,
                    need_p)
    gp = _param_grads_tangent(sc, ops, pvec, dpvec, noise is not None) \
        if need_p else None
    return gx, gy, gp


def gram_backward_jvp(G, profile, x, y=None, dx=None, dy=None, *, post=(),
                      noise=None, dpost=None, need_xy=True, need_p=True):
    """The tangent of `gram_backward` at fixed ``G`` along the points'
    tangents and the chain's ``dpost``: ``(dgx, dgy, dgp)``, as
    `gram_backward` returns ``(gx, gy, gp)``.  One launch of kernel C″
    for CUDA tensors (one per 4 coordinates at p > 4), reading G once,
    `gram_backward_jvp_plain` for CPU ones."""
    return _backward_jvp(_bwd_tangent, G, profile, x, y, dx, dy, post, noise,
                         dpost, need_xy, need_p)


def gram_backward_jvp_plain(G, profile, x, y=None, dx=None, dy=None, *,
                            post=(), noise=None, dpost=None, need_xy=True,
                            need_p=True):
    """Plain PyTorch version of `gram_backward_jvp` on any device."""
    return _backward_jvp(_bwd_tangent_plain, G, profile, x, y, dx, dy, post,
                         noise, dpost, need_xy, need_p)


def _sym_bwd_tangent_as(fn):
    def run(G, profile, x, y, dx, dy, coef, need_x, need_s):
        gx, sc = fn(G, profile, x, dx, coef, need_x, need_s)
        return gx, None, sc
    return run


def gram_sym_backward_jvp(G, profile, x, dx=None, *, post=(), noise=None,
                          dpost=None, need_x=True, need_p=True):
    """The tangent of `gram_sym_backward` at fixed ``G``: ``(dgx, dgp)``.
    Kernel E″ for CUDA tensors (the upper tile pairs, G and its mirror
    read in one pass), `gram_sym_backward_jvp_plain` for CPU ones."""
    gx, _, gp = _backward_jvp(_sym_bwd_tangent_as(_sym_bwd_tangent), G,
                              profile, x, None, dx, None, post, noise, dpost,
                              need_x, need_p)
    return gx, gp


def gram_sym_backward_jvp_plain(G, profile, x, dx=None, *, post=(),
                                noise=None, dpost=None, need_x=True,
                                need_p=True):
    """Plain PyTorch version of `gram_sym_backward_jvp` on any device."""
    gx, _, gp = _backward_jvp(_sym_bwd_tangent_as(_sym_bwd_tangent_plain), G,
                              profile, x, None, dx, None, post, noise, dpost,
                              need_x, need_p)
    return gx, gp
