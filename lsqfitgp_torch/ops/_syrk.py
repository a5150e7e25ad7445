"""Lower-trapezoid symmetric updates: the blocked Cholesky's Schur
complement (kernel A) and the marginal-likelihood gradient's ``WᵀW``
(kernel B).

Counterpart of ``lsqfitgp_tpu/ops/_syrk.py``.  Each wrapper runs its
plain PyTorch version for a CPU tensor and launches its hand-written
CUDA kernel (``csrc/syrk.cu``) for a CUDA tensor; there is no other
route.  Both kernels accumulate in IEEE fp32 (or fp64): the
``precision`` keyword is accepted for parity with the JAX package, and
every value gives that grade in this version.

Kernel A replaces ``lsqfitgp_tpu/ops/_syrk.py::_schur_kernel``.  On the
H100 it is bound by the FMA rate (the k-loop is as deep as the
factorization's panel); it keeps a 128 x 128 output tile in registers
across the whole k-loop, fuses the diagonal scaling and eps into the
tile's initial value, reads B through its offset and leading dimension,
and skips the strict-upper tiles entirely.

Kernel B replaces ``lsqfitgp_tpu/ops/_syrk.py::_syrk_t_kernel``.  Also
FMA-bound; it computes the lower output tiles only, starts each tile's
k-loop at its row tile (the rows of a lower-triangular W above are
zero: about n³/6 multiply-adds instead of n³/2 or n³), and writes the
mirror of each tile from the same registers.
"""

from __future__ import annotations

import torch

from . import _build

__all__ = ['schur_update', 'syrk_t_full', 'schur_update_plain',
           'syrk_t_full_plain']

# the kernels' output tile edge (csrc/syrk.cu: BM)
KERNEL_TILE = 128

_PRECISIONS = (None, 'default', 'high', 'highest')


def _check_precision(precision):
    if precision not in _PRECISIONS:
        raise ValueError(f'unknown precision {precision!r}')


def _suffix(dtype):
    if dtype == torch.float32:
        return '_f32'
    if dtype == torch.float64:
        return '_f64'
    raise TypeError(f'the CUDA kernels take float32 or float64, not {dtype}')


def _ptr(t):
    return None if t is None else t.data_ptr()


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _device_kind(*tensors):
    kinds = {t.device.type for t in tensors if t is not None}
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(f'tensors on several devices: {devices}')
    kind, = kinds
    if kind not in ('cpu', 'cuda'):
        raise ValueError(f'unsupported device {kind!r}')
    return kind


def _tile_mask(size, tile, device):
    nt = size // tile
    return torch.tril(torch.ones((nt, nt), dtype=torch.bool, device=device)
                      ).repeat_interleave(tile, 0).repeat_interleave(tile, 1)


def schur_update_plain(B, A, *, s=None, eps=None, size, offset=0, tile=512,
                       nreal=None):
    """Plain version of `schur_update`: the full square, with the
    strict-upper tiles zeroed (the kernel leaves them unwritten)."""
    S = -(A @ A.T)
    if B is not None:
        Bs = B[offset:offset + size, offset:offset + size]
        if s is not None:
            sl = s[offset:offset + size]
            Bs = Bs * sl[:, None] * sl[None, :]
        S = S + Bs
    if eps is not None:
        gi = offset + torch.arange(size, device=A.device)
        bound = size + offset if nreal is None else nreal
        d = torch.where(gi < bound, torch.as_tensor(eps, dtype=A.dtype,
                                                    device=A.device),
                        torch.zeros((), dtype=A.dtype, device=A.device))
        S = S + torch.diag(d)
    return torch.where(_tile_mask(size, tile, A.device), S,
                       torch.zeros((), dtype=S.dtype, device=S.device))


def schur_update(B, A, *, s=None, eps=None, size=None, offset=0, tile=512,
                 precision=None, nreal=None):
    """Lower-trapezoid tiles of ``S = diag(s) B diag(s) + eps I − A Aᵀ``
    where B is the ``(size, size)`` sub-square of a larger matrix at
    ``(offset, offset)``; the view is read in place, never sliced.

    B : (mb, mb) with mb >= offset + size, or None (treated as zero)
    A : (size, h)
    s : (mb,) or None, the symmetric diagonal scaling
    eps : scalar (number or 0-d tensor) or None, the diagonal shift
    size, offset : view geometry, both multiples of ``tile``
    nreal : optional GLOBAL index bound; eps lands only on diagonal
        entries with global index < nreal, so an identity-padded tail
        stays exactly 1.

    Returns (size, size) with the i >= j tiles (of edge ``tile``)
    written; the strict-upper tiles hold zeros on the CPU and are
    unwritten memory on CUDA, so callers must never read them.
    """
    _check_precision(precision)
    m, h = A.shape
    if size is None:
        size = m
    if size != m:
        raise ValueError(f'size {size} != A.shape[0] {m}')
    if size % tile or offset % tile:
        raise ValueError(f'size {size} and offset {offset} must be '
                         f'multiples of tile {tile}')
    if B is not None and B.shape[0] < offset + size:
        raise ValueError('B is smaller than offset + size')
    if _device_kind(B, A, s) == 'cpu':
        return schur_update_plain(B, A, s=s, eps=eps, size=size,
                                  offset=offset, tile=tile, nreal=nreal)
    return _schur_update_cuda(B, A, s, eps, size, offset, tile, nreal)


def _schur_update_cuda(B, A, s, eps, size, offset, tile, nreal):
    dtype = A.dtype
    suffix = _suffix(dtype)
    h = A.shape[1]
    if tile % KERNEL_TILE:
        raise ValueError(f'tile {tile} must be a multiple of {KERNEL_TILE} '
                         f'on CUDA')
    for t in (B, A, s):
        if t is not None and (t.dtype != dtype or not t.is_contiguous()):
            raise ValueError('B, A and s must be contiguous and share A\'s '
                             'dtype')
    if B is not None and B.dim() != 2:
        raise ValueError('B must be a matrix')
    if s is not None and s.shape[0] < offset + size:
        raise ValueError('s is shorter than offset + size')
    e = None
    if eps is not None:
        e = torch.as_tensor(eps, dtype=dtype, device=A.device).reshape(1)
    out = torch.empty((size, size), dtype=dtype, device=A.device)
    lib = _build.lib()
    err = getattr(lib, 'lsq_schur_update' + suffix)(
        _ptr(B), 0 if B is None else B.shape[1], offset, _ptr(s), _ptr(e),
        offset + size if nreal is None else nreal, _ptr(A), h, _ptr(out),
        size, tile, _stream(A.device))
    _build.check(err, 'schur_update')
    schur_update.launches += 1
    return out


schur_update.launches = 0


def syrk_t_full_plain(W):
    """Plain version of `syrk_t_full`, mirrored from its lower triangle
    so that it is exactly symmetric like the kernel's result."""
    C = W.T @ W
    Lt = torch.tril(C)
    return Lt + torch.tril(Lt, -1).T


def syrk_t_full(W, *, precision=None):
    """Full symmetric ``Wᵀ W`` for a lower-triangular W of shape (h, m).

    The kernel skips the rows of W that are zero above its diagonal, so
    W must be lower triangular.  The result is exactly symmetric.
    """
    _check_precision(precision)
    if _device_kind(W) == 'cpu':
        return syrk_t_full_plain(W)
    suffix = _suffix(W.dtype)
    if not W.is_contiguous():
        raise ValueError('W must be contiguous')
    h, m = W.shape
    out = torch.empty((m, m), dtype=W.dtype, device=W.device)
    err = getattr(_build.lib(), 'lsq_syrk_t' + suffix)(
        _ptr(W), h, m, _ptr(out), _stream(W.device))
    _build.check(err, 'syrk_t_full')
    syrk_t_full.launches += 1
    return out


syrk_t_full.launches = 0
