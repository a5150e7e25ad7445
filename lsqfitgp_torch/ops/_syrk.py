"""Lower-trapezoid symmetric updates: the blocked Cholesky's Schur
complement (kernel A), the same with the Gram computed in the tile
(kernel D, the streaming factorization's) and the marginal-likelihood
gradient's ``WᵀW`` (kernel B).

Counterpart of ``lsqfitgp_tpu/ops/_syrk.py``.  Each wrapper runs its
plain PyTorch version for a CPU tensor and launches a hand-written CUDA
kernel for a CUDA tensor; there is no other route.  On the CPU every
precision is IEEE arithmetic, as XLA's on the CPU ignores ``precision``.

Kernels A and D pick their CUDA kernel by ``(dtype, precision)``, with
``None`` meaning ``'high'`` as in the JAX package:

- float32 at ``'high'``: the tensor-core kernel (``csrc/schur_tc.cu``)
  in 3xTF32, each operand split into a TF32 ``hi`` and ``lo`` and the
  products ``hi·hi + hi·lo + lo·hi`` summed in fp32, the counterpart of
  the JAX package's bf16_3x (about 2⁻²¹ relative per product against
  bf16_3x's 2⁻¹⁶); counted by ``launches_tc``;
- float32 at ``'default'``: the same kernel with one TF32 pass, the
  counterpart of JAX's single bf16 pass; counted by ``launches_tc1``;
- float32 at ``'highest'``: the SIMT kernel (``csrc/syrk.cu``), IEEE
  fp32 FMA; counted by ``launches``;
- float64 at every precision: the FP64 tensor-core kernel
  (``csrc/dmma.cu``, DMMA ``mma.sync``), IEEE fp64; counted by
  ``launches_dmma``.

The TF32 tensor-core kernel takes A with 16-byte aligned rows (``h % 4
== 0``) and raises otherwise; the DMMA kernel takes any h.  Kernel B is
IEEE at every precision: the SIMT kernel in float32, the DMMA kernel in
float64.

Kernel A replaces ``lsqfitgp_tpu/ops/_syrk.py::_schur_kernel``.  The
SIMT kernel is bound by the FMA rate, the tensor-core kernels by the
TF32 rate over the pass count or the FP64 tensor-core rate (the k-loop
is as deep as the factorization's panel).  All keep a 128 x 128 output
tile in registers across the whole k-loop, fuse the diagonal scaling
and eps into the tile's initial value, read B through its offset and
leading dimension, and launch only the lower tiles.

Kernel D replaces ``lsqfitgp_tpu/ops/_syrk.py::_schur_gram_kernel`` and
its 2-D-grid twin ``_schur_gram_kernel2`` (one CUDA kernel serves both).
It is kernel A with another tile initialization: the virtual matrix
``blockdiag(K, I) + eps I`` (eps on the real diagonal only) computed
from the points, so the Gram block never exists in device memory.  Same
bounds, same designs.

Kernel B replaces ``lsqfitgp_tpu/ops/_syrk.py::_syrk_t_kernel``.  Also
bound by the products; it computes the lower output tiles only, starts
each tile's k-loop at its row tile (the rows of a lower-triangular W
above are zero: about n³/6 multiply-adds instead of n³/2 or n³), and
writes the mirror of each tile from the same registers.  In float64 it
also runs in place (`syrk_t_full_`): WᵀW's strict upper triangle goes
into W's, which is zero, and a second launch mirrors it, so the
gradient's K⁻¹ costs no n × n buffer beside W.
"""

from __future__ import annotations

import torch

from . import _build

__all__ = ['schur_update', 'schur_update_gram', 'syrk_t_full',
           'syrk_t_full_', 'schur_update_plain', 'schur_update_gram_plain',
           'syrk_t_full_plain']

# the kernels' output tile edge (csrc/syrk.cu: BM)
KERNEL_TILE = 128

_PRECISIONS = (None, 'default', 'high', 'highest')


def _check_precision(precision):
    if precision not in _PRECISIONS:
        raise ValueError(f'unknown precision {precision!r}')


def _passes(dtype, precision):
    """The tensor-core kernel's TF32 pass count for kernels A and D at
    ``(dtype, precision)``, or 0 for another kernel."""
    if dtype != torch.float32:
        return 0
    return {None: 3, 'high': 3, 'default': 1}.get(precision, 0)


def _counter(dtype, precision):
    """The launch counter of the CUDA kernel that kernels A and D run at
    ``(dtype, precision)``."""
    if dtype == torch.float64:
        return 'launches_dmma'
    return {0: 'launches', 3: 'launches_tc',
            1: 'launches_tc1'}[_passes(dtype, precision)]


def _count(wrapper, counter):
    setattr(wrapper, counter, getattr(wrapper, counter) + 1)


def _check_tc(A):
    if A.shape[1] % 4 or A.data_ptr() % 16:
        raise ValueError(
            'the tensor-core kernel (float32 at precision \'high\' or '
            '\'default\') needs A\'s rows 16-byte aligned: h % 4 == 0 and '
            'an aligned base; pass precision=\'highest\' for the SIMT '
            'kernel')


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
    return _schur_update_cuda(B, A, s, eps, size, offset, tile, nreal,
                              precision)


def _schur_update_cuda(B, A, s, eps, size, offset, tile, nreal, precision):
    dtype = A.dtype
    _suffix(dtype)
    passes = _passes(dtype, precision)
    counter = _counter(dtype, precision)
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
    args = (_ptr(B), 0 if B is None else B.shape[1], offset, _ptr(s), _ptr(e),
            offset + size if nreal is None else nreal, _ptr(A), h, _ptr(out),
            size, tile)
    lib = _build.lib()
    if counter == 'launches_dmma':
        err = lib.lsq_schur_update_dmma_f64(*args, _stream(A.device))
    elif passes:
        _check_tc(A)
        err = lib.lsq_schur_update_tc_f32(*args, passes, _stream(A.device))
    else:
        err = lib.lsq_schur_update_f32(*args, _stream(A.device))
    _build.check(err, 'schur_update')
    _count(schur_update, counter)
    return out


schur_update.launches = schur_update.launches_tc = 0
schur_update.launches_tc1 = schur_update.launches_dmma = 0


def _gram_view_mask(S, gi, nreal):
    """The virtual matrix ``blockdiag(K, I)`` from the Gram S of the rows
    with global indices ``gi``, in place: entries with a row or column
    >= nreal are 0, and 1 on the diagonal."""
    pad = gi >= nreal
    S[pad] = 0
    S[:, pad] = 0
    S.diagonal()[pad] = 1
    return S


def schur_update_gram_plain(profile, X, A, *, post=(), eps=None, nreal=None,
                            size, offset=0, tile=512):
    """Plain version of `schur_update_gram` (the JAX package's interpret
    branch): the full square of the virtual matrix minus ``A Aᵀ``, with
    the strict-upper tiles zeroed."""
    from . import _gram
    if nreal is None:
        nreal = X.shape[0]
    S = _gram.gram_plain(profile, X[offset:offset + size], post=post)
    gi = offset + torch.arange(size, device=A.device)
    S = _gram_view_mask(S, gi, nreal)
    if eps is not None:
        e = torch.as_tensor(eps, dtype=A.dtype, device=A.device)
        S.diagonal().add_(torch.where(gi < nreal, e, torch.zeros_like(e)))
    # in place: at the streaming factorization's top update the square
    # is gigabytes
    S.addmm_(A, A.T, alpha=-1)
    return S.masked_fill_(~_tile_mask(size, tile, A.device), 0)


def schur_update_gram(profile, X, A, *, post=(), eps=None, nreal=None,
                      size=None, offset=0, tile=512, precision=None):
    """Lower-trapezoid tiles of ``S = K[off:off+size, off:off+size] + eps I
    − A Aᵀ`` where ``K[i, j] = k(‖X_i − X_j‖²)`` is computed inside the
    kernel from the points: the Gram block never exists in memory.

    profile : str, Profile, Term or Terms, the profile as for `ops.gram`
        (any registered profile and term sum)
    X : (npad, p) points of the whole virtual matrix, global rows
    A : (size, h); size and offset multiples of ``tile``
    post : the profile's post chain of ('mul' | 'add', scalar) steps
    eps : scalar or None, added on the diagonal entries with global
        index < nreal
    nreal : global bound of the real rows (default all of X); the
        virtual matrix is exactly ``blockdiag(K, I)`` past it

    Same uninitialized-upper-tiles contract as `schur_update`.
    """
    _check_precision(precision)
    m, h = A.shape
    if size is None:
        size = m
    if nreal is None:
        nreal = X.shape[0]
    if size != m:
        raise ValueError(f'size {size} != A.shape[0] {m}')
    if size % tile or offset % tile:
        raise ValueError(f'size {size} and offset {offset} must be '
                         f'multiples of tile {tile}')
    if X.shape[0] < offset + size:
        raise ValueError('X has fewer rows than offset + size')
    if _device_kind(X, A) == 'cpu':
        return schur_update_gram_plain(profile, X, A, post=post, eps=eps,
                                       nreal=nreal, size=size, offset=offset,
                                       tile=tile)
    from . import _gram
    _, st, X, _, pvec = _gram._args(profile, X, None, post, eps)
    nterms, codes, _ = _gram._codes(st)
    fv = _gram._fold(st, pvec).detach().contiguous()
    _suffix(A.dtype)
    if tile % KERNEL_TILE:
        raise ValueError(f'tile {tile} must be a multiple of {KERNEL_TILE} '
                         f'on CUDA')
    if X.dtype != A.dtype or fv.dtype != A.dtype:
        raise ValueError('X, A and the parameters must share one dtype')
    if not A.is_contiguous():
        raise ValueError('A must be contiguous')
    passes = _passes(A.dtype, precision)
    counter = _counter(A.dtype, precision)
    out = torch.empty((size, size), dtype=A.dtype, device=A.device)
    args = (_ptr(X), X.shape[1], _ptr(fv), nterms, codes,
            int(eps is not None), nreal, offset, _ptr(A), h, _ptr(out), size,
            tile, _gram._tabs(st, X, fv))
    lib = _build.lib()
    if counter == 'launches_dmma':
        err = lib.lsq_schur_gram_dmma_f64(*args, _stream(A.device))
    elif passes:
        _check_tc(A)
        err = lib.lsq_schur_gram_tc_f32(*args, passes, _stream(A.device))
    else:
        err = lib.lsq_schur_gram_f32(*args, _stream(A.device))
    _build.check(err, 'schur_update_gram')
    # the tile initializer always takes ZooSpecial (csrc/schur_init.cuh)
    _gram._count(schur_update_gram, counter, st, _gram._SPECIAL)
    return out


schur_update_gram.launches = schur_update_gram.launches_tc = 0
schur_update_gram.launches_tc1 = schur_update_gram.launches_dmma = 0
schur_update_gram.by_profile = {}
schur_update_gram.by_evaluator = {}


def syrk_t_full_plain(W):
    """Plain version of `syrk_t_full`, mirrored from its lower triangle
    so that it is exactly symmetric like the kernel's result."""
    C = W.T @ W
    Lt = torch.tril(C)
    return Lt + torch.tril(Lt, -1).T


def syrk_t_full(W, *, precision=None):
    """Full symmetric ``Wᵀ W`` for a lower-triangular W of shape (h, m).

    The kernel skips the rows of W that are zero above its diagonal, so
    W must be lower triangular.  The result is exactly symmetric.  On
    CUDA, float32 runs the SIMT kernel (counted by ``launches``), float64
    the DMMA kernel (``launches_dmma``).
    """
    _check_precision(precision)
    if _device_kind(W) == 'cpu':
        return syrk_t_full_plain(W)
    _suffix(W.dtype)
    if not W.is_contiguous():
        raise ValueError('W must be contiguous')
    h, m = W.shape
    out = torch.empty((m, m), dtype=W.dtype, device=W.device)
    lib = _build.lib()
    if W.dtype == torch.float64:
        err = lib.lsq_syrk_t_dmma_f64(_ptr(W), h, m, _ptr(out), None,
                                      _stream(W.device))
        counter = 'launches_dmma'
    else:
        err = lib.lsq_syrk_t_f32(_ptr(W), h, m, _ptr(out), _stream(W.device))
        counter = 'launches'
    _build.check(err, 'syrk_t_full')
    _count(syrk_t_full, counter)
    return out


syrk_t_full.launches = syrk_t_full.launches_dmma = 0


def syrk_t_full_(W, *, precision=None):
    """`syrk_t_full` in place: leaves the full, exactly symmetric ``Wᵀ
    W`` of a square lower-triangular W in W's own buffer and returns W.

    On CUDA the DMMA kernel (float64 only) writes WᵀW's strict upper
    triangle into W's, which is zero, reading W's upper triangle as zero
    by index, then mirrors it; its only scratch is n doubles.  Counted
    by ``launches_dmma``.  On the CPU the plain version, then a copy.
    """
    _check_precision(precision)
    if W.dim() != 2 or W.shape[0] != W.shape[1]:
        raise ValueError(f'W must be square, not {tuple(W.shape)}')
    if _device_kind(W) == 'cpu':
        return W.copy_(syrk_t_full_plain(W))
    if W.dtype != torch.float64:
        raise TypeError(f'the in-place kernel takes float64, not {W.dtype}')
    if not W.is_contiguous():
        raise ValueError('W must be contiguous')
    n = W.shape[0]
    diag = torch.empty(n, dtype=W.dtype, device=W.device)
    err = _build.lib().lsq_syrk_t_dmma_f64(_ptr(W), n, n, _ptr(W),
                                           _ptr(diag), _stream(W.device))
    _build.check(err, 'syrk_t_full_')
    syrk_t_full_.launches_dmma += 1
    return W


syrk_t_full_.launches_dmma = 0
