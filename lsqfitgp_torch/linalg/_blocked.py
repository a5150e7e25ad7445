"""Blocked recursive Cholesky factorization and triangular solves.

Counterpart of ``lsqfitgp_tpu/linalg/_blocked.py``, recursive scheme
only.  The factorization splits the block grid in two, factors the
leading half, solves the panel against it with matrix products, forms
the trailing Schur complement with kernel A (`ops.schur_update`, its
plain version on the CPU), and recurses.  The factor comes back as a
tree of diagonal factors and panels, densified once; the inverses of
the diagonal blocks come with it, so the solves are matrix products.

Differences from the JAX package:

- the precision ladder's rungs are Python branches on
  ``torch.isfinite(...).all()`` (one host sync per factorization);
- kernel A runs at every internal node of the tree on CUDA (there is no
  small-trailing-block cutover);
- the strip and square schemes (``_chol_strips``, ``_chol_square``,
  ``_pick_scheme``) are not ported: they worked around an XLA compile
  wall that eager PyTorch does not have;
- no memory-policy size switch: eager code keeps one factorization
  alive, not both branches of a ``lax.cond``.
"""

from __future__ import annotations

import torch

from ..ops import _syrk

__all__ = ['chol_factor_scaled', 'chol_factor_scaled_ladder',
           'diag_block_inverses', 'trtri_blocked', 'solve_lower',
           'solve_lower_t']

_LIFT = 1024  # self-healing diagonal lift, in units of eps * matrix scale


def _precision(precision):
    """Validate a precision name.  Every name gives IEEE fp32 (or fp64)
    products in this version: TF32 is off (see ``_config``) and the
    kernels accumulate with plain FMA."""
    _syrk._check_precision(precision)
    return 'high' if precision is None else precision


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _chol_lifted(D, bump):
    """Cholesky of a block with self-healing diagonal lifting.

    The factor is NaN when the block is numerically indefinite (as JAX's
    ``lax.linalg.cholesky`` returns).  With ``bump`` the block is
    refactored with that diagonal shift where the first attempt failed,
    branch-free; ``bump is True`` derives the shift from this block.
    Only the lower triangle of D is read.
    """
    L, info = torch.linalg.cholesky_ex(D)
    nan = torch.full((), float('nan'), dtype=D.dtype, device=D.device)
    L = torch.where(info != 0, nan, L)
    if bump is None:
        return L
    if bump is True:
        eps = torch.finfo(D.dtype).eps
        bump = _LIFT * eps * D.abs().sum(1).max()
    bad = torch.isnan(L).any()
    D2 = D + torch.where(bad, bump, 0.0) * _eye(D.shape[0], D)
    L2, info2 = torch.linalg.cholesky_ex(D2)
    L2 = torch.where(info2 != 0, nan, L2)
    return torch.where(bad, L2, L)


def _factor_diag(D, b1, bump=None):
    """(L, L⁻¹) of a small PSD diagonal block by a recursive 2x2 scheme:
    ``torch.linalg.cholesky`` and a triangular solve at the (b1, b1)
    base, matrix products above it."""
    b = D.shape[0]
    if b <= b1:
        L = _chol_lifted(D, bump)
        Linv = torch.linalg.solve_triangular(L, _eye(b, D), upper=False)
        return L, Linv
    h = b // 2
    L11, I11 = _factor_diag(D[:h, :h], b1, bump)
    P = D[h:, :h] @ I11.T
    S = D[h:, h:] - P @ P.T
    L22, I22 = _factor_diag(S, b1, bump)
    Z = torch.zeros((h, b - h), dtype=D.dtype, device=D.device)
    L = torch.cat([torch.cat([L11, Z], 1), torch.cat([P, L22], 1)], 0)
    I21 = -(I22 @ P) @ I11
    Linv = torch.cat([torch.cat([I11, Z], 1), torch.cat([I21, I22], 1)], 0)
    return L, Linv


def _pad_spd(K, nb):
    """Pad K to (nb, nb) with an identity tail (block-diagonal, so the
    factor of the padded matrix is blockdiag(L, I))."""
    n = K.shape[0]
    if nb == n:
        return K
    Kp = torch.zeros((nb, nb), dtype=K.dtype, device=K.device)
    Kp[:n, :n] = K
    Kp[n:, n:] = _eye(nb - n, K)
    return Kp


def _tree_solve_right_t(B, tree, dinvs, block):
    """X = B L⁻ᵀ with L the factor tree and B (m, k), by recursive
    halving; a leaf is one product with its diagonal block's inverse."""
    if not isinstance(tree, tuple):
        return B @ dinvs[0].T
    P, t11, t22 = tree
    h = P.shape[1]
    hb = h // block
    X1 = _tree_solve_right_t(B[:, :h], t11, dinvs[:hb], block)
    B2 = B[:, h:] - X1 @ P.T
    X2 = _tree_solve_right_t(B2, t22, dinvs[hb:], block)
    return torch.cat([X1, X2], 1)


def _place(L, tree, o):
    """Write the factor tree into L at diagonal offset o.  (Module level:
    a recursive closure would keep L in a reference cycle, alive until
    the cyclic garbage collector runs.)"""
    if not isinstance(tree, tuple):
        b = tree.shape[0]
        L[o:o + b, o:o + b] = tree
        return
    P, t11, t22 = tree
    h = P.shape[1]
    _place(L, t11, o)
    L[o + h:o + h + P.shape[0], o:o + h] = P
    _place(L, t22, o + h)


def _tree_assemble(tree, n):
    """Dense lower factor (cropped to (n, n)) from a factor tree, each
    piece written once into one zero-initialized buffer."""
    if not isinstance(tree, tuple):
        return tree[:n, :n]
    P, _, _ = tree
    npad = P.shape[0] + P.shape[1]
    L = torch.zeros((npad, npad), dtype=P.dtype, device=P.device)
    _place(L, tree, 0)
    return L[:n, :n]


def _view_block(M, s, eps, base, r0, c0, h, w, nreal=None):
    """One (h, w) block of the virtual matrix ``diag(s) M diag(s) + eps
    I`` whose (0, 0) sits at global offset ``base`` inside M; (r0, c0)
    are global.  eps lands only on diagonal entries with global index
    < ``nreal`` (identity-pad pivots stay exactly 1)."""
    A = M[r0 - base:r0 - base + h, c0 - base:c0 - base + w]
    if s is not None:
        A = A * s[r0:r0 + h, None] * s[None, c0:c0 + w]
    if eps is not None and r0 == c0:
        gi = r0 + torch.arange(h, device=M.device)
        bound = r0 + h if nreal is None else nreal
        d = torch.where(gi < bound, torch.as_tensor(eps, dtype=A.dtype,
                                                    device=A.device),
                        torch.zeros((), dtype=A.dtype, device=A.device))
        A = A + torch.diag(d)
    return A


def _chol_rec_tree_kernel(M, s, eps, base, o, kb, block, b1, precision,
                          bump, nreal=None):
    """Recursive Cholesky over a kb x kb block grid at global offset
    ``o`` of the virtual matrix ``diag(s) M diag(s) + eps I``, with each
    trailing Schur complement computed by kernel A on its lower tiles
    only (the recursion reads only diagonal blocks and sub-diagonal
    panels).  M is padded to a block multiple (s extended with ones).

    Returns (tree, [leaf L⁻¹ list in diagonal order]); a leaf is a
    (block, block) diagonal factor, a node ``(P, t11, t22)`` with P the
    sub-diagonal panel.
    """
    if kb == 1:
        D = _view_block(M, s, eps, base, o, o, block, block, nreal)
        L, Linv = _factor_diag(D, b1, bump)
        return L, [Linv]
    hb = (kb + 1) // 2
    h = hb * block
    w = (kb - hb) * block
    t11, d1 = _chol_rec_tree_kernel(M, s, eps, base, o, hb, block, b1,
                                    precision, bump, nreal)
    A21 = _view_block(M, s, None, base, o + h, o, w, h)
    P = _tree_solve_right_t(A21, t11, d1, block).contiguous()
    S = _syrk.schur_update(
        M, P, s=s, eps=eps, size=w, offset=o + h - base, tile=block,
        precision=precision, nreal=None if nreal is None else nreal - base)
    t22, d2 = _chol_rec_tree_kernel(S, None, None, o + h, o + h, kb - hb,
                                    block, b1, precision, bump, nreal)
    return (P, t11, t22), d1 + d2


def _chol_tree_impl(K, s, eps, block, b1, prec, lift):
    """(tree, [L⁻¹ list]) of diag(s) K diag(s) + eps I (``s``/``eps``
    None to skip)."""
    precision_ = _precision(prec)
    n = K.shape[0]
    nb = -(-n // block)
    bump = None
    if lift:
        eps_m = torch.finfo(K.dtype).eps
        if s is None:
            bump = _LIFT * eps_m * K.abs().sum(1).max()
        else:
            bump = _LIFT * eps_m * (s * (K.abs() @ s)).max()
    npad = nb * block
    Kp = _pad_spd(K, npad).contiguous()
    sp = s
    if s is not None and npad != n:
        sp = torch.cat([s, torch.ones(npad - n, dtype=K.dtype,
                                      device=K.device)])
    return _chol_rec_tree_kernel(Kp, sp, eps, 0, 0, nb, block, b1,
                                 precision_, bump, nreal=n)


def _finite(Dinv):
    return bool(torch.isfinite(Dinv).all())


def chol_factor_scaled(K, s, eps, block=512, b1=128, precision=None,
                       heal=True):
    """(L, Dinv) of ``diag(s) K diag(s) + eps I`` without materializing
    the scaled matrix: the scaling and eps are fused into the first
    reads (kernel A's tile initialization on CUDA).  ``Dinv`` stacks
    the inverses of the (block, block) diagonal blocks.

    With ``precision=None`` a first pass without lift is refactored
    with the self-healing lift (``heal``) if it comes back non-finite.
    """
    n = K.shape[0]
    if precision is not None:
        tree, dinvs = _chol_tree_impl(K, s, eps, block, b1, precision, heal)
        Dinv = torch.stack(dinvs)
    else:
        tree, dinvs = _chol_tree_impl(K, s, eps, block, b1, 'high', False)
        Dinv = torch.stack(dinvs)
        if not _finite(Dinv):
            tree, dinvs = _chol_tree_impl(K, s, eps, block, b1, 'highest',
                                          heal)
            Dinv = torch.stack(dinvs)
    return _tree_assemble(tree, n), Dinv


def chol_factor_scaled_ladder(K, s, eps, eps2, block=512, b1=128):
    """The float32 'auto' factorization of ``diag(s) K diag(s) + eps I``:

    1. the small ``eps`` without the self-healing lift;
    2. on a non-finite factor: the bound-scaled ``eps2`` with the lift.

    (The JAX ladder has a middle rung that retries rung 1 at HIGHEST
    matmul precision; here every precision is already IEEE fp32, so
    that rung would repeat rung 1 exactly.)

    Returns ``(L, Dinv, eps_used, escalated)``.  Forward only: the
    gradient of the log-density comes from `chol_nll`'s rule.
    """
    n = K.shape[0]
    tree, dinvs = _chol_tree_impl(K, s, eps, block, b1, 'high', False)
    Dinv = torch.stack(dinvs)
    escalated = not _finite(Dinv)
    if escalated:
        eps = eps2
        tree, dinvs = _chol_tree_impl(K, s, eps2, block, b1, 'highest',
                                      True)
        Dinv = torch.stack(dinvs)
    return _tree_assemble(tree, n), Dinv, eps, escalated


def diag_block_inverses(L, block):
    """Inverses of the (block, block) diagonal blocks of lower-triangular
    L, shape (ceil(n/block), block, block); the tail block is padded
    with identity."""
    n = L.shape[0]
    nb = -(-n // block) * block
    if nb != n:
        L = _pad_spd(L, nb)
    D = torch.stack([L[j:j + block, j:j + block]
                     for j in range(0, nb, block)])
    eye = _eye(block, L).expand_as(D)
    return torch.linalg.solve_triangular(D, eye, upper=False)


def trtri_blocked(L, Dinv, block=512, precision=None):
    """W = L⁻¹ of the blocked lower factor, by recursive halving over
    the block grid,

        W = [ W11   0  ]      W21 = −W22 (L21 W11),
            [ W21  W22 ]

    with the stored diagonal-block inverses as leaves: n³/3
    multiply-adds of matrix products, written into one buffer.

    L is consumed: when n is a multiple of ``block`` and L is contiguous,
    that buffer is L itself (each L21 is read before W21 takes its
    place), so the inverse costs no second n × n buffer.  L's strict
    upper triangle must hold zeros, as this module's factors do."""
    _precision(precision)
    n = L.shape[0]
    nb = -(-n // block)
    npad = nb * block
    Lp = _pad_spd(L, npad) if npad != n else L
    if Dinv is None:
        Dinv = diag_block_inverses(Lp, block)
    if npad == n and L.is_contiguous():
        W = L
    else:
        W = torch.zeros((npad, npad), dtype=L.dtype, device=L.device)
    _trtri_rec(W, Lp, Dinv, 0, nb, block)
    return W[:n, :n].contiguous()


def _trtri_rec(W, Lp, Dinv, o, kb, block):
    """`trtri_blocked`'s recursion over the kb x kb block grid at o."""
    if kb == 1:
        W[o:o + block, o:o + block] = Dinv[o // block]
        return
    hb = (kb + 1) // 2
    h = hb * block
    w = (kb - hb) * block
    _trtri_rec(W, Lp, Dinv, o, hb, block)
    _trtri_rec(W, Lp, Dinv, o + h, kb - hb, block)
    W11 = W[o:o + h, o:o + h]
    W22 = W[o + h:o + h + w, o + h:o + h + w]
    L21 = Lp[o + h:o + h + w, o:o + h]
    W[o + h:o + h + w, o:o + h] = -(W22 @ (L21 @ W11))


def _solve_prep(L, B, block, Dinv):
    n = L.shape[0]
    vec = B.dim() == 1
    if vec:
        B = B[:, None]
    if Dinv is None:
        Dinv = diag_block_inverses(L, block)
    nb = Dinv.shape[0] * block
    if nb != n:
        B = torch.cat([B, torch.zeros((nb - n, B.shape[1]), dtype=B.dtype,
                                      device=B.device)])
        L = _pad_spd(L, nb)
    return L, B, Dinv, vec


def solve_lower(L, B, *, block=512, Dinv=None, precision=None):
    """X = L⁻¹ B by blocked forward substitution: each block row is one
    product with the solved rows above and one with its diagonal
    block's inverse.  ``B``: (n,) or (n, m)."""
    _precision(precision)
    n = L.shape[0]
    Lp, Bp, Dinv, vec = _solve_prep(L, B, block, Dinv)
    blocks = []
    for k in range(Dinv.shape[0]):
        c0 = k * block
        rhs = Bp[c0:c0 + block]
        if k:
            rhs = rhs - Lp[c0:c0 + block, :c0] @ torch.cat(blocks)
        blocks.append(Dinv[k] @ rhs)
    X = torch.cat(blocks)[:n]
    return X[:, 0] if vec else X


def solve_lower_t(L, B, *, block=512, Dinv=None, precision=None):
    """X = L⁻ᵀ B by blocked backward substitution."""
    _precision(precision)
    n = L.shape[0]
    Lp, Bp, Dinv, vec = _solve_prep(L, B, block, Dinv)
    nk = Dinv.shape[0]
    blocks = []
    for k in reversed(range(nk)):
        c0 = k * block
        rhs = Bp[c0:c0 + block]
        if k + 1 < nk:
            rhs = rhs - Lp[c0 + block:, c0:c0 + block].T @ torch.cat(blocks)
        blocks.insert(0, Dinv[k].T @ rhs)
    X = torch.cat(blocks)[:n]
    return X[:, 0] if vec else X
