"""Toeplitz matrix algorithms (Schur and Levinson), O(n²) time.

Counterpart of ``lsqfitgp_tpu/linalg/_toeplitz.py``.  The JAX package
runs each recursion as a ``lax.fori_loop`` that XLA compiles to one
program; here each is a Python loop over PyTorch operations on the
input's device, so a call makes O(n) launches of small kernels: fine
for the AR kernels' Yule-Walker systems (p + 1 lags) and the tests, not
for a large n.

All functions take the first row/column ``t`` of a symmetric positive
definite Toeplitz matrix ``T[i,j] = t[|i-j|]``.
"""

from __future__ import annotations

import torch

__all__ = ['chol', 'chol_solve', 'chol_matmul', 'logdet', 'solve',
           'eigv_bound']


def _float(t):
    t = torch.as_tensor(t)
    if not t.is_floating_point():
        t = t.to(torch.get_default_dtype())
    return t


def _shift(v):
    """v moved down by one place, a zero entering at the top (Z v)."""
    return torch.cat([v.new_zeros(1), v[:-1]])


def chol(t):
    """Cholesky factor L of the SPD Toeplitz matrix with first row t
    (Schur algorithm, O(n²)): column k is the first generator below
    the diagonal; then the generator is shifted down and a hyperbolic
    rotation zeroes the second one at k + 1."""
    t = _float(t)
    n = t.shape[0]
    g1 = t / torch.sqrt(t[0])
    g2 = torch.cat([g1.new_zeros(1), g1[1:]])
    tiny = torch.finfo(t.dtype).tiny
    idx = torch.arange(n, device=t.device)
    cols = []
    for k in range(n - 1):
        cols.append(torch.where(idx >= k, g1, 0.0))
        g1 = _shift(g1)
        rho = torch.where(g1[k + 1] != 0, g2[k + 1] / g1[k + 1], 0.0)
        c = 1 / torch.sqrt(torch.clamp(1 - rho * rho, min=tiny))
        g1, g2 = (g1 - rho * g2) * c, (g2 - rho * g1) * c
    cols.append(torch.where(idx == n - 1, g1, 0.0))
    return torch.stack(cols, 1)


def chol_matmul(t, m):
    """L @ m, L the Toeplitz Cholesky factor (formed: it fits when n²
    does, as in the JAX package)."""
    return chol(t) @ torch.as_tensor(m)


def chol_solve(t, b, *, diageps=None):
    """L⁻¹ b for the Toeplitz Cholesky factor (forward substitution on
    the dense factor), with ``diageps`` added to t[0] first."""
    t = _float(t)
    if diageps is not None:
        t = torch.cat([t[:1] + diageps, t[1:]])
    L = chol(t)
    b = torch.as_tensor(b, dtype=L.dtype, device=L.device)
    vec = b.dim() == 1
    x = torch.linalg.solve_triangular(L, b[:, None] if vec else b,
                                      upper=False)
    return x[:, 0] if vec else x


def logdet(t):
    """log det T from the Schur factor's diagonal."""
    return 2 * torch.log(torch.diagonal(chol(t))).sum()


def solve(t, b):
    """T⁻¹ b by the Levinson recursion, O(n²) time, O(n) state.

    After step k, ``f`` (size k+1) solves ``T_{k+1} f = e_0`` and ``x``
    (k+1 rows) solves ``T_{k+1} x = b[:k+1]``; each step extends both
    with the reversed ``f`` (T is symmetric) and two inner products."""
    t = _float(t)
    b = torch.as_tensor(b, dtype=t.dtype, device=t.device)
    n = t.shape[0]
    vec = b.dim() == 1
    bn = (b[:, None] if vec else b) / t[0]
    tn = t / t[0]
    tiny = torch.finfo(t.dtype).tiny
    f = tn.new_ones(1)
    x = bn[:1]
    for k in range(1, n):
        w = tn[1:k + 1].flip(0)                 # t[k-j], j < k
        eps = w @ f                             # extension error of f
        denom = torch.clamp(1 - eps * eps, min=tiny)
        f = (torch.cat([f, f.new_zeros(1)])
             - eps * torch.cat([f.new_zeros(1), f.flip(0)])) / denom
        r = bn[k] - w @ x                       # residual of row k
        x = torch.cat([x, x.new_zeros(1, x.shape[1])]) \
            + f.flip(0)[:, None] * r[None, :]
    return x[:, 0] if vec else x


def eigv_bound(t):
    """Upper bound on the eigenvalues of T: the largest absolute row
    sum, bounded by 2 Σ|t| − |t_0|."""
    t = _float(t)
    return 2 * t.abs().sum() - t[0].abs()
