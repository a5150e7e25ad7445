"""PSD matrix decompositions.

Counterpart of ``lsqfitgp_tpu/linalg/_decomp.py``: the `Decomposition`
contract, the regularized Cholesky `Chol` (pow2 diagonal scaling,
Gershgorin-bound eps, the float32 eps ladder, degradation probes) and
the fused marginal likelihood `chol_nll` with its hand-derived
gradient, as a `torch.autograd.Function`.

Not in this version: the double-float rescue (``df`` must be False or
'auto', which here means off), ``Chol.fisher``, the streaming
likelihoods and a backward through `Chol` itself (differentiate the
log-density through `chol_nll`).
"""

from __future__ import annotations

import abc
import math
import warnings

import torch

from . import _blocked
from .. import _torchutil
from ..ops import syrk_t_full

__all__ = ['Decomposition', 'Chol', 'chol_nll']


def _float_eps(dtype):
    return float(torch.finfo(dtype).eps)


class Decomposition(abc.ABC):
    """Abstract decomposition of a PSD matrix K, exposing regularized
    pseudo-inverse bilinear forms and Gaussian-density operations."""

    @abc.abstractmethod
    def matrix(self):
        """The (regularized) matrix K."""

    @property
    @abc.abstractmethod
    def n(self):
        """Size of K."""

    @abc.abstractmethod
    def ginv_linear(self, X):
        """K⁺ X."""

    def ginv(self):
        M = self.matrix()
        return self.ginv_linear(torch.eye(self.n, dtype=M.dtype,
                                          device=M.device))

    @abc.abstractmethod
    def pinv_bilinear(self, A, r):
        """A' K⁺ r."""

    @abc.abstractmethod
    def ginv_quad(self, A):
        """A' K⁺ A."""

    @abc.abstractmethod
    def ginv_diagquad(self, A):
        """diag(A' K⁺ A)."""

    @abc.abstractmethod
    def correlate(self, x):
        """M x with M M' = K (colored noise from white)."""

    @abc.abstractmethod
    def back_correlate(self, X):
        """M' X."""

    @abc.abstractmethod
    def pinv_correlate(self, x):
        """M⁻¹ x (whitening)."""

    @abc.abstractmethod
    def minus_log_normal_density(self, r):
        """-log N(r | 0, K) = (r'K⁺r + logdet K + n log 2π) / 2."""

    @abc.abstractmethod
    def logdet(self):
        """log det K (regularized)."""


def _parse_eps(epsrel, epsabs, n, dtype):
    """'auto' regularization scale: ``n * eps`` relative to the
    Gershgorin bound in float64; in float32 a zero relative part (the
    caller adds a diagonal-anchored ``4 * eps32`` and enables the
    escalation ladder).  Returns ``(epsrel, epsabs, escalate)``."""
    mach = _float_eps(dtype)
    f32 = mach > 1e-10
    escalate = False
    if epsrel == 'auto':
        if f32:
            epsrel = 0.0
            escalate = True
        else:
            epsrel = n * mach
    if epsabs == 'auto':
        epsabs = 4 * mach
    return float(epsrel), float(epsabs), escalate


def diag_scale_pow2(K):
    """Power-of-2 diagonal scaling s with s_i ≈ 1/sqrt(K_ii), exactly
    representable, so scaling introduces no rounding error."""
    d = torch.diagonal(K)
    safe = torch.where(d > 0, d, torch.ones((), dtype=d.dtype,
                                            device=d.device))
    return torch.exp2(torch.round(-0.5 * torch.log2(safe)))


def eigval_bound(K):
    """Cheap upper bound on the max eigenvalue (Gershgorin)."""
    return K.abs().sum(1).max()


def _small_factor_ladder(K, s, eps, eps2, escalate):
    """Unblocked (n < 1024) factorization of ``diag(s) K diag(s) + eps
    I``, escalating once to ``eps2`` (with the self-healing lift) when
    the small-eps factor is non-finite.  Returns ``(L, eps_used,
    escalated)``."""
    n = K.shape[0]
    eye = torch.eye(n, dtype=K.dtype, device=K.device)

    def small(e, heal):
        Ks = K * s[:, None] * s[None, :] + e * eye
        return _blocked._chol_lifted(Ks, True if heal else None)

    L = small(eps, heal=not escalate)
    if not escalate or bool(torch.isfinite(L).all()):
        return L, eps, False
    return small(eps2, True), eps2, True


class Chol(Decomposition):
    """Regularized Cholesky decomposition.

    K is scaled to near-unit diagonal with exact power-of-2 factors, a
    regularization ``eps = epsrel * maxeig_bound + epsabs`` is added to
    the scaled diagonal, and the Cholesky factor is taken.  In float32
    'auto' is the two-rung ladder: a tiny diagonal-anchored eps
    (``4 * eps32 *`` the max scaled diagonal), refactored with the
    bound-scaled ``32 * eps32 * bound`` only when the first factor is
    non-finite.

    ``blocked='auto'`` uses the blocked recursive factorization (kernel
    A on CUDA) and blocked solves for ``n >= 1024``.  ``df`` is accepted
    for parity with the JAX package: the double-float rescue is not in
    this version, so only False and 'auto' (meaning off) are allowed.

    The factor has no backward: differentiate the log-density through
    `chol_nll` (or ``GP.marginal_likelihood``).
    """

    _BLOCK = 512

    def __init__(self, K, *, epsrel='auto', epsabs=0, blocked='auto',
                 precision=None, block=None, df='auto'):
        if df not in (False, 'auto'):
            raise NotImplementedError(
                'the double-float rescue (df) is not in lsqfitgp_torch yet')
        K = torch.as_tensor(K)
        if K.requires_grad and torch.is_grad_enabled():
            raise NotImplementedError(
                'Chol has no backward in lsqfitgp_torch; differentiate the '
                'log-density through linalg.chol_nll')
        n = K.shape[0]
        epsrel, epsabs, escalate = _parse_eps(epsrel, epsabs, n, K.dtype)
        mach = _float_eps(K.dtype)
        s = diag_scale_pow2(K)
        # Gershgorin bound of the scaled matrix as a scaled |K| matvec
        bound = (s * (K.abs() @ s)).max()
        eps = epsrel * bound + epsabs
        if escalate:
            dmax = (torch.diagonal(K) * s * s).max()
            eps = eps + 4 * mach * dmax
            eps2 = 32 * mach * bound + epsabs
        else:
            eps2 = eps
        eps = torch.as_tensor(eps, dtype=K.dtype, device=K.device)
        eps2 = torch.as_tensor(eps2, dtype=K.dtype, device=K.device)
        if block is not None:
            self._BLOCK = int(block)
        if blocked == 'auto':
            blocked = n >= 1024
        escalated = False
        if blocked:
            if escalate and precision is None:
                L, Dinv, eps, escalated = \
                    _blocked.chol_factor_scaled_ladder(
                        K, s, eps, eps2, self._BLOCK, 128)
            else:
                L, Dinv = _blocked.chol_factor_scaled(
                    K, s, eps, self._BLOCK, 128, precision, not escalate)
                if escalate and not bool(torch.isfinite(Dinv).all()):
                    L, Dinv = _blocked.chol_factor_scaled(
                        K, s, eps2, self._BLOCK, 128, 'highest')
                    eps = eps2
                    escalated = True
        else:
            L, eps, escalated = _small_factor_ladder(K, s, eps, eps2,
                                                     escalate)
            Dinv = None
        self._L = L
        self._Dinv = Dinv
        self._s = s
        self._eps = eps
        self._escalated = escalated
        # matvec-probe estimate of the factorization backward error, in
        # units of one rounding of the dominant eigenvalue
        v = torch.where(torch.arange(n, device=K.device) % 2 == 0, 1.0,
                        -1.0).to(K.dtype)
        Kv = s * (K @ (s * v)) + eps * v
        LLtv = L @ (L.T @ v)
        tiny = torch.finfo(K.dtype).tiny
        self._resid_ratio = (Kv - LLtv).abs().max() \
            / torch.clamp(mach * bound, min=tiny)
        # pivot-based condition estimate: bound over the smallest pivot²
        self._cond_est = bound / torch.clamp(
            torch.diagonal(L).min() ** 2, min=tiny)

    @property
    def n(self):
        return self._L.shape[0]

    @property
    def eps(self):
        return self._eps

    @property
    def accuracy_ratio(self):
        """Matvec-probe backward-error estimate, in units of one rounding
        (``eps * maxeig_bound``)."""
        return self._resid_ratio

    @property
    def cond_estimate(self):
        """Condition-number estimate of the regularized scaled matrix:
        Gershgorin λmax bound over the smallest pivot²."""
        return self._cond_est

    def _warn_if_degraded(self, what):
        """Eager numerical-reliability warning at inverse-using
        operations.  Three signals: the escalation to the bound-scaled
        eps fired; the probe residual is far above healthy (the
        self-healing lift engaged); the condition estimate approaches
        1/eps.  Skipped while checks are off (inside `empbayes_fit`'s
        objective)."""
        mach = _float_eps(self._L.dtype)

        def check():
            n = self.n
            if self._escalated:
                warnings.warn(
                    f'Chol.{what}: the matrix was numerically singular '
                    f'at {self._L.dtype}; the factorization used the '
                    f'fallback regularization eps={float(self._eps):.2e} '
                    f'which may exceed the model noise.  Likelihoods '
                    f'and gradients are unreliable; add noise, pass '
                    f'epsabs explicitly, or use float64.')
            elif float(self._resid_ratio) > 100 * max(1., n ** 0.5):
                warnings.warn(
                    f'Chol.{what}: factorization residual '
                    f'{float(self._resid_ratio):.1e} eps-units means '
                    f'self-healing regularization engaged: conditioning '
                    f'is at the {self._L.dtype} limit and results may '
                    f'be inaccurate.  Add noise or use float64.')
            elif float(self._cond_est) > 0.3 / mach:
                warnings.warn(
                    f'Chol.{what}: condition number ~'
                    f'{float(self._cond_est):.1e} approaches the '
                    f'{self._L.dtype} resolution 1/eps={1 / mach:.1e}; '
                    f'solve and gradient accuracy degrades as '
                    f'eps*cond.  Add noise or use float64.')

        _torchutil.check(check)

    def matrix(self):
        L, s = self._L, self._s
        return (L @ L.T) / (s[:, None] * s[None, :])

    # -- solves ----------------------------------------------------------

    def _solve_L(self, x):
        """L⁻¹ x"""
        if self._Dinv is not None:
            return _blocked.solve_lower(self._L, x, block=self._BLOCK,
                                        Dinv=self._Dinv)
        X = x[:, None] if x.dim() == 1 else x
        out = torch.linalg.solve_triangular(self._L, X, upper=False)
        return out[:, 0] if x.dim() == 1 else out

    def _solve_Lt(self, x):
        """L'⁻¹ x"""
        if self._Dinv is not None:
            return _blocked.solve_lower_t(self._L, x, block=self._BLOCK,
                                          Dinv=self._Dinv)
        X = x[:, None] if x.dim() == 1 else x
        out = torch.linalg.solve_triangular(self._L.T, X, upper=True)
        return out[:, 0] if x.dim() == 1 else out

    def _scale(self, X):
        return X * (self._s[:, None] if X.dim() > 1 else self._s)

    def ginv_linear(self, X):
        self._warn_if_degraded('ginv_linear')
        return self._scale(self._solve_Lt(self._solve_L(self._scale(X))))

    def pinv_bilinear(self, A, r):
        # A' K⁻¹ r = (L⁻¹ S A)' (L⁻¹ S r)
        self._warn_if_degraded('pinv_bilinear')
        ZA = self._solve_L(A * self._s[:, None])
        zr = self._solve_L(r * self._s)
        return ZA.T @ zr

    def ginv_quad(self, A):
        self._warn_if_degraded('ginv_quad')
        ZA = self._solve_L(A * self._s[:, None])
        return ZA.T @ ZA

    def ginv_diagquad(self, A):
        ZA = self._solve_L(A * self._s[:, None])
        return (ZA * ZA).sum(0)

    def correlate(self, x):
        """(S⁻¹ L) x, where (S⁻¹L)(S⁻¹L)' = K."""
        out = self._L @ x
        return out / (self._s[:, None] if out.dim() > 1 else self._s)

    def back_correlate(self, X):
        Xs = X / (self._s[:, None] if X.dim() > 1 else self._s)
        return self._L.T @ Xs

    def pinv_correlate(self, x):
        return self._solve_L(self._scale(x))

    # -- density ---------------------------------------------------------

    def logdet(self):
        if self._Dinv is not None:
            # diag(L) = 1/diag(Dinv blocks); identity-padded tail blocks
            # contribute log 1 = 0
            d = torch.diagonal(self._Dinv, dim1=1, dim2=2)
            twologdiagL = -2 * torch.log(d).sum()
        else:
            twologdiagL = 2 * torch.log(torch.diagonal(self._L)).sum()
        return twologdiagL - 2 * torch.log(self._s).sum()

    def minus_log_normal_density(self, r):
        self._warn_if_degraded('minus_log_normal_density')
        z = self.pinv_correlate(r)
        return 0.5 * (torch.dot(z, z) + self.logdet()
                      + self.n * math.log(2 * math.pi))


class _CholNLL(torch.autograd.Function):
    """The fused log-density with the hand-derived reverse rule

        ∂V/∂K = ½ S (K_s⁻¹ − z̃ z̃ᵀ) S,   z̃ = K_s⁻¹ S r,   ∂V/∂r = S z̃,

    with ``K_s = S K S + eps·I = L Lᵀ`` (S and eps held constant: S is
    pow2-quantized and the eps sensitivity is O(eps)).  ``K_s⁻¹`` is
    one blocked triangular inverse (`trtri_blocked`) and one
    triangular-skip WᵀW (kernel B on CUDA)."""

    @staticmethod
    def forward(ctx, K, r, opts):
        dec = Chol(K, **dict(opts))
        ctx.dec = dec
        ctx.precision = dict(opts).get('precision')
        ctx.save_for_backward(r)
        return dec.minus_log_normal_density(r)

    @staticmethod
    def backward(ctx, g):
        r, = ctx.saved_tensors
        dec = ctx.dec
        if dec is None:
            raise RuntimeError('chol_nll: the backward consumes the factor, '
                               'so it runs once per forward')
        # drop the factor once read, so that it and its float64 copy are
        # never alive together with the carrier
        ctx.dec = None
        zt = dec._s * dec._solve_Lt(dec.pinv_correlate(r))  # S K_s⁻¹ S r
        s, Dinv, block = dec._s, dec._Dinv, dec._BLOCK
        # K_s⁻¹ is formed in float64 even from a float32 factor.  The
        # contraction <K⁻¹, ∂K> needs K⁻¹ accurate on the smooth,
        # large-eigenvalue subspace, where its entries are ~1/λmax, and
        # a float32 inverse is not: on the H100 at n = 16384 (cond_est
        # 1.6e5) the float32 carrier gave ∂NLL/∂log(amp) = −3.6 where
        # float64 gives +8.3, and BFGS stalled; inverting the same
        # float32 factor in float64 gives +8.30 (see PERF.md).  Memory:
        # the float64 copy of L becomes L⁻¹ in place, so the carrier
        # holds two float64 n × n buffers at its peak (W and K-bar).
        wide = torch.promote_types(r.dtype, torch.float64)
        W = dec._L.to(wide)
        del dec
        if Dinv is not None:
            W = _blocked.trtri_blocked(W, Dinv.to(wide), block, ctx.precision)
            Kbar = syrk_t_full(W, precision=ctx.precision)
        else:
            eye = torch.eye(W.shape[0], dtype=wide, device=r.device)
            W = torch.linalg.solve_triangular(W, eye, upper=False)
            Kbar = W.T @ W
        del W
        # Kbar = ½ S (K_s⁻¹ − (zt/s)(zt/s)ᵀ) S, in place (n² buffers are
        # the gradient's peak memory)
        s = s.to(wide)
        ztw = zt.to(wide)
        Kbar.mul_(s[:, None]).mul_(s[None, :])
        Kbar.addr_(ztw, ztw, alpha=-1).mul_(0.5 * g.to(wide))
        gr = g * zt if ctx.needs_input_grad[1] else None
        return Kbar.to(r.dtype), gr, None


def chol_nll(K, r, **choleskykw):
    """Fused ``Chol(K, **kw).minus_log_normal_density(r)`` whose
    gradient with respect to K and r is the hand-derived rule instead
    of autograd through the factorization: value+gradient costs about
    two factorizations' worth of products."""
    return _CholNLL.apply(K, torch.as_tensor(r),
                          tuple(sorted(choleskykw.items())))
