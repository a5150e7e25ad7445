"""PSD matrix decompositions.

Counterpart of ``lsqfitgp_tpu/linalg/_decomp.py``: the `Decomposition`
contract, the regularized Cholesky `Chol` (pow2 diagonal scaling,
Gershgorin-bound eps, the float32 eps ladder, degradation probes), the
fused marginal likelihood `chol_nll` with its hand-derived gradient, as
a `torch.autograd.Function`, and the streaming likelihood and posterior
(`chol_nll_stream`, `chol_nll_stream_grad`, `chol_pred_stream`), which
never form the Gram matrix.

The float32 rescue (``Chol(df=...)``) refactors in native float64
where the JAX package refactors in emulated double precision (its
``linalg/_df.py`` is not ported).

`chol_nll` has forward mode (its ``jvp``, the JAX rule ``⟨K̄, dK⟩ +
⟨S z̃, dr⟩``) and, evaluated inside `second_order`, a backward that is
differentiable once more, by the closed-form second derivative
(`_CholNLLGrad`); `Chol.fisher` and `Chol.fishvec_cotangent` are the
Fisher information and the cotangents of a Fisher-vector product.  Not
in this version: a backward through `Chol` itself (differentiate the
log-density through `chol_nll`), the streaming gradient's Hutchinson
estimate (``exact=False``), the streamed Fisher information and the
left-looking streaming factorization.
"""

from __future__ import annotations

import abc
import contextlib
import contextvars
import math
import warnings

import torch

from . import _blocked
from .. import _torchutil
from .. import ops
from ..ops import syrk_t_full_

__all__ = ['Decomposition', 'Chol', 'chol_nll', 'second_order',
           'chol_nll_stream', 'chol_nll_stream_grad', 'chol_pred_stream',
           'solve_batched_triangular', 'solve_batched']


# the largest n the float32 rescue takes at df='auto' (the JAX package's
# DF_MAX, lsqfitgp_tpu/linalg/_df.py)
DF_MAX = 4096


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
    A on CUDA) and blocked solves for ``n >= 1024``.

    ``df`` is the float32 rescue, on the JAX package's triggers: in
    float32 'auto' (``epsrel='auto'``), with ``df=True`` or ``df='auto'``
    and ``n <= DF_MAX``, when the ladder escalated or the condition
    estimate passes ``0.1 / eps32``, ``diag(s) K diag(s) + eps I`` is
    factored again in float64 at the primary (small) eps, through the
    same blocked path (kernel A on the FP64 tensor cores on CUDA).  The
    solves, ``logdet`` and the log-density then run in float64 on that
    factor and return the input's dtype; `correlate` keeps the float32
    factor.  ``df_gram``, a callable returning the model's Gram in
    float64, is refactored in its place at ``eps = n 2⁻⁴⁹ max(diag(s K
    s))`` (the GP passes it for a model kernel C can assemble).  The
    JAX package refactors in emulated double precision instead.  A
    matrix still indefinite in float64 keeps the float32 result, and
    the warnings tell the three outcomes apart.  ``df=False`` disables
    the rescue; well-posed inputs get the same bits either way.

    The factor has no backward: differentiate the log-density through
    `chol_nll` (or ``GP.marginal_likelihood``).
    """

    _BLOCK = 512

    def __init__(self, K, *, epsrel='auto', epsabs=0, blocked='auto',
                 precision=None, block=None, df='auto', df_gram=None):
        if df not in (False, True, 'auto'):
            raise ValueError(f"df must be True, False or 'auto', not {df!r}")
        K = torch.as_tensor(K)
        if K.requires_grad and torch.is_grad_enabled():
            raise NotImplementedError(
                'Chol has no backward in lsqfitgp_torch; differentiate the '
                'log-density through linalg.chol_nll')
        n = K.shape[0]
        epsrel, epsabs, escalate = _parse_eps(epsrel, epsabs, n, K.dtype)
        rescuable = escalate and df is not False \
            and (df is True or n <= DF_MAX)
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
        eps_primary = eps
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
        # the float32 rescue: (L, Dinv) of the float64 refactor that
        # rescued, which the solves and the density then use
        self._wide = None
        self._df_rescued = self._df_failed = False
        self._df_gram_used = df_gram is not None
        # two triggers, the JAX package's: the ladder escalated (the
        # result is biased by eps2), or the condition estimate is past
        # 0.1/eps32, where the fused gradient's error crosses ~1 %
        if rescuable and (escalated
                          or float(self._cond_est) > 0.1 / mach):
            self._rescue(K, s, eps_primary, df_gram, blocked)

    def _rescue(self, K, s, epsp, df_gram, blocked):
        """Factor ``diag(s) K diag(s) + epsp I`` again in float64, or the
        float64 Gram ``df_gram()`` in K's place at ``n 2⁻⁴⁹ max(diag(s K
        s))``; keep the factor if it is finite."""
        n = K.shape[0]
        wide = torch.float64
        with torch.no_grad():
            if df_gram is not None:
                # the Gram is the model's own: regularize at the float64
                # scale, not at the float32 anchor (which would bias the
                # NLL by more than the float32 result's error)
                dmax = (torch.diagonal(K) * s * s).max()
                epsp = torch.as_tensor(n * 2.0 ** -49, dtype=K.dtype,
                                       device=K.device) * dmax
                Kw = df_gram().to(wide)
            else:
                Kw = K.detach().to(wide)
            sw, ew = s.to(wide), epsp.to(wide)
            if blocked:
                L, Dinv = _blocked.chol_factor_scaled(
                    Kw, sw, ew, self._BLOCK, 128, 'highest', heal=False)
                ok = _blocked._finite(Dinv)
            else:
                Kw.mul_(sw[:, None]).mul_(sw[None, :])
                Kw.diagonal().add_(ew)
                L, Dinv = _blocked._chol_lifted(Kw, None), None
                ok = bool(torch.isfinite(torch.diagonal(L)).all())
            del Kw
        if ok:
            self._wide = (L, Dinv)
            self._eps = epsp.detach()
        self._df_rescued, self._df_failed = ok, not ok

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
            dtype = self._L.dtype
            if self._df_rescued:
                # accuracy recovered: only the cost is worth a word
                warnings.warn(
                    f'Chol.{what}: conditioning exceeded the {dtype} '
                    f'factorization limit; rescued by a float64 '
                    f'refactorization (accurate, but the solves and the '
                    f'density run in float64).  Add noise or pass epsabs '
                    f'to stay on the {dtype} path.')
            elif self._df_failed:
                if self._df_gram_used:
                    why = ('the Gram was assembled in float64, so the MODEL '
                           'itself is singular at this eps; the result '
                           f'keeps the {dtype} fallback regularization')
                else:
                    why = (f'the {dtype}-assembled Gram carries rounding '
                           'error that can fake indefiniteness at cond '
                           '≳ 1e6; a profile-expressible model (plain '
                           'isotropic kernel + noise) would get a float64 '
                           'Gram assembly and may still be rescuable')
                warnings.warn(
                    f'Chol.{what}: the float64 rescue was attempted but '
                    f'the factorization found the matrix indefinite '
                    f'({why}).  Results use eps={float(self._eps):.2e}; '
                    f'add noise, raise epsabs, or use float64.')
            elif self._escalated:
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

    def _wide_solve(self, x, trans):
        """L⁻¹ x, or L'⁻¹ x with ``trans``, on the float64 factor of the
        rescue, in float64."""
        L, Dinv = self._wide
        x = x.to(L.dtype)
        if Dinv is not None:
            solve = _blocked.solve_lower_t if trans else _blocked.solve_lower
            return solve(L, x, block=self._BLOCK, Dinv=Dinv)
        X = x[:, None] if x.dim() == 1 else x
        out = torch.linalg.solve_triangular(L.T if trans else L, X,
                                            upper=trans)
        return out[:, 0] if x.dim() == 1 else out

    def _solve_L(self, x):
        """L⁻¹ x"""
        if self._wide is not None:
            return self._wide_solve(x, False).to(x.dtype)
        if self._Dinv is not None:
            return _blocked.solve_lower(self._L, x, block=self._BLOCK,
                                        Dinv=self._Dinv)
        X = x[:, None] if x.dim() == 1 else x
        out = torch.linalg.solve_triangular(self._L, X, upper=False)
        return out[:, 0] if x.dim() == 1 else out

    def _solve_Lt(self, x):
        """L'⁻¹ x"""
        if self._wide is not None:
            return self._wide_solve(x, True).to(x.dtype)
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
        if self._wide is not None:
            s = self._s.to(self._wide[0].dtype)
            s = s[:, None] if X.dim() > 1 else s
            Z = self._wide_solve(self._wide_solve(X * s, False), True)
            return (Z * s).to(X.dtype)
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

    def _logdet_wide(self):
        """log det K from the rescue's float64 factor, in float64."""
        L, _ = self._wide
        return 2 * torch.log(torch.diagonal(L)).sum() \
            - 2 * torch.log(self._s.to(L.dtype)).sum()

    def logdet(self):
        if self._wide is not None:
            return self._logdet_wide().to(self._L.dtype)
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
        if self._wide is not None:
            z = self._wide_solve(r * self._s.to(torch.float64), False)
            v = 0.5 * (torch.dot(z, z) + self._logdet_wide()
                       + self.n * math.log(2 * math.pi))
            return v.to(r.dtype)
        z = self.pinv_correlate(r)
        return 0.5 * (torch.dot(z, z) + self.logdet()
                      + self.n * math.log(2 * math.pi))

    # -- curvature -----------------------------------------------------------

    def _solve_factor(self, X):
        """L⁻¹ X on the factor of K's dtype (the rescue's float64 factor
        is not used, as in the JAX package's Fisher)."""
        if self._Dinv is not None:
            return _blocked.solve_lower(self._L, X, block=self._BLOCK,
                                        Dinv=self._Dinv)
        return torch.linalg.solve_triangular(self._L, X, upper=False)

    def fisher(self, dK, dr):
        """Fisher information of the parameters p of (K(p), r(p)),

            F_ij = tr(K⁻¹ dK_i K⁻¹ dK_j)/2 + dr_iᵀ K⁻¹ dr_j,

        ``dK`` of shape (P, n, n) (or a sequence of P matrices), ``dr``
        (P, n).  B_i = L⁻¹ S dK_i S L⁻ᵀ by two triangular solves with n
        right-hand sides each, then F^K_ij = ½ Σ B_i ∘ B_jᵀ.  As the JAX
        package's, on the factor of K's dtype even where the float32
        rescue fired (a curvature estimate for a Laplace covariance)."""
        s = self._s
        B = []
        for dKi in dK:
            A = self._solve_factor(dKi * s[:, None] * s[None, :])
            B.append(self._solve_factor(A.T.contiguous()))
            del A
        P = len(B)
        FK = torch.stack([torch.stack([(B[i] * B[j].T).sum()
                                       for j in range(P)])
                          for i in range(P)])
        zr = self._solve_factor((dr * s).T.contiguous())
        return 0.5 * FK + zr.T @ zr

    def fishvec_cotangent(self, dKv, drv):
        """Cotangents ``(C_K, c_r)`` of a Fisher-vector product: given
        the directional derivatives ``dKv`` (n, n) and ``drv`` (n,) of
        (K, r) along a parameter direction v, pulling ``(C_K, c_r)`` back
        through the vjp of p → (K(p), r(p)) gives

            (F v)_i = tr(K⁻¹ ∂K_i K⁻¹ dKv)/2 + ∂r_iᵀ K⁻¹ drv

        in O(n²) memory: ``C_K = K⁻¹ dKv K⁻¹ / 2`` (symmetrized) and
        ``c_r = K⁻¹ drv``."""
        M = self.ginv_linear(self.ginv_linear(dKv).T)
        M = 0.5 * (M + M.T)
        return 0.5 * M, self.ginv_linear(drv)



# whether `chol_nll` is evaluated twice differentiable (`second_order`),
# and the factor shared by the passes of one forward-mode gradient
# (`_share_factor`)
_SECOND_ORDER = contextvars.ContextVar('lsqfitgp_torch_second_order',
                                       default=False)
_SHARED = contextvars.ContextVar('lsqfitgp_torch_shared_factor',
                                 default=None)

_THIRD = ('chol_nll is differentiable twice in lsqfitgp_torch: a third '
          'derivative is not implemented')


@contextlib.contextmanager
def second_order():
    """Evaluate `chol_nll` twice differentiable.  Inside, it keeps K in
    the autograd graph until its backward, which under ``create_graph``
    returns (K̄, r̄) through `_CholNLLGrad`, whose own backward is the
    closed-form second derivative.  Outside, K is freed after the
    forward (the first-order path's memory) and a ``create_graph``
    backward raises rather than contributing zero."""
    token = _SECOND_ORDER.set(True)
    try:
        yield
    finally:
        _SECOND_ORDER.reset(token)


@contextlib.contextmanager
def _share_factor():
    """Within, `chol_nll` evaluations of equal (K, r, options) share one
    factorization and one gradient carrier: the P forward-mode passes of
    one gradient factor once."""
    token = _SHARED.set({})
    try:
        yield
    finally:
        _SHARED.reset(token)


def _factor(K, r, opts):
    """``Chol(K, **opts)``, or within `_share_factor` the factor of an
    earlier evaluation of the same K, r and options (the float64 Gram's
    closure, rebuilt with each evaluation, is the same model's)."""
    shared = _SHARED.get()
    key = tuple(kv for kv in opts if kv[0] != 'df_gram')
    if shared is not None and shared.get('key') == key \
            and shared['K'].shape == K.shape and torch.equal(shared['K'], K) \
            and torch.equal(shared['r'], r):
        return shared['dec']
    dec = Chol(K, **dict(opts))
    if shared is not None:
        shared.update(key=key, K=K, r=r, dec=dec)
    return dec


def _kinv_wide(box, r, precision, keep):
    """``(K_s⁻¹, zt, s)``: K_s⁻¹ in float64, zt = S K_s⁻¹ S r and the
    scaling, from the factor in ``box``, a one-element list that this
    empties so that the factor's last reference goes with it: the
    float32 factor is then freed once its float64 copy exists, and the
    copy becomes L⁻¹ in place (`trtri_blocked`) and then K_s⁻¹ = WᵀW in
    place (kernel B).  With ``keep`` the factor stays usable: a float64
    factor is copied before it is inverted."""
    dec = box.pop()
    wide = torch.promote_types(r.dtype, torch.float64)
    if dec._wide is not None:
        # rescued: the carrier and zt from the float64 factor, whose
        # buffer then becomes the carrier's
        sw = dec._s.to(wide)
        zt = sw * dec._wide_solve(dec._wide_solve(r * sw, False), True)
        W, Dinv = dec._wide
    else:
        zt = dec._s * dec._solve_Lt(dec.pinv_correlate(r))  # S K_s⁻¹ S r
        W, Dinv = dec._L, dec._Dinv
    if keep and W.dtype == wide:
        W = W.clone()
    W = W.to(wide)
    s, block = dec._s, dec._BLOCK
    del dec
    if Dinv is not None:
        W = _blocked.trtri_blocked(W, Dinv.to(wide), block, precision)
        del Dinv
        return syrk_t_full_(W, precision=precision), zt, s
    eye = torch.eye(W.shape[0], dtype=wide, device=r.device)
    W = torch.linalg.solve_triangular(W, eye, upper=False)
    return W.T @ W, zt, s


class _Curvature:
    """What the second derivative of the log-density needs, kept across
    the passes of one Hessian: K_s⁻¹ in float64, the scaling S, zt =
    S K_s⁻¹ S r and w = K_s⁻¹ S r (S and eps held constant, as in the
    JAX rule)."""

    def __init__(self, box, r, precision, keep):
        self.kinv, zt, s = _kinv_wide(box, r, precision, keep)
        wide = self.kinv.dtype
        self.s = s.to(wide)
        self.zt = zt.to(wide)
        self.w = self.zt / self.s
        self.dtype = r.dtype

    def kbar(self):
        """K̄ = ½ S (K_s⁻¹ − w wᵀ) S, in float64."""
        s = self.s
        Kbar = self.kinv * s[:, None] * s[None, :]
        return Kbar.addr_(self.zt, self.zt, alpha=-1).mul_(0.5)

    def hvp(self, dK, dr):
        """The tangent of (K̄, r̄) along (dK, dr), in float64:

            dK̄ = ½ S (−K_s⁻¹ dK_s K_s⁻¹ + q wᵀ + w qᵀ) S,
            dr̄ = S (v − u),

        with dK_s = S sym(dK) S, u = K_s⁻¹ dK_s w, v = K_s⁻¹ S dr and
        q = u − v.  It is the Hessian of the log-density applied to
        (dK, dr), so it is also the VJP of (K̄, r̄).  Either tangent may
        be None (zero)."""
        Kinv, s, w = self.kinv, self.s, self.w
        u = v = torch.zeros_like(w)
        if dK is not None:
            dKs = dK.to(Kinv.dtype)
            dKs = (dKs + dKs.T).mul_(0.5 * s[:, None]).mul_(s[None, :])
            A = Kinv @ dKs
            del dKs
            u = A @ w
            out = torch.matmul(A, Kinv).neg_()   # −K_s⁻¹ dK_s K_s⁻¹
            del A
        else:
            out = torch.zeros_like(Kinv)
        if dr is not None:
            v = Kinv @ (s * dr.to(Kinv.dtype))
        q = u - v
        out.addr_(q, w).addr_(w, q).mul_(0.5 * s[:, None]).mul_(s[None, :])
        return out, s * (v - u)


class _CholNLL(torch.autograd.Function):
    """The fused log-density with the hand-derived reverse rule

        ∂V/∂K = ½ S (K_s⁻¹ − z̃ z̃ᵀ) S,   z̃ = K_s⁻¹ S r,   ∂V/∂r = S z̃,

    with ``K_s = S K S + eps·I = L Lᵀ`` (S and eps held constant: S is
    pow2-quantized and the eps sensitivity is O(eps)).  ``K_s⁻¹`` is
    one blocked triangular inverse (`trtri_blocked`) and one
    triangular-skip WᵀW (kernel B on CUDA), both in one buffer.

    Forward mode (``jvp``) is the JAX rule ``⟨K̄, dK⟩ + ⟨S z̃, dr⟩`` with
    the carrier formed the same way, once per factor.  Evaluated inside
    `second_order`, the backward under ``create_graph`` returns (K̄, r̄)
    through `_CholNLLGrad`, keeping K_s⁻¹ for the passes of a Hessian;
    the ordinary backward keeps its single-use, in-place path."""

    @staticmethod
    def forward(ctx, K, r, opts):
        ctx.dec = _factor(K, r, opts)
        ctx.shared = _SHARED.get() is not None
        ctx.precision = dict(opts).get('precision')
        ctx.twice = _SECOND_ORDER.get()
        ctx.save_for_backward(r, K if ctx.twice else None)
        ctx.save_for_forward(r)
        return ctx.dec.minus_log_normal_density(r)

    @staticmethod
    def jvp(ctx, dK, dr, _):
        r, = ctx.saved_tensors
        dec = ctx.dec
        if dec is None:
            raise RuntimeError('chol_nll: the factor was consumed by the '
                               'backward')
        # the carrier, once per factor (the passes of one forward-mode
        # gradient share it, `_share_factor`)
        if getattr(dec, '_carrier', None) is None:
            cur = _Curvature([dec], r, ctx.precision, keep=True)
            dec._carrier = (cur.kbar(), cur.zt)
            del cur
        Kbar, zt = dec._carrier
        out = zt.new_zeros(())
        if dK is not None:
            out = out + torch.vdot(Kbar.reshape(-1),
                                   dK.reshape(-1).to(Kbar.dtype))
        if dr is not None:
            out = out + torch.dot(zt, dr.to(zt.dtype))
        return out.to(r.dtype)

    @staticmethod
    def backward(ctx, g):
        r, K = ctx.saved_tensors
        if ctx.dec is None:
            raise RuntimeError('chol_nll: the backward consumes the factor, '
                               'so it runs once per forward')
        # the factor goes with the box: it and its float64 copy are never
        # alive together with the carrier.  Inside `second_order` (and
        # within `_share_factor`) it stays, so the backward may run again
        keep = ctx.twice or ctx.shared
        box = [ctx.dec]
        if not keep:
            ctx.dec = None
        if torch.is_grad_enabled():
            # create_graph: the gradient as a Function of (K, r, g)
            if K is None:
                raise RuntimeError(
                    'chol_nll was evaluated once differentiable: evaluate '
                    'it inside lsqfitgp_torch.linalg.second_order() for a '
                    'backward with create_graph (a Hessian)')
            state = _Curvature(box, r, ctx.precision, keep=True)
            Kbar, gr = _CholNLLGrad.apply(K, r, g, state)
            return Kbar, gr if ctx.needs_input_grad[1] else None, None
        # K_s⁻¹ is formed in float64 even from a float32 factor.  The
        # contraction <K⁻¹, ∂K> needs K⁻¹ accurate on the smooth,
        # large-eigenvalue subspace, where its entries are ~1/λmax, and
        # a float32 inverse is not: on the H100 at n = 16384 (cond_est
        # 1.6e5) the float32 carrier gave ∂NLL/∂log(amp) = −3.6 where
        # float64 gives +8.3, and BFGS stalled; inverting the same
        # float32 factor in float64 gives +8.30 (see PERF.md).  Memory:
        # the float64 copy of L becomes L⁻¹ in place and then K_s⁻¹ =
        # WᵀW in place (kernel B), so the carrier is one float64 n × n
        # buffer: the peaks are the float32 L beside its float64 copy
        # and the float64 K-bar beside its float32 result, 12 bytes per
        # n² from a float32 factor.
        Kbar, zt, s = _kinv_wide(box, r, ctx.precision, keep)
        wide = Kbar.dtype
        # Kbar = ½ S (K_s⁻¹ − (zt/s)(zt/s)ᵀ) S, in place (n² buffers are
        # the gradient's peak memory)
        s = s.to(wide)
        ztw = zt.to(wide)
        Kbar.mul_(s[:, None]).mul_(s[None, :])
        Kbar.addr_(ztw, ztw, alpha=-1).mul_(0.5 * g.to(wide))
        gr = (g * zt).to(r.dtype) if ctx.needs_input_grad[1] else None
        return Kbar.to(r.dtype), gr, None


class _CholNLLGrad(torch.autograd.Function):
    """The gradient of `chol_nll`, ``(g K̄, g S z̃)``, as a function of
    (K, r, g): its backward is the closed-form second derivative
    (`_Curvature.hvp`, which is self-adjoint), what
    ``jax.jacfwd(jax.grad(chol_nll))`` computes through the factor's
    tangent, with S and eps held constant."""

    @staticmethod
    def forward(ctx, K, r, g, state):
        ctx.state = state
        ctx.save_for_backward(g)
        ctx.set_materialize_grads(False)
        gw = g.to(state.kinv.dtype)
        return (state.kbar() * gw).to(r.dtype), (state.zt * gw).to(r.dtype)

    @staticmethod
    def backward(ctx, cK, cr):
        if torch.is_grad_enabled():
            raise RuntimeError(_THIRD)
        g, = ctx.saved_tensors
        st = ctx.state
        need_K, need_r, need_g = ctx.needs_input_grad[:3]
        gK = gr = gg = None
        if need_K or need_r:
            dKbar, drbar = st.hvp(cK, cr)
            gw = g.to(st.kinv.dtype)
            gK = (dKbar * gw).to(st.dtype) if need_K else None
            gr = (drbar * gw).to(st.dtype) if need_r else None
        if need_g:
            gg = st.zt.new_zeros(())
            if cK is not None:
                gg = gg + torch.vdot(st.kbar().reshape(-1),
                                     cK.reshape(-1).to(gg.dtype))
            if cr is not None:
                gg = gg + torch.dot(st.zt, cr.to(gg.dtype))
            gg = gg.to(g.dtype)
        return gK, gr, gg, None


def chol_nll(K, r, **choleskykw):
    """Fused ``Chol(K, **kw).minus_log_normal_density(r)`` whose
    gradient with respect to K and r is the hand-derived rule instead
    of autograd through the factorization: value+gradient costs about
    two factorizations' worth of products.  Forward mode works
    everywhere; a Hessian (a backward with ``create_graph``) needs the
    evaluation inside `second_order`."""
    return _CholNLL.apply(K, torch.as_tensor(r),
                          tuple(sorted(choleskykw.items())))


def solve_batched_triangular(L, B):
    """X = L⁻¹ B for lower-triangular L, with B of shape (n, m), (P, n)
    (each row a right-hand side) or (..., n, m)."""
    if B.dim() == 2 and B.shape[0] == L.shape[0]:
        return torch.linalg.solve_triangular(L, B, upper=False)
    if B.dim() == 2:
        return torch.linalg.solve_triangular(L, B.T, upper=False).T
    return torch.linalg.solve_triangular(L, B, upper=False)


def solve_batched(decomp, B):
    """K⁺ B through the decomposition."""
    return decomp.ginv_linear(B)


# -- streaming (never-materialized Gram) ---------------------------------------

def _pad_eps(eps, n, npad):
    """A per-row noise vector padded with zeros to the block-padded
    length (the pad pivots are the exact identity); scalars pass."""
    if eps.dim() == 0:
        return eps
    return torch.cat([eps.expand(n), eps.new_zeros(npad - n)])


def _stream_points(x, block):
    """(X, Xp, center): the points as an (n, p) float tensor, centered
    globally, and padded to a block multiple by repeating the last real
    point (so mixed real/pad tiles stay geometrically tight; the masks
    make them exact anyway)."""
    X = ops._gram._prep(_torchutil.asarray(x)).detach()
    center = X.mean(0, keepdim=True)
    X = X - center
    n = X.shape[0]
    npad = -(-n // block) * block
    Xp = torch.cat([X, X[n - 1:].expand(npad - n, -1)])
    return X, Xp, center


def _on(post, like):
    """The post chain with its scalars as 0-d tensors of ``like``'s
    dtype and device (still differentiable)."""
    return tuple((op, torch.as_tensor(v, dtype=like.dtype,
                                      device=like.device).reshape(()))
                 for op, v in post)


def _k0(profile, post, like):
    """The kernel's value at zero distance, post(g(0))."""
    v = ops._gram._profile(profile).value(like.new_zeros(()))
    for op, c in post:
        v = v * c if op == 'mul' else v + c
    return v


def _stream_probe_resid(tree, profile, post, Xp, n, eps, block):
    """Closure computing the matvec-probe backward error of the streaming
    factor, ``max|K̃v − L(Lᵀv)|`` for a fixed ±1 vector over the real
    rows, with K̃ the virtual regularized matrix streamed in row strips
    (kernel C on CUDA).  O(n²): evaluated only inside the eager
    degradation check."""

    def resid():
        npad = Xp.shape[0]
        idx = torch.arange(npad, device=Xp.device)
        v = torch.where(idx % 2 == 0, 1.0, -1.0).to(Xp.dtype)
        v = v * (idx < n).to(Xp.dtype)
        kv = torch.cat([
            _blocked._gram_block(Xp, profile, post, r0, 0, block, npad, n)
            @ v for r0 in range(0, npad, block)])
        kv = kv + _blocked._eps_diag(eps, 0, npad, n) * v
        llv = _blocked._tree_mv(tree, _blocked._tree_mv_t(tree, v))
        return (kv - llv).abs().max()

    return resid


def _stream_warn_if_degraded(dinvs, eps, k0, n, what, bump=None,
                             resid=None):
    """Eager degradation warning of the streaming factorization, the
    same contract as ``Chol._warn_if_degraded``: non-finite leaf
    inverses (the factorization failed at this dtype and eps); a probe
    residual at the scale of the self-healing lift's bump (the lift
    engaged and distorts the model); a pivot-based condition estimate
    beyond ~0.3/eps.  Skipped while checks are off."""

    def check():
        D = torch.stack(dinvs)
        mach = _float_eps(D.dtype)
        epsmin = float(eps[:n].min() if eps.dim() else eps)
        if not bool(torch.isfinite(D).all()):
            warnings.warn(
                f'{what}: the streaming factorization produced non-finite '
                f'values: the model is numerically singular at {D.dtype} '
                f'with eps={epsmin:.2e}.  Results are NaN; raise epsabs '
                f'(it should be at least the model noise floor), reduce '
                f'the correlation length, or use float64.')
            return
        pivmin2 = float(1 / torch.diagonal(D, dim1=1, dim2=2).max() ** 2)
        if resid is not None:
            r = float(resid())
            if bump is not None and r > 0.25 * float(bump):
                warnings.warn(
                    f'{what}: the self-healing diagonal lift engaged '
                    f'(matvec probe residual {r:.2e} ~ the lift bump '
                    f'{float(bump):.2e}): the model is numerically '
                    f'singular at {D.dtype} and the result is distorted by '
                    f'the lift.  Raise epsabs (it should be at least the '
                    f'model noise floor) or use float64.')
                return
        if n * float(k0) > 0.3 / mach * pivmin2:
            warnings.warn(
                f'{what}: condition number ~{n * float(k0) / pivmin2:.1e} '
                f'approaches the {D.dtype} resolution 1/eps={1 / mach:.1e}; '
                f'solve and gradient accuracy degrades as eps*cond.  Raise '
                f'epsabs or use float64.')

    _torchutil.check(check)


def _stream_factor(Xp, n, profile, post, epsabs, block, b1, precision,
                   what):
    """(tree, dinvs, eps, k0) of the streaming factorization of the
    virtual ``K + (epsabs + 4 mach k0) I`` over the padded points, with
    the eager degradation check."""
    npad = Xp.shape[0]
    k0 = _k0(profile, post, Xp)
    mach = _float_eps(Xp.dtype)
    eps = _pad_eps(torch.as_tensor(epsabs, dtype=Xp.dtype, device=Xp.device)
                   + 4 * mach * k0, n, npad)
    # trace bound on the largest eigenvalue (PSD, constant diagonal):
    # sizes the self-healing lift without a |K| matvec
    bump = _blocked._LIFT * mach * n * k0
    prec = _blocked._precision(precision)
    tree, dinvs = _blocked._chol_rec_tree_gram(
        Xp, profile, post, eps, 0, npad // block, block, b1, prec, bump, n)
    _stream_warn_if_degraded(
        dinvs, eps, k0, n, what, bump=bump,
        resid=_stream_probe_resid(tree, profile, post, Xp, n, eps, block))
    return tree, dinvs, eps, k0


def _stream_nll_value(tree, dinvs, y, npad, block):
    """(NLL, zt = L⁻¹y) from the streaming factor tree."""
    n = y.shape[0]
    ypad = torch.cat([y, y.new_zeros(npad - n)])
    zt = _blocked._tree_solve_right_t(ypad[None, :], tree, dinvs, block)
    logdiag = torch.cat(_blocked._tree_leaf_logdiag(tree))[:n]
    nll = 0.5 * ((zt * zt).sum() + 2 * logdiag.sum()
                 + n * math.log(2 * math.pi))
    return nll, zt


def chol_nll_stream(profile, x, y, *, post=(), epsabs=None, block=512,
                    b1=128, precision='high'):
    """-log N(y | 0, K + eps I) for an isotropic kernel without ever
    forming the Gram matrix: ``K[i, j] = post(g(‖x_i − x_j‖²))`` is
    computed on first touch inside the streaming factorization (kernels
    C and D on CUDA), whose factor stays a lower-trapezoid tree (n²/2
    floats); the solve runs on the tree and the log-determinant comes
    from its leaves.  Value only: the gradient is `chol_nll_stream_grad`.

    ``profile`` is a registered profile (`ops.PROFILES`) and ``post`` its
    chain of ('mul' | 'add', scalar) steps.  ``epsabs`` (default 0) is
    added to the 'auto' diagonal anchor ``4 eps k(0)``; it may be a
    per-point noise-variance vector.  There is no eps ladder: an
    infeasible model warns (eagerly) instead of failing silently.
    """
    with torch.no_grad():
        X, Xp, _ = _stream_points(x, block)
        n = X.shape[0]
        y = _torchutil.asarray(y, dtype=X.dtype, device=X.device)
        post = _on(post, Xp)
        tree, dinvs, _, _ = _stream_factor(
            Xp, n, profile, post, 0.0 if epsabs is None else epsabs, block,
            b1, precision, 'chol_nll_stream')
        return _stream_nll_value(tree, dinvs, y, Xp.shape[0], block)[0]


def chol_pred_stream(profile, x, y, xstar, *, post=(), epsabs=None,
                     block=512, b1=128, precision='high', return_nll=False,
                     return_var=False, return_cov=False):
    """Streaming GP posterior mean at ``xstar``,
    ``K(x*, x) (K(x, x) + eps I)⁻¹ y``, with the factorization of
    `chol_nll_stream`: ``alpha = K⁻¹ y`` by two tree solves, then one
    (n*, n) cross Gram (kernel C).  ``return_var`` adds the posterior
    variances, ``return_cov`` the full (n*, n*) posterior covariance
    instead (one tree solve with the cross Gram as right-hand side,
    O(n n*) memory), ``return_nll`` the training NLL.  Value only."""
    with torch.no_grad():
        X, Xp, center = _stream_points(x, block)
        Xs = ops._gram._prep(_torchutil.asarray(
            xstar, dtype=X.dtype, device=X.device)) - center
        n = X.shape[0]
        npad = Xp.shape[0]
        y = _torchutil.asarray(y, dtype=X.dtype, device=X.device)
        post = _on(post, Xp)
        tree, dinvs, _, k0 = _stream_factor(
            Xp, n, profile, post, 0.0 if epsabs is None else epsabs, block,
            b1, precision, 'chol_pred_stream')
        nll, zt = _stream_nll_value(tree, dinvs, y, npad, block)
        alpha = _blocked._tree_solve_right(zt, tree, dinvs, block)[0]
        Kst = Xp.new_zeros((Xs.shape[0], npad))
        Kst[:, :n] = ops.gram(profile, Xs, X, post=post)
        out = (Kst @ alpha,)
        if return_var or return_cov:
            W = _blocked._tree_solve_right_t(Kst, tree, dinvs, block)
            if return_cov:
                cov = ops.gram(profile, Xs, post=post) - W @ W.T
                out += (0.5 * (cov + cov.T),)
            else:
                out += (torch.clamp(k0 - (W * W).sum(1), min=0),)
        if return_nll:
            out += (nll,)
        return out[0] if len(out) == 1 else out


class _StreamNLL(torch.autograd.Function):
    """The streaming NLL with the exact reverse rule

        dV = <½ (K̃⁻¹ − α αᵀ), dK̃> + αᵀ dy,   α = K̃⁻¹ y,

    K̃ the regularized virtual matrix.  The K̃⁻¹ contraction runs over row
    strips [c0, c0 + w): two skip-aware tree solves give the strip
    ``C = K̃⁻¹[c0:c0+w, :]`` on the columns >= c0, and symmetry covers
    the others through the weight (1 on the strip's own columns, 2
    beyond).  The strip's dK̃ contraction is kernel C's backward with the
    weighted carrier as its output gradient (pad rows and columns cut
    off), and the eps diagonal is added analytically.  Nothing n × n is
    formed.

    Deviation from the JAX rule: the strips are formed in float64 from
    a float64 copy of the float32 factor tree, as `chol_nll`'s carrier
    is, because a float32 K⁻¹ flipped the sign of the amplitude
    gradient of the dense path at cond ~1e5 (PERF.md)."""

    @staticmethod
    def forward(ctx, meta, Xp, y, eps, lenscale, *pvec):
        profile, ops_, block, b1, precision, gradblock = meta
        n = y.shape[0]
        post = tuple(zip(ops_, pvec))
        tree, dinvs, _, _ = _stream_factor(
            Xp / lenscale, n, profile, post, eps, block, b1, precision,
            'chol_nll_stream_grad')
        nll, _ = _stream_nll_value(tree, dinvs, y, Xp.shape[0], block)
        ctx.meta = meta
        ctx.tree = tree, dinvs
        ctx.save_for_backward(Xp, y, eps, lenscale, *pvec)
        return nll

    @staticmethod
    def backward(ctx, ct):
        if ctx.tree is None:
            raise RuntimeError('chol_nll_stream_grad: the backward consumes '
                               'the factor, so it runs once per forward')
        if torch.is_grad_enabled():
            raise RuntimeError(
                'the streaming likelihood is differentiable once: a '
                'backward with create_graph (a Hessian) is not implemented; '
                "use covariance='minhess' or the dense solver")
        profile, ops_, block, b1, precision, gradblock = ctx.meta
        Xp, y, eps, lenscale, *pvec = ctx.saved_tensors
        need_y, need_eps, need_ls, *need_p = ctx.needs_input_grad[2:]
        n = y.shape[0]
        npad = Xp.shape[0]
        wide = torch.promote_types(y.dtype, torch.float64)
        # the float64 copy of the tree replaces the float32 one, which is
        # dropped here (its last reference)
        tree, dinvs = ctx.tree
        ctx.tree = None
        tree = _blocked._tree_map(tree, lambda t: t.to(wide))
        dinvs = [d.to(wide) for d in dinvs]
        _, zt = _stream_nll_value(tree, dinvs, y.to(wide), npad, block)
        alpha = _blocked._tree_solve_right(zt, tree, dinvs, block)[0]
        del zt

        ls = lenscale.detach().to(wide).requires_grad_(need_ls)
        pv = [p.detach().to(wide).requires_grad_(q)
              for p, q in zip(pvec, need_p)]
        post = tuple(zip(ops_, pv))
        leaves = [t for t in (ls, *pv) if t.requires_grad]
        grads = [torch.zeros((), dtype=wide, device=y.device) for _ in leaves]
        cdiag = torch.zeros(n, dtype=wide, device=y.device)
        X64 = Xp[:n].to(wide)
        wk = min(int(gradblock), npad)
        for c0 in range(0, n, wk) if leaves or need_eps else ():
            w = min(wk, npad - c0)
            nr = min(w, n - c0)
            E = torch.zeros((w, npad), dtype=wide, device=y.device)
            E[:, c0:c0 + w] = torch.eye(w, dtype=wide, device=y.device)
            Zt = _blocked._tree_solve_right_t_skip(E, tree, dinvs, block, 0,
                                                   c0)
            del E
            C = _blocked._tree_solve_right_skip(Zt, tree, dinvs, block, 0, c0)
            del Zt
            # the carrier on the strip's real rows and the real columns
            # >= c0 (the weight is 0 on the columns below)
            car = C[:nr, c0:n] - alpha[c0:c0 + nr, None] * alpha[None, c0:n]
            del C
            car[:, nr:] *= 2
            car *= 0.5
            cdiag[c0:c0 + nr] = car.diagonal()
            if leaves:
                with torch.enable_grad():
                    K = ops.gram(profile, X64[c0:c0 + nr] / ls, X64[c0:] / ls,
                                 post=post)
                for g, d in zip(grads, torch.autograd.grad(
                        K, leaves, car, allow_unused=True)):
                    if d is not None:
                        g += d
                del K
            del car
        # the regularized diagonal eps + 4 mach k(0) on the real rows
        e = eps.detach().to(wide).requires_grad_(need_eps)
        wrt = [t for t in (e, *leaves) if t.requires_grad]
        dd = {}
        if wrt:
            with torch.enable_grad():
                k0 = _k0(profile, post, e)
                diag = (cdiag * (e + 4 * _float_eps(y.dtype) * k0)).sum()
            dd = dict(zip(map(id, wrt), torch.autograd.grad(
                diag, wrt, allow_unused=True)))
            for t, g in zip(leaves, grads):
                if dd.get(id(t)) is not None:
                    g += dd[id(t)]
        gmap = dict(zip(map(id, leaves), grads))

        def out(g, like):
            return None if g is None else (ct * g).to(like.dtype)

        return (None, None, out(alpha[:n], y) if need_y else None,
                out(dd.get(id(e)), eps) if need_eps else None,
                out(gmap.get(id(ls)), lenscale),
                *(out(gmap.get(id(t)), p) for t, p in zip(pv, pvec)))


def chol_nll_stream_grad(profile, x, y, *, post=(), lenscale=None,
                         epsabs=1e-4, exact=True, block=512, b1=128,
                         gradblock=None, precision='high'):
    """The streaming NLL of `chol_nll_stream`, differentiable: the exact
    hand-derived gradient (`_StreamNLL`) with respect to the post-chain
    scalars ``post``, the isotropic input length scale ``lenscale``
    (applied as x / lenscale; the coordinates themselves carry no
    gradient), the nugget ``epsabs`` (a scalar, or a per-point variance
    vector with per-element gradients) and ``y``.  K⁻¹ is produced in
    row strips of width ``gradblock`` (default ``4 * block``) by two
    skip-aware tree solves per strip, about n³/3 extra multiply-adds;
    nothing n × n is formed.

    ``exact=False`` (the JAX package's Hutchinson estimate) is not in
    lsqfitgp_torch yet (ROADMAP.md, queue 1, item 8).
    """
    if not exact:
        raise NotImplementedError(
            'chol_nll_stream_grad(exact=False), the Hutchinson estimate, '
            'is not in lsqfitgp_torch yet (ROADMAP.md, queue 1, item 8)')
    _, Xp, _ = _stream_points(x, block)
    y = _torchutil.asarray(y, dtype=Xp.dtype, device=Xp.device)
    post = _on(post, Xp)
    ls = torch.as_tensor(1.0 if lenscale is None else lenscale,
                         dtype=Xp.dtype, device=Xp.device).reshape(())
    ep = torch.as_tensor(epsabs, dtype=Xp.dtype, device=Xp.device)
    if gradblock is None:
        gradblock = 4 * int(block)
    meta = (ops._gram._profile(profile), tuple(op for op, _ in post),
            int(block), int(b1), precision, int(gradblock))
    return _StreamNLL.apply(meta, Xp, y, ep, ls, *(v for _, v in post))
