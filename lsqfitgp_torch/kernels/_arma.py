"""Discrete AR(p) / MA(q) process kernels.

Counterpart of ``lsqfitgp_tpu/kernels/_arma.py``, with its three AR
parametrizations:

- ``phi`` + ``maxlag``: Yule-Walker for the head of the autocovariance,
  then the AR recursion to maxlag;
- ``gamma`` + ``maxlag``: coefficients from a Levinson-Toeplitz solve of
  the Yule-Walker system, then the recursion;
- ``slnr``/``lnc`` (log-roots of the characteristic polynomial): the
  analytic mixed power-exponential form, with amplitudes from a linear
  solve against the Yule-Walker head; root multiplicities handled by
  per-occurrence polynomial powers, log-normalized columns for
  stability.

No CUDA profile, as the JAX package has no fast-Gram spec for them: the
Gram is the broadcast core's.  The log-root form evaluates its basis at
every lag of the n × m block; its columns are summed into one buffer
as they are made, and under autograd the block is recomputed in the
backward (`_torchutil.recompute`) rather than kept as a graph of a
dozen n × m tensors.
"""

from __future__ import annotations

import torch

from .. import _torchutil
from ..kernelalg import stationarykernel
from ..linalg import _toeplitz

__all__ = ['MA', 'AR']


def _real(v, device=None):
    dtype = torch.get_default_dtype()
    if isinstance(v, torch.Tensor) and v.is_floating_point():
        dtype = v.dtype
    return _torchutil.asarray(v, dtype=dtype, device=device)


def _complex(v, device=None):
    dtype = torch.complex128 if torch.get_default_dtype() == torch.float64 \
        else torch.complex64
    if isinstance(v, torch.Tensor) and v.is_complex():
        dtype = v.dtype
    elif isinstance(v, torch.Tensor) and v.is_floating_point():
        dtype = torch.complex128 if v.dtype == torch.float64 \
            else torch.complex64
    return _torchutil.asarray(v, dtype=dtype, device=device)


def _get(acf, idx, fill):
    """``acf[idx]``, ``fill`` where idx is outside acf (``.at[idx].get(
    mode='fill')``): the index clamped, then the fill put back."""
    inside = (idx >= 0) & (idx < acf.shape[0])
    return torch.where(inside, acf[idx.clamp(0, acf.shape[0] - 1)], fill)


@stationarykernel(derivable=False, maxdim=1, input='abs')
def MA(delta, w=None, norm=False):
    r"""Moving-average kernel over integer lags:
    k(Δ) = Σ_{k=|Δ|}^{n-1} w_k w_{k-|Δ|}; autocovariance of white noise
    filtered by weights w.  ``norm=True`` normalizes k(0) = 1."""
    w = _real(w, delta.device)
    assert w.dim() == 1
    n = w.shape[0]
    if not n:
        return torch.zeros(delta.shape, device=delta.device)
    # the full autocorrelation, lags −(n−1) … n−1 (``jnp.convolve(w,
    # w[::-1])``)
    acf = torch.nn.functional.conv1d(w[None, None], w[None, None],
                                     padding=n - 1)[0, 0]
    if norm:
        acf = acf / acf[n - 1]
    # round-to-nearest lag: exact on integer inputs, and robust to the
    # float error of a Δ computed as √r²
    idx = torch.round(delta).long() + (n - 1)
    return _get(acf, idx, 0.0)


# -- AR helpers ----------------------------------------------------------------


def _solve(A, b):
    """A⁻¹ b, non-finite where A is singular rather than raising, as
    ``jnp.linalg.solve``."""
    return torch.linalg.solve_ex(A, b)[0]


def _yule_walker(gamma):
    """phi (lag 1..p) from autocovariance gamma (lag 0..p): Toeplitz
    solve of the YW system."""
    if gamma.shape[0] <= 1:
        return gamma.new_empty(0)
    return _toeplitz.solve(gamma[:-1], gamma[1:])


def _yule_walker_inv(phi):
    """gamma (lag 0..p) from phi, unit driving-noise variance.

    Row m of the linear system: γ_m − Σ_k φ_k γ_{|m−k|} = δ_{m0}; the
    coefficient of γ_j is δ_{mj} − (φ_{m−j} + φ_{m+j}), with the j = 0
    column counting φ_m once.
    """
    p = phi.shape[0]
    zero = phi.new_zeros(1)
    pad = torch.cat([zero, phi, zero])
    ar = torch.arange(p + 1, device=phi.device)
    m, j = ar[:, None], ar[None, :]
    lo = pad[(m - j).clamp(0, p + 1)]
    hi = pad[(m + j).clamp(0, p + 1)]
    A = torch.eye(p + 1, dtype=phi.dtype, device=phi.device) \
        - torch.where(j > 0, lo + hi, lo)
    e0 = torch.cat([phi.new_ones(1), phi.new_zeros(p)])
    return _solve(A, e0)


def _ar_evolve(phi, start, n):
    """Evolve the AR recursion γ_m = Σ φ_k γ_{m−k} for n more steps, on
    the inputs' device."""
    if not phi.shape[0]:
        return phi.new_zeros(n)
    rphi = phi.flip(0)
    window, out = start, []
    for _ in range(n):
        nxt = window @ rphi
        window = torch.cat([window[1:], nxt[None]])
        out.append(nxt)
    return torch.stack(out) if out else phi.new_empty(0)


def _ar_columns(slnr, lnc, lag, lagnorm):
    """The basis of mixed power-exponentials at (broadcast) lags, one
    column at a time: the ∞-root δ_{m0}, one per real log-root, two
    (cos/sin, or power-doubled for a real "complex" root) per complex
    log-root.  Each column is divided by a lag-independent
    normalization exp(lognorm) so entries stay O(1)."""
    # dtype-aware floor: a float64 literal like 1e-300 flushes to 0 in
    # float32, and rep * log(0) = 0 * -inf = NaN for simple roots
    tiny = torch.finfo(lag.dtype).tiny
    llag = torch.where(lag > 0, torch.log(torch.clamp(lag, min=tiny)), 0.0)
    zero = lag.new_zeros(())

    def logcol(lam, rep):
        # log of m^rep e^{-lam m} (modulus part)
        return -lam * lag + rep * llag

    def lognorm(lam, rep):
        # max over m in [0, lagnorm] of rep·log m − lam·m
        mstar = torch.where(lam > 0, rep / torch.clamp(lam, min=tiny),
                            float(lagnorm))
        m0 = torch.clamp(mstar, tiny, lagnorm)
        return rep * torch.log(torch.clamp(m0, min=tiny)) - lam * m0

    yield torch.where(lag == 0, 1.0, 0.0).to(lag.dtype)

    # real roots: basis sign^m |r|^{-m} m^rep
    prev = None
    for i in range(slnr.shape[0]):
        root = slnr[i]
        rep = zero if prev is None else torch.where(root == prev, rep + 1,
                                                    zero)
        prev = root
        lam = root.abs()
        col = torch.sign(root) ** lag \
            * torch.exp(logcol(lam, rep) - lognorm(lam, rep))
        yield torch.where((rep > 0) & (lag == 0), zero, col)

    # complex roots: e^{-λm}, λ = a + ib -> m^rep e^{-am}(cos, sin)(bm)
    prev = None
    for i in range(lnc.shape[0]):
        root = lnc[i]
        rep = zero if prev is None else torch.where(root == prev, rep + 1,
                                                    zero)
        prev = root
        a, b = root.real, root.imag
        mod = torch.exp(logcol(a, rep) - lognorm(a, rep))
        mod = torch.where((rep > 0) & (lag == 0), zero, mod)
        yield mod * torch.cos(b * lag)
        # a real "complex" root acts as a double real root: the second
        # column gains one power of m instead of the sine
        mod1 = torch.exp(logcol(a, rep + 1) - lognorm(a, rep + 1))
        mod1 = torch.where(lag == 0, zero, mod1)
        yield torch.where(b != 0, mod * torch.sin(b * lag), mod1)
        rep = torch.where(b != 0, rep, rep + 1)


def _ar_basis(slnr, lnc, lag, lagnorm):
    """`_ar_columns` stacked in a trailing axis."""
    return torch.stack(list(_ar_columns(slnr, lnc, lag, lagnorm)), -1)


def _ar_sum(slnr, lnc, lag, lagnorm, ampl):
    """``_ar_basis(...) @ ampl``, each column added in as it is made."""
    out = None
    for c, col in enumerate(_ar_columns(slnr, lnc, lag, lagnorm)):
        term = col * ampl[c]
        out = term if out is None else out + term
    return out


def _phi_from_roots(slnr, lnc):
    """AR coefficients from the log-roots: expand
    P(x) = Π_j (1 − x / x_j) and read φ_k = −coeff_k."""
    ir_real = torch.copysign(torch.exp(-slnr.abs()), slnr)  # 1/x_j
    ic = torch.exp(-lnc)                                     # complex 1/x_j
    p = slnr.shape[0] + 2 * lnc.shape[0]

    def shift(c, k):
        return torch.cat([c.new_zeros(k), c[:-k]])

    coef = torch.cat([lnc.new_ones(1), lnc.new_zeros(p)])
    for i in range(slnr.shape[0]):
        coef = coef - ir_real[i] * shift(coef, 1)
    for i in range(lnc.shape[0]):
        # multiply by (1 - ic x)(1 - conj(ic) x)
        #            = 1 - 2 Re(ic) x + |ic|^2 x^2
        c = ic[i]
        coef = coef - 2 * c.real * shift(coef, 1) \
            + (c.real ** 2 + c.imag ** 2) * shift(coef, 2)
    return -coef[1:].real


@stationarykernel(derivable=False, maxdim=1, input='abs')
def _ARBase(delta, phi=None, gamma=None, maxlag=None, slnr=None, lnc=None,
            norm=False):
    r"""Discrete autoregressive kernel.

    Specify exactly one of phi+maxlag, gamma+maxlag, or slnr+lnc; see
    class `AR` for the parameter meanings."""
    by_phi = phi is not None and maxlag is not None and gamma is None \
        and slnr is None and lnc is None
    by_gamma = gamma is not None and maxlag is not None and phi is None \
        and slnr is None and lnc is None
    by_roots = slnr is not None and lnc is not None and phi is None \
        and gamma is None and maxlag is None
    if not (by_phi or by_gamma or by_roots):
        raise ValueError('specify exactly one of phi+maxlag, gamma+maxlag, '
                         'slnr+lnc')
    dev = delta.device

    if by_roots:
        slnr = _real(slnr, dev)
        lnc = _complex(lnc, dev)
        phi = _phi_from_roots(slnr, lnc)
        gam = _yule_walker_inv(phi)
        if norm:
            gam = gam / gam[0]
        p = phi.shape[0]
        lag0p = torch.arange(p + 1, dtype=phi.dtype, device=dev)
        M = _ar_basis(slnr, lnc, lag0p, max(p, 1))
        ampl = _solve(M, gam)
        lag = delta.to(phi.dtype)
        return _torchutil.recompute(
            lambda: _ar_sum(slnr, lnc, lag, max(p, 1), ampl))

    if by_phi:
        phi = _real(phi, dev)
        gam = _yule_walker_inv(phi)
    else:
        gam = _real(gamma, dev)
        phi = _yule_walker(gam)
    if norm:
        gam = gam / gam[0]
    n_ext = int(maxlag) + 1 - gam.shape[0]
    if n_ext > 0:
        ext = _ar_evolve(phi, gam[gam.shape[0] - phi.shape[0]:], n_ext)
        acf = torch.cat([gam, ext])
    else:
        acf = gam
    # round-to-nearest lag (see MA): robust to √r² float error
    return _get(acf, torch.round(delta).long(), float('nan'))


class AR(_ARBase):
    r"""Autoregressive process kernel y_i = Σ_k φ_k y_{i-k} + ε_i.

    Parameters: ``phi`` (AR coefficients, lag 1..p) + ``maxlag``, or
    ``gamma`` (autocovariance, lag 0..p) + ``maxlag``, or the log-root
    parametrization ``slnr`` (signed log real roots) + ``lnc`` (log
    complex roots, one per conjugate pair).  ``norm=True`` normalizes
    the variance to 1.
    """

    @classmethod
    def phi_from_gamma(cls, gamma):
        """AR coefficients from the autocovariance head (Yule-Walker)."""
        return _yule_walker(_real(gamma))

    @classmethod
    def gamma_from_phi(cls, phi):
        """Autocovariance head from AR coefficients (unit noise).

        Wildly inaccurate for roots with high multiplicity or very close
        to 1 (inherent to the Yule-Walker linear system)."""
        return _yule_walker_inv(_real(phi))

    @classmethod
    def extend_gamma(cls, gamma, phi, n):
        """Extend the autocovariance ``n`` lags past its end using the
        AR recursion."""
        gamma = _real(gamma)
        phi = _real(phi, gamma.device)
        assert gamma.shape[0] > phi.shape[0]
        ext = _ar_evolve(phi, gamma[gamma.shape[0] - phi.shape[0]:], int(n))
        return torch.cat([gamma, ext])

    @classmethod
    def phi_from_roots(cls, slnr, lnc):
        """AR coefficients from log-root parametrization."""
        slnr = _real(slnr)
        return _phi_from_roots(slnr, _complex(lnc, slnr.device))
