"""Correlated-Gaussian uncertainty propagation.

Counterpart of ``lsqfitgp_tpu/uncert/_uarray.py``: a `UArray` is a mean
tensor plus a dict mapping primary block ids to Jacobians of shape
``mean.shape + (n_block,)`` with respect to blocks of iid standard
normals.  Two UArrays correlate through shared block ids; propagation
through sums and linear maps is dense linear algebra on the mean's
device.  The nonlinear (delta-method) operations wait.  `evalcov`,
`corr` and `sample` read the joint distribution of UArrays; `sample`
draws from a `torch.Generator` where the JAX package takes a key.
"""

from __future__ import annotations

import itertools

import torch

from .. import _config, _torchutil

__all__ = ['UArray', 'from_cov', 'normal', 'uconcatenate',
           'next_block_id', 'evalcov', 'corr', 'sample']

_block_counter = itertools.count()


def next_block_id():
    return next(_block_counter)


class UArray:
    """Array of correlated Gaussian variables: mean + per-block Jacobians."""

    __slots__ = ('mean', 'jac')

    # make numpy defer to our reflected operators
    __array_ufunc__ = None

    def __init__(self, mean, jac=None):
        object.__setattr__(self, 'mean', _torchutil.asarray(mean))
        object.__setattr__(self, 'jac', dict(jac or {}))

    def __setattr__(self, *_):
        raise AttributeError('UArray is immutable')

    # -- introspection ------------------------------------------------------

    @property
    def shape(self):
        return tuple(self.mean.shape)

    @property
    def ndim(self):
        return self.mean.dim()

    @property
    def size(self):
        return self.mean.numel()

    def __len__(self):
        return len(self.mean)

    @property
    def sdev(self):
        return torch.sqrt(self.var)

    @property
    def var(self):
        out = torch.zeros_like(self.mean)
        for J in self.jac.values():
            out = out + (J * J).sum(-1)
        return out

    def cov(self):
        """Full covariance matrix of the flattened array, reshaped to
        ``shape + shape``."""
        n = self.size
        out = torch.zeros((n, n), dtype=self.mean.dtype,
                          device=self.mean.device)
        for J in self.jac.values():
            Jf = J.reshape(n, J.shape[-1])
            out = out + Jf @ Jf.T
        return out.reshape(self.shape + self.shape)

    # -- indexing / reshaping ---------------------------------------------

    def __getitem__(self, key):
        # the caller's key addresses the mean's axes only; normalize it
        # before appending a full slice for the block axis
        jkey = self._jac_key(key)
        return UArray(self.mean[key],
                      {k: J[jkey] for k, J in self.jac.items()})

    def _jac_key(self, key):
        if not isinstance(key, tuple):
            key = (key,)
        nell = sum(1 for k in key if k is Ellipsis)
        if nell > 1:
            raise IndexError('an index can only have a single ellipsis')
        consumed = 0
        for k in key:
            if k is None or k is Ellipsis:
                continue
            if isinstance(k, torch.Tensor) and k.dtype == torch.bool:
                consumed += k.dim()
            else:
                consumed += 1
        if consumed > self.ndim:
            raise IndexError(f'too many indices: array is {self.ndim}-d, '
                             f'index consumes {consumed} axes')
        fill = (slice(None),) * (self.ndim - consumed)
        if nell:
            i = key.index(Ellipsis)
            expanded = key[:i] + fill + key[i + 1:]
        else:
            expanded = key + fill
        return expanded + (slice(None),)

    def reshape(self, *shape):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        mean = self.mean.reshape(shape)
        return UArray(mean, {k: J.reshape(tuple(mean.shape) + (J.shape[-1],))
                             for k, J in self.jac.items()})

    # -- linear arithmetic (exact) ---------------------------------------

    def _plus(self, other, sign):
        omean = other.mean if isinstance(other, UArray) else \
            _torchutil.asarray(other, dtype=self.mean.dtype,
                               device=self.mean.device)
        mean = self.mean + sign * omean
        shape = tuple(mean.shape)
        jac = {k: J.expand(shape + J.shape[-1:])
               for k, J in self.jac.items()}
        if isinstance(other, UArray):
            for k, J in other.jac.items():
                term = sign * J.expand(shape + J.shape[-1:])
                jac[k] = jac[k] + term if k in jac else term
        return UArray(mean, jac)

    def __add__(self, other):
        return self._plus(other, 1)

    __radd__ = __add__

    def __sub__(self, other):
        return self._plus(other, -1)

    def __rsub__(self, other):
        return (-self) + other

    def __neg__(self):
        return UArray(-self.mean, {k: -J for k, J in self.jac.items()})

    def __matmul__(self, other):
        """Linear contraction with a plain tensor (exact)."""
        if isinstance(other, UArray):
            raise NotImplementedError('UArray @ UArray not supported')
        other = _torchutil.asarray(other, dtype=self.mean.dtype,
                                   device=self.mean.device)
        sub = {(1, 1): 'nz,n->z', (1, 2): 'nz,nm->mz',
               (2, 1): 'anz,n->az', (2, 2): 'anz,nm->amz'}
        eq = sub.get((self.ndim, other.dim()))
        if eq is None:
            raise NotImplementedError('matmul supports 1D/2D operands')
        return UArray(self.mean @ other,
                      {k: torch.einsum(eq, J, other)
                       for k, J in self.jac.items()})

    def __rmatmul__(self, other):
        other = _torchutil.asarray(other, dtype=self.mean.dtype,
                                   device=self.mean.device)
        sub = {(1, 1): 'n,nz->z', (2, 1): 'mn,nz->mz',
               (1, 2): 'n,nkz->kz', (2, 2): 'mn,nkz->mkz'}
        eq = sub.get((other.dim(), self.ndim))
        if eq is None:
            raise NotImplementedError('matmul supports 1D/2D operands')
        return UArray(other @ self.mean,
                      {k: torch.einsum(eq, other, J)
                       for k, J in self.jac.items()})

    def __repr__(self):
        return f'UArray(mean={self.mean!r}, sdev={self.sdev!r})'


# -- constructors --------------------------------------------------------

def from_cov(mean, covmat, *, block_id=None):
    """UArray with given mean and covariance (one new primary block).
    The covariance (shape ``s + s`` over the flattened ``s``) is
    factorized by symmetric eigendecomposition with negative eigenvalues
    clipped to zero: posterior covariances are often indefinite at the
    eps level."""
    mean = _torchutil.asarray(mean)
    covmat = _torchutil.asarray(covmat, dtype=mean.dtype, device=mean.device)
    n = mean.numel()
    covf = covmat.reshape(n, n)
    covf = 0.5 * (covf + covf.T)
    w, V = torch.linalg.eigh(covf)
    L = V * torch.sqrt(torch.clamp(w, min=0))
    if block_id is None:
        block_id = next_block_id()
    return UArray(mean, {block_id: L.reshape(tuple(mean.shape) + (n,))})


def normal(mean, sdev):
    """Independent normal variables with the given means and sdevs (one
    new primary block)."""
    mean = _torchutil.asarray(mean, dtype=_config.default_float())
    sdev = _torchutil.asarray(sdev, dtype=mean.dtype, device=mean.device)
    mean, sdev = torch.broadcast_tensors(mean, sdev)
    n = mean.numel()
    J = torch.diag(sdev.reshape(-1)).reshape(tuple(mean.shape) + (n,))
    return UArray(mean, {next_block_id(): J})


def uconcatenate(arrays, axis=0):
    """Concatenate UArrays, aligning primary blocks."""
    arrays = [a if isinstance(a, UArray) else UArray(a) for a in arrays]
    m = torch.cat([a.mean for a in arrays], axis)
    jac = {}
    for k in sorted({k for a in arrays for k in a.jac}):
        nb = next(a.jac[k].shape[-1] for a in arrays if k in a.jac)
        parts = [a.jac.get(k, torch.zeros(a.shape + (nb,), dtype=m.dtype,
                                          device=m.device))
                 for a in arrays]
        jac[k] = torch.cat(parts, axis if axis >= 0 else axis - 1)
    return UArray(m, jac)


# -- reading the distribution ---------------------------------------------


def evalcov(a, b=None):
    """Covariance between a and b (default: a), of shape
    ``a.shape + b.shape``."""
    if b is None:
        b = a
    na, nb = a.size, b.size
    out = torch.zeros((na, nb), dtype=a.mean.dtype, device=a.mean.device)
    for k, Ja in a.jac.items():
        Jb = b.jac.get(k)
        if Jb is not None:
            out = out + Ja.reshape(na, -1) @ Jb.reshape(nb, -1).T
    return out.reshape(a.shape + b.shape)


def corr(a, b=None):
    """Correlation between a and b (default: a), of shape
    ``a.shape + b.shape``."""
    c = evalcov(a, b)
    sa = a.sdev.reshape(-1)
    sb = (a if b is None else b).sdev.reshape(-1)
    return (c.reshape(sa.numel(), sb.numel())
            / torch.outer(sa, sb)).reshape(c.shape)


def sample(generator, x, shape=()):
    """Joint samples of the UArray ``x``, of shape ``shape + x.shape``,
    from standard normals drawn with the `torch.Generator`
    ``generator`` (on ``x``'s device)."""
    if not isinstance(shape, tuple):
        shape = (shape,)
    out = x.mean.expand(shape + x.shape)
    for J in x.jac.values():
        z = torch.randn(shape + (J.shape[-1],), generator=generator,
                        dtype=x.mean.dtype, device=x.mean.device)
        out = out + torch.tensordot(z, J, dims=([-1], [-1]))
    return out
