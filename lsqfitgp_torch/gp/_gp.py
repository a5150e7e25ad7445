"""The GP object: processes, elements, covariance assembly, inference.

Counterpart of ``lsqfitgp_tpu/gp/_gp.py`` with the dense 'chol' solver:
immutable construction (``addx``, ``addcov``, ``addlintransf`` return
new GPs), covariance-block assembly with point blocks evaluated by kernel C
(``gram='tiled'``) or by broadcasting the kernel core, and inference
(``prior``, ``pred``/``predfromdata``, ``marginal_likelihood``) whose
posteriors are `uncert.UArray`.

Not in this version: derived processes (``defproc``, ``deftransf``,
...), derivative elements, user decompositions in ``addcov``,
``halfmatrix`` (kernel E), the streaming and distributed solvers, and
the double-float Gram of the conditioning rescue.
"""

from __future__ import annotations

import collections
import math

import numpy
import torch

from .. import _config, _torchutil
from .._deriv import Deriv
from ..kernelalg import Kernel, Zero
from ..kernelalg import _fastgram as fg
from .. import linalg, ops, uncert

__all__ = ['GP', 'DefaultProcess']


class _DefaultProcess:
    def __repr__(self):
        return 'DefaultProcess'


DefaultProcess = _DefaultProcess()

_ProcKernel = collections.namedtuple('_ProcKernel', ['kernel'])

_Points = collections.namedtuple('_Points', ['x', 'proc', 'shape'])
_LinTransfEl = collections.namedtuple('_LinTransfEl',
                                      ['transf', 'keys', 'shape'])
_CovEl = collections.namedtuple('_CovEl', ['shape'])


def _size(shape):
    return math.prod(shape) if shape else 1


class GP:
    """A Gaussian process model: a dictionary of processes and a
    dictionary of finite elements built from them.

    Parameters
    ----------
    covfun : Kernel, optional
        Kernel of the default process.
    solver : str
        Decomposition used for posteriors: 'chol' (the blocked
        regularized Cholesky, `linalg.Chol`), the only one in this
        version.  Extra keywords go to `Chol`.
    checkpos, checksym, checkfinite, checklin : bool
        Eager sanity checks (skipped inside `empbayes_fit`'s objective).
    posepsfac : float
        Tolerance factor for the positivity check.
    gram : {'auto', 'tiled', 'broadcast'}
        Point-block assembly.  'tiled' evaluates isotropic kernels whose
        profile kernel C knows (`ops.gram`); 'broadcast' evaluates the
        kernel core on ``x[:, None], y[None, :]``; 'auto' broadcasts, as
        the JAX package does off the TPU, until a measured cutover.
    """

    _SOLVERS = ('chol',)

    def __init__(self, covfun=None, *, solver='chol', checkpos=True,
                 checksym=True, checkfinite=True, checklin=True,
                 posepsfac=1, gram='auto', **kw):
        self._procs = {}
        self._elements = {}
        self._kernel_cache = {}
        self._covblock_cache = {}
        self._decomp_cache = {}
        if solver not in self._SOLVERS:
            raise KeyError(f'unknown solver {solver!r}, must be one of '
                           f'{self._SOLVERS}')
        self._solverkw = dict(kw)
        self._solver = solver
        if gram not in ('auto', 'tiled', 'broadcast'):
            raise KeyError(f'unknown gram mode {gram!r}')
        self._gram_mode = gram
        self._checks = dict(pos=checkpos, sym=checksym, finite=checkfinite,
                            lin=checklin, posepsfac=posepsfac)
        # device of the model's tensors, set by the first tensor added;
        # later array-likes are placed there
        self._device = None
        if covfun is not None:
            if not isinstance(covfun, Kernel):
                raise TypeError('covfun must be a (symmetric) Kernel')
            self._procs[DefaultProcess] = _ProcKernel(covfun)

    # -- cloning and key checks ---------------------------------------------

    def _clone(self):
        new = object.__new__(GP)
        new._procs = dict(self._procs)
        new._elements = dict(self._elements)
        # caches are copied, not shared: sibling clones may define the
        # same key differently
        new._kernel_cache = dict(self._kernel_cache)
        new._covblock_cache = dict(self._covblock_cache)
        new._decomp_cache = dict(self._decomp_cache)
        new._solverkw = self._solverkw
        new._solver = self._solver
        new._checks = self._checks
        new._gram_mode = self._gram_mode
        new._device = self._device
        return new

    def _asarray(self, x):
        # floating inputs take the working dtype, as in the JAX package
        x = _torchutil.asarray(x, device=self._device)
        if x.is_floating_point():
            x = x.to(_config.default_float())
        if self._device is None:
            self._device = x.device
        return x

    def _zeros(self, n1, n2):
        return torch.zeros((n1, n2), dtype=_config.default_float(),
                           device=self._device)

    def _checkprockey(self, key):
        if key not in self._procs:
            raise KeyError(f'process {key!r} not defined')

    def _checkelkey(self, key, new=True):
        if key is None:
            raise KeyError('key cannot be None')
        if new and key in self._elements:
            raise KeyError(f'element key {key!r} already used')
        if not new and key not in self._elements:
            raise KeyError(f'element {key!r} not defined')

    def _crosskernel(self, pa, pb):
        key = (pa, pb)
        if key not in self._kernel_cache:
            a = self._procs[pa]
            self._kernel_cache[key] = a.kernel if pa is pb or pa == pb \
                else Zero()
        return self._kernel_cache[key]

    # -- element definition ----------------------------------------------------

    def addx(self, x, key=None, *, deriv=0, proc=DefaultProcess):
        """Add points where the process is evaluated."""
        if not isinstance(x, dict):
            if key is None:
                raise ValueError('key required when x is not a dict')
            x = {key: x}
        elif key is not None:
            raise ValueError('key not allowed when x is a dict')
        self._checkprockey(proc)
        if Deriv(deriv):
            raise NotImplementedError(
                'derivative elements are not in lsqfitgp_torch yet')
        new = self._clone()
        for k, xk in x.items():
            new._checkelkey(k)
            xk = new._asarray(xk)
            if self._checks['finite']:
                def check(xk=xk):
                    if not bool(torch.isfinite(xk).all()):
                        raise ValueError('non-finite x')
                _torchutil.check(check)
            new._elements[k] = _Points(xk, proc, tuple(xk.shape))
        return new

    def addlintransf(self, transf, keys, key, *, checklin=None):
        """Add a finite linear transformation of other elements."""
        self._checkelkey(key)
        for k in keys:
            self._checkelkey(k, new=False)
        shapes = [self._elements[k].shape for k in keys]
        dtype = _config.default_float()
        # the output shape from zero vectors of the elements' shapes (no
        # meta tensors: a meta-device op keeps its callers' frames, and
        # with them this GP and its n × n blocks, alive until the cyclic
        # garbage collector runs)
        out = transf(*[torch.zeros(s, dtype=dtype, device=self._device)
                       for s in shapes])
        if checklin is None:
            checklin = self._checks['lin']
        if checklin:
            self._checklinear(transf, shapes)
        new = self._clone()
        new._elements[key] = _LinTransfEl(transf, list(keys),
                                          tuple(out.shape))
        return new

    def _checklinear(self, transf, shapes):
        """Verify transf is linear via a jvp identity probe."""
        dtype = _config.default_float()
        rng = numpy.random.default_rng(0)
        xs = [torch.as_tensor(rng.standard_normal(s), dtype=dtype)
              for s in shapes]
        zeros = [torch.zeros(s, dtype=dtype) for s in shapes]

        def check():
            y0 = transf(*zeros)
            direct = transf(*xs)
            _, tangent = torch.func.jvp(transf, tuple(zeros), tuple(xs))
            if not (torch.allclose(y0, torch.zeros_like(y0), atol=1e-10)
                    and torch.allclose(direct, tangent, rtol=1e-6,
                                       atol=1e-10)):
                raise RuntimeError(
                    'the transformation is not linear; pass checklin=False '
                    'to skip this check')

        _torchutil.check(check)

    def addcov(self, covblocks, key=None):
        """Add finite variables with explicit covariance blocks."""
        if not isinstance(covblocks, dict):
            if key is None:
                raise ValueError('key required when covblocks is not a dict')
            covblocks = {(key, key): covblocks}
        elif key is not None:
            raise ValueError('key not allowed when covblocks is a dict')

        new = self._clone()
        pairs = {}
        elkeys = []
        for (k1, k2), block in covblocks.items():
            pairs[k1, k2] = new._asarray(block)
            for k in (k1, k2):
                if k not in elkeys:
                    elkeys.append(k)
        shapes = {}
        for k in elkeys:
            self._checkelkey(k)
            diag = pairs.get((k, k))
            if diag is None:
                raise ValueError(f'missing diagonal block for key {k!r}')
            if diag.dim() % 2:
                raise ValueError(f'diagonal block {k!r} has odd ndim')
            half = diag.dim() // 2
            shapes[k] = tuple(diag.shape[:half])
            if tuple(diag.shape[half:]) != shapes[k]:
                raise ValueError(f'diagonal block {k!r} not square')

        if self._checks['sym']:
            def check():
                for (k1, k2), block in pairs.items():
                    n1, n2 = _size(shapes[k1]), _size(shapes[k2])
                    if k1 == k2:
                        b = block.reshape(n1, n1)
                        if not torch.allclose(b, b.T):
                            raise ValueError(
                                f'non-symmetric diagonal block {k1!r}')
                    elif (k2, k1) in pairs:
                        bt = pairs[k2, k1].reshape(n2, n1)
                        if not torch.allclose(block.reshape(n1, n2), bt.T):
                            raise ValueError(
                                f'blocks ({k1!r},{k2!r}) not transposes')
            _torchutil.check(check)
        if self._checks['finite']:
            def checkf():
                for block in pairs.values():
                    if not bool(torch.isfinite(block).all()):
                        raise ValueError('non-finite covariance block')
            _torchutil.check(checkf)

        for k in elkeys:
            new._elements[k] = _CovEl(shapes[k])
        for k1 in elkeys:
            for k2 in elkeys:
                n1, n2 = _size(shapes[k1]), _size(shapes[k2])
                if (k1, k2) in pairs:
                    blk = pairs[k1, k2].reshape(n1, n2)
                elif (k2, k1) in pairs:
                    blk = pairs[k2, k1].reshape(n2, n1).T
                else:
                    blk = new._zeros(n1, n2)
                new._covblock_cache[k1, k2] = blk
        return new

    # -- covariance assembly -------------------------------------------------

    def _covblock(self, a, b):
        cache = self._covblock_cache
        if (a, b) in cache:
            return cache[a, b]
        if (b, a) in cache:
            blk = cache[b, a].T
            cache[a, b] = blk
            return blk
        ea, eb = self._elements[a], self._elements[b]
        if isinstance(ea, _Points) and isinstance(eb, _Points):
            blk = self._block_points(ea, eb)
        elif isinstance(ea, _LinTransfEl):
            blk = self._block_lintransf_left(ea, b)
        elif isinstance(eb, _LinTransfEl):
            blk = self._block_lintransf_left(eb, a).T
        else:
            # independent of everything not specified in addcov
            blk = self._zeros(_size(ea.shape), _size(eb.shape))
        cache[a, b] = blk
        return blk

    def _block_points(self, ea, eb):
        kernel = self._crosskernel(ea.proc, eb.proc)
        if isinstance(kernel, Zero):
            return self._zeros(_size(ea.shape), _size(eb.shape))
        blk = self._block_points_tiled(kernel, ea, eb)
        if blk is not None:
            return blk
        xa = ea.x.reshape(-1)
        xb = eb.x.reshape(-1)
        return kernel(xa[:, None], xb[None, :])

    def _block_points_tiled(self, kernel, ea, eb):
        """Kernel-C assembly of an isotropic point block, or None when
        the kernel or the inputs fall outside the fast path (the caller
        then broadcasts the core).  Decided before any launch."""
        if self._gram_mode != 'tiled':
            # 'auto' keeps the broadcast path off the TPU, as the JAX
            # package does; a cutover waits for an H100 measurement
            return None
        spec = getattr(kernel, '_fastgram', None)
        if spec is None or spec.noise is not None or spec.core is None:
            # δ-noise components need the exact x == y comparison of the
            # broadcast core
            return None
        cols_a = fg.leaf_columns(ea.x)
        cols_b = cols_a if eb is ea else fg.leaf_columns(eb.x)
        if cols_a is None or cols_b is None or len(cols_a) != len(cols_b):
            return None
        if spec.maxdim is not None and len(cols_a) > spec.maxdim:
            return None  # let the broadcast path raise the guard error
        prof = fg.build_profile(spec)
        if prof is None:
            return None
        profile, post = prof
        X = fg.transform_points(spec, cols_a)
        sym = ea is eb or (eb.x is ea.x and eb.proc == ea.proc)
        Y = None if sym else fg.transform_points(spec, cols_b)
        return ops.gram(profile, X, Y, post=post)

    def _block_lintransf_left(self, ea, b):
        nb = _size(self._elements[b].shape)
        cols = [self._covblock(k, b).reshape(self._elements[k].shape
                                              + (nb,))
                for k in ea.keys]
        vm = torch.func.vmap(ea.transf, in_dims=(-1,) * len(cols),
                             out_dims=-1)
        return vm(*cols).reshape(_size(ea.shape), nb)

    def _assemble(self, rowkeys, colkeys):
        rows = [torch.cat([self._covblock(a, b) for b in colkeys], 1)
                for a in rowkeys]
        return torch.cat(rows, 0) if len(rows) > 1 else rows[0]

    def _checkpos(self, K):
        if not self._checks['pos']:
            return

        def check():
            Kd = K.detach()
            n = Kd.shape[0]
            eps = torch.finfo(Kd.dtype).eps
            if n <= 512:
                eigs = torch.linalg.eigvalsh(Kd)
                mineig = eigs.min()
                mx = eigs.abs().max()
            else:
                # LOBPCG extremal eigenvalue estimate of mx·I − K
                mx = Kd.abs().sum(1).max()
                ar = torch.arange(n, dtype=Kd.dtype, device=Kd.device)
                X = torch.sin(ar[:, None] * (1.0 + ar[None, :8]))
                shifted = mx * torch.eye(n, dtype=Kd.dtype,
                                         device=Kd.device) - Kd
                w, _ = torch.lobpcg(shifted, X=X, niter=32, largest=True)
                mineig = mx - w.max()
            bound = -n * eps * mx * self._checks['posepsfac'] * 64
            if not bool(mineig >= bound):
                raise ValueError(
                    f'covariance matrix not positive definite (min eig '
                    f'{float(mineig):.3g} < {float(bound):.3g})')

        _torchutil.check(check)

    # -- solvers ---------------------------------------------------------------

    def _solver_for(self, inkeys, extracov=None, **decompkw):
        cachekey = tuple(inkeys)
        cacheable = extracov is None and not decompkw
        if cacheable and cachekey in self._decomp_cache:
            return self._decomp_cache[cachekey]
        Kxx = self._assemble(inkeys, inkeys)
        if extracov is not None:
            Kxx = Kxx + extracov
        else:
            self._checkpos(Kxx)
        dec = self._make_decomp(Kxx, **decompkw)
        if cacheable:
            self._decomp_cache[cachekey] = dec
        return dec

    def _make_decomp(self, K, **decompkw):
        return linalg.Chol(K, **{**self._solverkw, **decompkw})

    # -- data ------------------------------------------------------------------

    def _flatgiven(self, given, givencov=None):
        """Flatten a dict key->data into (inkeys, ymean, ycov, yuarr)."""
        if not isinstance(given, dict):
            raise TypeError('given must be a dict')
        inkeys = list(given)
        means = []
        uarrs = []
        for k in inkeys:
            self._checkelkey(k, new=False)
            v = given[k]
            shape = self._elements[k].shape
            if isinstance(v, uncert.UArray):
                uarrs.append(v.reshape(-1))
                means.append(v.mean.reshape(-1))
            else:
                v = self._asarray(v)
                if tuple(v.shape) != shape:
                    raise ValueError(
                        f'data for key {k!r} has shape {tuple(v.shape)}, '
                        f'element has shape {shape}')
                uarrs.append(None)
                means.append(v.reshape(-1))
        ymean = torch.cat(means)
        if self._checks['finite']:
            def check():
                if not bool(torch.isfinite(ymean).all()):
                    raise ValueError('non-finite data')
            _torchutil.check(check)

        n = ymean.numel()
        ycov = None
        yu = None
        if givencov is not None:
            if isinstance(givencov, dict):
                sizes = [m.numel() for m in means]
                offs = numpy.cumsum([0] + sizes)
                ycov = self._zeros(n, n)
                for (k1, k2), blk in givencov.items():
                    i, j = inkeys.index(k1), inkeys.index(k2)
                    blk = self._asarray(blk).reshape(sizes[i], sizes[j])
                    ycov[offs[i]:offs[i + 1], offs[j]:offs[j + 1]] = blk
                    if k1 != k2:
                        ycov[offs[j]:offs[j + 1], offs[i]:offs[i + 1]] = \
                            blk.T
            else:
                ycov = self._asarray(givencov).reshape(n, n)
        elif any(u is not None for u in uarrs):
            yu = uncert.uconcatenate([
                u if u is not None else uncert.UArray(m)
                for u, m in zip(uarrs, means)])
            ycov = yu.cov()
        return inkeys, ymean, ycov, yu

    # -- prior ---------------------------------------------------------------

    def prior(self, key=None, *, raw=False):
        """Prior distribution of the elements (mean zero), correlated
        across keys."""
        if key is None:
            keys = list(self._elements)
        elif isinstance(key, (list, tuple)):
            keys = list(key)
        else:
            keys = [key]
        for k in keys:
            self._checkelkey(k, new=False)
        K = self._assemble(keys, keys)
        self._checkpos(K)
        single = key is not None and not isinstance(key, (list, tuple))
        if raw:
            return K if single else self._unflatten_cov(K, keys)
        u = uncert.from_cov(torch.zeros(K.shape[0], dtype=K.dtype,
                                        device=K.device), K)
        out = self._split(u, keys)
        return out[key] if single else out

    def _split(self, v, keys):
        out = {}
        i = 0
        for k in keys:
            shape = self._elements[k].shape
            m = _size(shape)
            out[k] = v[i:i + m].reshape(shape)
            i += m
        return out

    def _unflatten_cov(self, K, keys):
        out = {}
        offs = [0]
        for k in keys:
            offs.append(offs[-1] + _size(self._elements[k].shape))
        for i, k1 in enumerate(keys):
            for j, k2 in enumerate(keys):
                blk = K[offs[i]:offs[i + 1], offs[j]:offs[j + 1]]
                out[k1, k2] = blk.reshape(self._elements[k1].shape
                                          + self._elements[k2].shape)
        return out

    # -- posterior -----------------------------------------------------------

    def pred(self, given, key=None, givencov=None, *, fromdata=None,
             raw=False, keepcorr=None):
        """Posterior distribution on elements ``key`` given data.

        ``fromdata=True``: data = process + independent noise of
        covariance ``givencov`` (or the data UArray covariance).
        ``fromdata=False``: data is an estimate of the process itself
        with uncertainty ``givencov``.
        """
        if fromdata is None:
            raise ValueError('specify fromdata=True/False, or use '
                             'predfromdata/predfromfit')
        single = key is not None and not isinstance(key, (list, tuple))
        if key is None:
            outkeys = [k for k in self._elements if k not in given]
        elif single:
            outkeys = [key]
        else:
            outkeys = list(key)
        for k in outkeys:
            self._checkelkey(k, new=False)

        inkeys, ymean, ycov, yu = self._flatgiven(given, givencov)
        if keepcorr is None:
            keepcorr = yu is not None and not raw
        if keepcorr and yu is None:
            yu = uncert.UArray(ymean)

        solver = self._solver_for(inkeys,
                                  extracov=ycov if fromdata else None)
        Kxxs = self._assemble(inkeys, outkeys)
        Kxsxs = self._assemble(outkeys, outkeys)

        A = solver.ginv_linear(Kxxs)          # (n, ns)
        mean = A.T @ ymean
        cov_post = Kxsxs - solver.ginv_quad(Kxxs)
        extra = None
        if not fromdata and ycov is not None:
            extra = A.T @ ycov @ A

        if raw:
            cov = cov_post if extra is None else cov_post + extra
            if single:
                return mean.reshape(self._elements[outkeys[0]].shape), cov
            return self._split(mean, outkeys), \
                self._unflatten_cov(cov, outkeys)

        if keepcorr:
            # exact joint representation: posterior = prior_out +
            # A'(data - prior_in), with prior_in/out drawn jointly
            allkeys = list(inkeys)
            for k in outkeys:
                if k not in allkeys:
                    allkeys.append(k)
            Kall = self._assemble(allkeys, allkeys)
            up = uncert.from_cov(torch.zeros(Kall.shape[0], dtype=Kall.dtype,
                                             device=Kall.device), Kall)
            parts = self._split(up, allkeys)
            yp = uncert.uconcatenate([parts[k].reshape(-1) for k in inkeys])
            ysp = uncert.uconcatenate([parts[k].reshape(-1)
                                       for k in outkeys])
            u = ysp + (A.T @ (yu - yp))
        else:
            cov = cov_post if extra is None else cov_post + extra
            u = uncert.from_cov(mean, cov)
        out = self._split(u, outkeys)
        return out[outkeys[0]] if single else out

    def predfromdata(self, given, key=None, givencov=None, **kw):
        """Posterior given noisy data."""
        return self.pred(given, key, givencov, fromdata=True, **kw)

    def predfromfit(self, given, key=None, givencov=None, **kw):
        """Posterior given a fit result."""
        return self.pred(given, key, givencov, fromdata=False, **kw)

    # -- likelihood -----------------------------------------------------------

    def marginal_likelihood(self, given, givencov=None):
        """Log marginal likelihood of the data under the prior;
        differentiable with respect to the hyperparameters through
        `linalg.chol_nll`'s rule."""
        return -self._prior_nll(given, givencov)

    def _prior_nll_parts(self, given, givencov=None, **decompkw):
        """(K, residuals, choleskykw) for the fused NLL."""
        inkeys, ymean, ycov, _ = self._flatgiven(given, givencov)
        K = self._assemble(inkeys, inkeys)
        if ycov is not None:
            K = K + ycov
        else:
            self._checkpos(K)
        return K, ymean, {**self._solverkw, **decompkw}

    def _prior_nll(self, given, givencov=None, **decompkw):
        """-log marginal density of the data; the fit objective."""
        K, ymean, kw = self._prior_nll_parts(given, givencov, **decompkw)
        return linalg.chol_nll(K, ymean, **kw)
