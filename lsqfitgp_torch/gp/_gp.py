"""The GP object: processes, elements, covariance assembly, inference.

Counterpart of ``lsqfitgp_tpu/gp/_gp.py`` with the dense 'chol' and the
streaming 'chol-stream' solvers: immutable construction (every
``def*``/``add*`` method returns a new GP), a process registry (kernels,
linear maps of processes, kernel transformations of processes: the
cross-kernels come from `_crosskernel`), an element registry (points,
possibly of a derivative of the process, finite linear maps, explicit
covariance blocks), covariance-block assembly with point blocks
evaluated by kernel C (``gram='tiled'``, and 'auto' on CUDA), by kernel
E on the upper triangle (``halfmatrix=True``) or by broadcasting the
kernel core, and inference (``prior``, ``pred``/``predfromdata``,
``marginal_likelihood``) whose posteriors are `uncert.UArray`.  Points
may be tensors or `StructuredArray` (multi-field) points.

Not in this version: the distributed solver and the streaming solver's
mesh options, and the double-float Gram of the conditioning rescue.
"""

from __future__ import annotations

import collections
import math

import numpy
import torch

from .. import _array, _config, _torchutil
from .._deriv import Deriv
from ..kernelalg import CrossKernel, Kernel, Zero
from ..kernelalg import _util
from ..kernelalg import _fastgram as fg
from .. import linalg, ops, uncert

__all__ = ['GP', 'DefaultProcess']


class _DefaultProcess:
    def __repr__(self):
        return 'DefaultProcess'


DefaultProcess = _DefaultProcess()

# -- process kinds -----------------------------------------------------------

_ProcKernel = collections.namedtuple('_ProcKernel', ['kernel'])
_ProcLinTransf = collections.namedtuple('_ProcLinTransf', ['transf', 'keys'])
_ProcKernelTransf = collections.namedtuple(
    '_ProcKernelTransf', ['proc', 'transfname', 'arg'])

# -- element kinds -----------------------------------------------------------

_Points = collections.namedtuple('_Points', ['x', 'proc', 'deriv', 'shape'])
_LinTransfEl = collections.namedtuple('_LinTransfEl',
                                      ['transf', 'keys', 'shape'])
_CovEl = collections.namedtuple('_CovEl', ['shape'])


def _size(shape):
    return math.prod(shape) if shape else 1


def _auto_tiles(device, na, nb, p):
    """Whether ``gram='auto'`` evaluates an (na, nb) point block of p
    coordinates by kernel C (kernel E on a symmetric halfmatrix block):
    on the CPU never, as the JAX package off its accelerator; on CUDA at
    p >= 4, and at fewer coordinates from 6144² entries.  PERF.md's
    ``gram='auto'`` cutover table (``chip_smoke.py --gram-route``, the
    block through the GP, forward and forward + backward, float32 and
    float64) measures n x n blocks from n = 256 to 16384 and n x 64
    prediction blocks.  At p < 4 C wins in both dtypes and directions
    from 6144 x 6144 up; below, both routes cost about the host time of
    their launches.  From p = 4 the broadcast's p passes cost more
    everywhere but in the forward of some host-bound n x 64 blocks at
    p = 4 (by at most a quarter of a millisecond).  Blocks smaller than
    the smallest measured (256 x 64) follow the rule unmeasured."""
    if device.type != 'cuda':
        return False
    return p >= 4 or na * nb >= 6144 * 6144


class GP:
    """A Gaussian process model: a dictionary of processes and a
    dictionary of finite elements built from them.

    Parameters
    ----------
    covfun : Kernel, optional
        Kernel of the default process.
    solver : str
        Decomposition used for posteriors: 'chol' (the blocked
        regularized Cholesky, `linalg.Chol`; extra keywords go to it) or
        'chol-stream' (the streaming pipeline, which never forms the
        Gram matrix: `marginal_likelihood` carries the exact gradient of
        `linalg.chol_nll_stream_grad`, `predfromdata` returns means and
        small dense output covariances).  The streaming model must be
        one isotropic process whose kernel C knows the profile,
        optionally inside scalar ``amp * k + c`` chains and plus
        ``sigma2 * White()``, observed by a single ``addx`` element,
        with a ``givencov`` that is a scalar or a per-point variance
        vector; anything else raises with a diagnostic.  Extra keywords:
        ``block``, ``b1``, ``gradblock``, ``precision``.
    checkpos, checksym, checkfinite, checklin : bool
        Eager sanity checks (skipped inside `empbayes_fit`'s objective).
    posepsfac : float
        Tolerance factor for the positivity check.
    halfmatrix : bool
        Evaluate symmetric point blocks on the upper triangle only and
        mirror them: kernel E (`ops.gram_sym`) on the tiled path, the
        kernel core on the packed upper triangle otherwise.
    gram : {'auto', 'tiled', 'broadcast'}
        Point-block assembly.  'tiled' evaluates isotropic kernels whose
        profile kernel C knows (`ops.gram`); 'broadcast' evaluates the
        kernel core on ``x[:, None], y[None, :]``; 'auto' takes kernel C
        on CUDA points where the H100 measured it faster
        (`_block_points_tiled`), and broadcasts on the CPU, as the JAX
        package does off its accelerator.
    """

    _SOLVERS = ('chol', 'chol-stream')

    def __init__(self, covfun=None, *, solver='chol', checkpos=True,
                 checksym=True, checkfinite=True, checklin=True,
                 posepsfac=1, halfmatrix=False, gram='auto', **kw):
        self._procs = {}
        self._elements = {}
        self._kernel_cache = {}
        self._covblock_cache = {}
        self._decomp_cache = {}
        self._user_decomps = {}
        if solver not in self._SOLVERS:
            raise KeyError(f'unknown solver {solver!r}, must be one of '
                           f'{self._SOLVERS}')
        self._solverkw = dict(kw)
        self._solver = solver
        if gram not in ('auto', 'tiled', 'broadcast'):
            raise KeyError(f'unknown gram mode {gram!r}')
        self._gram_mode = gram
        self._halfmatrix = bool(halfmatrix)
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
        new._user_decomps = dict(self._user_decomps)
        new._solverkw = self._solverkw
        new._solver = self._solver
        new._checks = self._checks
        new._gram_mode = self._gram_mode
        new._halfmatrix = self._halfmatrix
        new._device = self._device
        return new

    def _asarray(self, x):
        """A tensor or a StructuredArray on the model's device; floating
        values (fields) take the working dtype, as in the JAX package;
        strings stay host numpy arrays."""
        if not isinstance(x, torch.Tensor):
            x = _array.asarray(x, device=self._device)
        if isinstance(x, numpy.ndarray):
            return x
        x = x.to(device=self._device, dtype=_config.default_float()) \
            if isinstance(x, _array.StructuredArray) or x.is_floating_point() \
            else x.to(device=self._device)
        if self._device is None:
            self._device = x.device
        return x

    def _zeros(self, n1, n2):
        return torch.zeros((n1, n2), dtype=_config.default_float(),
                           device=self._device)

    def _zero_block(self, n1, n2):
        """A covariance block known to be zero: one zero broadcast to
        (n1, n2), never materialized."""
        return torch.zeros((), dtype=_config.default_float(),
                           device=self._device).expand(n1, n2)

    def _checkprockey(self, key, new=False):
        if new and key in self._procs:
            raise KeyError(f'process key {key!r} already defined')
        if not new and key not in self._procs:
            raise KeyError(f'process {key!r} not defined')

    def _checkelkey(self, key, new=True):
        if key is None:
            raise KeyError('key cannot be None')
        if new and key in self._elements:
            raise KeyError(f'element key {key!r} already used')
        if not new and key not in self._elements:
            raise KeyError(f'element {key!r} not defined')

    # -- process definition ----------------------------------------------------

    def defproc(self, key, kernel=None, *, deriv=0):
        """Define a new independent process with the given kernel (the
        default process's if None), or its derivative ``deriv``."""
        self._checkprockey(key, new=True)
        if kernel is None:
            kernel = self._procs[DefaultProcess].kernel
        if not isinstance(kernel, Kernel):
            raise TypeError('kernel must be a symmetric Kernel')
        new = self._clone()
        deriv = Deriv(deriv)
        if deriv:
            # the derivative of an anonymous plain process
            base = object()
            new._procs[base] = _ProcKernel(kernel)
            new._procs[key] = _ProcKernelTransf(base, 'diff', deriv)
        else:
            new._procs[key] = _ProcKernel(kernel)
        return new

    def deftransf(self, key, ops, *, deriv=0):
        """Define a process as a linear combination of other processes:
        f_key = Σ_i c_i f_i, with ``ops = {prockey: c_i}``, each c_i a
        scalar or a function of the input."""
        self._checkprockey(key, new=True)
        keys = list(ops)
        coefs = [ops[k] for k in keys]
        for k in keys:
            self._checkprockey(k)
        for c in coefs:
            if not (callable(c) or _util.is_numerical_scalar(c)):
                raise TypeError(f'invalid coefficient {c!r}')

        def transf(*fns):
            def combo(x):
                out = None
                for c, f in zip(coefs, fns):
                    term = (c(x) if callable(c) else c) * f(x)
                    out = term if out is None else out + term
                return out
            return combo

        return self.deflintransf(key, transf, keys, deriv=deriv)

    def deflintransf(self, key, transf, procs, *, deriv=0, checklin=False):
        """Define a process as a linear map of other processes:
        f_key = T(f_1, ..., f_k), ``transf(*fns)`` returning the function
        of x, or its derivative ``deriv``."""
        self._checkprockey(key, new=True)
        for k in procs:
            self._checkprockey(k)
        new = self._clone()
        deriv = Deriv(deriv)
        new._procs[key] = _ProcLinTransf(transf, list(procs))
        if deriv:
            inner = object()
            new._procs[inner] = new._procs.pop(key)
            new._procs[key] = _ProcKernelTransf(inner, 'diff', deriv)
        return new

    def deflinop(self, key, transfname, arg, proc):
        """Define a process by applying the kernel linop ``transfname``
        with argument ``arg`` to process ``proc``."""
        self._checkprockey(key, new=True)
        self._checkprockey(proc)
        new = self._clone()
        new._procs[key] = _ProcKernelTransf(proc, transfname, arg)
        return new

    def defderiv(self, key, deriv, proc):
        """f_key = ∂^deriv f_proc."""
        return self.deflinop(key, 'diff', Deriv(deriv), proc)

    def defxtransf(self, key, transf, proc):
        """f_key(x) = f_proc(transf(x))."""
        if not callable(transf):
            raise TypeError('transf must be callable')
        return self.deflinop(key, 'xtransf', transf, proc)

    def defrescale(self, key, fun, proc):
        """f_key(x) = fun(x) f_proc(x)."""
        if not callable(fun):
            raise TypeError('fun must be callable')
        return self.deflinop(key, 'rescale', fun, proc)

    # -- cross-kernel derivation -----------------------------------------------

    def _crosskernel(self, pa, pb):
        """The kernel Cov[f_pa(x), f_pb(y)], built recursively from the
        process records and cached; a pair's transpose comes from the
        cache swapped."""
        key = (pa, pb)
        cache = self._kernel_cache
        if key in cache:
            return cache[key]
        if (pb, pa) in cache:
            k = cache[pb, pa]._swap()
            cache[key] = k
            return k
        a = self._procs[pa]
        b = self._procs[pb]
        if isinstance(a, _ProcKernel) and isinstance(b, _ProcKernel):
            k = a.kernel if pa is pb or pa == pb else Zero()
        elif isinstance(a, _ProcKernelTransf):
            base = self._crosskernel(a.proc, pb)
            k = base if isinstance(base, Zero) else base.linop(
                a.transfname, a.arg, None)
        elif isinstance(b, _ProcKernelTransf):
            base = self._crosskernel(pa, b.proc)
            k = base if isinstance(base, Zero) else base.linop(
                b.transfname, None, b.arg)
        elif isinstance(a, _ProcLinTransf):
            kernels = [self._crosskernel(p, pb) for p in a.keys]
            k = Zero() if all(isinstance(k0, Zero) for k0 in kernels) \
                else CrossKernel._nary(a.transf, kernels,
                                       CrossKernel._side.LEFT)
        elif isinstance(b, _ProcLinTransf):
            kernels = [self._crosskernel(pa, p) for p in b.keys]
            k = Zero() if all(isinstance(k0, Zero) for k0 in kernels) \
                else CrossKernel._nary(b.transf, kernels,
                                       CrossKernel._side.RIGHT)
        else:  # pragma: no cover
            raise TypeError(f'unknown process kinds {a!r}, {b!r}')
        cache[key] = k
        return k

    # -- element definition ----------------------------------------------------

    def addx(self, x, key=None, *, deriv=0, proc=DefaultProcess):
        """Add points where the process ``proc`` (or its derivative
        ``deriv``) is evaluated: a tensor or array-like of scalar points,
        or structured points (`StructuredArray`, a numpy structured
        array); a derivative along named fields needs structured
        points with those fields."""
        if not isinstance(x, dict):
            if key is None:
                raise ValueError('key required when x is not a dict')
            x = {key: x}
        elif key is not None:
            raise ValueError('key not allowed when x is a dict')
        self._checkprockey(proc)
        deriv = Deriv(deriv)
        new = self._clone()
        for k, xk in x.items():
            new._checkelkey(k)
            xk = new._asarray(xk)
            if isinstance(xk, _array.StructuredArray):
                for dim in deriv:
                    if dim is not None and dim not in xk.fields:
                        raise ValueError(
                            f'derivative along missing field {dim!r}')
            else:
                if not deriv.implicit:
                    raise ValueError('named derivative with non-structured x')
                if self._checks['finite'] and isinstance(xk, torch.Tensor):
                    def check(xk=xk):
                        if not bool(torch.isfinite(xk).all()):
                            raise ValueError('non-finite x')
                    _torchutil.check(check)
            new._elements[k] = _Points(xk, proc, deriv, tuple(xk.shape))
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

    def addtransf(self, tensors, key, *, axes=1):
        """Add a tensor-contraction linear transformation: the sum over
        keys k of ``tensordot(tensors[k], element_k, axes)`` (a scalar
        tensor multiplies), the per-key results broadcast together.
        ``axes`` counts the contracted dimensions: the trailing axes of
        each tensor against the leading axes of its element."""
        if not (isinstance(axes, int) and axes >= 0):
            raise ValueError(f'axes must be a nonneg integer, got {axes!r}')
        self._checkelkey(key)
        if not tensors:
            raise ValueError('empty tensors, undetermined output shape')
        keys = list(tensors)
        tens = []
        shapes = []
        for k in keys:
            self._checkelkey(k, new=False)
            t = self._asarray(tensors[k])
            eshape = self._elements[k].shape
            tshape = tuple(t.shape)
            if tshape and tshape[t.dim() - axes:] != eshape[:axes]:
                raise ValueError(
                    f'tensors[{k!r}].shape = {tshape} cannot contract '
                    f'{axes} axes against element shape {eshape}')
            if self._checks['finite']:
                def check(t=t, k=k):
                    if not bool(torch.isfinite(t).all()):
                        raise ValueError(f'tensors[{k!r}] contains infs/nans')
                _torchutil.check(check)
            tens.append(t)
            shapes.append(tshape[:t.dim() - axes] + eshape[axes:] if tshape
                          else eshape)
        try:
            torch.broadcast_shapes(*shapes)
        except RuntimeError:
            raise ValueError(f'per-key results of shapes {shapes} do not '
                             f'broadcast together') from None

        def transf(*vals):
            out = None
            for t, v in zip(tens, vals):
                term = t * v if t.dim() == 0 else torch.tensordot(t, v, axes)
                out = term if out is None else out + term
            return out

        return self.addlintransf(transf, keys, key, checklin=False)

    def addcov(self, covblocks, key=None, *, decomps=None):
        """Add finite variables with explicit covariance blocks.

        ``decomps``: a `linalg.Decomposition` of the diagonal block (or a
        dict key -> decomposition).  When an inference call's data are
        exactly one such key, with no further covariance, the stored
        decomposition is used and the block is not factored again."""
        if not isinstance(covblocks, dict):
            if key is None:
                raise ValueError('key required when covblocks is not a dict')
            covblocks = {(key, key): covblocks}
            if decomps is not None and not isinstance(decomps, dict):
                decomps = {key: decomps}
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

        if decomps is not None:
            if not isinstance(decomps, dict):
                raise TypeError('decomps must be a dict key -> '
                                'Decomposition when covblocks is a dict')
            for k, d in decomps.items():
                if k not in elkeys:
                    raise KeyError(
                        f'decomps key {k!r} not among covblocks keys')
                if not isinstance(d, linalg.Decomposition):
                    raise TypeError(f'decomps[{k!r}] is not a Decomposition')
                if d.n != _size(shapes[k]):
                    raise ValueError(f'decomps[{k!r}].n = {d.n} != block '
                                     f'size {_size(shapes[k])}')
            new._user_decomps.update(decomps)

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
                    blk = new._zero_block(n1, n2)
                new._covblock_cache[k1, k2] = blk
        return new

    # -- covariance assembly -------------------------------------------------

    def _covblock(self, a, b, cache=True):
        """Covariance block (a, b): from the GP's cache, or computed and,
        with ``cache``, cached; without, the blocks computed on the way
        live only as long as their reader holds them."""
        known = self._covblock_cache
        if (a, b) in known:
            return known[a, b]
        if (b, a) in known:
            blk = known[b, a].T
            known[a, b] = blk
            return blk
        ea, eb = self._elements[a], self._elements[b]
        if isinstance(ea, _Points) and isinstance(eb, _Points):
            blk = self._block_points(ea, eb)
        elif isinstance(ea, _LinTransfEl):
            blk = self._block_lintransf_left(ea, b, cache)
        elif isinstance(eb, _LinTransfEl):
            blk = self._block_lintransf_left(eb, a, cache).T
        else:
            # independent of everything not specified in addcov
            blk = self._zero_block(_size(ea.shape), _size(eb.shape))
        if cache:
            self._covblock_cache[a, b] = blk
        return blk

    def _block_points(self, ea, eb):
        kernel = self._crosskernel(ea.proc, eb.proc)
        if isinstance(kernel, Zero):
            return self._zero_block(_size(ea.shape), _size(eb.shape))
        if ea.deriv or eb.deriv:
            kernel = kernel.linop('diff', ea.deriv, eb.deriv)
        sym = ea is eb or (eb.x is ea.x and eb.proc == ea.proc
                           and eb.deriv == ea.deriv)
        blk = self._block_points_tiled(kernel, ea, eb, sym)
        if blk is not None:
            return blk
        xa = ea.x.reshape(-1)
        if sym and self._halfmatrix:
            return self._block_points_half(kernel, xa)
        xb = eb.x.reshape(-1)
        return kernel(xa[:, None], xb[None, :])

    @staticmethod
    def _block_points_half(kernel, x):
        """Symmetric point block with the kernel core evaluated on the
        n(n+1)/2 packed upper-triangle pairs only, then mirrored."""
        n = x.shape[0]
        iu, ju = torch.triu_indices(n, n, device=x.device)
        ka = kernel(x[iu], x[ju])
        K = ka.new_zeros((n, n)).index_put((iu, ju), ka)
        return K + K.T - torch.diag(torch.diagonal(K))

    def _block_points_tiled(self, kernel, ea, eb, sym):
        """Kernel-C assembly of an isotropic point block, or None when
        the kernel or the inputs fall outside the fast path, or 'auto'
        finds the broadcast faster: the caller then broadcasts the core.
        Decided before any launch, for a stated reason, never because a
        launch failed."""
        mode = self._gram_mode
        if mode == 'broadcast':
            return None
        spec = getattr(kernel, '_fastgram', None)
        if spec is None or spec.noise is not None or (
                spec.core is None and spec.terms is None):
            # no spec: a transformation that changes the kernel's values
            # dropped it (a derivative, an x transformation, ...), or the
            # kernel is no isotropic constructor; δ-noise components need
            # the exact x == y comparison of the broadcast core
            return None
        cols_a = fg.leaf_columns(ea.x)
        cols_b = cols_a if eb is ea else fg.leaf_columns(eb.x)
        if cols_a is None or cols_b is None or len(cols_a) != len(cols_b):
            return None
        p = len(cols_a)
        if spec.maxdim is not None and p > spec.maxdim:
            return None  # let the broadcast path raise the guard error
        profile = fg.build_profile(spec)
        if profile is None:
            return None  # a core outside GRAM_PROFILES (fg.why_not)
        if mode == 'auto' and not _auto_tiles(cols_a[0].device,
                                              _size(ea.shape),
                                              _size(eb.shape), p):
            return None
        X = fg.transform_points(spec, cols_a)
        if sym and self._halfmatrix:
            return ops.gram_sym(profile, X)
        Y = None if sym else fg.transform_points(spec, cols_b)
        return ops.gram(profile, X, Y)

    def _block_lintransf_left(self, ea, b, cache=True):
        nb = _size(self._elements[b].shape)
        cols = [self._covblock(k, b, cache).reshape(self._elements[k].shape
                                                     + (nb,))
                for k in ea.keys]
        vm = torch.func.vmap(ea.transf, in_dims=(-1,) * len(cols),
                             out_dims=-1)
        return vm(*cols).reshape(_size(ea.shape), nb)

    def _assemble(self, rowkeys, colkeys):
        rows = [torch.cat([self._covblock(a, b) for b in colkeys], 1)
                for a in rowkeys]
        return torch.cat(rows, 0) if len(rows) > 1 else rows[0]

    def _assemble_once(self, keys):
        """The (keys, keys) covariance for one use, the fit objective's:
        the blocks computed on the way (the points blocks, the
        `addlintransf` intermediates) are dropped as soon as their reader
        has them and never enter the GP's cache (a block read twice is
        computed twice, but an off-diagonal block is computed once and
        transposed for its mirror), and a single block is taken as it
        is, not copied.  Returns a contiguous matrix that may be a block
        of the GP's cache: the caller must not write into it."""
        if len(keys) == 1:
            K = self._covblock(keys[0], keys[0], cache=False)
        else:
            blocks = {}
            for i, a in enumerate(keys):
                for b in keys[i:]:
                    blocks[a, b] = self._covblock(a, b, cache=False)
                    blocks[b, a] = blocks[a, b].T
            K = torch.cat([torch.cat([blocks[a, b] for b in keys], 1)
                           for a in keys], 0)
            del blocks
        return K.contiguous()

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
                shifted = -Kd
                shifted.diagonal().add_(mx)
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
        if len(inkeys) == 1 and cacheable \
                and inkeys[0] in self._user_decomps:
            # the data covariance is a user-decomposed addcov block
            return self._user_decomps[inkeys[0]]
        Kxx = self._assemble(inkeys, inkeys)
        if extracov is not None:
            Kxx = Kxx + extracov
        else:
            self._checkpos(Kxx)
        dfg = self._df_gram_maker(inkeys, extracov)
        if dfg is not None:
            decompkw = {**decompkw, 'df_gram': dfg}
        dec = self._make_decomp(Kxx, **decompkw)
        if cacheable:
            self._decomp_cache[cachekey] = dec
        return dec

    def _df_gram_maker(self, inkeys, extracov):
        """A callable returning the data block's Gram (plus ``extracov``)
        assembled in float64 from float64 copies of the points, by kernel
        C in float64 on CUDA (`ops.gram`), or None when the model is not
        one kernel C evaluates (the JAX package's ``_df_gram_maker``,
        which assembles in emulated double precision).  `linalg.Chol`
        calls it only when its float32 rescue fires, and factors it in
        place of the float32 Gram, whose rounding can make a Gram of
        condition ≳ 1e6 indefinite before any factorization sees it."""
        if self._solver != 'chol' or len(inkeys) != 1:
            return None
        el = self._elements[inkeys[0]]
        if not isinstance(el, _Points) or el.deriv:
            return None
        spec = getattr(self._crosskernel(el.proc, el.proc), '_fastgram',
                       None)
        if spec is None or (spec.core is None and spec.terms is None):
            return None
        profile = fg.build_profile(spec)
        cols = fg.leaf_columns(el.x)
        if profile is None or cols is None or (
                spec.maxdim is not None and len(cols) > spec.maxdim):
            return None

        def wide(v):
            return torch.as_tensor(v).detach().to(device=el.x.device,
                                                  dtype=torch.float64)

        def df_gram():
            # the raw points: distances do not see loc, and the scale is
            # divided out in float64
            X = torch.stack([wide(c) for c in cols], -1)
            if spec.scale is not None:
                X = X / wide(spec.scale)
            K = ops.gram(ops.map_scalars(profile, wide), X)
            if spec.noise is not None:
                K.diagonal().add_(wide(spec.noise))
            if extracov is not None:
                K += wide(extracov)
            return K

        return df_gram

    def _make_decomp(self, K, **decompkw):
        if self._solver == 'chol-stream':
            raise RuntimeError(
                "solver='chol-stream' never materializes the Gram matrix, "
                "so there is no dense decomposition; use "
                "marginal_likelihood/predfromdata (which stream), or "
                "solver='chol'")
        return linalg.Chol(K, **{**self._solverkw, **decompkw})

    @classmethod
    def decompose(cls, posdefmatrix, solver='chol', **kw):
        """Decompose a positive definite matrix with the GP's solver
        machinery (`linalg.Chol`)."""
        if solver == 'chol':
            return linalg.Chol(_torchutil.asarray(posdefmatrix), **kw)
        raise KeyError(f'unknown solver {solver!r}')

    # -- streaming solver (never-materialized Gram) --------------------------

    def _stream_kw(self):
        kw = self._solverkw
        out = dict(block=kw.get('block', 512), b1=kw.get('b1', 128))
        if 'precision' in kw:
            out['precision'] = kw['precision']
        return out

    def _stream_model(self, inkeys, givencov):
        """Reduce the model to (profile, post, X, lenscale, noise_kernel,
        noise_total) for the streaming pipeline (every profiled spec the
        JAX package streams: a core kernel C knows, or a sum of such
        terms), or raise a ValueError naming the constraint that
        failed."""

        def bail(msg):
            raise ValueError(
                "solver='chol-stream' needs a model of the form 'one "
                "isotropic-kernel process + diagonal noise' (a single addx "
                "element, kernel = an isotropic constructor whose profile "
                "kernel C knows, or a sum of such kernels, optionally "
                "inside scalar amp*k + c chains and + sigma2*White() sums, "
                "givencov a scalar or a "
                f"per-point variance vector): {msg}")

        if len(inkeys) != 1:
            bail(f'got {len(inkeys)} data elements, need exactly 1')
        el = self._elements[inkeys[0]]
        if not isinstance(el, _Points):
            bail('the data element must come from addx')
        if el.deriv:
            bail('derivative elements are not streamable')
        proc = self._procs[el.proc]
        if not isinstance(proc, _ProcKernel):
            bail('the data process must be a plain kernel process')
        spec = getattr(proc.kernel, '_fastgram', None)
        if spec is None:
            bail('the kernel carries no fast-Gram spec (use an isotropic '
                 'constructor kernel; transformations other than scalar '
                 'mul/add and White sums drop it)')
        if spec.core is None and spec.terms is None:
            bail('the kernel has no isotropic profile (pure noise)')
        cols = fg.leaf_columns(el.x)
        if cols is None:
            bail('inputs outside the fast path (non-numeric points)')
        if spec.maxdim is not None and len(cols) > spec.maxdim:
            bail(f'{len(cols)} input dims exceed the kernel maxdim '
                 f'{spec.maxdim}')
        reason = fg.why_not(spec)
        if reason is not None:
            bail(reason)
        profile, post = fg.build_profile(spec), ()
        X = fg.transform_points(spec._replace(scale=None), cols)
        noise_kernel = spec.noise
        noise_total = noise_kernel
        if givencov is not None:
            gcov = self._asarray(givencov)
            if gcov.dim() == 1 and gcov.shape[0] != _size(el.shape):
                bail(f'givencov vector length {gcov.shape[0]} != '
                     f'{_size(el.shape)} data points')
            if gcov.dim() > 1:
                bail('givencov must be a scalar iid variance or a per-point '
                     'variance vector on the streaming solver (a full '
                     "matrix would materialize n²); or use solver='chol'")
            noise_total = gcov if noise_total is None \
                else noise_total.to(gcov.device) + gcov
        return profile, post, X, spec.scale, noise_kernel, noise_total

    def _stream_flat(self, given):
        if not isinstance(given, dict):
            raise TypeError('given must be a dict')
        inkeys = list(given)
        vals = []
        for k in inkeys:
            self._checkelkey(k, new=False)
            v = given[k]
            if isinstance(v, uncert.UArray):
                raise ValueError(
                    "solver='chol-stream' takes plain-array data and a "
                    "scalar or vector givencov noise variance (UArray data "
                    "would materialize its n² covariance)")
            vals.append(self._asarray(v).reshape(-1))
        return inkeys, torch.cat(vals)

    def _stream_nll(self, given, givencov):
        """-log marginal likelihood through the streaming pipeline, with
        the exact gradient: the fit objective at sizes whose dense Gram
        cannot exist."""
        inkeys, y = self._stream_flat(given)
        profile, post, X, lenscale, _, noise = \
            self._stream_model(inkeys, givencov)
        if self._checks['finite']:
            def check():
                if not bool(torch.isfinite(y).all()):
                    raise ValueError('non-finite data')
            _torchutil.check(check)
        return linalg.chol_nll_stream_grad(
            profile, X, y, post=post, lenscale=lenscale,
            epsabs=0.0 if noise is None else noise,
            gradblock=self._solverkw.get('gradblock'), **self._stream_kw())

    def _stream_pred(self, given, key, givencov, *, fromdata, raw,
                     keepcorr):
        if fromdata is not True:
            raise ValueError(
                "solver='chol-stream' supports predfromdata only (fromfit's "
                "A' ycov A correction needs the dense posterior operator)")
        if keepcorr:
            raise ValueError(
                'keepcorr=True joint priors would materialize n²; use '
                'keepcorr=False on the streaming solver')
        single = key is not None and not isinstance(key, (list, tuple))
        if key is None:
            outkeys = [k for k in self._elements if k not in given]
        elif single:
            outkeys = [key]
        else:
            outkeys = list(key)
        inkeys, y = self._stream_flat(given)
        profile, post, X, lenscale, noise_kernel, noise = \
            self._stream_model(inkeys, givencov)
        proc = self._elements[inkeys[0]].proc
        spec = self._procs[proc].kernel._fastgram
        xs = []
        for k in outkeys:
            self._checkelkey(k, new=False)
            el = self._elements[k]
            if not isinstance(el, _Points) or el.deriv or el.proc != proc:
                raise ValueError('streaming pred outputs must be plain addx '
                                 'points (no derivative) of the same '
                                 'process as the data')
            ck = fg.leaf_columns(el.x)
            if ck is None:
                raise ValueError('output inputs outside the fast path')
            xs.append(fg.transform_points(spec._replace(scale=None), ck))
        Xs = torch.cat(xs)
        if lenscale is not None:
            X = X / lenscale
            Xs = Xs / lenscale
        mean, cov = linalg.chol_pred_stream(
            profile, X, y, Xs, post=post,
            epsabs=0.0 if noise is None else noise, return_cov=True,
            **self._stream_kw())
        if noise_kernel is not None:
            # the process kernel's White component is in the outputs'
            # prior variance too, as on the dense solver
            cov = cov + torch.as_tensor(noise_kernel, dtype=cov.dtype,
                                        device=cov.device) * torch.eye(
                cov.shape[0], dtype=cov.dtype, device=cov.device)
        if raw:
            if single:
                return mean.reshape(self._elements[key].shape), cov
            return self._split(mean, outkeys), \
                self._unflatten_cov(cov, outkeys)
        out = self._split(uncert.from_cov(mean, cov), outkeys)
        return out[outkeys[0]] if single else out

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
                # a scalar is σ² I and a length-n vector diag(v), the
                # forms the streaming solver takes; else an (n, n) matrix
                ycov = self._asarray(givencov)
                if ycov.dim() == 0:
                    ycov = torch.diag(ycov.expand(n))
                elif ycov.dim() == 1 and ycov.shape[0] == n:
                    ycov = torch.diag(ycov)
                else:
                    ycov = ycov.reshape(n, n)
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
        if self._solver == 'chol-stream':
            return self._stream_pred(given, key, givencov, fromdata=fromdata,
                                     raw=raw, keepcorr=keepcorr)
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
        """(K, residuals, choleskykw) for the fused NLL.  K is assembled
        for this one use (`_assemble_once`): at the factorization only K
        itself is alive of the assembly."""
        inkeys, ymean, ycov, _ = self._flatgiven(given, givencov)
        K = self._assemble_once(inkeys)
        if ycov is not None:
            K = K + ycov
        else:
            self._checkpos(K)
        kw = {**self._solverkw, **decompkw}
        dfg = self._df_gram_maker(inkeys, ycov)
        if dfg is not None:
            kw['df_gram'] = dfg
        return K, ymean, kw

    def _prior_kr(self, given, givencov=None):
        """(data covariance matrix, residuals) without decomposing: the
        assembly whose forward and reverse derivatives the fit's Fisher
        information and Fisher-vector products take."""
        if self._solver == 'chol-stream':
            raise RuntimeError(
                "method/covariance='fisher' assemble the dense (K, r) "
                "and are unavailable with solver='chol-stream'; use "
                "covariance='minhess' or 'hess'")
        inkeys, ymean, ycov, _ = self._flatgiven(given, givencov)
        K = self._assemble(inkeys, inkeys)
        if ycov is not None:
            K = K + ycov
        return K, ymean

    def _prior_nll(self, given, givencov=None, **decompkw):
        """-log marginal density of the data; the fit objective.  Through
        `linalg.chol_nll` on 'chol', through the streaming pipeline with
        its exact gradient on 'chol-stream'."""
        if self._solver == 'chol-stream':
            return self._stream_nll(given, givencov)
        K, ymean, kw = self._prior_nll_parts(given, givencov, **decompkw)
        return linalg.chol_nll(K, ymean, **kw)
