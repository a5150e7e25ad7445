"""MAP hyperparameter fitting.

Counterpart of ``lsqfitgp_tpu/fit.py`` (``empbayes_fit``) with the scipy
optimizer:

1. flatten and whiten the hyperprior, so the optimizer works on iid
   standard-normal coordinates;
2. the objective is the GP marginal likelihood (``GP._prior_nll``: the
   fused `linalg.chol_nll` on the dense solver, the streaming
   `linalg.chol_nll_stream_grad` on ``solver='chol-stream'``, both with
   hand-derived gradients; or a user's ``custom_nll``) plus the
   standard-normal prior on the whitened parameters (+ an optional
   additional loss), evaluated on the data's device with the model's
   eager checks off; its gradient by reverse mode, or with
   ``forward=True`` by P forward-mode passes that share one
   factorization;
3. minimize with scipy: BFGS on the value and gradient, Nelder-Mead
   without gradient, or (``method='fisher'``) trust-ncg with the
   Hessian of the objective at P <= 20 and Fisher-vector products at
   P > 20;
4. return the hyperparameters as correlated `uncert.UArray`, with a
   Laplace covariance from the BFGS inverse Hessian ('minhess'), the
   Hessian of the objective ('hess': P double-backward passes over one
   ``create_graph`` gradient, through `linalg.second_order` and the
   Gram kernels' second-order kernels) or the expected Fisher
   information ('fisher': `Chol.fisher` of the forward-mode (K, r)
   tangents at P <= 20, columns of Fisher-vector products at P > 20).

``covariance='auto'`` follows the JAX package's rule: 'minhess' where
the minimizer gives an inverse-Hessian estimate, else 'hess', and for a
streaming or ``custom_nll`` objective (which have no second
derivative) 'prior', with a warning.

Not in this version: ``optimizer='jax'|'optax'``, the streaming GP's
``covariance='fisher'`` (the streamed Fisher information; ROADMAP.md,
queue 1), phase timing and profiler traces.
"""

from __future__ import annotations

import json
import time
import warnings

import numpy
import torch
import torch.autograd.forward_ad as fwAD

from . import _config, _torchutil, uncert
from .linalg import Chol, second_order
from .linalg._decomp import _share_factor
from .uncert import BufferDict, UArray

__all__ = ['empbayes_fit']


class Logger:
    """Verbosity-leveled logger."""

    def __init__(self, verbosity=0):
        self.verbosity = verbosity

    def log(self, message, level=1):
        if self.verbosity >= level:
            print(message)


class _Timed:
    """Wall-clock accounting of the objective's evaluations.  ``fn``
    returns host values, so each sample ends after the device work."""

    def __init__(self):
        self.samples = []

    def time(self, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        self.samples.append(time.perf_counter() - t0)
        return out


def _parse_hyperprior(hyperprior, device):
    """(BufferDict layout, mean vector, whitening Chol of the cov), on
    ``device``.  Accepts a BufferDict of UArray, or a dict key -> UArray
    | (mean, sdev) | scalar mean (sdev 1)."""
    if not isinstance(hyperprior, BufferDict):
        conv = {}
        for k, v in hyperprior.items():
            if isinstance(v, UArray):
                conv[k] = v
            elif isinstance(v, tuple) and len(v) == 2:
                conv[k] = uncert.normal(*v)
            else:
                conv[k] = uncert.normal(v, 1.0)
        hyperprior = BufferDict(conv)
    buf = hyperprior.buf
    if not isinstance(buf, UArray):
        buf = uncert.normal(buf, torch.ones(buf.shape, dtype=buf.dtype))
        hyperprior = hyperprior.replace_buf(buf)
    mean = buf.mean.to(device)
    cov = buf.cov().to(device)
    return hyperprior, mean, Chol(cov)


def _parse_data(data):
    """data: dict given | (given, givencov) | callable(hp) -> either."""
    if callable(data):
        return data, None, True
    if isinstance(data, tuple):
        given, givencov = data
        return given, givencov, False
    return data, None, False


def _auto_covariance(method, hess_inv, custom):
    """The covariance that ``covariance='auto'`` stands for, by the JAX
    package's rule: for a streaming or ``custom_nll`` objective the
    minimizer's inverse-Hessian estimate, or else the prior with a
    warning; for a dense one 'hess' with ``method='fisher'`` or without
    an estimate, else 'minhess'."""
    if custom:
        if hess_inv is not None:
            return 'minhess'
        warnings.warn(
            "the objective is the streaming solver's likelihood or a "
            "custom_nll and the minimizer provides no hessian estimate: "
            "posterior covariance set to the prior's "
            "(covariance='prior').  Use method='gradient' (BFGS) for a "
            "Laplace estimate ('minhess').")
        return 'prior'
    return 'hess' if method == 'fisher' or hess_inv is None else 'minhess'


def _check_covariance(covariance, stream, custom):
    """The covariances a streaming or ``custom_nll`` objective cannot
    give, raised as soon as the objective is known: 'hess' (no second
    derivative) with the JAX package's ValueError, and the streaming
    GP's 'fisher', which this version does not have."""
    if covariance == 'fisher' and stream:
        raise NotImplementedError(
            "covariance='fisher' of a streaming GP (the streamed Fisher "
            "information) is not in lsqfitgp_torch yet (ROADMAP.md, queue "
            "1): use 'minhess' (BFGS's inverse Hessian), 'none' or "
            "'prior'")
    if covariance in ('hess', 'fisher') and custom:
        raise ValueError(
            f"covariance={covariance!r} needs second-order AD or the "
            "materialized K(p), neither of which exists for a custom-VJP "
            "likelihood (streaming solver / custom_nll); use "
            "covariance='minhess' with method='gradient' (BFGS), or "
            "'none'/'prior'")


def _data_device(given):
    if isinstance(given, dict):
        for v in given.values():
            v = v.mean if isinstance(v, UArray) else v
            if isinstance(v, torch.Tensor):
                return v.device
    return _config.default_device()


class empbayes_fit:
    """Maximum-a-posteriori fit of GP hyperparameters.

    Parameters
    ----------
    hyperprior : dict or BufferDict
        Prior for the hyperparameters: values may be `uncert.UArray`,
        ``(mean, sdev)`` tuples, or bare means (sdev 1).  Keys may use
        transformation names, e.g. ``'log(sigma)'``.
    gpfactory : callable
        ``gpfactory(hp, **gpfactorykw) -> GP`` where hp is a BufferDict.
    data : dict, (dict, cov), or callable
        Observed data per element key; optionally with covariance, or a
        callable of the hyperparameters.  The fit runs on the device of
        the data's tensors (the default device for array-likes).
    method : {'gradient', 'nograd', 'fisher'}
        BFGS with the gradient (default), Nelder-Mead, or trust-ncg with
        the Hessian of the objective (P <= 20 hyperparameters) or
        Fisher-vector products (P > 20; ``minkw['fishvec']`` overrides
        the switch), which leave out ``additional_loss``'s curvature.
    optimizer : {'scipy'}
    initial : 'priormean', 'priorsample' or array
        Starting point.
    covariance : {'auto', 'hess', 'fisher', 'minhess', 'none', 'prior'}
        Posterior covariance: the inverse Hessian of the objective
        ('hess', with the whitened prior and ``additional_loss``), of
        the expected Fisher information plus the whitened prior
        ('fisher', dense solver), the minimizer's inverse-Hessian
        estimate ('minhess'), zero ('none'), or the unchanged
        hyperprior covariance ('prior').  'auto' is 'minhess' where the
        minimizer gives an estimate and 'hess' otherwise (and with
        ``method='fisher'``); for a streaming GP or a ``custom_nll``,
        which have no second derivative, 'prior' (with a warning) in
        place of 'hess', which raises.
    fix : dict, optional
        Map key -> bool (or array of bool) freezing hyperparameters at
        their prior means.
    additional_loss : callable, optional
        Extra loss term ``loss(hp) -> scalar`` added to the objective.
    raises : bool
        Raise on minimizer failure (else warn and keep the last iterate).
    verbosity : int
        0 silent .. 3 per iteration.
    forward : bool
        Gradient by forward mode: one pass per hyperparameter, the
        passes sharing one factorization of K.
    custom_nll : callable, optional
        ``custom_nll(hp) -> scalar`` replaces the GP's marginal
        likelihood (``gpfactory`` and ``data`` may then be omitted); the
        whitened prior, ``additional_loss``, ``fix`` and the optimizers
        apply as before.  ``method='fisher'`` and ``covariance='fisher'``
        need the (K, r) assembly and raise.

    Attributes
    ----------
    p : BufferDict of UArray
        Hyperparameter posterior (MAP with Laplace covariance).
    pmean : BufferDict of posterior means; pcov : flat posterior
        covariance (stored space).
    prior : the parsed hyperprior BufferDict.
    minresult : scipy OptimizeResult.
    evaltimes : seconds of each objective evaluation.
    counts : the minimizer's evaluations of the objective ('fun'), its
        gradient ('jac') and its curvature ('hess', Hessians or
        Fisher-vector products).
    """

    def __init__(self, hyperprior, gpfactory=None, data=None, *,
                 method='gradient', optimizer='scipy', initial='priormean',
                 covariance='auto', fix=None, additional_loss=None,
                 raises=True, verbosity=0, minkw={}, mlkw={},
                 gpfactorykw={}, forward=False, seed=0, custom_nll=None):
        import scipy.optimize

        log = Logger(verbosity)
        self.log = log
        if optimizer != 'scipy':
            raise KeyError(f'unknown optimizer {optimizer!r}: only '
                           "'scipy' is in lsqfitgp_torch yet")
        if method not in ('gradient', 'nograd', 'fisher'):
            raise KeyError(f'unknown method {method!r}')
        if covariance not in ('auto', 'hess', 'fisher', 'minhess', 'none',
                              'prior'):
            raise KeyError(f'unknown covariance {covariance!r}')
        if custom_nll is None and (gpfactory is None or data is None):
            raise TypeError('provide gpfactory and data, or custom_nll')
        if custom_nll is not None:
            if method == 'fisher' or covariance == 'fisher':
                raise ValueError(
                    "method/covariance='fisher' need the (K, r) assembly "
                    "and are unavailable with custom_nll; use "
                    "covariance='hess'")
            # the custom objective owns the data
            gpfactory = gpfactory or (lambda hp, **kw: None)
            data = {} if data is None else data
        given, givencov, data_callable = _parse_data(data)
        device = _data_device(given)
        prior, pmean_prior, pdec = _parse_hyperprior(hyperprior, device)
        self.prior = prior
        dtype = pmean_prior.dtype
        nparam = pmean_prior.numel()

        fixmask = numpy.zeros(nparam, bool)
        if fix is not None:
            for k, v in fix.items():
                sl, shape = prior._slices[k]
                fixmask[sl] = numpy.broadcast_to(v, shape).reshape(-1)
        self.fix = fixmask
        fixmask_t = torch.as_tensor(fixmask, device=device)

        # whether the objective is the streaming solver's, set by nll; a
        # streaming or custom_nll objective has no second derivative
        stream = [False]

        def custom():
            return stream[0] or custom_nll is not None

        def make_hp(w):
            # p = mean + L w ; frozen coordinates stay at the prior mean
            w = torch.where(fixmask_t, torch.zeros((), dtype=dtype,
                                                   device=device), w)
            return prior.replace_buf(pmean_prior + pdec.correlate(w))

        def model_data(hp):
            if data_callable:
                d = given(hp, **gpfactorykw)
                return d if isinstance(d, tuple) else (d, None)
            return given, givencov

        def nll(w):
            with _config.disable_checks():
                hp = make_hp(w)
                if custom_nll is not None:
                    out = custom_nll(hp)
                else:
                    g, gcov = model_data(hp)
                    gp = gpfactory(hp, **gpfactorykw)
                    stream[0] = gp._solver == 'chol-stream'
                    out = gp._prior_nll(g, gcov, **mlkw)
                wfree = w[~fixmask_t]
                out = out + 0.5 * torch.dot(wfree, wfree)
                if additional_loss is not None:
                    out = out + additional_loss(hp)
            return out

        def make_Kr(w):
            """(K(w), r(w)) without decomposing, the assembly whose
            tangents and cotangents the Fisher information takes."""
            with _config.disable_checks():
                hp = make_hp(w)
                g, gcov = model_data(hp)
                return gpfactory(hp, **gpfactorykw)._prior_kr(g, gcov)

        def unit(k):
            e = torch.zeros(nparam, dtype=dtype, device=device)
            e[k] = 1
            return e

        if forward:
            def value_and_grad(w):
                # one forward-mode pass per free coordinate; the passes
                # share the factorization and the gradient carrier
                w = w.detach()
                grad = torch.zeros_like(w)
                v = None
                with _share_factor():
                    for k in numpy.flatnonzero(~fixmask):
                        with fwAD.dual_level():
                            out = nll(fwAD.make_dual(w, unit(k)))
                            v, t = fwAD.unpack_dual(out)
                        if t is not None:
                            grad[k] = t
                if v is None:
                    v = nll(w)
                return v.detach(), grad
        else:
            def value_and_grad(w):
                w = w.detach().requires_grad_(True)
                v = nll(w)
                g, = torch.autograd.grad(v, w)
                return v.detach(), g

        def hessian(w):
            """The Hessian of the objective: P double-backward passes over
            one create_graph gradient, symmetrized; fixed coordinates get
            a unit diagonal."""
            w = w.detach().requires_grad_(True)
            with second_order():
                v = nll(w)
            g, = torch.autograd.grad(v, w, create_graph=True)
            rows = []
            for k in range(nparam):
                h = None
                if not fixmask[k]:
                    h, = torch.autograd.grad(g[k], w, retain_graph=True,
                                             allow_unused=True)
                rows.append(torch.zeros_like(w) if h is None else h)
            del g, v
            H = torch.stack(rows).detach()
            # symmetric to the rounding of the passes: taken exactly so
            H = 0.5 * (H + H.T)
            mask = fixmask_t[:, None] | fixmask_t[None, :]
            return torch.where(mask, torch.eye(nparam, dtype=H.dtype,
                                               device=device), H)

        def make_fishvec():
            """Expected-Fisher-vector products F v: one forward-mode
            pass of (K, r) along v gives the directional derivatives,
            `Chol.fishvec_cotangent` turns them into cotangents, one
            reverse pass pulls them back; plus the whitened prior's
            identity (``additional_loss``'s curvature is left out).  The
            factorization and the reverse graph are kept for the last w."""
            last = {}

            def fishvec(w, v):
                key = w.detach().cpu().numpy().tobytes()
                if last.get('key') != key:
                    last.clear()
                    wg = w.detach().requires_grad_(True)
                    K, r = make_Kr(wg)
                    outs = [t for t in (K, r) if t.requires_grad]
                    last.update(key=key, wg=wg, K=K, r=r, outs=outs,
                                dec=Chol(K.detach()))
                vfree = torch.where(fixmask_t, torch.zeros((), dtype=dtype,
                                                           device=device), v)
                with fwAD.dual_level():
                    Kd, rd = make_Kr(fwAD.make_dual(w.detach(), vfree))
                    dK = fwAD.unpack_dual(Kd).tangent
                    dr = fwAD.unpack_dual(rd).tangent
                K, r = last['K'], last['r']
                dK = torch.zeros_like(K) if dK is None else dK
                dr = torch.zeros_like(r) if dr is None else dr
                CK, cr = last['dec'].fishvec_cotangent(dK, dr)
                Fv = torch.zeros_like(v)
                if last['outs']:
                    cots = [c for t, c in ((K, CK), (r, cr))
                            if t.requires_grad]
                    Fv, = torch.autograd.grad(last['outs'], last['wg'],
                                              cots, retain_graph=True,
                                              allow_unused=True)
                    Fv = torch.zeros_like(v) if Fv is None else Fv
                return torch.where(fixmask_t, v, Fv + v)

            return fishvec

        def fisher_dense(w):
            """The expected Fisher information plus the whitened prior:
            `Chol.fisher` of the forward-mode tangents of (K, r), one
            pass per coordinate; fixed coordinates get a unit diagonal."""
            w = w.detach()
            with torch.no_grad():
                K0, _ = make_Kr(w)
            dKs, drs = [], []
            for k in range(nparam):
                with fwAD.dual_level():
                    Kd, rd = make_Kr(fwAD.make_dual(w, unit(k)))
                    dK = fwAD.unpack_dual(Kd).tangent
                    dr = fwAD.unpack_dual(rd).tangent
                dKs.append(torch.zeros_like(K0) if dK is None else dK)
                drs.append(torch.zeros(K0.shape[0], dtype=K0.dtype,
                                       device=device) if dr is None else dr)
            F = Chol(K0).fisher(dKs, torch.stack(drs))
            del dKs
            F = F.to(dtype) + torch.eye(nparam, dtype=dtype, device=device)
            mask = fixmask_t[:, None] | fixmask_t[None, :]
            return torch.where(mask, torch.eye(nparam, dtype=dtype,
                                               device=device), F)

        self._nll = nll
        self._value_and_grad = value_and_grad
        self._hessian = hessian
        self._make_Kr = make_Kr

        def totensor(w):
            return torch.as_tensor(numpy.asarray(w), dtype=dtype,
                                   device=device)

        if isinstance(initial, str) and initial == 'priormean':
            w0 = numpy.zeros(nparam)
        elif isinstance(initial, str) and initial == 'priorsample':
            w0 = numpy.random.default_rng(seed).standard_normal(nparam)
        elif isinstance(initial, str):
            raise KeyError(f'unknown initial {initial!r}')
        else:
            p0 = _torchutil.asarray(initial, dtype=dtype, device=device)
            w0 = pdec.pinv_correlate(p0 - pmean_prior).cpu().numpy()

        log.log(f'empbayes_fit: {nparam} hyperparameters, '
                f'method={method!r}, device={device}', 1)

        timer = _Timed()
        itercount = [0]
        self.itertimes = []
        lastiter = [time.perf_counter()]

        def callback(xk):
            itercount[0] += 1
            now = time.perf_counter()
            self.itertimes.append(now - lastiter[0])
            lastiter[0] = now
            if verbosity >= 3:
                v = float(nll(totensor(xk)))
                log.log(f'iter {itercount[0]}: nll = {v:.6g} '
                        f'({self.itertimes[-1] * 1e3:.1f} ms)', 3)

        seen_finite = [False]

        def finite(v, g=None):
            """Map non-finite objective values to a large finite value
            with zero gradient, so line searches backtrack; a non-finite
            first evaluation raises (warns with ``raises=False``)."""
            _check_covariance(covariance, stream[0], custom())
            ok = numpy.isfinite(v) and (g is None or numpy.all(
                numpy.isfinite(g)))
            if ok:
                seen_finite[0] = True
                return v if g is None else (v, g)
            if not seen_finite[0]:
                msg = ('the objective (or its gradient) is non-finite at '
                       'the starting point; check the model/hyperprior (or '
                       'pass a different initial=)')
                if raises:
                    raise FloatingPointError(msg)
                seen_finite[0] = True
                warnings.warn(msg)
            big = 1e30
            return big if g is None else (big, numpy.zeros_like(g))

        kw = dict(minkw)
        if 'maxiter' in kw:
            # the form the JAX package's optax loop reads
            kw['options'] = {**kw.get('options', {}),
                             'maxiter': kw.pop('maxiter')}
        counts = {'fun': 0, 'jac': 0, 'hess': 0}

        def f(w):
            counts['fun'] += 1
            counts['jac'] += 1

            def host(w):
                v, g = value_and_grad(totensor(w))
                return float(v), g.cpu().numpy().astype(float)
            return finite(*timer.time(host, w))

        t0 = time.perf_counter()
        if method == 'nograd':
            def fval(w):
                counts['fun'] += 1
                with torch.no_grad():
                    return finite(timer.time(
                        lambda w: float(nll(totensor(w))), w))
            res = scipy.optimize.minimize(fval, w0, method='Nelder-Mead',
                                          callback=callback, **kw)
        elif method == 'fisher':
            use_fishvec = kw.pop('fishvec', nparam > 20)
            if use_fishvec:
                fvec = make_fishvec()

                def hessp(w, v):
                    counts['hess'] += 1
                    return fvec(totensor(w), totensor(v)).cpu().numpy() \
                        .astype(float)
                res = scipy.optimize.minimize(
                    f, w0, jac=True, method='trust-ncg', hessp=hessp,
                    callback=callback, **kw)
            else:
                def hess(w):
                    counts['hess'] += 1
                    return hessian(totensor(w)).cpu().numpy().astype(float)
                res = scipy.optimize.minimize(
                    f, w0, jac=True, method='trust-ncg', hess=hess,
                    callback=callback, **kw)
        else:
            res = scipy.optimize.minimize(
                f, w0, jac=True, method=kw.pop('method', 'BFGS'),
                callback=callback, **kw)
        success = bool(res.success)
        hess_inv = getattr(res, 'hess_inv', None)
        if hess_inv is not None and hasattr(hess_inv, 'todense'):
            hess_inv = hess_inv.todense()
        if not success and 'precision loss' in \
                str(getattr(res, 'message', '')).lower():
            success = self._converged_anyway(res, hess_inv, dtype)
        self.elapsed = time.perf_counter() - t0
        self.minresult = res
        self.evaltimes = list(timer.samples)
        log.log(f'minimization done in {self.elapsed:.2f}s, {res.nit} '
                f'iters, success={success}', 1)
        if not success:
            msg = f'minimization failed: {getattr(res, "message", "?")}'
            if raises:
                raise RuntimeError(msg)
            warnings.warn(msg)

        # posterior covariance in whitened space
        if covariance == 'auto':
            covariance = _auto_covariance(method, hess_inv, custom())
        _check_covariance(covariance, stream[0], custom())
        wmin = totensor(numpy.where(fixmask, 0.0, res.x))
        t1 = time.perf_counter()
        if covariance == 'hess':
            cov_w = Chol(hessian(totensor(res.x))).ginv()
        elif covariance == 'fisher':
            if nparam > 20:
                # one Fisher-vector product per column, on one factor
                fvec = make_fishvec()
                wx = totensor(res.x)
                F = torch.stack([fvec(wx, unit(k)) for k in range(nparam)])
                del fvec
            else:
                F = fisher_dense(totensor(res.x))
            cov_w = Chol(F).ginv()
        elif covariance == 'minhess':
            if hess_inv is None:
                raise ValueError('minimizer provides no hessian estimate')
            cov_w = numpy.asarray(hess_inv, float)
        elif covariance == 'none':
            cov_w = numpy.zeros((nparam, nparam))
        else:
            cov_w = numpy.eye(nparam)
        self.covtime = time.perf_counter() - t1
        cov_w = torch.as_tensor(cov_w, dtype=dtype, device=device)
        freeze = fixmask_t[:, None] | fixmask_t[None, :]
        cov_w = torch.where(freeze, torch.zeros((), dtype=dtype,
                                                device=device), cov_w)

        # back to stored-parameter space: p = mean + L w
        L = pdec.correlate(torch.eye(nparam, dtype=dtype, device=device))
        pmean = pmean_prior + pdec.correlate(wmin)
        pcov = L @ cov_w @ L.T
        self.pmean = prior.replace_buf(pmean)
        self.pcov = pcov
        self.p = prior.replace_buf(uncert.from_cov(pmean, pcov))
        self.w = wmin
        self.covariance = covariance
        self.minargs = dict(method=method, optimizer=optimizer, minkw=minkw)
        self.counts = counts
        self.gpfactory = gpfactory
        self.gpfactorykw = gpfactorykw
        hp_map = prior.replace_buf(pmean)
        self.pmap = hp_map
        if data_callable:
            d = given(hp_map, **gpfactorykw)
            self.data = d if isinstance(d, tuple) else (d, None)
        else:
            self.data = (given, givencov)

    @staticmethod
    def _converged_anyway(res, hess_inv, dtype):
        """scipy's line-search tolerances assume float64 gradients: a
        'precision loss' exit with the gradient at the objective's
        dtype noise level, or with a tiny Newton decrement g' H⁻¹ g, is
        convergence."""
        g = getattr(res, 'jac', None)
        if g is None:
            return False
        eps = torch.finfo(dtype).eps
        gv = numpy.asarray(g, float)
        scale = max(1.0, abs(float(res.fun)))
        if numpy.max(numpy.abs(gv)) <= 10 * eps ** 0.5 * scale:
            return True
        if hess_inv is None:
            return False
        lam2 = float(gv @ (numpy.asarray(hess_inv, float) @ gv))
        return 0 <= lam2 <= 100 * eps * scale

    def gp(self):
        """The GP built at the MAP hyperparameters."""
        gp = self.gpfactory(self.pmap, **self.gpfactorykw)
        if gp is None:
            raise TypeError('no gpfactory: this fit used custom_nll; build '
                            'the model from .pmap yourself')
        return gp

    # -- checkpoint / resume ---------------------------------------------------

    def save(self, path):
        """Persist the fit state (layout, posterior mean/cov, whitened
        minimum) to an .npz file, in the JAX package's format."""
        layout = json.dumps({
            'keys': list(self.prior.keys()),
            'shapes': [list(self.prior._slices[k][1])
                       for k in self.prior.keys()],
        })
        numpy.savez(
            path,
            layout=numpy.asarray(layout),
            pmean=self.pmean.buf.detach().cpu().numpy(),
            pcov=self.pcov.detach().cpu().numpy(),
            w=self.w.detach().cpu().numpy(),
        )

    @staticmethod
    def load(path):
        """Load a saved fit state (from either package): a dict with 'p'
        (BufferDict of UArray posterior), 'pmean', 'pcov', 'w'."""
        dat = numpy.load(path)
        layout = json.loads(str(dat['layout']))
        pmean = _torchutil.asarray(dat['pmean'])
        pcov = _torchutil.asarray(dat['pcov'])
        bd = BufferDict(keys=list(layout['keys']),
                        shapes=[tuple(s) for s in layout['shapes']],
                        buf=uncert.from_cov(pmean, pcov))
        return dict(p=bd, pmean=pmean, pcov=pcov,
                    w=_torchutil.asarray(dat['w']))
