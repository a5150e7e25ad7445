"""MAP hyperparameter fitting.

Counterpart of ``lsqfitgp_tpu/fit.py`` (``empbayes_fit``) with the scipy
optimizer:

1. flatten and whiten the hyperprior, so the optimizer works on iid
   standard-normal coordinates;
2. the objective is the GP marginal likelihood (the fused
   `linalg.chol_nll`, whose gradient is the hand-derived rule) plus the
   standard-normal prior on the whitened parameters (+ an optional
   additional loss), evaluated on the data's device with the model's
   eager checks off;
3. minimize with scipy (BFGS on the torch value and gradient, or
   Nelder-Mead without gradient);
4. return the hyperparameters as correlated `uncert.UArray`, with the
   BFGS inverse-Hessian ('minhess') as Laplace covariance.

Not in this version: ``method='fisher'``, ``optimizer='jax'|'optax'``,
``covariance='hess'|'fisher'``, ``custom_nll``, ``forward``, phase
timing and profiler traces.
"""

from __future__ import annotations

import json
import time
import warnings

import numpy
import torch

from . import _config, _torchutil, uncert
from .linalg import Chol
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
    method : {'gradient', 'nograd'}
        BFGS with the gradient (default) or Nelder-Mead.
    optimizer : {'scipy'}
    initial : 'priormean', 'priorsample' or array
        Starting point.
    covariance : {'auto', 'minhess', 'none', 'prior'}
        Posterior covariance: the minimizer's inverse-Hessian estimate
        ('minhess', what 'auto' picks when BFGS provides one), zero
        ('none'), or the unchanged hyperprior covariance ('prior', what
        'auto' falls back to otherwise).
    fix : dict, optional
        Map key -> bool (or array of bool) freezing hyperparameters at
        their prior means.
    additional_loss : callable, optional
        Extra loss term ``loss(hp) -> scalar`` added to the objective.
    raises : bool
        Raise on minimizer failure (else warn and keep the last iterate).
    verbosity : int
        0 silent .. 3 per iteration.

    Attributes
    ----------
    p : BufferDict of UArray
        Hyperparameter posterior (MAP with Laplace covariance).
    pmean : BufferDict of posterior means; pcov : flat posterior
        covariance (stored space).
    prior : the parsed hyperprior BufferDict.
    minresult : scipy OptimizeResult.
    evaltimes : seconds of each objective evaluation.
    """

    def __init__(self, hyperprior, gpfactory, data, *, method='gradient',
                 optimizer='scipy', initial='priormean', covariance='auto',
                 fix=None, additional_loss=None, raises=True, verbosity=0,
                 minkw={}, mlkw={}, gpfactorykw={}, seed=0):
        import scipy.optimize

        log = Logger(verbosity)
        self.log = log
        if optimizer != 'scipy':
            raise KeyError(f'unknown optimizer {optimizer!r}: only '
                           "'scipy' is in lsqfitgp_torch yet")
        if method not in ('gradient', 'nograd'):
            raise KeyError(f'unknown method {method!r}')
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

        def make_hp(w):
            # p = mean + L w ; frozen coordinates stay at the prior mean
            w = torch.where(fixmask_t, torch.zeros((), dtype=dtype,
                                                   device=device), w)
            return prior.replace_buf(pmean_prior + pdec.correlate(w))

        def nll(w):
            with _config.disable_checks():
                hp = make_hp(w)
                if data_callable:
                    d = given(hp, **gpfactorykw)
                    g, gcov = d if isinstance(d, tuple) else (d, None)
                else:
                    g, gcov = given, givencov
                gp = gpfactory(hp, **gpfactorykw)
                out = gp._prior_nll(g, gcov, **mlkw)
                wfree = w[~fixmask_t]
                out = out + 0.5 * torch.dot(wfree, wfree)
                if additional_loss is not None:
                    out = out + additional_loss(hp)
            return out

        def value_and_grad(w):
            w = w.detach().requires_grad_(True)
            v = nll(w)
            g, = torch.autograd.grad(v, w)
            return v.detach(), g

        self._nll = nll
        self._value_and_grad = value_and_grad

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
        counts = {'fun': 0, 'jac': 0}
        t0 = time.perf_counter()
        if method == 'nograd':
            def f(w):
                counts['fun'] += 1
                with torch.no_grad():
                    return finite(timer.time(
                        lambda w: float(nll(totensor(w))), w))
            res = scipy.optimize.minimize(f, w0, method='Nelder-Mead',
                                          callback=callback, **kw)
        else:
            def f(w):
                counts['fun'] += 1
                counts['jac'] += 1
                def host(w):
                    v, g = value_and_grad(totensor(w))
                    return float(v), g.cpu().numpy().astype(float)
                return finite(*timer.time(host, w))
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
            covariance = 'minhess' if hess_inv is not None else 'prior'
        if covariance == 'minhess':
            if hess_inv is None:
                raise ValueError('minimizer provides no hessian estimate')
            cov_w = numpy.asarray(hess_inv, float)
        elif covariance == 'none':
            cov_w = numpy.zeros((nparam, nparam))
        elif covariance == 'prior':
            cov_w = numpy.eye(nparam)
        else:
            raise KeyError(f'unknown covariance {covariance!r}')
        cov_w = numpy.where(fixmask[:, None] | fixmask[None, :], 0.0, cov_w)
        cov_w = torch.as_tensor(cov_w, dtype=dtype, device=device)

        # back to stored-parameter space: p = mean + L w
        wmin = totensor(numpy.where(fixmask, 0.0, res.x))
        L = pdec.correlate(torch.eye(nparam, dtype=dtype, device=device))
        pmean = pmean_prior + pdec.correlate(wmin)
        pcov = L @ cov_w @ L.T
        self.pmean = prior.replace_buf(pmean)
        self.pcov = pcov
        self.p = prior.replace_buf(uncert.from_cov(pmean, pcov))
        self.w = wmin
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
        return self.gpfactory(self.pmap, **self.gpfactorykw)

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
