#!/usr/bin/env python3
"""Smoke run of lsqfitgp_torch on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It

1. prints the card's name and power limit (``nvidia-smi``) and the
   torch and CUDA versions, and exits non-zero when torch sees no CUDA
   device or the package is not beside the script;
2. builds the CUDA kernels from ``lsqfitgp_torch/csrc`` and prints the
   build time;
3. holds each kernel (A ``schur_update``, B ``syrk_t_full``, C ``gram``
   with its backward) against its plain PyTorch version on the card, at
   the main path's shapes, in float32 and float64, and times both with
   CUDA events (median of 7 runs after one warm-up); the record keeps
   the main path's dtype (float64 for B, float32 for A and C);
4. fits ``amp * ExpQuad(scale)`` plus noise to n = 16384 points with
   ``empbayes_fit`` in float32 (the main path), predicts at 64 points,
   checks that kernels A, B and C were launched by that run, and holds
   the NLL and its gradient at the start point, at the fitted
   hyperparameters and at a worse-conditioned point, and the posterior
   mean at the fitted hyperparameters, against a plain float64
   computation with ``torch.linalg.cholesky`` (at the fit, through the
   shift of the optimum that the gradient's error implies);
5. prints a JSON line of kernel records and, last, the device line.

Any failed check exits non-zero before the last line.
"""

import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
N = 16384          # the slice's size (see PERF.md, Cells)
NPRED = 64
NOISE_VAR = 0.09   # 0.3**2, the data's noise


def fail(msg):
    print(f'FAIL: {msg}', flush=True)
    sys.exit(1)


def log(msg):
    print(msg, flush=True)


def median_ms(fn, reps=7):
    """Median device time of ``fn()`` in ms, CUDA events, after one
    warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def unit_roundoff(dtype):
    import torch
    return torch.finfo(dtype).eps / 2


def check_close(what, got, ref, tol):
    """Elementwise |got - ref| <= tol; returns the max abs error."""
    import torch
    err = (got - ref).abs()
    if not torch.isfinite(got).all():
        fail(f'{what}: non-finite values')
    bad = int((err > tol).sum())
    maxerr = float(err.max())
    if bad:
        worst = float((err - tol).max())
        fail(f'{what}: {bad} entries outside tolerance (max abs err '
             f'{maxerr:.3e}, worst excess {worst:.3e})')
    log(f'  {what}: max abs err {maxerr:.3e} (tolerance up to '
        f'{float(torch.as_tensor(tol).max()):.3e})')
    return maxerr


def header():
    import torch
    try:
        smi = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'],
            capture_output=True, text=True, timeout=60).stdout.strip()
    except (OSError, subprocess.TimeoutExpired) as exc:
        smi = f'nvidia-smi unavailable: {exc}'
    log(smi)
    log(f'python {sys.version.split()[0]}, torch {torch.__version__}, '
        f'CUDA {torch.version.cuda}')
    if not torch.cuda.is_available():
        fail('torch.cuda.is_available() is False')


def build():
    from lsqfitgp_torch import ops
    info = ops.build_info()
    log(f'build: {info["seconds"]:.1f} s -> {info["path"]}')
    for line in info['log'].splitlines():
        if 'registers' in line or 'spill' in line:
            log(f'  ptxas: {line.strip()}')


# -- kernel phase -------------------------------------------------------------

def kernel_schur(dtype, gen):
    """Kernel A at the largest trailing update of the n = 16384
    factorization (w = h = 8192), with B read at a nonzero offset,
    scaling s, eps, and a ragged nreal."""
    import torch
    from lsqfitgp_torch.ops import _syrk
    size = h = N // 2
    offset, tile = 512, 512
    mb = offset + size
    nreal = offset + size - 300
    kw = dict(device='cuda', dtype=dtype, generator=gen)
    A = torch.randn(size, h, **kw)
    B = torch.randn(mb, mb, **kw)
    s = 0.5 + 1.5 * torch.rand(mb, **kw)
    eps = torch.tensor(0.5, device='cuda', dtype=dtype)
    args = dict(s=s, eps=eps, size=size, offset=offset, tile=tile,
                nreal=nreal)
    got = _syrk.schur_update(B, A, **args)
    ref = _syrk.schur_update_plain(B, A, **args)
    # tolerance: the two sum h products in another order, so each entry
    # may differ by the probabilistic rounding bound of a length-h dot
    # product, 4 sqrt(h) u sum_k |A_ik A_jk|, plus one rounding of the
    # scaled B entry and of eps
    u = unit_roundoff(dtype)
    Aa = A.abs()
    Bv = B[offset:, offset:] * s[offset:, None] * s[None, offset:]
    tol = 4 * math.sqrt(h) * u * (Aa @ Aa.T) + 4 * u * (Bv.abs() + 0.5)
    mask = _syrk._tile_mask(size, tile, A.device)
    err = check_close(f'A schur_update {dtype}', got[mask], ref[mask],
                      tol[mask])
    ms = median_ms(lambda: _syrk.schur_update(B, A, **args))
    plain_ms = median_ms(lambda: _syrk.schur_update_plain(B, A, **args))
    log(f'  A {dtype}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms')
    return err, ms, plain_ms


def kernel_syrk(dtype, gen):
    """Kernel B at the gradient's shape: W = L⁻¹ of n x n (float64 on
    the main path, whose gradient carrier is float64)."""
    import torch
    from lsqfitgp_torch.ops import _syrk
    W = torch.randn(N, N, device='cuda', dtype=dtype, generator=gen).tril_()
    got = _syrk.syrk_t_full(W)
    ref = _syrk.syrk_t_full_plain(W)
    if not torch.equal(got, got.T):
        fail(f'B syrk_t_full {dtype}: result not exactly symmetric')
    # tolerance: as for A, 4 sqrt(n) u (|W|ᵀ|W|)_ij for sums of up to n
    # products taken in another order
    Wa = W.abs()
    tol = 4 * math.sqrt(N) * unit_roundoff(dtype) * _syrk.syrk_t_full_plain(Wa)
    del Wa
    err = check_close(f'B syrk_t_full {dtype}', got, ref, tol)
    del got, ref, tol
    ms = median_ms(lambda: _syrk.syrk_t_full(W))
    plain_ms = median_ms(lambda: _syrk.syrk_t_full_plain(W))
    log(f'  B {dtype}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms')
    return err, ms, plain_ms


def kernel_gram(dtype, gen):
    """Kernel C: the slice's point block (n = m = 16384, p = 1, post
    chain amp, nugget), a p = 8 block, the prediction cross block
    (n x 64), and the backward against autograd of the plain version."""
    import torch
    from lsqfitgp_torch.ops import gram, gram_plain
    u = unit_roundoff(dtype)
    kw = dict(device='cuda', dtype=dtype, generator=gen)
    x = (torch.rand(N, **kw) - 0.5) * 100
    amp = torch.tensor(1.3, device='cuda', dtype=dtype)
    noise = torch.tensor(NOISE_VAR, device='cuda', dtype=dtype)
    post = (('mul', amp),)
    # tolerance: r² is computed identically at p = 1 and exp differs by a
    # few ulps between the two exp implementations: 16 u max|K|; at p > 1
    # the p-term sum also rounds in another order: 16 (p + 1) u max|K|
    K = gram('expquad', x, post=post, noise=noise)
    Kp = gram_plain('expquad', x, post=post, noise=noise)
    err = check_close(f'C gram p=1 {dtype}', K, Kp,
                      16 * u * float(Kp.abs().max()))
    del K, Kp
    ms = median_ms(lambda: gram('expquad', x, post=post, noise=noise))
    plain_ms = median_ms(
        lambda: gram_plain('expquad', x, post=post, noise=noise))
    log(f'  C {dtype}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms')

    X8 = torch.randn(N // 2, 8, **kw)
    K = gram('expquad', X8, post=post)
    Kp = gram_plain('expquad', X8, post=post)
    check_close(f'C gram p=8 {dtype}', K, Kp,
                16 * 9 * u * float(Kp.abs().max()))
    del K, Kp, X8

    xs = (torch.rand(NPRED, **kw) - 0.5) * 120
    K = gram('expquad', x, xs, post=post, noise=noise)
    Kp = gram_plain('expquad', x, xs, post=post, noise=noise)
    check_close(f'C gram cross {N}x{NPRED} {dtype}', K, Kp,
                16 * u * float(Kp.abs().max()))
    del K, Kp

    # backward: gradients of <G, K> with respect to x (both sides),
    # amp and the nugget.  Tolerance: sums of n terms (x, the nugget)
    # in another order, 8 sqrt(n) u sum|terms|; the amp gradient sums
    # n² terms by torch's reduction tree, whose error grows with its
    # depth: ceil(log2(n²)) 4 u sum|terms| (~1e-2 of the value here, so
    # a zero or wrong core fails in float32 too).
    G = torch.randn(N, N, **kw)
    leaves = [x.clone().requires_grad_(), amp.clone().requires_grad_(),
              noise.clone().requires_grad_()]

    def grads(fn):
        xl, al, nl = [t.detach().clone().requires_grad_() for t in leaves]
        out = fn('expquad', xl, post=(('mul', al),), noise=nl)
        return torch.autograd.grad(out, (xl, al, nl), G)

    got = grads(gram)
    ref = grads(gram_plain)
    with torch.no_grad():
        D = x[:, None] - x[None, :]
        g = torch.exp(-0.5 * D * D)
        M = G.abs() * (0.5 * amp * g) * D.abs()
        tx = 2 * (M.sum(1) + M.sum(0))
        ta = (G.abs() * g).sum()
        del D, g, M
    check_close(f'C gram backward dx {dtype}', got[0], ref[0],
                8 * math.sqrt(N) * u * tx)
    check_close(f'C gram backward damp {dtype}', got[1], ref[1],
                math.ceil(math.log2(N * N)) * 4 * u * ta)
    check_close(f'C gram backward dnoise {dtype}', got[2], ref[2],
                8 * math.sqrt(N) * u * G.diagonal().abs().sum())
    return err, ms, plain_ms


def kernel_phase():
    import torch
    records = []
    gen = torch.Generator(device='cuda').manual_seed(20261016)
    f32, f64 = torch.float32, torch.float64
    # each kernel's variants, the main path's first: its numbers go into
    # the record
    specs = [
        ('schur_update', kernel_schur, 'lsqfitgp_torch/csrc/syrk.cu',
         'lsqfitgp_tpu/ops/_syrk.py:63', [f32, f64]),
        ('syrk_t_full', kernel_syrk, 'lsqfitgp_torch/csrc/syrk.cu',
         'lsqfitgp_tpu/ops/_syrk.py:250', [f64, f32]),
        ('gram', kernel_gram, 'lsqfitgp_torch/csrc/gram.cu',
         'lsqfitgp_tpu/ops/_gram.py:68', [f32, f64]),
    ]
    for name, fn, source, replaces, variants in specs:
        log(f'kernel {name}:')
        err, ms, plain_ms = fn(variants[0], gen)
        for v in variants[1:]:
            fn(v, gen)
        torch.cuda.empty_cache()
        records.append(dict(name=name, route='cuda', source=source,
                            replaces=replaces, max_abs_err=err, ms=ms,
                            plain_ms=plain_ms))
    return records


# -- slice phase ----------------------------------------------------------------

def plain_nll64(x, y, log_scale, log_amp):
    """Independent float64 reference of the objective's likelihood part:
    dense K, ``torch.linalg.cholesky`` and autograd, no port code."""
    import torch
    scale, amp = log_scale.exp(), log_amp.exp()
    d = (x[:, None] - x[None, :]) / scale
    K = amp * torch.exp(-0.5 * d * d)
    K.diagonal().add_(NOISE_VAR)
    L = torch.linalg.cholesky(K)
    z = torch.linalg.solve_triangular(L, y[:, None], upper=False)[:, 0]
    return 0.5 * (z @ z) + torch.log(L.diagonal()).sum() \
        + 0.5 * len(x) * math.log(2 * math.pi)


def plain_mean64(x, y, xs, scale, amp):
    """Independent float64 reference of the posterior mean."""
    import torch
    k = lambda a, b: amp * torch.exp(-0.5 * ((a[:, None] - b[None, :])
                                             / scale) ** 2)
    K = k(x, x)
    K.diagonal().add_(NOISE_VAR)
    L = torch.linalg.cholesky(K)
    return k(x, xs).T @ torch.cholesky_solve(y[:, None], L)[:, 0]


def slice_phase(dev='cuda'):
    import numpy as np
    import torch
    import lsqfitgp_torch as lgp
    from lsqfitgp_torch import ops

    def sync():
        if dev == 'cuda':
            torch.cuda.synchronize()

    f32 = torch.float32
    torch.set_default_dtype(f32)
    rng = np.random.default_rng(20261016)
    x = rng.uniform(-50, 50, N)
    y = np.sin(x) + math.sqrt(NOISE_VAR) * rng.standard_normal(N)
    xs = np.linspace(-55, 55, NPRED)
    xt = torch.as_tensor(x, dtype=f32, device=dev)
    yt = torch.as_tensor(y, dtype=f32, device=dev)
    xst = torch.as_tensor(xs, dtype=f32, device=dev)
    noise = NOISE_VAR * torch.eye(N, dtype=f32, device=dev)

    def gpfactory(hp):
        gp = lgp.GP(hp['amp'] * lgp.ExpQuad(scale=hp['scale']),
                    gram='tiled')
        gp = gp.addx(xt, 'f').addcov(noise, 'e')
        return gp.addlintransf(lambda f, e: f + e, ['f', 'e'], 'y')

    hyperprior = {'log(scale)': (0., 1.), 'log(amp)': (0., 1.)}
    counters = [ops.schur_update, ops.syrk_t_full, ops.gram]

    log(f'slice: n = {N}, float32, amp * ExpQuad(scale) + '
        f'{NOISE_VAR} I, gram=tiled')
    for c in counters:
        c.launches = 0
    sync()
    t0 = time.perf_counter()
    fit = lgp.empbayes_fit(hyperprior, gpfactory, {'y': yt},
                           minkw={'maxiter': 50}, raises=True)
    sync()
    wall = time.perf_counter() - t0
    fit_launches = [c.launches for c in counters]
    gp = fit.gp().addx(xst, 'pred')
    post = gp.predfromdata({'y': yt}, 'pred')
    mean = post.mean
    sync()
    launches = [c.launches for c in counters]
    log(f'  fit: {wall:.2f} s wall, {fit.minresult.nit} BFGS iterations, '
        f'{len(fit.evaltimes)} evaluations, median '
        f'{statistics.median(fit.evaltimes) * 1e3:.1f} ms per evaluation '
        f'(value + gradient)')
    log(f'  launches during the fit (A, B, C): {fit_launches}; fit + '
        f'predfromdata: {launches}')
    for name, k in zip(['schur_update', 'syrk_t_full', 'gram'],
                       fit_launches):
        if k == 0:
            fail(f'kernel {name} was not launched during the fit')
    scale = float(fit.pmean['scale'])
    amp = float(fit.pmean['amp'])
    log(f'  fitted scale {scale:.6g}, amp {amp:.6g}; pmean '
        f'{fit.pmean.buf.tolist()}, pcov {fit.pcov.tolist()}')

    # conditioning at the fitted hyperparameters
    K = gp.prior('y', raw=True)
    cond = float(lgp.linalg.Chol(K).cond_estimate)
    del K
    log(f'  Chol.cond_estimate at the fit: {cond:.4g} (0.1/eps32 = '
        f'{0.1 / torch.finfo(f32).eps:.4g})')
    if not cond < 0.1 / torch.finfo(f32).eps:
        fail('conditioning beyond the float32 factorization limit')

    # NLL and its gradient, the port's float32 main path against the
    # float64 reference, at the start point, at the fit, and at a point
    # of worse conditioning where a float32 gradient carrier (the JAX
    # rule's) gets the sign of ∂NLL/∂log(amp) wrong (PERF.md, Findings)
    x64 = xt.double()
    y64 = yt.double()
    eps32 = torch.finfo(f32).eps

    def grad64(lp):
        lp64 = torch.tensor(lp, dtype=torch.float64, device=dev,
                            requires_grad=True)
        nll64 = plain_nll64(x64, y64, lp64[0], lp64[1])
        g64, = torch.autograd.grad(nll64, lp64)
        return float(nll64.detach()), g64

    fitted = [math.log(scale), math.log(amp)]
    points = [('start point', [0., 0.]), ('fitted point', fitted),
              ('ill-conditioned point', [1.05, 2.44])]
    for label, lpv in points:
        lp = torch.tensor(lpv, dtype=f32, device=dev, requires_grad=True)
        gp0 = gpfactory({'scale': lp[0].exp(), 'amp': lp[1].exp()})
        nll32 = -gp0.marginal_likelihood({'y': yt})
        g32, = torch.autograd.grad(nll32, lp)
        with torch.no_grad():
            cond0 = float(lgp.linalg.Chol(gp0.prior('y', raw=True))
                          .cond_estimate)
        del gp0
        ls, la = lp.detach().tolist()
        nll64, g64 = grad64([ls, la])
        nll32 = float(nll32.detach())
        dnll = abs(nll32 - nll64)
        dg = g32.double() - g64
        log(f'  {label} (log scale {ls:.6g}, log amp {la:.6g}): '
            f'cond_estimate {cond0:.4g}; NLL port float32 {nll32:.8g}, '
            f'plain float64 {nll64:.8g}, |diff| {dnll:.3e}')
        log(f'    gradient: port float32 {g32.tolist()}, plain float64 '
            f'{g64.tolist()}')
        # tolerances.  NLL: the float32 path adds its eps = 4 eps32 dmax
        # diagonal anchor (dmax the largest scaled diagonal), which
        # shifts the NLL by eps tr(K_s⁻¹)/2 <= 2 eps32 n (amp + σ²)/σ²
        # (since λmin(K) >= σ²), doubled for rounding.
        if dnll > 4 * eps32 * N * (math.exp(la) + NOISE_VAR) / NOISE_VAR:
            fail(f'{label}: NLL disagrees with the float64 reference')
        if label != 'fitted point':
            # gradient: forward error of float32 solves, ~cond eps32
            # relative, with a factor 10 of margin
            rel = float(dg.norm() / g64.norm())
            log(f'    relative diff {rel:.3e} (limit '
                f'{10 * cond0 * eps32:.3e})')
            if rel > 10 * cond0 * eps32:
                fail(f'{label}: gradient disagrees with the float64 '
                     f'reference')
            continue
        # at the fit the likelihood's gradient only balances the prior's
        # and is small, so its relative error means little; what a fit
        # shows is where its optimum lands.  The gradient error moves it
        # by H⁻¹ dg, H the float64 posterior Hessian in the log
        # parameters (central differences of the float64 gradient plus
        # the N(0, 1) prior's identity): that must stay under a tenth of
        # the posterior standard deviation.
        h = 1e-3
        H = torch.stack([
            (grad64([ls + h * (k == 0), la + h * (k == 1)])[1]
             - grad64([ls - h * (k == 0), la - h * (k == 1)])[1]) / (2 * h)
            for k in range(2)], 1)
        Hinv = torch.linalg.inv(0.5 * (H + H.T)
                                + torch.eye(2, dtype=H.dtype, device=dev))
        shift = (Hinv @ dg).abs() / Hinv.diagonal().sqrt()
        log(f'    optimum shift from the gradient error: {shift.tolist()} '
            f'posterior sdev (limit 0.1); float64 posterior sdev '
            f'{Hinv.diagonal().sqrt().tolist()}')
        if not bool((shift <= 0.1).all()):
            fail(f'{label}: the gradient error moves the optimum too far')

    # posterior mean at the fitted hyperparameters
    with torch.no_grad():
        ref = plain_mean64(x64, y64, xst.double(), scale, amp)
    dmean = float((mean.double() - ref).abs().max())
    log(f'  posterior mean at {NPRED} points: max |port - float64| '
        f'{dmean:.3e}, max |mean| {float(ref.abs().max()):.4g}')
    if not bool(torch.isfinite(mean).all()) or mean.shape != (NPRED,):
        fail('posterior mean not finite or of the wrong shape')
    if dmean > 10 * cond * eps32 * float(ref.abs().max()):
        fail('posterior mean disagrees with the float64 reference')
    return launches


def main():
    sys.path.insert(0, ROOT)
    header()
    try:
        import lsqfitgp_torch  # noqa: F401
    except ImportError as exc:
        fail(f'lsqfitgp_torch not found beside chip_smoke.py: {exc}')
    import torch
    t0 = time.perf_counter()
    build()
    records = kernel_phase()
    torch.cuda.empty_cache()
    launches = slice_phase()
    for rec, k in zip(records, launches):
        rec['launches'] = k
    log(f'total {time.perf_counter() - t0:.1f} s')
    keys = ['name', 'route', 'source', 'replaces', 'launches',
            'max_abs_err', 'ms', 'plain_ms']
    print(json.dumps({'kernels': [{k: r[k] for k in keys}
                                  for r in records]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
