#!/usr/bin/env python3
"""Smoke run of lsqfitgp_torch on one CUDA card.

Run from the root of a checkout: ``python3 chip_smoke.py``.  It

1. prints the card's name and power limit (``nvidia-smi``) and the
   torch and CUDA versions, and exits non-zero when torch sees no CUDA
   device or the package is not beside the script;
2. builds the CUDA kernels from ``lsqfitgp_torch/csrc`` and prints the
   build time;
3. holds each kernel (A ``schur_update``, B ``syrk_t_full`` and its
   in-place form ``syrk_t_full_``, C ``gram`` and its fused backward
   ``gram_backward``, D ``schur_update_gram``, E ``gram_sym`` and its
   fused backward ``gram_sym_backward``) against its plain PyTorch
   version on the card, at its path's shapes, in float32 and float64,
   and times both with CUDA events (median of a few runs after one
   warm-up; C's and E's, sub-millisecond, by their device time under
   the profiler), beside the bound (the least time the card could take
   for the same work) and, where one PyTorch call computes a superset of
   the work, that call's time.  A and D run in float32 at each
   precision, each its own record: 'high' (the tensor-core kernel in
   3xTF32, the path's), 'default' (1xTF32) and 'highest' (the SIMT
   kernel), and in float64 (the FP64 tensor-core kernel, DMMA); B has a
   record for float64 out of place and in place (DMMA; the path's) and
   for float32 (SIMT); C, E and their backward for float32 and float64
   (E's and its backward's with '/float64' off every path); the fused
   backward must give the same bits in two calls, and E the same
   entries as C; each record has its share of the bound;
4. the float32 rescue: ``Chol`` and ``chol_nll`` of a float32 ExpQuad
   Gram with a small nugget at n = 4096 (the largest size the rescue
   takes by default), on which the 'high' rung fails: prints the rung
   the ladder ended on and whether the rescue fired, checks that kernel
   A ran at 'highest' (the SIMT kernel) and in float64 (DMMA) and that
   the rescue fired, and holds the NLL, logdet, solve and the gradient
   in K and y against float64 ``torch.linalg.cholesky`` of the same
   float32 matrix plus the primary eps;
5. the dense path: fits ``amp * ExpQuad(scale)`` plus noise to n = 16384
   points with ``empbayes_fit`` in float32, predicts at 64 points,
   checks that kernels A (on the tensor cores), B (in place) and C were
   launched by that run, C's forward and fused backward once for each
   evaluation (so no other Gram evaluation ran), prints the peak memory
   of one value+gradient in bytes per n² (before the Gram's backward and
   from it on) and a profile of one, and holds the NLL and its gradient
   at the
   start point, at the fitted hyperparameters and at a worse-conditioned
   point (where it also prints the error at precision 'highest'), and
   the posterior mean at the fitted hyperparameters, against a plain
   float64 computation with ``torch.linalg.cholesky`` (at the fit,
   through the shift of the optimum that the gradient's error implies);
   then the same model in float64 (the lane of the JAX package's users
   under x64): a few value+gradients at the fit, their median time, that
   kernels A and B (both DMMA) and C (forward and fused backward once for
   each evaluation) ran, and the NLL and gradient against the float64
   computation;
6. the streaming path: ``GP(solver='chol-stream')`` fitted by
   ``empbayes_fit`` (3 BFGS iterations from the dense fit's MAP) to
   n = 65536 points from numpy, a size whose dense Gram does not fit the
   card, then
   ``predfromdata``; checks that kernels D and A were launched on the
   tensor cores and C's fused backward once for each gradient strip,
   and prints the peak memory; then at n = 32768 holds the streaming NLL, gradient and
   posterior mean against the float64 computation, as in 5;
7. the halfmatrix path: one dense value+gradient at n = 16384 with
   ``halfmatrix=True, gram='tiled'`` (kernel E and its fused backward,
   once each) against the same with ``halfmatrix=False`` (C's, once
   each);
8. the second-order path of the dense model at n = 16384, float32: from
   the BFGS fit's MAP, ``empbayes_fit`` with ``covariance='hess'`` (the
   Hessian by double backward: kernels C′ and C″ once per
   hyperparameter) and ``covariance='fisher'`` (C′ once per
   hyperparameter), each matrix held to a float64 oracle (closed-form
   Hessian and Fisher information from ``torch.linalg.cholesky``)
   within a bound from the conditioning; a ``method='fisher'`` fit
   (trust-ncg on the Hessian) from the start point, which must land
   within one posterior standard deviation of the BFGS fit's MAP; the
   launch counts of each, and that the BFGS fit launched neither
   tangent kernel; then the P > 20 path (the noise in 24 groups, P = 26,
   at n = 8192: trust-ncg on Fisher-vector products for a few
   iterations, and the Fisher covariance from their columns, positive
   definite), and ``covariance='hess'`` on the halfmatrix model (E′ and
   E″) against the full one, both held to the oracle; the tangent
   kernels C′ (``gram_jvp``), C″ (``gram_backward_jvp``), E′ and E″ are
   held in step 3 against their plain versions at 16384², C″ and E″ to
   the bit in two calls, E′ to C′'s entries;
9. prints a JSON line of kernel records and, last, the device line.

Any failed check exits non-zero before the last line.

``python3 chip_smoke.py --dense-at N`` runs only one dense float32
value+gradient of the dense slice's model at n = N and prints its peak
memory (it needs nothing of this version beyond the package's public
API); ``--memory-probe`` runs that at each of a list of sizes, each in
its own process, to find the largest n that fits the card;
``--compare-fits`` runs the dense and the streaming fits at precision
'high' and 'highest' in turns; ``--compare-highest`` the dense fit at
'high' and 'highest' and streaming evaluations at 'highest', each with
its time per evaluation and a profile; ``--dense64`` runs only the
float64 dense evaluation, at the dense fit's optimum; ``--gram-route`` times kernels C
and E with their backward through the public API, and dense float32
value+gradients at the optimum with a profile (``--dense64`` and
``--gram-route`` run from an older checkout too, to time its route in
the same call).
"""

import json
import math
import os
import statistics
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
N = 16384          # the dense slice's size (see PERF.md, Cells)
N_STREAM = 65536   # the streaming slice's size
N_CHECK = 32768    # the streaming slice's float64 check
NPRED = 64
STREAM_BLOCK = 512  # the streaming solver's block
NOISE_VAR = 0.09   # 0.3**2, the data's noise
# the rescue phase: a float32 Gram at the largest size the float32 rescue
# takes by default (DF_MAX), smooth enough (ExpQuad of scale 2 over 4096
# points on [0, 100]) that its small nugget makes the 'high' rung fail
N_RESCUE = 4096
RESCUE_SPAN, RESCUE_SCALE, RESCUE_NOISE = 100.0, 2.0, 1e-5
SEED = 20261016
# the dense slice's optimum (log scale, log amp) as its fits find it
# (PERF.md): where --dense64 evaluates
OPTIMUM = [0.9016, 1.067]

# the card's peak rates (NVIDIA's H100 SXM data sheet, at 700 W): HBM
# bandwidth, and FP32 (outside the tensor cores), FP64 (tensor core) and
# TF32 (tensor core, dense) operations; a 3xTF32 product costs three
# TF32 passes, so its useful rate is the TF32 peak over 3
PEAK_BYTES = 3.35e12
PEAK_OPS = {'float32': 67e12, 'float64': 67e12, 'tf32': 495e12}


def fail(msg):
    print(f'FAIL: {msg}', flush=True)
    sys.exit(1)


def log(msg):
    print(msg, flush=True)


def median_ms(fn, reps=7, setup=None, batch=1):
    """Median device time of ``fn()`` in ms, CUDA events, after one
    warm-up.  Each run's result is dropped before the next; ``setup()``,
    if given, runs before each, outside the timed span.  With ``batch``,
    each run is that many calls back to back, and its time is their
    mean: the wrapper's host time then overlaps the card's work, as on
    the main path, instead of adding to a sub-millisecond kernel's."""
    import torch
    if setup:
        setup()
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if setup:
            setup()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / batch)
    return statistics.median(times)


# kernels C and E and their backward take a few tenths of a millisecond:
# timed over this many calls back to back (median_ms, device_ms), as
# their plain versions are
GRAM_BATCH = 20


def device_ms(fn, calls=GRAM_BATCH):
    """Device time of one ``fn()`` in ms: the sum of the durations of all
    the kernels it launches (torch.profiler, CUPTI), over ``calls`` calls
    after one warm-up, divided by ``calls``.  Unlike CUDA events around
    the calls it leaves out the time the card waits for the host, which
    a wrapper of a few small torch operations around a sub-millisecond
    kernel can take up."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for e in prof.key_averages():
        if 'CUDA' in str(getattr(e, 'device_type', '')):
            total += getattr(e, 'self_device_time_total',
                             getattr(e, 'self_cuda_time_total', 0))
    if total <= 0:
        fail('the profiler saw no device time')
    return total / 1e3 / calls


def gram_times(fn, plain):
    """(ms, plain_ms, wrapper_ms) of kernel C's or E's wrapper ``fn`` and
    its plain version: device time per call (`device_ms`), and the
    wrapper's mean over GRAM_BATCH calls back to back on CUDA events."""
    return device_ms(fn), device_ms(plain), median_ms(fn, batch=GRAM_BATCH)


def unit_roundoff(dtype):
    import torch
    return torch.finfo(dtype).eps / 2


def bound(nbytes, ops, dtype, passes=0):
    """(ms, 'bytes' | 'operations'): the least time the card could take
    to move ``nbytes`` and do ``ops`` operations of ``dtype``, or, with
    ``passes``, ``ops`` useful operations as that many TF32 passes."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    if passes:
        t_ops = passes * ops / PEAK_OPS['tf32'] * 1e3
    else:
        t_ops = ops / PEAK_OPS[str(dtype).split('.')[-1]] * 1e3
    return (t_bytes, 'bytes') if t_bytes >= t_ops else (t_ops, 'operations')


def record(err, ms, plain_ms, bound_ms_by, library_ms=None, **extra):
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms_by[0], bound_by=bound_ms_by[1],
                share_of_bound=bound_ms_by[0] / ms, library_ms=library_ms,
                **extra)


# kernels A and D: the float32 variants, each a record of its own, with
# the CUDA kernel and the launch counter each runs, and the float64 one
PRECISIONS = [('high', 'schur_tc.cu', 3, 'launches_tc'),
              ('default', 'schur_tc.cu', 1, 'launches_tc1'),
              ('highest', 'syrk.cu', 0, 'launches')]
FLOAT64 = [('float64', 'dmma.cu', 0, 'launches_dmma')]


def tc_extra(passes):
    """The per-product rounding of the TF32 passes beyond fp32's, in
    units of (|A||A|ᵀ)ᵢⱼ: 3xTF32 drops lo·lo and rounds lo, each below
    2⁻²² |a b|; 1xTF32 rounds both factors to 2⁻¹¹."""
    return {3: 4 * 2.0 ** -22, 1: 2 * 2.0 ** -11, 0: 0.0}[passes]


def lower_fraction(size, tile):
    """Share of a (size, size) square in its i >= j tiles of edge tile."""
    nt = size // tile
    return nt * (nt + 1) / 2 / nt ** 2


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
    # ptxas reports each kernel's spills, then its registers, after the
    # line that names it (mangled)
    for line in info['log'].splitlines():
        if 'Compiling entry function' in line:
            log(f'  ptxas: {line.split(chr(39))[1][:100]}')
        elif 'registers' in line or 'spill' in line:
            log(f'    {line.strip()}')


# -- kernel phase -------------------------------------------------------------

def kernel_schur(dtype, gen):
    """Kernel A at the largest trailing update of the n = 16384
    factorization (w = h = 8192), with B read at a nonzero offset,
    scaling s, eps, and a ragged nreal; in float32 at each precision, a
    record each, and in float64."""
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
    ref = _syrk.schur_update_plain(B, A, **args)
    plain_ms = median_ms(lambda: _syrk.schur_update_plain(B, A, **args))
    # the library call: one addmm on the full square of the scaled view
    Bs = (B[offset:, offset:] * s[offset:, None] * s[None, offset:]
          ).contiguous()
    library_ms = median_ms(lambda: torch.addmm(Bs, A, A.T, alpha=-1))
    torch.backends.cuda.matmul.allow_tf32 = True
    library_tf32_ms = median_ms(lambda: torch.addmm(Bs, A, A.T, alpha=-1))
    torch.backends.cuda.matmul.allow_tf32 = False
    del Bs
    # tolerance: the two sum h products in another order, so each entry
    # may differ by the probabilistic rounding bound of a length-h dot
    # product, 4 sqrt(h) u sum_k |A_ik A_jk|, plus one rounding of the
    # scaled B entry and of eps; the TF32 passes add their per-product
    # rounding (tc_extra) times the same sum
    u = unit_roundoff(dtype)
    Aa = A.abs()
    S = Aa @ Aa.T
    del Aa
    Bv = B[offset:, offset:] * s[offset:, None] * s[None, offset:]
    init_tol = 4 * u * (Bv.abs() + 0.5)
    del Bv
    mask = _syrk._tile_mask(size, tile, A.device)
    # useful work: the lower 512-tiles, 2h flops per entry; A read once,
    # the view of B and the output's lower tiles once each
    f = lower_fraction(size, tile)
    isz = A.element_size()
    nbytes = isz * (size * h + 2 * f * size * size)
    flops = 2 * f * size ** 2 * h
    variants = PRECISIONS if dtype == torch.float32 else FLOAT64
    records = []
    for precision, source, passes, counter in variants:
        prec = None if precision == 'float64' else precision
        got = _syrk.schur_update(B, A, precision=prec, **args)
        tol = (4 * math.sqrt(h) * u + tc_extra(passes)) * S + init_tol
        err = check_close(f'A schur_update {dtype} {precision}', got[mask],
                          ref[mask], tol[mask])
        # the sums' rounding bias: on the diagonal all the products are
        # positive, so a rounding toward zero shows as a mean offset
        bias = float(((got - ref).diagonal() / S.diagonal()).mean())
        log(f'    mean (got - plain) / (|A||A|ᵀ) on the diagonal: '
            f'{bias:.3e}')
        del got, tol
        ms = median_ms(lambda: _syrk.schur_update(B, A, precision=prec,
                                                  **args))
        bd = bound(nbytes, flops, dtype, passes)
        lib = library_tf32_ms if passes == 1 else library_ms
        libname = 'torch.addmm, full square, cuBLAS ' + (
            'TF32' if passes == 1 else 'IEEE ' + str(dtype).split('.')[-1])
        log(f'  A {dtype} {precision}: kernel {ms:.3f} ms '
            f'({flops / ms / 1e9:.1f} TFLOP/s useful), plain '
            f'{plain_ms:.3f} ms, {libname} {lib:.3f} ms, bound '
            f'{bd[0]:.3f} ms ({bd[1]})')
        records.append(record(err, ms, plain_ms, bd, lib,
                              precision=precision, dtype=str(dtype),
                              source='lsqfitgp_torch/csrc/' + source,
                              counter=counter, library=libname))
    return records


def kernel_syrk(dtype, gen):
    """Kernel B at the gradient's shape: W = L⁻¹ of n x n.  In float64,
    the main path's dtype (its gradient carrier is float64), out of place
    and in place (`syrk_t_full_`, the path's call: the result must be
    exactly symmetric and live in W's own buffer), both on the DMMA
    kernel; in float32 out of place on the SIMT kernel.  A record each."""
    import torch
    from lsqfitgp_torch import ops
    from lsqfitgp_torch.ops import _syrk
    W = torch.randn(N, N, device='cuda', dtype=dtype, generator=gen).tril_()
    ref = _syrk.syrk_t_full_plain(W)
    # tolerance: as for A, 4 sqrt(n) u (|W|ᵀ|W|)_ij for sums of up to n
    # products taken in another order
    Wa = W.abs()
    tol = 4 * math.sqrt(N) * unit_roundoff(dtype) * _syrk.syrk_t_full_plain(Wa)
    del Wa
    plain_ms = median_ms(lambda: _syrk.syrk_t_full_plain(W))
    library_ms = median_ms(lambda: W.mT @ W)
    # n³/3 flops (the lower output tiles over the nonzero rows of W); W's
    # lower triangle read once, the full square written once
    isz = W.element_size()
    bd = bound(isz * (N * N / 2 + N * N), N ** 3 / 3, dtype)
    f64 = dtype == torch.float64
    variants = [('syrk_t_full', False)] + ([('syrk_t_full_', True)]
                                           if f64 else [])
    records = []
    for name, inplace in variants:
        what = f'B {name} {dtype}'
        Wc = W.clone()
        got = (ops.syrk_t_full_ if inplace else ops.syrk_t_full)(Wc)
        if inplace and got.data_ptr() != Wc.data_ptr():
            fail(f'{what}: the result is not in W\'s buffer')
        if not torch.equal(got, got.T):
            fail(f'{what}: result not exactly symmetric')
        err = check_close(what, got, ref, tol)
        del got
        if inplace:
            # each run overwrites W: a fresh copy before each, untimed
            ms = median_ms(lambda: ops.syrk_t_full_(Wc),
                           setup=lambda: Wc.copy_(W))
        else:
            ms = median_ms(lambda: ops.syrk_t_full(W))
        del Wc
        log(f'  {what}: kernel {ms:.3f} ms ({N ** 3 / 3 / ms / 1e9:.1f} '
            f'TFLOP/s useful), plain {plain_ms:.3f} ms, W.mT @ W '
            f'{library_ms:.3f} ms, bound {bd[0]:.3f} ms ({bd[1]})')
        label = str(dtype).split('.')[-1]
        records.append(record(
            err, ms, plain_ms, bd, library_ms, name=f'{name}/{label}',
            precision=label, dtype=str(dtype),
            source='lsqfitgp_torch/csrc/' + ('dmma.cu' if f64 else 'syrk.cu'),
            counter='launches_dmma' if f64 else 'launches',
            library='W.mT @ W, full square, cuBLAS IEEE ' + label))
    return records


def bwd_bounds(G, x, amp, u):
    """The smoke's tolerances of the Gram backward's sums at p = 1 (x
    both arguments, the amp chain): sums of n terms (the x gradient, the
    nugget) in another order, 8 sqrt(n) u sum|terms|; the amp gradient
    sums n² terms, whose error grows with the depth of the reduction:
    ceil(log2(n²)) 4 u sum|terms| (~1e-2 of the value here, so a zero or
    wrong core fails in float32 too).  Returns (x, amp, nugget)."""
    import torch
    n = G.shape[0]
    with torch.no_grad():
        D = x[:, None] - x[None, :]
        g = torch.exp(-0.5 * D * D)
        M = G.abs() * (0.5 * amp * g) * D.abs()
        tx = 2 * (M.sum(1) + M.sum(0))
        ta = (G.abs() * g).sum()
        del D, g, M
    return (8 * math.sqrt(n) * u * tx,
            math.ceil(math.log2(n * n)) * 4 * u * ta,
            8 * math.sqrt(n) * u * G.diagonal().abs().sum())


def check_bwd(what, fused, plain, G, x, amp, u):
    """The fused backward of kernel C or E (``fused()``, returning the x
    gradient and the parameter vector's) against its plain version on
    the card, and against itself: two calls must agree to the bit."""
    import torch
    got, again = fused(), fused()
    for a, b in zip(got, again):
        if not torch.equal(a, b):
            fail(f'{what}: two calls differ')
    ref = plain()
    tx, ta, tn = bwd_bounds(G, x, amp, u)
    err = check_close(f'{what} dx', got[0][:, 0], ref[0][:, 0], tx)
    err = max(err, check_close(f'{what} damp', got[1][0], ref[1][0], ta))
    if len(got[1]) > 1 and G.shape[0] == G.shape[1]:
        err = max(err, check_close(f'{what} dnoise', got[1][1], ref[1][1],
                                   tn))
    log(f'    {what}: two calls agree to the bit')
    return err


# the JVP rules of the TPU kernels C and E, which the fused backward
# kernels replace
BWD_REPLACES = {'gram': 'lsqfitgp_tpu/ops/_gram.py:278',
                'gram_sym': 'lsqfitgp_tpu/ops/_gram.py:320'}


def gram_records(name, dtype, fwd, bwd):
    """The records of kernel C or E (``name``) and of its fused backward
    in ``dtype``: named ``name`` and ``name_bwd``, with '/float64'
    appended in float64, each with the key of its launch count."""
    label = str(dtype).split('.')[-1]
    suffix = '' if label == 'float32' else '/' + label
    fwd.update(name=name + suffix, key=name, counter='launches',
               dtype=label)
    bwd.update(name=name + '_bwd' + suffix, key=name + '_bwd',
               counter='launches_bwd', dtype=label,
               replaces=BWD_REPLACES[name])
    return [fwd, bwd]


def kernel_gram(dtype, gen):
    """Kernel C: the slice's point block (n = m = 16384, p = 1, post
    chain amp, nugget), a p = 8 block, the prediction cross block
    (n x 64), and the backward: the fused kernel against the plain
    version on the card, at p = 1 and p = 8 (two launches), and against
    autograd of the plain version.  A record each for the forward and
    the fused backward."""
    import torch
    from lsqfitgp_torch.ops import (gram, gram_plain, gram_backward,
                                    gram_backward_plain)
    u = unit_roundoff(dtype)
    isz = torch.finfo(dtype).bits // 8
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
    ms, plain_ms, wrap = gram_times(
        lambda: gram('expquad', x, post=post, noise=noise),
        lambda: gram_plain('expquad', x, post=post, noise=noise))
    # the output written once; per entry a difference, a square, the
    # exp's argument, the exp and the amp: 5 operations
    bd = bound(isz * (N * N + 2 * N), 5 * N * N, dtype)
    log(f'  C {dtype}: kernel {ms:.3f} ms (the wrapper {wrap:.3f} ms), '
        f'plain {plain_ms:.3f} ms, bound {bd[0]:.3f} ms ({bd[1]})')

    X8 = torch.randn(N // 2, 8, **kw)
    K = gram('expquad', X8, post=post)
    Kp = gram_plain('expquad', X8, post=post)
    check_close(f'C gram p=8 {dtype}', K, Kp,
                16 * 9 * u * float(Kp.abs().max()))
    del K, Kp

    xs = (torch.rand(NPRED, **kw) - 0.5) * 120
    K = gram('expquad', x, xs, post=post, noise=noise)
    Kp = gram_plain('expquad', x, xs, post=post, noise=noise)
    check_close(f'C gram cross {N}x{NPRED} {dtype}', K, Kp,
                16 * u * float(Kp.abs().max()))
    del K, Kp

    # the fused backward: gradients of <G, K> with respect to x (both of
    # K's arguments: gx + gy), amp and the nugget
    G = torch.randn(N, N, **kw)
    args = ('expquad', x)
    akw = dict(post=post, noise=noise)

    def fused():
        gx, gy, gp = gram_backward(G, *args, **akw)
        return gx + gy, gp

    def plain():
        gx, gy, gp = gram_backward_plain(G, *args, **akw)
        return gx + gy, gp

    err_b = check_bwd(f'C gram backward {dtype}', fused, plain, G, x, amp,
                      u)
    ms_b, plain_b, wrap_b = gram_times(
        lambda: gram_backward(G, *args, **akw),
        lambda: gram_backward_plain(G, *args, **akw))
    # G read once, the points read and the gradients written once; per
    # entry about 12 operations (r², the exp, the weight, three sums)
    bd_b = bound(isz * (N * N + 3 * N), 12 * N * N, dtype)
    log(f'  C backward {dtype}: fused kernel {ms_b:.3f} ms (the wrapper '
        f'{wrap_b:.3f} ms), plain {plain_b:.3f} ms, bound {bd_b[0]:.3f} ms '
        f'({bd_b[1]})')

    # p = 8: two launches of 4 coordinates each.  Tolerance: the sums'
    # order as at p = 1, plus the p-term r² rounding of the forward's
    # tolerance, 16 (p + 1) u, on each term
    n8 = N // 2
    G8 = torch.randn(n8, n8, **kw)
    got = gram_backward(G8, 'expquad', X8, post=post)
    ref = gram_backward_plain(G8, 'expquad', X8, post=post)
    with torch.no_grad():
        # |C| + |C|ᵀ with C = G ∘ Wr: x is both of K's arguments
        Kb = gram_plain('expquad', X8)
        A = G8.abs() * (0.5 * amp) * Kb
        A = A + A.T
        tx = torch.stack([2 * (A * (X8[:, d, None] - X8[None, :, d]).abs())
                          .sum(1) for d in range(8)], 1)
        ta = (G8.abs() * Kb).sum()
        del A, Kb
    rel = 16 * 9 * u
    check_close(f'C gram backward p=8 dx {dtype}', got[0] + got[1],
                ref[0] + ref[1], (8 * math.sqrt(n8) * u + rel) * tx)
    check_close(f'C gram backward p=8 damp {dtype}', got[2][0], ref[2][0],
                (math.ceil(math.log2(n8 * n8)) * 4 * u + rel) * ta)
    del G8, X8, got, ref, tx

    # autograd through gram against autograd through the plain version
    leaves = [x.clone().requires_grad_(), amp.clone().requires_grad_(),
              noise.clone().requires_grad_()]

    def grads(fn):
        xl, al, nl = [t.detach().clone().requires_grad_() for t in leaves]
        out = fn('expquad', xl, post=(('mul', al),), noise=nl)
        return torch.autograd.grad(out, (xl, al, nl), G)

    got = grads(gram)
    ref = grads(gram_plain)
    tx, ta, tn = bwd_bounds(G, x, amp, u)
    check_close(f'C gram autograd dx {dtype}', got[0], ref[0], tx)
    check_close(f'C gram autograd damp {dtype}', got[1], ref[1], ta)
    check_close(f'C gram autograd dnoise {dtype}', got[2], ref[2], tn)
    return gram_records('gram', dtype,
                        record(err, ms, plain_ms, bd, wrapper_ms=wrap),
                        record(err_b, ms_b, plain_b, bd_b, wrapper_ms=wrap_b))


def kernel_schur_gram(dtype, gen):
    """Kernel D at the top trailing update of the streaming factorization
    (size = h = offset = n/2, float32 at n = 65536 as on the streaming
    path, at each precision, a record each; float64 at n = 32768, the
    size whose plain version's temporaries fit the card): points on the
    path's scale, the smoke's post chain, eps, and a ragged nreal (the
    last 300 rows are pad)."""
    import torch
    from lsqfitgp_torch.ops import _syrk
    n = N_STREAM if dtype == torch.float32 else N_CHECK
    size = h = offset = n // 2
    tile = 512
    nreal = n - 300
    kw = dict(device='cuda', dtype=dtype, generator=gen)
    X = (torch.rand(n, 1, **kw) - 0.5) * (400 * n / N_STREAM)
    A = torch.randn(size, h, **kw) / math.sqrt(h)
    amp = torch.tensor(1.3, device='cuda', dtype=dtype)
    eps = torch.tensor(NOISE_VAR, device='cuda', dtype=dtype)
    args = dict(post=(('mul', amp),), eps=eps, nreal=nreal, size=size,
                offset=offset, tile=tile)
    ref = _syrk.schur_update_gram_plain('expquad', X, A, **args)
    reps = 3
    plain_ms = median_ms(
        lambda: _syrk.schur_update_gram_plain('expquad', X, A, **args), reps)
    # tolerance: the kernel sums the h products into an accumulator that
    # starts at the Gram entry, so each rounding is relative to a partial
    # sum bounded by |K_ij + eps| + (|A||A|ᵀ)_ij: 4 sqrt(h) u times that
    # (a probabilistic bound for sums taken in another order), plus
    # 16 u (amp + eps) for the Gram entry itself (exp differs by a few
    # ulps between the two implementations; r² is computed identically);
    # the TF32 passes add their per-product rounding (tc_extra) times
    # (|A||A|ᵀ)_ij
    u = unit_roundoff(dtype)
    Aa = A.abs()
    S = torch.mm(Aa, Aa.T)
    del Aa
    mask = _syrk._tile_mask(size, tile, A.device)
    # useful work: the lower 512-tiles, 2h flops per entry (the in-tile
    # Gram, ~5 operations per entry, is negligible beside it); A read
    # once, the lower tiles written once
    f = lower_fraction(size, tile)
    nbytes = A.element_size() * (size * h + f * size * size)
    flops = f * size * size * (2 * h + 5)
    variants = PRECISIONS if dtype == torch.float32 else FLOAT64
    records = []
    for precision, source, passes, counter in variants:
        prec = None if precision == 'float64' else precision
        got = _syrk.schur_update_gram('expquad', X, A, precision=prec,
                                      **args)
        got.masked_fill_(~mask, 0)
        tol = (S + (1.3 + NOISE_VAR)).mul_(4 * math.sqrt(h) * u) \
            .add_(S, alpha=tc_extra(passes)).add_(16 * u * (1.3 + NOISE_VAR))
        err = check_close(f'D schur_update_gram n={n} {dtype} {precision}',
                          got, ref, tol)
        del got, tol
        ms = median_ms(lambda: _syrk.schur_update_gram(
            'expquad', X, A, precision=prec, **args), reps)
        bd = bound(nbytes, flops, dtype, passes)
        log(f'  D {dtype} {precision}: kernel {ms:.3f} ms, plain '
            f'{plain_ms:.3f} ms, bound {bd[0]:.3f} ms ({bd[1]}), '
            f'{2 * f * size * size * h / ms / 1e9:.1f} TFLOP/s useful')
        records.append(record(err, ms, plain_ms, bd, precision=precision,
                              dtype=str(dtype),
                              source='lsqfitgp_torch/csrc/' + source,
                              counter=counter))
    return records


def kernel_gram_sym(dtype, gen):
    """Kernel E: the halfmatrix path's point block (n = 16384, p = 1, the
    amp post chain) and a p = 8 block, each against the plain version
    and, to the bit (and with a nugget), against kernel C; the fused
    backward against the plain version on the card and against autograd
    of the plain version.  A record each for the forward and the fused
    backward."""
    import torch
    from lsqfitgp_torch.ops import (gram, gram_sym, gram_sym_plain,
                                    gram_sym_backward,
                                    gram_sym_backward_plain)
    u = unit_roundoff(dtype)
    isz = torch.finfo(dtype).bits // 8
    kw = dict(device='cuda', dtype=dtype, generator=gen)
    x = (torch.rand(N, **kw) - 0.5) * 100
    amp = torch.tensor(1.3, device='cuda', dtype=dtype)
    noise = torch.tensor(NOISE_VAR, device='cuda', dtype=dtype)
    post = (('mul', amp),)
    # the halfmatrix path holds its NLL equal to the full path's: E must
    # write C's entries to the bit
    for nz in (noise, None):
        K = gram_sym('expquad', x, post=post, noise=nz)
        if not torch.equal(K, gram('expquad', x, post=post, noise=nz)):
            fail(f'E gram_sym {dtype}: differs from kernel C')
    if not torch.equal(K, K.T):
        fail(f'E gram_sym {dtype}: result not exactly symmetric')
    Kp = gram_sym_plain('expquad', x, post=post)
    # tolerance as for C
    err = check_close(f'E gram_sym p=1 {dtype}', K, Kp,
                      16 * u * float(Kp.abs().max()))
    log(f'    E gram_sym {dtype}: equal to kernel C to the bit')
    del K, Kp
    ms, plain_ms, wrap = gram_times(
        lambda: gram_sym('expquad', x, post=post),
        lambda: gram_sym_plain('expquad', x, post=post))
    # the full output written once (the mirror included), the operations
    # of the upper half only
    bd = bound(isz * (N * N + N), 5 * N * (N + 1) / 2, dtype)
    log(f'  E {dtype}: kernel {ms:.3f} ms (the wrapper {wrap:.3f} ms), '
        f'plain {plain_ms:.3f} ms, bound {bd[0]:.3f} ms ({bd[1]})')

    X8 = torch.randn(N, 8, **kw)
    K = gram_sym('expquad', X8, post=post)
    if not torch.equal(K, gram('expquad', X8, post=post)):
        fail(f'E gram_sym p=8 {dtype}: differs from kernel C')
    Kp = gram_sym_plain('expquad', X8, post=post)
    check_close(f'E gram_sym p=8 {dtype}', K, Kp,
                16 * 9 * u * float(Kp.abs().max()))
    del K, Kp, X8

    # the fused backward, with the tolerances of C's (x enters as both
    # arguments)
    G = torch.randn(N, N, **kw)
    akw = dict(post=post)
    err_b = check_bwd(
        f'E gram_sym backward {dtype}',
        lambda: gram_sym_backward(G, 'expquad', x, **akw),
        lambda: gram_sym_backward_plain(G, 'expquad', x, **akw), G, x, amp,
        u)
    ms_b, plain_b, wrap_b = gram_times(
        lambda: gram_sym_backward(G, 'expquad', x, **akw),
        lambda: gram_sym_backward_plain(G, 'expquad', x, **akw))
    # all of G read once; the operations of the upper half
    bd_b = bound(isz * (N * N + 2 * N), 12 * N * (N + 1) / 2, dtype)
    log(f'  E backward {dtype}: fused kernel {ms_b:.3f} ms (the wrapper '
        f'{wrap_b:.3f} ms), plain {plain_b:.3f} ms, bound {bd_b[0]:.3f} ms '
        f'({bd_b[1]})')

    leaves = [x, amp]

    def grads(fn):
        xl, al = [t.detach().clone().requires_grad_() for t in leaves]
        out = fn('expquad', xl, post=(('mul', al),))
        return torch.autograd.grad(out, (xl, al), G)

    got = grads(gram_sym)
    ref = grads(gram_sym_plain)
    tx, ta, _ = bwd_bounds(G, x, amp, u)
    check_close(f'E gram_sym autograd dx {dtype}', got[0], ref[0], tx)
    check_close(f'E gram_sym autograd damp {dtype}', got[1], ref[1], ta)
    return gram_records('gram_sym', dtype,
                        record(err, ms, plain_ms, bd, wrapper_ms=wrap),
                        record(err_b, ms_b, plain_b, bd_b, wrapper_ms=wrap_b))


# the TPU code the tangent kernels replace: C′ the forward direction of
# C's JVP rule, C″ (and E″) JAX's second differentiation of its
# derivative-weight Pallas calls under jacfwd(grad), E′ that of E's rule
TANGENT_REPLACES = {'gram_jvp': 'lsqfitgp_tpu/ops/_gram.py:278',
                    'gram_bwd_jvp': 'lsqfitgp_tpu/ops/_gram.py:244',
                    'gram_sym_jvp': 'lsqfitgp_tpu/ops/_gram.py:320',
                    'gram_sym_bwd_jvp': 'lsqfitgp_tpu/ops/_gram.py:244'}


def tangent_record(name, dtype, rec):
    """A record of a tangent kernel, named ``name`` ('/float64' appended
    in float64), with the key of its launch count."""
    label = str(dtype).split('.')[-1]
    suffix = '' if label == 'float32' else '/' + label
    rec.update(name=name + suffix, key=name, dtype=label,
               counter='launches_jvp' if name.endswith('_jvp') and
               'bwd' not in name else 'launches_bwd_jvp',
               replaces=TANGENT_REPLACES[name])
    return rec


def tangent_inputs(dtype, gen):
    """The slice's points (p = 1), their tangent, G, and the amp chain
    with its tangent, at n = N."""
    import torch
    kw = dict(device='cuda', dtype=dtype, generator=gen)
    x = (torch.rand(N, **kw) - 0.5) * 100
    dx = torch.randn(N, **kw)
    amp = torch.tensor(1.3, device='cuda', dtype=dtype)
    noise = torch.tensor(NOISE_VAR, device='cuda', dtype=dtype)
    return x, dx, amp, noise


def tangent_path_args(x, dx, amp, damp, dnoise):
    """(X, dX, profile, coef): the points and their tangent as (n, 1)
    and the coefficients [α, dα, dβ, dnoise] of the amp chain, as the
    autograd Functions hand them to the tangent kernels."""
    import torch
    from lsqfitgp_torch.ops import _gram
    coef = torch.stack([amp, amp.new_tensor(damp), amp.new_zeros(()),
                        amp.new_tensor(dnoise)])
    return x[:, None], dx[:, None], _gram.PROFILES['expquad'], coef


def tangent_tol(x, dx, amp, damp, dnoise, u):
    """C′'s per-entry rounding: 16 (p + 1) u times the sum of its terms'
    magnitudes, |α g' dr²| + |dα| g + |dnoise| (p = 1)."""
    import torch
    with torch.no_grad():
        D = x[:, None] - x[None, :]
        g = torch.exp(-0.5 * D * D)
        terms = (0.5 * amp) * g * 2 * (D * (dx[:, None] - dx[None, :])).abs()
        terms += abs(damp) * g + abs(dnoise)
        del D, g
    return 32 * u * terms


def bwd_jvp_bounds(G, x, dx, amp, damp, u, sym):
    """The tolerances of C″'s and E″'s sums at p = 1 (x both arguments),
    as `bwd_bounds`: the x sums, n terms in another order, 8 sqrt(n) u
    sum|terms| with the terms' weights |G| (|dα| |g'| + α |g'' dr²|) on
    |Δ| and |G| α |g'| on |dΔ| (both of K's arguments: the weights and
    their transposes); the amp tangent's sum of n² terms, ceil(log2(n²))
    4 u sum|G g' dr²|.  Returns (x, amp)."""
    import torch
    n = G.shape[0]
    with torch.no_grad():
        D = x[:, None] - x[None, :]
        dD = dx[:, None] - dx[None, :]
        g = torch.exp(-0.5 * D * D)
        adr2 = 2 * (D * dD).abs()
        Ga = G.abs() + G.abs().T if sym else G.abs()
        A1 = Ga * g * (0.5 * abs(damp) + 0.25 * amp * adr2)
        A2 = Ga * g * (0.5 * amp)
        T = A1 * D.abs() + A2 * dD.abs()
        tx = 2 * (T.sum(1) + T.sum(0))
        del T, A1, A2
        ta = (G.abs() * g * adr2).sum()
        del D, dD, g
    return (8 * math.sqrt(n) * u * tx + 32 * u * tx,
            math.ceil(math.log2(n * n)) * 4 * u * ta)


def kernel_gram_tangent(dtype, gen):
    """Kernels C′ and C″ at the slice's point block (n = m = 16384,
    p = 1, the amp chain with the nugget): C′ (`gram_jvp`, along the
    points', amp's and the nugget's tangents) and C″ (`gram_backward_jvp`,
    at a fixed G) against their plain versions on the card, C″ also
    against itself to the bit.  A record each."""
    import torch
    from lsqfitgp_torch.ops import (gram_jvp, gram_jvp_plain,
                                    gram_backward_jvp,
                                    gram_backward_jvp_plain, _gram)
    u = unit_roundoff(dtype)
    isz = torch.finfo(dtype).bits // 8
    x, dx, amp, noise = tangent_inputs(dtype, gen)
    damp, dnoise = 0.3, 0.5
    kw = dict(post=(('mul', amp),), noise=noise, dpost=(damp,),
              dnoise=dnoise)
    got = gram_jvp('expquad', x, None, dx, **kw)
    ref = gram_jvp_plain('expquad', x, None, dx, **kw)
    err = check_close(f'C\' gram_jvp {dtype}', got, ref,
                      tangent_tol(x, dx, float(amp), damp, dnoise, u))
    del got, ref
    # timed as the autograd path calls it (`_Gram.jvp`, the double
    # backward's G-cotangent): the folded chain's coefficients formed
    # once; the public wrapper, which folds them per call, on the host
    # clock beside it
    X, dX, prof, coef = tangent_path_args(x, dx, amp, damp, dnoise)
    ms = device_ms(lambda: _gram._tangent(prof, X, X, dX, dX, coef, True))
    plain_ms = device_ms(
        lambda: _gram._tangent_plain(prof, X, X, dX, dX, coef, True))
    wrap = median_ms(lambda: gram_jvp('expquad', x, None, dx, **kw),
                     batch=GRAM_BATCH)
    # the output written once; the points and their tangents read once
    bd = bound(isz * (N * N + 2 * N), 10 * N * N, dtype)
    log(f'  C\' {dtype}: kernel {ms:.3f} ms (the wrapper {wrap:.3f} ms), '
        f'plain {plain_ms:.3f} ms, bound {bd[0]:.3f} ms ({bd[1]})')

    G = torch.randn(N, N, device='cuda', dtype=dtype, generator=gen)
    bkw = dict(post=(('mul', amp),), noise=noise, dpost=(damp,))

    def fused():
        gx, gy, gp = gram_backward_jvp(G, 'expquad', x, None, dx, **bkw)
        return gx + gy, gp

    got, again = fused(), fused()
    for a, b in zip(got, again):
        if not torch.equal(a, b):
            fail(f'C\'\' gram_backward_jvp {dtype}: two calls differ')
    gx, gy, gp = gram_backward_jvp_plain(G, 'expquad', x, None, dx, **bkw)
    tx, ta = bwd_jvp_bounds(G, x, dx, float(amp), damp, u, False)
    err_b = check_close(f'C\'\' gram_backward_jvp dx {dtype}', got[0][:, 0],
                        (gx + gy)[:, 0], tx)
    err_b = max(err_b, check_close(f'C\'\' gram_backward_jvp damp {dtype}',
                                   got[1][0], gp[0], ta))
    log(f'    C\'\' gram_backward_jvp {dtype}: two calls agree to the bit')
    del got, again, gx, gy, gp
    # as `_GramBackward.backward` calls it: the points' half and the
    # chain's sums (the public wrapper adds the chain's tangent by
    # torch.func.jvp, a few dozen small kernels)
    ms_b = device_ms(lambda: _gram._bwd_tangent(G, prof, X, X, dX, dX,
                                                coef[:2], True, True))
    plain_b = device_ms(lambda: _gram._bwd_tangent_plain(
        G, prof, X, X, dX, dX, coef[:2], True, True))
    wrap_b = median_ms(
        lambda: gram_backward_jvp(G, 'expquad', x, None, dx, **bkw),
        batch=GRAM_BATCH)
    # G read once; the points, their tangents and the sums' slots
    bd_b = bound(isz * (N * N + 4 * N), 20 * N * N, dtype)
    log(f'  C\'\' {dtype}: kernel {ms_b:.3f} ms (the wrapper {wrap_b:.3f} '
        f'ms), plain {plain_b:.3f} ms, bound {bd_b[0]:.3f} ms ({bd_b[1]})')
    return [tangent_record('gram_jvp', dtype,
                           record(err, ms, plain_ms, bd, wrapper_ms=wrap)),
            tangent_record('gram_bwd_jvp', dtype,
                           record(err_b, ms_b, plain_b, bd_b,
                                  wrapper_ms=wrap_b))]


def kernel_gram_sym_tangent(dtype, gen):
    """Kernels E′ and E″ as C′ and C″ on E's upper tile pairs: E′'s
    entries equal C′'s to the bit; E″ against its plain version and
    against itself to the bit.  A record each."""
    import torch
    from lsqfitgp_torch.ops import (gram_jvp, gram_sym_jvp,
                                    gram_sym_jvp_plain,
                                    gram_sym_backward_jvp,
                                    gram_sym_backward_jvp_plain, _gram)
    u = unit_roundoff(dtype)
    isz = torch.finfo(dtype).bits // 8
    x, dx, amp, noise = tangent_inputs(dtype, gen)
    damp, dnoise = 0.3, 0.5
    kw = dict(post=(('mul', amp),), noise=noise, dpost=(damp,),
              dnoise=dnoise)
    got = gram_sym_jvp('expquad', x, dx, **kw)
    if not torch.equal(got, gram_jvp('expquad', x, None, dx, **kw)):
        fail(f'E\' gram_sym_jvp {dtype}: differs from kernel C\'')
    ref = gram_sym_jvp_plain('expquad', x, dx, **kw)
    err = check_close(f'E\' gram_sym_jvp {dtype}', got, ref,
                      tangent_tol(x, dx, float(amp), damp, dnoise, u))
    log(f'    E\' gram_sym_jvp {dtype}: equal to kernel C\' to the bit')
    del got, ref
    X, dX, prof, coef = tangent_path_args(x, dx, amp, damp, dnoise)
    ms = device_ms(lambda: _gram._sym_tangent(prof, X, dX, coef, True))
    plain_ms = device_ms(
        lambda: _gram._tangent_plain(prof, X, X, dX, dX, coef, True))
    wrap = median_ms(lambda: gram_sym_jvp('expquad', x, dx, **kw),
                     batch=GRAM_BATCH)
    bd = bound(isz * (N * N + 2 * N), 10 * N * (N + 1) / 2, dtype)
    log(f'  E\' {dtype}: kernel {ms:.3f} ms (the wrapper {wrap:.3f} ms), '
        f'plain {plain_ms:.3f} ms, bound {bd[0]:.3f} ms ({bd[1]})')

    G = torch.randn(N, N, device='cuda', dtype=dtype, generator=gen)
    bkw = dict(post=(('mul', amp),), noise=noise, dpost=(damp,))
    got = gram_sym_backward_jvp(G, 'expquad', x, dx, **bkw)
    again = gram_sym_backward_jvp(G, 'expquad', x, dx, **bkw)
    for a, b in zip(got, again):
        if not torch.equal(a, b):
            fail(f'E\'\' gram_sym_backward_jvp {dtype}: two calls differ')
    ref = gram_sym_backward_jvp_plain(G, 'expquad', x, dx, **bkw)
    tx, ta = bwd_jvp_bounds(G, x, dx, float(amp), damp, u, True)
    err_b = check_close(f'E\'\' gram_sym_backward_jvp dx {dtype}',
                        got[0][:, 0], ref[0][:, 0], tx)
    err_b = max(err_b, check_close(
        f'E\'\' gram_sym_backward_jvp damp {dtype}', got[1][0], ref[1][0],
        ta))
    log(f'    E\'\' gram_sym_backward_jvp {dtype}: two calls agree to the '
        f'bit')
    del got, again, ref
    ms_b = device_ms(lambda: _gram._sym_bwd_tangent(G, prof, X, dX,
                                                    coef[:2], True, True))
    plain_b = device_ms(lambda: _gram._sym_bwd_tangent_plain(
        G, prof, X, dX, coef[:2], True, True))
    wrap_b = median_ms(
        lambda: gram_sym_backward_jvp(G, 'expquad', x, dx, **bkw),
        batch=GRAM_BATCH)
    bd_b = bound(isz * (N * N + 3 * N), 20 * N * (N + 1) / 2, dtype)
    log(f'  E\'\' {dtype}: kernel {ms_b:.3f} ms (the wrapper {wrap_b:.3f} '
        f'ms), plain {plain_b:.3f} ms, bound {bd_b[0]:.3f} ms ({bd_b[1]})')
    return [tangent_record('gram_sym_jvp', dtype,
                           record(err, ms, plain_ms, bd, wrapper_ms=wrap)),
            tangent_record('gram_sym_bwd_jvp', dtype,
                           record(err_b, ms_b, plain_b, bd_b,
                                  wrapper_ms=wrap_b))]


def kernel_phase():
    import torch
    records = []
    gen = torch.Generator(device='cuda').manual_seed(SEED)
    f32, f64 = torch.float32, torch.float64
    # each kernel's variants, its path's dtype first: its numbers go into
    # the record
    specs = [
        ('schur_update', kernel_schur, 'lsqfitgp_torch/csrc/syrk.cu',
         'lsqfitgp_tpu/ops/_syrk.py:63', [f32, f64]),
        ('syrk_t_full', kernel_syrk, 'lsqfitgp_torch/csrc/dmma.cu',
         'lsqfitgp_tpu/ops/_syrk.py:250', [f64, f32]),
        ('gram', kernel_gram, 'lsqfitgp_torch/csrc/gram.cu',
         'lsqfitgp_tpu/ops/_gram.py:68', [f32, f64]),
        ('schur_update_gram', kernel_schur_gram,
         'lsqfitgp_torch/csrc/syrk.cu', 'lsqfitgp_tpu/ops/_syrk.py:334',
         [f32, f64]),
        ('gram_sym', kernel_gram_sym, 'lsqfitgp_torch/csrc/gram.cu',
         'lsqfitgp_tpu/ops/_gram.py:157', [f32, f64]),
        ('gram tangents', kernel_gram_tangent, 'lsqfitgp_torch/csrc/gram.cu',
         None, [f32, f64]),
        ('gram_sym tangents', kernel_gram_sym_tangent,
         'lsqfitgp_torch/csrc/gram.cu', None, [f32, f64]),
    ]
    for name, fn, source, replaces, variants in specs:
        log(f'kernel {name}:')
        for v in variants:
            torch.cuda.empty_cache()
            # a record for each precision and dtype (and B's in-place
            # form, C's and E's backward); A's, B's and D's are named by
            # their precision
            records += [{'name': f'{name}/{r.get("precision")}',
                         'route': 'cuda', 'source': source,
                         'replaces': replaces, **r} for r in fn(v, gen)]
        torch.cuda.empty_cache()
    return records


# -- slice phase ----------------------------------------------------------------

def plain_nll64(x, y, log_scale, log_amp, jitter=0.0):
    """Independent float64 reference of the objective's likelihood part
    and its gradient in (log scale, log amp), with ``jitter`` more on K's
    diagonal beside the noise: dense K, ``torch.linalg.cholesky`` and
    the textbook gradient
    ½ <K⁻¹ − α αᵀ, ∂K>, α = K⁻¹ y, with ∂K/∂log amp = amp E and
    ∂K/∂log scale = amp E ∘ Δ²/scale², E = exp(−Δ²/(2 scale²)); no port
    code.  Four float64 n × n buffers at the peak (autograd through the
    same computation keeps about eight, too many at n = 32768)."""
    import torch
    scale, amp = math.exp(log_scale), math.exp(log_amp)
    d2 = x[:, None] - x[None, :]
    d2.mul_(d2).div_(scale * scale)
    E = torch.exp(d2 * -0.5)
    K = E * amp
    K.diagonal().add_(NOISE_VAR + jitter)
    L = torch.linalg.cholesky(K)
    del K
    z = torch.linalg.solve_triangular(L, y[:, None], upper=False)
    nll = 0.5 * float(z.T @ z) + float(torch.log(L.diagonal()).sum()) \
        + 0.5 * len(x) * math.log(2 * math.pi)
    alpha = torch.cholesky_solve(y[:, None], L)[:, 0]
    G = torch.cholesky_inverse(L)
    del L
    G.addr_(alpha, alpha, alpha=-1).mul_(E).mul_(0.5 * amp)
    del E
    g_amp = G.sum()
    g_scale = (G * d2).sum()
    return nll, torch.stack([g_scale, g_amp])


def plain_mean64(x, y, xs, scale, amp):
    """Independent float64 reference of the posterior mean."""
    import torch
    k = lambda a, b: amp * torch.exp(-0.5 * ((a[:, None] - b[None, :])
                                             / scale) ** 2)
    K = k(x, x)
    K.diagonal().add_(NOISE_VAR)
    L = torch.linalg.cholesky(K)
    return k(x, xs).T @ torch.cholesky_solve(y[:, None], L)[:, 0]


KERNELS = ['schur_update', 'syrk_t_full', 'syrk_t_full_', 'gram',
           'schur_update_gram', 'gram_sym']

# each wrapper's launch counters and the suffix of their key in the
# counts: A and D count their SIMT kernel ('launches'), their TF32
# tensor-core kernel in 3xTF32 ('launches_tc') and 1xTF32
# ('launches_tc1') and their FP64 tensor-core kernel ('launches_dmma')
# apart; B its SIMT (float32) and DMMA (float64) kernels, and its
# in-place form, `syrk_t_full_`, its DMMA kernel; C and E their forward
# ('launches'), their fused backward ('launches_bwd'), their tangent
# kernels C′ and E′ ('launches_jvp') and the tangent of their backward,
# C″ and E″ ('launches_bwd_jvp') apart
COUNTERS = {'launches': '', 'launches_tc': '_tc', 'launches_tc1': '_tc1',
            'launches_dmma': '_dmma', 'launches_bwd': '_bwd',
            'launches_jvp': '_jvp', 'launches_bwd_jvp': '_bwd_jvp'}


def _counters():
    from lsqfitgp_torch import ops
    for name in KERNELS:
        fn = getattr(ops, name)
        for attr, suffix in COUNTERS.items():
            if hasattr(fn, attr):
                yield name + suffix, fn, attr


def reset_counts():
    for _, fn, attr in _counters():
        setattr(fn, attr, 0)


def read_counts():
    return {key: getattr(fn, attr) for key, fn, attr in _counters()}


def nonzero(counts):
    return {k: c for k, c in counts.items() if c}


def require_launched(counts, names, what):
    for name in names:
        if counts[name] == 0:
            fail(f'kernel {name} was not launched during {what}')


def require_counts(counts, expected, what):
    """Launch counts that must be exact: kernel C's and E's forward and
    fused backward, one of each per evaluation they serve, so that no
    other Gram evaluation (such as the derivative weights of an unfused
    backward) ran on the card."""
    for name, n in expected.items():
        if counts[name] != n:
            fail(f'{what}: {counts[name]} launches of {name}, expected {n}')


def check_points(n, value_grad32, cond_at, x64, y64, points):
    """The port's float32 NLL and its gradient against the float64
    reference (`plain_nll64`) at each (label, [log scale, log amp],
    near_optimum) point; ``value_grad32(lp, precision=None)`` is the
    port's NLL at the float32 tensor lp, ``cond_at(ls, la)`` the float32
    condition estimate there.  Away from the optimum the gradient's error
    at precision 'highest' is printed beside the default's ('high'); the
    limits hold the default."""
    import torch
    eps32 = torch.finfo(torch.float32).eps

    def grad64(lp):
        return plain_nll64(x64, y64, *lp)

    for label, lpv, near_optimum in points:
        lp = torch.tensor(lpv, dtype=torch.float32, device=x64.device,
                          requires_grad=True)
        nll32 = value_grad32(lp)
        g32, = torch.autograd.grad(nll32, lp)
        ls, la = lp.detach().tolist()
        cond0 = cond_at(ls, la)
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
        if dnll > 4 * eps32 * n * (math.exp(la) + NOISE_VAR) / NOISE_VAR:
            fail(f'{label}: NLL disagrees with the float64 reference')
        if not near_optimum:
            # gradient: forward error of float32 solves, ~cond eps32
            # relative, with a factor 10 of margin
            rel = float(dg.norm() / g64.norm())
            lph = lp.detach().clone().requires_grad_()
            nllh = value_grad32(lph, 'highest')
            gh, = torch.autograd.grad(nllh, lph)
            relh = float((gh.double() - g64).norm() / g64.norm())
            log(f'    relative diff {rel:.3e} (limit '
                f'{10 * cond0 * eps32:.3e}); at precision \'highest\' '
                f'{relh:.3e}, gradient {gh.tolist()}, NLL |diff| '
                f'{abs(float(nllh.detach()) - nll64):.3e}')
            if rel > 10 * cond0 * eps32:
                fail(f'{label}: gradient disagrees with the float64 '
                     f'reference')
            continue
        # near an optimum the likelihood's gradient only balances the
        # prior's and is small, so its relative error means little; what
        # a fit shows is where its optimum lands.  The gradient error
        # moves it by H⁻¹ dg, H the float64 posterior Hessian in the log
        # parameters (central differences of the float64 gradient plus
        # the N(0, 1) prior's identity): that must stay under a tenth of
        # the posterior standard deviation.
        h = 1e-3
        H = torch.stack([
            (grad64([ls + h * (k == 0), la + h * (k == 1)])[1]
             - grad64([ls - h * (k == 0), la - h * (k == 1)])[1]) / (2 * h)
            for k in range(2)], 1)
        Hinv = torch.linalg.inv(0.5 * (H + H.T)
                                + torch.eye(2, dtype=H.dtype,
                                            device=H.device))
        shift = (Hinv @ dg).abs() / Hinv.diagonal().sqrt()
        log(f'    optimum shift from the gradient error: {shift.tolist()} '
            f'posterior sdev (limit 0.1); float64 posterior sdev '
            f'{Hinv.diagonal().sqrt().tolist()}')
        if not bool((shift <= 0.1).all()):
            fail(f'{label}: the gradient error moves the optimum too far')


def slice_phase(dev='cuda'):
    import numpy as np
    import torch
    import lsqfitgp_torch as lgp

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

    def gpfactory(hp, precision=None):
        kw = {} if precision is None else dict(precision=precision)
        gp = lgp.GP(hp['amp'] * lgp.ExpQuad(scale=hp['scale']),
                    gram='tiled', **kw)
        gp = gp.addx(xt, 'f').addcov(noise, 'e')
        return gp.addlintransf(lambda f, e: f + e, ['f', 'e'], 'y')

    hyperprior = {'log(scale)': (0., 1.), 'log(amp)': (0., 1.)}

    log(f'dense slice: n = {N}, float32, amp * ExpQuad(scale) + '
        f'{NOISE_VAR} I, gram=tiled')
    sync()
    reset_counts()
    t0 = time.perf_counter()
    fit = lgp.empbayes_fit(hyperprior, gpfactory, {'y': yt},
                           minkw={'maxiter': 50}, raises=True)
    sync()
    wall = time.perf_counter() - t0
    fit_launches = read_counts()
    gp = fit.gp().addx(xst, 'pred')
    post = gp.predfromdata({'y': yt}, 'pred')
    mean = post.mean
    sync()
    launches = read_counts()
    log(f'  fit: {wall:.2f} s wall, {fit.minresult.nit} BFGS iterations, '
        f'{len(fit.evaltimes)} evaluations, median '
        f'{statistics.median(fit.evaltimes) * 1e3:.1f} ms per evaluation '
        f'(value + gradient)')
    log(f'  launches during the fit: {fit_launches}; fit + '
        f'predfromdata: {launches}')
    require_launched(fit_launches, ['schur_update_tc', 'syrk_t_full__dmma',
                                    'gram', 'gram_bwd'], 'the dense fit')
    evals = len(fit.evaltimes)
    require_counts(fit_launches, {'gram': evals, 'gram_bwd': evals,
                                  'gram_jvp': 0, 'gram_bwd_jvp': 0},
                   'the dense fit')
    scale = float(fit.pmean['scale'])
    amp = float(fit.pmean['amp'])
    log(f'  fitted scale {scale:.6g}, amp {amp:.6g}; pmean '
        f'{fit.pmean.buf.tolist()}, pcov {fit.pcov.tolist()}')
    fitted = [math.log(scale), math.log(amp)]

    # where one value+gradient's time goes at the fit, as the fit
    # evaluates it (checks off), and its peak memory
    def value_grad():
        lp = torch.tensor(fitted, device=dev, requires_grad=True)
        with lgp.disable_checks():
            nll = -gpfactory({'scale': lp[0].exp(), 'amp': lp[1].exp()}
                             ).marginal_likelihood({'y': yt})
        torch.autograd.grad(nll, lp)

    if dev == 'cuda':
        profile_phase(value_grad)
        dense_memory(N)

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

    def value_grad32(lp, precision=None):
        gp0 = gpfactory({'scale': lp[0].exp(), 'amp': lp[1].exp()},
                        precision)
        return -gp0.marginal_likelihood({'y': yt})

    def cond_at(ls, la):
        with torch.no_grad():
            gp0 = gpfactory({'scale': torch.tensor(math.exp(ls)),
                             'amp': torch.tensor(math.exp(la))})
            return float(lgp.linalg.Chol(gp0.prior('y', raw=True))
                         .cond_estimate)

    check_points(N, value_grad32, cond_at, x64, y64,
                 [('start point', [0., 0.], False),
                  ('fitted point', fitted, True),
                  ('ill-conditioned point', [1.05, 2.44], False)])

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
    return launches, fitted


def rescue_phase(dev='cuda'):
    """The float32 rescue: `Chol` and `chol_nll` of a float32 ExpQuad Gram
    with a small nugget at n = N_RESCUE, the largest size the rescue
    takes by default.  The 'high' rung fails on it, so the ladder runs
    kernel A at 'highest' (the SIMT kernel), and the rescue refactors in
    float64 (A on DMMA); checks both ran and the rescue fired, and holds
    the NLL, logdet, solve and the fused NLL's gradient in K and y
    against a float64 ``torch.linalg.cholesky`` of the same float32
    matrix plus the primary eps (with the same float32 data) at the JAX
    package's tolerances for its rescue (``tests/linalg/test_df.py``):
    NLL 1e-4 relative, logdet 1e-2, solve and gradient 1e-4 relative to
    their largest entry.  Returns the launch counts."""
    import warnings
    import numpy as np
    import torch
    from lsqfitgp_torch import linalg

    def sync():
        if dev == 'cuda':
            torch.cuda.synchronize()

    f32, f64 = torch.float32, torch.float64
    n = N_RESCUE
    rng = np.random.default_rng(SEED)
    x = torch.as_tensor(np.sort(rng.uniform(0, RESCUE_SPAN, n)), dtype=f64,
                        device=dev)
    d2 = (x[:, None] - x[None, :]) ** 2
    K64 = torch.exp(-0.5 * d2 / RESCUE_SCALE ** 2)
    K64.diagonal().add_(RESCUE_NOISE)
    z = torch.as_tensor(rng.standard_normal(n), dtype=f64, device=dev)
    K32 = K64.to(f32)
    y32 = (torch.linalg.cholesky(K64) @ z).to(f32)
    del K64, d2, x
    log(f'rescue: n = {n}, float32, ExpQuad(scale={RESCUE_SCALE}) on '
        f'[0, {RESCUE_SPAN}] + {RESCUE_NOISE} I')
    sync()
    reset_counts()
    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        dec = linalg.Chol(K32)
        nll = dec.minus_log_normal_density(y32)
        ld = dec.logdet()
        sol = dec.ginv_linear(y32)
        sync()
        counts_chol = read_counts()
        K = K32.clone().requires_grad_(True)
        y = y32.clone().requires_grad_(True)
        v = linalg.chol_nll(K, y)
        gK, gy = torch.autograd.grad(v, (K, y))
        sync()
    secs = time.perf_counter() - t0
    counts = read_counts()
    del K, y
    simt = counts_chol['schur_update']
    rung = 3 if dec._escalated else 2 if simt else 1
    log(f'  Chol: the ladder ended on rung {rung} (1 high, 2 highest, 3 '
        f'highest with eps2 and the lift), cond_estimate '
        f'{float(dec.cond_estimate):.4g}; rescue fired: '
        f'{dec._df_rescued}, failed: {dec._df_failed}, eps '
        f'{float(dec.eps):.4g}')
    log(f'  launches of Chol: {nonzero(counts_chol)}; with chol_nll and its '
        f'gradient: {nonzero(counts)}; {secs:.2f} s')
    for w in {str(w.message) for w in caught}:
        log(f'  warning: {w}')
    if not dec._df_rescued:
        fail('the float32 rescue did not fire, or found the matrix '
             'indefinite in float64')
    require_launched(counts_chol, ['schur_update', 'schur_update_dmma'],
                     'the rescue phase\'s Chol')
    require_launched(counts, ['syrk_t_full__dmma'], 'the rescue phase')
    if nll.dtype != f32 or sol.dtype != f32 or gK.dtype != f32:
        fail('the rescue returns another dtype than its input\'s')

    # the float64 truth of the matrix the rescue factors
    s = dec._s.to(f64)
    Kreg = K32.to(f64)
    Kreg.diagonal().add_(float(dec.eps) / s ** 2)
    L = torch.linalg.cholesky(Kreg)
    del Kreg
    y64 = y32.to(f64)
    zt = torch.linalg.solve_triangular(L, y64[:, None], upper=False)[:, 0]
    nll64 = 0.5 * float(zt @ zt) + float(torch.log(L.diagonal()).sum()) \
        + 0.5 * n * math.log(2 * math.pi)
    ld64 = 2 * float(torch.log(L.diagonal()).sum())
    alpha = torch.cholesky_solve(y64[:, None], L)[:, 0]
    Kbar = torch.cholesky_inverse(L)
    del L
    Kbar.addr_(alpha, alpha, alpha=-1).mul_(0.5)

    def rel(got, ref):
        return float((got.to(f64) - ref).abs().max() / ref.abs().max())

    errs = {'nll': abs(float(nll) - nll64) / abs(nll64),
            'logdet': abs(float(ld) - ld64) / max(1.0, abs(ld64)),
            'solve': rel(sol, alpha),
            'chol_nll': abs(float(v.detach()) - nll64) / abs(nll64),
            'grad K': rel(gK, Kbar), 'grad y': rel(gy, alpha)}
    tols = {'nll': 1e-4, 'logdet': 1e-2, 'solve': 1e-4, 'chol_nll': 1e-4,
            'grad K': 1e-4, 'grad y': 1e-4}
    log('  against float64: ' + ', '.join(
        f'{k} {e:.3e} (tolerance {tols[k]:g})' for k, e in errs.items()))
    bad = [k for k in errs if not errs[k] < tols[k]]
    if bad:
        fail(f'the rescue disagrees with float64 in {bad}')
    return counts


def dense64_phase(point, dev='cuda', evals=5):
    """The dense slice's model in float64, the lane of the JAX package's
    users under x64: ``evals`` value+gradients at n = N at ``point`` (log
    scale, log amp), each timed on the host clock up to the read of its
    result, as the fit times its evaluations (checks off); checks that
    kernels A, B and C ran, and holds the NLL and gradient against
    `plain_nll64`.  Returns the launch counts."""
    import numpy as np
    import torch
    import lsqfitgp_torch as lgp
    f64 = torch.float64
    torch.set_default_dtype(f64)
    rng = np.random.default_rng(20261016)
    x = rng.uniform(-50, 50, N)
    y = np.sin(x) + math.sqrt(NOISE_VAR) * rng.standard_normal(N)
    xt = torch.as_tensor(x, dtype=f64, device=dev)
    yt = torch.as_tensor(y, dtype=f64, device=dev)
    noise = NOISE_VAR * torch.eye(N, dtype=f64, device=dev)
    ls, la = point
    log(f'dense float64: n = {N}, the dense slice\'s model at log scale '
        f'{ls:.6g}, log amp {la:.6g}, {evals} value+gradients')
    reset_counts()
    times = []
    for _ in range(evals):
        if dev == 'cuda':
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        lp = torch.tensor(point, dtype=f64, device=dev, requires_grad=True)
        with lgp.disable_checks():
            gp = lgp.GP(lp[1].exp() * lgp.ExpQuad(scale=lp[0].exp()),
                        gram='tiled')
            gp = gp.addx(xt, 'f').addcov(noise, 'e')
            gp = gp.addlintransf(lambda f, e: f + e, ['f', 'e'], 'y')
            nll = -gp.marginal_likelihood({'y': yt})
            del gp
        g, = torch.autograd.grad(nll, lp)
        nll = float(nll.detach())
        g = g.tolist()
        times.append(time.perf_counter() - t0)
    counts = read_counts()
    log(f'  {statistics.median(times) * 1e3:.1f} ms median per value + '
        f'gradient (each: {[round(t * 1e3, 1) for t in times]} ms); '
        f'launches {counts}')
    require_launched(counts, ['schur_update_dmma', 'syrk_t_full__dmma',
                              'gram', 'gram_bwd'],
                     'the float64 dense evaluation')
    require_counts(counts, {'gram': evals, 'gram_bwd': evals},
                   'the float64 dense evaluation')
    del noise
    # the port's float64 factorization adds eps = n eps64 times the
    # Gershgorin bound of the scaled matrix on its diagonal: in K's
    # units δ = n eps64 max_i Σ_j |K_ij|, since K's diagonal is constant
    # and its power-of-2 scaling cancels.  The reference adds the same δ,
    # so the two differ by float64 rounding alone: 10 cond eps64 of the
    # NLL's terms (|NLL| + n), and of the gradient's two terms, each at
    # most about n/2 here (½ tr(K⁻¹ ∂K) <= n/2 for log amp), so
    # 10 cond eps64 n absolute
    eps64 = torch.finfo(f64).eps
    with torch.no_grad():
        d = (xt[:, None] - xt[None, :]) / math.exp(ls)
        K = math.exp(la) * torch.exp(-0.5 * d * d)
        del d
        K.diagonal().add_(NOISE_VAR)
        rowsum = float(K.sum(1).max())
        cond = float(lgp.linalg.Chol(K).cond_estimate)
        del K
    delta = N * eps64 * rowsum
    nll64, g64 = plain_nll64(xt, yt, ls, la, jitter=delta)
    g = torch.tensor(g, dtype=f64, device=dev)
    dnll = abs(nll - nll64)
    dg = float((g - g64).abs().max())
    tol_nll = 10 * cond * eps64 * (abs(nll64) + N)
    tol_g = 10 * cond * eps64 * N
    log(f'  cond_estimate {cond:.4g}, δ {delta:.4g}; NLL port {nll:.12g}, '
        f'plain float64 {nll64:.12g}, |diff| {dnll:.3e} (limit '
        f'{tol_nll:.3e}); gradient port {g.tolist()}, plain '
        f'{g64.tolist()}, max |diff| {dg:.3e} (limit {tol_g:.3e})')
    if dnll > tol_nll:
        fail('float64 dense NLL disagrees with the float64 reference')
    if dg > tol_g:
        fail('float64 dense gradient disagrees with the float64 reference')
    torch.set_default_dtype(torch.float32)
    return counts


def dense_memory(n):
    """Peak device memory of one dense float32 value+gradient of the dense
    slice's model at n points (the dense slice's point density, log scale
    0, log amp 0), evaluated as the fit evaluates it (checks off): the
    forward's and the backward's peaks above what is allocated before
    (the inputs: the points, the data and the caller's n × n noise
    matrix).  Prints them in bytes per n² and returns the value+gradient's
    peak above the inputs, in bytes."""
    import numpy as np
    import torch
    import lsqfitgp_torch as lgp
    f32 = torch.float32
    rng = np.random.default_rng(SEED)
    half = 50 * n / N
    xn = rng.uniform(-half, half, n)
    x = torch.as_tensor(xn, dtype=f32, device='cuda')
    y = torch.as_tensor(np.sin(xn) + math.sqrt(NOISE_VAR)
                        * rng.standard_normal(n), dtype=f32, device='cuda')
    noise = NOISE_VAR * torch.eye(n, dtype=f32, device='cuda')
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    lp = torch.zeros(2, dtype=f32, device='cuda', requires_grad=True)
    with lgp.disable_checks():
        gp = lgp.GP(lp[1].exp() * lgp.ExpQuad(scale=lp[0].exp()),
                    gram='tiled')
        gp = gp.addx(x, 'f').addcov(noise, 'e')
        gp = gp.addlintransf(lambda f, e: f + e, ['f', 'e'], 'y')
        nll = -gp.marginal_likelihood({'y': y})
        del gp
    torch.cuda.synchronize()
    fwd = torch.cuda.max_memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    # the backward's peak before the Gram's backward (chol_nll's stage)
    # and from it on, apart
    from lsqfitgp_torch.ops import _gram
    inner = _gram._Gram.backward
    stages = []

    def traced(ctx, G):
        torch.cuda.synchronize()
        stages.append(torch.cuda.max_memory_allocated() - base)
        torch.cuda.reset_peak_memory_stats()
        return inner(ctx, G)

    _gram._Gram.backward = staticmethod(traced)
    try:
        torch.autograd.grad(nll, lp)
    finally:
        _gram._Gram.backward = staticmethod(inner)
    torch.cuda.synchronize()
    stages.append(torch.cuda.max_memory_allocated() - base)
    bwd = max(stages)
    wall = time.perf_counter() - t0
    n2 = n * n
    peak = max(fwd, bwd)
    log(f'  dense value+gradient at n = {n}: {wall:.3f} s; peak memory '
        f'above its inputs: forward {fwd / n2:.2f} B/n², backward '
        f'{bwd / n2:.2f} B/n² ({peak / 2**30:.2f} GiB; before the Gram\'s '
        f'backward {stages[0] / n2:.2f}, from it on '
        f'{stages[-1] / n2:.2f}); the inputs hold '
        f'{base / n2:.2f} B/n² (the noise matrix 4), so the peak in all is '
        f'{(peak + base) / n2:.2f} B/n² ({(peak + base) / 2**30:.2f} GiB) '
        f'of {torch.cuda.get_device_properties(0).total_memory / 2**30:.2f} '
        f'GiB')
    return peak


def compare_fits():
    """The dense fit (n = 16384 from the prior mean, as in the dense
    slice) at precision 'high', 'highest', 'highest', 'high', then the
    streaming fit (n = 65536, 3 BFGS iterations from the last dense
    fit's MAP, as in the streaming slice) at 'high' and 'highest', in
    one process on one card: BFGS iterations, evaluations, wall time,
    BFGS's message and the end point of each."""
    import numpy as np
    import torch
    import lsqfitgp_torch as lgp
    f32 = torch.float32
    torch.set_default_dtype(f32)
    rng = np.random.default_rng(20261016)
    x = rng.uniform(-50, 50, N)
    y = np.sin(x) + math.sqrt(NOISE_VAR) * rng.standard_normal(N)
    xt = torch.as_tensor(x, dtype=f32, device='cuda')
    yt = torch.as_tensor(y, dtype=f32, device='cuda')
    noise = NOISE_VAR * torch.eye(N, dtype=f32, device='cuda')
    hyperprior = {'log(scale)': (0., 1.), 'log(amp)': (0., 1.)}

    def report(what, fit, wall):
        ev = fit.evaltimes
        end = [math.log(float(fit.pmean['scale'])),
               math.log(float(fit.pmean['amp']))]
        log(f'{what}: {wall:.2f} s wall, {fit.minresult.nit} iterations, '
            f'{len(ev)} evaluations, median {statistics.median(ev):.4f} s, '
            f'{fit.minresult.message!r}, end point {end}')
        return end

    for prec in ('high', 'highest', 'highest', 'high'):
        def gpfactory(hp, prec=prec):
            gp = lgp.GP(hp['amp'] * lgp.ExpQuad(scale=hp['scale']),
                        gram='tiled', precision=prec)
            gp = gp.addx(xt, 'f').addcov(noise, 'e')
            return gp.addlintransf(lambda f, e: f + e, ['f', 'e'], 'y')
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fit = lgp.empbayes_fit(hyperprior, gpfactory, {'y': yt},
                               minkw={'maxiter': 50}, raises=False)
        torch.cuda.synchronize()
        start = report(f'dense n = {N} at {prec!r}', fit,
                       time.perf_counter() - t0)
    del noise, fit
    torch.cuda.empty_cache()
    xs, ys, _ = stream_data(N_STREAM)
    for prec in ('high', 'highest'):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fit = lgp.empbayes_fit(
            hyperprior, lambda hp: stream_gp(hp, prec).addx(xs, 'f'),
            {'f': ys}, initial=start, minkw={'maxiter': 3}, raises=False)
        torch.cuda.synchronize()
        report(f'streaming n = {N_STREAM} at {prec!r}', fit,
               time.perf_counter() - t0)


def compare_highest(evals=5):
    """Precision 'highest' per evaluation, to compare two checkouts in one
    call (this script runs from the root of either, as ``--dense64``
    does): the dense fit of the dense slice at 'high' and at 'highest'
    (where kernel A runs its SIMT kernel), then ``evals`` streaming
    value+gradients at n = N_STREAM at 'highest' (kernels D and A on the
    SIMT kernel) at the dense optimum.  Each prints its median time per
    evaluation on the host clock, and one value+gradient at 'highest'
    under the profiler (device time by kernel)."""
    import numpy as np
    import torch
    import lsqfitgp_torch as lgp
    f32 = torch.float32
    torch.set_default_dtype(f32)
    rng = np.random.default_rng(20261016)
    x = rng.uniform(-50, 50, N)
    y = np.sin(x) + math.sqrt(NOISE_VAR) * rng.standard_normal(N)
    xt = torch.as_tensor(x, dtype=f32, device='cuda')
    yt = torch.as_tensor(y, dtype=f32, device='cuda')
    noise = NOISE_VAR * torch.eye(N, dtype=f32, device='cuda')
    hyperprior = {'log(scale)': (0., 1.), 'log(amp)': (0., 1.)}

    def dense_gp(hp, prec):
        gp = lgp.GP(hp['amp'] * lgp.ExpQuad(scale=hp['scale']),
                    gram='tiled', precision=prec)
        gp = gp.addx(xt, 'f').addcov(noise, 'e')
        return gp.addlintransf(lambda f, e: f + e, ['f', 'e'], 'y')

    def value_grad(make, data):
        lp = torch.tensor(OPTIMUM, device='cuda', requires_grad=True)
        with lgp.disable_checks():
            nll = -make({'scale': lp[0].exp(), 'amp': lp[1].exp()}
                        ).marginal_likelihood(data)
        g, = torch.autograd.grad(nll, lp)
        return float(nll), g.tolist()

    for prec in ('high', 'highest'):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fit = lgp.empbayes_fit(hyperprior, lambda hp: dense_gp(hp, prec),
                               {'y': yt}, minkw={'maxiter': 50},
                               raises=False)
        torch.cuda.synchronize()
        ev = fit.evaltimes
        log(f'dense n = {N} at {prec!r}: {time.perf_counter() - t0:.2f} s '
            f'wall, {len(ev)} evaluations, median '
            f'{statistics.median(ev) * 1e3:.1f} ms per evaluation')
    profile_phase(lambda: value_grad(lambda hp: dense_gp(hp, 'highest'),
                                     {'y': yt}))
    del noise, fit
    torch.cuda.empty_cache()
    xs, ys, _ = stream_data(N_STREAM)
    xs = torch.as_tensor(xs, dtype=f32, device='cuda')
    ys = torch.as_tensor(ys, dtype=f32, device='cuda')
    make = lambda hp: stream_gp(hp, 'highest').addx(xs, 'f')
    times = []
    for _ in range(evals):
        t0 = time.perf_counter()
        value_grad(make, {'f': ys})
        times.append(time.perf_counter() - t0)
    log(f'streaming n = {N_STREAM} at \'highest\': {evals} value+gradients '
        f'at {OPTIMUM}, median {statistics.median(times):.4f} s '
        f'(each: {[round(t, 3) for t in times]})')
    profile_phase(lambda: value_grad(make, {'f': ys}))


def gram_route(evals=7):
    """Kernels C and E as the main path calls them, through the public API
    only (`ops.gram`, `ops.gram_sym` and autograd), so that the same
    script times the parent's route from the parent's checkout: at the
    dense slice's shape (n = 16384, p = 1, the amp chain; C with the
    nugget), in float32 and float64, the forward alone and forward +
    backward, each a mean over GRAM_BATCH calls back to back (median of
    7), their difference the backward's time; then ``evals`` dense
    float32 value+gradients at the dense fit's optimum (host clock up to
    the read of the result, checks off), their median, and the profile
    of one."""
    import numpy as np
    import torch
    import lsqfitgp_torch as lgp
    from lsqfitgp_torch import ops
    gen = torch.Generator(device='cuda').manual_seed(SEED)
    for dtype in (torch.float32, torch.float64):
        kw = dict(device='cuda', dtype=dtype, generator=gen)
        x = ((torch.rand(N, **kw) - 0.5) * 100).requires_grad_()
        G = torch.randn(N, N, **kw)
        amp = torch.tensor(1.3, device='cuda', dtype=dtype,
                           requires_grad=True)
        noise = torch.tensor(NOISE_VAR, device='cuda', dtype=dtype,
                             requires_grad=True)
        post = (('mul', amp),)
        for name, fn, leaves in (
                ('C gram', lambda: ops.gram('expquad', x, post=post,
                                            noise=noise), (x, amp, noise)),
                ('E gram_sym', lambda: ops.gram_sym('expquad', x, post=post),
                 (x, amp))):
            with torch.no_grad():
                fwd = median_ms(fn, batch=GRAM_BATCH)
            both = median_ms(lambda: torch.autograd.grad(fn(), leaves, G),
                             batch=GRAM_BATCH)
            log(f'  {name} {dtype}: forward {fwd:.3f} ms, forward + '
                f'backward {both:.3f} ms, the backward {both - fwd:.3f} ms')
        del G
        torch.cuda.empty_cache()
    f32 = torch.float32
    torch.set_default_dtype(f32)
    rng = np.random.default_rng(20261016)
    xd = rng.uniform(-50, 50, N)
    yd = np.sin(xd) + math.sqrt(NOISE_VAR) * rng.standard_normal(N)
    xt = torch.as_tensor(xd, dtype=f32, device='cuda')
    yt = torch.as_tensor(yd, dtype=f32, device='cuda')
    noise = NOISE_VAR * torch.eye(N, dtype=f32, device='cuda')

    def value_grad():
        lp = torch.tensor(OPTIMUM, device='cuda', requires_grad=True)
        with lgp.disable_checks():
            gp = lgp.GP(lp[1].exp() * lgp.ExpQuad(scale=lp[0].exp()),
                        gram='tiled')
            gp = gp.addx(xt, 'f').addcov(noise, 'e')
            gp = gp.addlintransf(lambda f, e: f + e, ['f', 'e'], 'y')
            nll = -gp.marginal_likelihood({'y': yt})
        g, = torch.autograd.grad(nll, lp)
        return float(nll.detach()), g.tolist()

    times = []
    for _ in range(evals):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        value_grad()
        times.append(time.perf_counter() - t0)
    log(f'  dense float32 value+gradient at n = {N}, log scale, log amp '
        f'{OPTIMUM}: {statistics.median(times) * 1e3:.1f} ms median (each: '
        f'{[round(t * 1e3, 1) for t in times]} ms)')
    profile_phase(value_grad, top=16)


def memory_probe(sizes=(45056, 53248, 57344, 61440, 63488, 65536)):
    """The largest n at which one dense value+gradient (`dense_memory`)
    fits the card: each n in a process of its own, so that running out
    of memory ends that process only; an n that does not fit with the
    default allocator is tried again with
    ``PYTORCH_CUDA_ALLOC_CONF=expandable_segments:True``.  Prints one
    line per run."""
    for n in sizes:
        for conf in (None, 'expandable_segments:True'):
            env = dict(os.environ)
            if conf:
                env['PYTORCH_CUDA_ALLOC_CONF'] = conf
            t0 = time.perf_counter()
            proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                                   '--dense-at', str(n)], env=env,
                                  capture_output=True, text=True,
                                  timeout=900)
            lines = [l for l in proc.stdout.splitlines()
                     if 'peak memory' in l]
            why = lines[-1].strip() if lines else \
                (proc.stderr.strip().splitlines() or ['no output'])[-1]
            log(f'n = {n}, allocator {conf or "default"}: exit '
                f'{proc.returncode} after {time.perf_counter() - t0:.1f} s: '
                f'{why[:300]}')
            if proc.returncode == 0:
                break


# -- streaming and halfmatrix phases ------------------------------------------

def stream_data(n):
    """The streaming slice's data: x uniform with the point density of
    the dense slice (n = 65536 on [-200, 200]), y = sin(x) + noise."""
    import numpy as np
    rng = np.random.default_rng(SEED)
    half = 200 * n / N_STREAM
    x = rng.uniform(-half, half, n)
    y = np.sin(x) + math.sqrt(NOISE_VAR) * rng.standard_normal(n)
    return x, y, np.linspace(-1.05 * half, 1.05 * half, NPRED)


def stream_gp(hp, precision=None):
    import lsqfitgp_torch as lgp
    k = hp['amp'] * lgp.ExpQuad(scale=hp['scale']) \
        + NOISE_VAR * lgp.White()
    kw = {} if precision is None else dict(precision=precision)
    return lgp.GP(k, solver='chol-stream', block=STREAM_BLOCK, b1=128,
                  **kw)


def stream_phase(start, dev='cuda'):
    """The streaming slice at n = 65536 from numpy inputs: a 3-iteration
    fit and predfromdata; returns the launch counts and the end point.

    The fit starts from ``start``, the dense slice's MAP on a quarter of
    the span at the same point density, as a user warm-starts a large
    fit from a subset's.  From the prior mean, 3 BFGS iterations took 61
    evaluations (9 s each) and ended at an ill-conditioned point
    (PERF.md, Findings)."""
    import torch
    import lsqfitgp_torch as lgp
    cuda = dev == 'cuda'
    torch.set_default_dtype(torch.float32)
    x, y, xs = stream_data(N_STREAM)
    hyperprior = {'log(scale)': (0., 1.), 'log(amp)': (0., 1.)}
    log(f'streaming slice: n = {N_STREAM}, float32, amp * ExpQuad(scale) + '
        f'{NOISE_VAR} * White(), solver=chol-stream, block=512, b1=128, '
        f'from log scale {start[0]:.6g}, log amp {start[1]:.6g}')
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    fit = lgp.empbayes_fit(hyperprior, lambda hp: stream_gp(hp).addx(x, 'f'),
                           {'f': y}, initial=start, minkw={'maxiter': 3},
                           raises=False)
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fit_counts = read_counts()
    peak_fit = torch.cuda.max_memory_allocated() if cuda else 0
    gp = fit.gp().addx(xs, 'pred')
    devices = {gp._elements['f'].x.device.type, fit.pmean.buf.device.type}
    if devices != {dev}:
        fail(f'the streaming model is not on the {dev}: {devices}')
    t1 = time.perf_counter()
    mean = gp.predfromdata({'f': y}, 'pred').mean
    if cuda:
        torch.cuda.synchronize()
    pred_s = time.perf_counter() - t1
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    total = torch.cuda.get_device_properties(0).total_memory if cuda else 0
    ev = fit.evaltimes
    log(f'  fit: {wall:.2f} s wall, {fit.minresult.nit} BFGS iterations, '
        f'{len(ev)} evaluations, {statistics.median(ev):.3f} s median per '
        f'value + gradient (each: {[round(t, 3) for t in ev]})')
    log(f'  predfromdata at {NPRED} points: {pred_s:.3f} s')
    log(f'  peak memory: fit {peak_fit / 2**30:.2f} GiB '
        f'({peak_fit / N_STREAM**2:.2f} B/n²), fit + predfromdata '
        f'{peak / 2**30:.2f} GiB, of {total / 2**30:.2f} GiB')
    log(f'  launches during the fit: {fit_counts}; fit + predfromdata: '
        f'{counts}')
    require_launched(fit_counts, ['schur_update_gram_tc', 'schur_update_tc',
                                  'gram', 'gram_bwd'], 'the streaming fit')
    # one fused backward per gradient strip (width 4 block, the default
    # gradblock) of each evaluation
    strips = -(-N_STREAM // (4 * STREAM_BLOCK))
    require_counts(fit_counts, {'gram_bwd': strips * len(ev)},
                   'the streaming fit')
    if not bool(torch.isfinite(mean).all()) or mean.shape != (NPRED,):
        fail('streaming posterior mean not finite or of the wrong shape')
    end = [math.log(float(fit.pmean['scale'])),
           math.log(float(fit.pmean['amp']))]
    log(f'  end point: log scale {end[0]:.6g}, log amp {end[1]:.6g}; '
        f'pcov {fit.pcov.tolist()}')

    # where one value+gradient's time goes at the end point, as in the
    # fit (checks off): forward and backward on the host clock, then the
    # device time by kernel under torch.profiler
    def value_grad():
        lp = torch.tensor(end, device=dev, requires_grad=True)
        with lgp.disable_checks():
            gp = stream_gp({'scale': lp[0].exp(), 'amp': lp[1].exp()})
            nll = -gp.addx(x, 'f').marginal_likelihood({'f': y})
        if cuda:
            torch.cuda.synchronize()
        t = time.perf_counter()
        torch.autograd.grad(nll, lp)
        if cuda:
            torch.cuda.synchronize()
        return t

    t0 = time.perf_counter()
    t1 = value_grad()
    t2 = time.perf_counter()
    log(f'  one value+gradient at the end point: forward {t1 - t0:.3f} s, '
        f'backward {t2 - t1:.3f} s')
    if cuda:
        profile_phase(value_grad)
    return counts, end


def profile_phase(fn, top=12):
    """Device time by kernel of one ``fn()`` under torch.profiler, and the
    device's busy share of the host wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    t0 = time.perf_counter()
    with profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = []
    for e in prof.key_averages():
        # the kernels themselves (device events), not the host operators
        # that launched them, whose device time is the same time again
        if 'CUDA' not in str(getattr(e, 'device_type', '')):
            continue
        dev_us = getattr(e, 'self_device_time_total',
                         getattr(e, 'self_cuda_time_total', 0))
        if dev_us > 0:
            rows.append((dev_us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    # torch's own elementwise kernels (the plain passes around the
    # kernels), apart
    elem = [r for r in rows if 'elementwise' in r[2]]
    log(f'  profile: host {wall * 1e3:.1f} ms (under the profiler), device '
        f'busy {busy:.1f} ms ({100 * busy / (wall * 1e3):.1f} %), of which '
        f'torch\'s elementwise kernels {sum(r[0] for r in elem):.1f} ms '
        f'({sum(r[1] for r in elem)} launches)')
    for ms, count, name in rows[:top]:
        log(f'    {ms:10.1f} ms {100 * ms / max(busy, 1e-9):5.1f} % '
            f'x{count:<6d} {name[:90]}')


def stream_check_phase(end, dev='cuda'):
    """The streaming NLL, gradient and posterior mean at n = 32768 against
    the independent float64 computation, at the start point, at the
    streaming fit's end point and at the worse-conditioned point."""
    import torch
    import lsqfitgp_torch as lgp
    f32 = torch.float32
    x, y, xs = stream_data(N_CHECK)
    # the reference sees the data as the float32 model does (rounded to
    # float32), as the dense slice's checks do, so that the comparison
    # measures the computation and not the rounding of the coordinates
    x64 = torch.as_tensor(x, dtype=f32, device=dev).double()
    y64 = torch.as_tensor(y, dtype=f32, device=dev).double()
    log(f'streaming check: n = {N_CHECK} against float64')

    def hp(lp):
        return {'scale': lp[0].exp(), 'amp': lp[1].exp()}

    def value_grad32(lp, precision=None):
        return -stream_gp(hp(lp), precision).addx(x, 'f') \
            .marginal_likelihood({'f': y})

    def cond_at(ls, la):
        # the dense float32 matrix's condition estimate (lsqfitgp_torch's
        # Chol), as the dense slice's checks use
        with torch.no_grad():
            xt = torch.as_tensor(x, dtype=f32, device=dev)
            d = (xt[:, None] - xt[None, :]) / math.exp(ls)
            K = math.exp(la) * torch.exp(-0.5 * d * d)
            del d
            K.diagonal().add_(NOISE_VAR)
            return float(lgp.linalg.Chol(K).cond_estimate)

    check_points(N_CHECK, value_grad32, cond_at, x64, y64,
                 [('start point', [0., 0.], False),
                  ('end point of the n = 65536 fit', end, True),
                  ('ill-conditioned point', [1.05, 2.44], False)])

    # the dense float32 path on the same data at the ill-conditioned
    # point, for comparison (no limit: it shows how much of the
    # streaming gradient's error the float32 model has on either path)
    lp = torch.tensor([1.05, 2.44], dtype=f32, device=dev,
                      requires_grad=True)
    noise = NOISE_VAR * torch.eye(N_CHECK, dtype=f32, device=dev)
    gp = lgp.GP(lp[1].exp() * lgp.ExpQuad(scale=lp[0].exp()), gram='tiled')
    gp = gp.addx(x, 'f').addcov(noise, 'e')
    gp = gp.addlintransf(lambda f, e: f + e, ['f', 'e'], 'y')
    g32, = torch.autograd.grad(-gp.marginal_likelihood({'y': y}), lp)
    del gp, noise
    g64 = plain_nll64(x64, y64, 1.05, 2.44)[1]
    log(f'  dense float32 path at the ill-conditioned point: gradient '
        f'{g32.tolist()}, relative diff '
        f'{float((g32.double() - g64).norm() / g64.norm()):.3e}')
    lp = torch.tensor(end, dtype=f32, device=dev)
    gp = stream_gp(hp(lp)).addx(x, 'f').addx(xs, 'pred')
    mean = gp.predfromdata({'f': y}, 'pred').mean
    cond = cond_at(*end)
    eps32 = torch.finfo(f32).eps
    with torch.no_grad():
        xs64 = torch.as_tensor(xs, dtype=f32, device=dev).double()
        ref = plain_mean64(x64, y64, xs64, math.exp(end[0]),
                           math.exp(end[1]))
    dmean = float((mean.double() - ref).abs().max())
    log(f'  posterior mean at {NPRED} points: max |port - float64| '
        f'{dmean:.3e}, max |mean| {float(ref.abs().max()):.4g}, limit '
        f'{10 * cond * eps32 * float(ref.abs().max()):.3e}')
    if not bool(torch.isfinite(mean).all()) or mean.shape != (NPRED,):
        fail('streaming posterior mean not finite or of the wrong shape')
    if dmean > 10 * cond * eps32 * float(ref.abs().max()):
        fail('streaming posterior mean disagrees with the float64 '
             'reference')


def halfmatrix_phase(dev='cuda'):
    """One dense value+gradient at n = 16384 with halfmatrix=True and
    gram='tiled' (kernel E) against the same with halfmatrix=False."""
    import numpy as np
    import torch
    import lsqfitgp_torch as lgp
    f32 = torch.float32
    torch.set_default_dtype(f32)
    rng = np.random.default_rng(SEED)
    x = rng.uniform(-50, 50, N)
    y = np.sin(x) + math.sqrt(NOISE_VAR) * rng.standard_normal(N)
    noise = NOISE_VAR * torch.eye(N, dtype=f32, device=dev)
    log(f'halfmatrix: n = {N}, float32, the dense slice\'s model at log '
        f'scale 0, log amp 0')
    out = {}
    for hm in (False, True):
        if dev == 'cuda':
            torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        lp = torch.zeros(2, dtype=f32, device=dev, requires_grad=True)
        gp = lgp.GP(lp[1].exp() * lgp.ExpQuad(scale=lp[0].exp()),
                    gram='tiled', halfmatrix=hm)
        gp = gp.addx(x, 'f').addcov(noise, 'e')
        gp = gp.addlintransf(lambda f, e: f + e, ['f', 'e'], 'y')
        nll = -gp.marginal_likelihood({'y': y})
        g, = torch.autograd.grad(nll, lp)
        if dev == 'cuda':
            torch.cuda.synchronize()
        out[hm] = (float(nll.detach()), g.double(),
                   time.perf_counter() - t0, read_counts())
        del gp, nll
        log(f'  halfmatrix={hm}: NLL {out[hm][0]:.8g}, gradient '
            f'{g.tolist()}, {out[hm][2]:.3f} s, launches {out[hm][3]}')
    # one forward and one fused backward of E with halfmatrix, of C
    # without
    require_counts(out[True][3], {'gram_sym': 1, 'gram_sym_bwd': 1,
                                  'gram': 0, 'gram_bwd': 0},
                   'the halfmatrix run')
    require_counts(out[False][3], {'gram': 1, 'gram_bwd': 1, 'gram_sym': 0,
                                   'gram_sym_bwd': 0}, 'the full run')
    # kernel E writes the same entries as kernel C (r² is symmetric in
    # its arguments), so the NLL is identical; the gradients differ by
    # the order of the backward's sums of n² float32 terms: a relative
    # 1e-3 is ~15 times the depth-28 reduction tree's 4 u per level
    if out[True][0] != out[False][0]:
        fail('halfmatrix NLL differs from the full evaluation')
    rel = float((out[True][1] - out[False][1]).norm() / out[False][1].norm())
    log(f'  gradient relative difference {rel:.3e} (limit 1e-3)')
    if rel > 1e-3:
        fail('halfmatrix gradient differs from the full evaluation')
    return out[True][3]


# -- second-order phases ---------------------------------------------------------

N_FISHVEC = 8192    # the P > 20 model's size
FISHVEC_GROUPS = 24  # its noise groups: P = 26
FISHVEC_ITERS = 3    # its trust-ncg iterations (the smoke's time)
FISHER_ITERS = 30    # the cap of the method='fisher' fit at n = N


def dense_model(dev, n=None, groups=0, halfmatrix=False):
    """The dense slice's model and data at n points (its point density):
    ``(gpfactory, hyperprior, x, y)`` in float32 on ``dev``; with
    ``groups``, the noise variance is a hyperparameter per contiguous
    group of points (``log(noise)``, N(log 0.09, 0.5²) each)."""
    import numpy as np
    import torch
    import lsqfitgp_torch as lgp
    f32 = torch.float32
    n = N if n is None else n
    rng = np.random.default_rng(SEED)
    half = 50 * n / N
    x = rng.uniform(-half, half, n)
    y = np.sin(x) + math.sqrt(NOISE_VAR) * rng.standard_normal(n)
    xt = torch.as_tensor(x, dtype=f32, device=dev)
    yt = torch.as_tensor(y, dtype=f32, device=dev)
    hyperprior = {'log(scale)': (0., 1.), 'log(amp)': (0., 1.)}
    if groups:
        which = torch.arange(n, device=dev) * groups // n
        hyperprior['log(noise)'] = (np.full(groups, math.log(NOISE_VAR)),
                                    np.full(groups, 0.5))
    else:
        noise = NOISE_VAR * torch.eye(n, dtype=f32, device=dev)

    def gpfactory(hp):
        gp = lgp.GP(hp['amp'] * lgp.ExpQuad(scale=hp['scale']),
                    gram='tiled', halfmatrix=halfmatrix)
        cov = torch.diag(hp['noise'][which]) if groups else noise
        gp = gp.addx(xt, 'f').addcov(cov, 'e')
        return gp.addlintransf(lambda f, e: f + e, ['f', 'e'], 'y')

    return gpfactory, hyperprior, xt, yt


def plain_curvature64(x, y, log_scale, log_amp):
    """Independent float64 reference of the objective's Hessian and of
    its expected Fisher information in (log scale, log amp), each with
    the N(0, 1) prior's identity: dense K, ``torch.linalg.cholesky`` and
    the textbook forms

        H_ab = ½ tr(K⁻¹K_ab) − ½ tr(K⁻¹K_a K⁻¹K_b)
               + (K_a α)ᵀ K⁻¹ (K_b α) − ½ αᵀ K_ab α,
        F_ab = ½ tr(K⁻¹K_a K⁻¹K_b),   α = K⁻¹ y,

    with K_amp = K_amp,amp = amp E, K_scale = K_scale,amp = amp E ∘ D and
    K_scale,scale = amp E ∘ (D² − 2D), D = Δ²/scale², E = exp(−D/2); no
    port code.  Returns (H, F, S) as 2 × 2 float64, S the sum of the
    magnitudes of H's terms (its first and last pairs cancel, as the
    gradient's do: a float32 error scales with them, not with H)."""
    import torch
    scale, amp = math.exp(log_scale), math.exp(log_amp)
    D = x[:, None] - x[None, :]
    D.mul_(D).div_(scale * scale)
    K1 = torch.exp(D * -0.5).mul_(amp)
    K = K1.clone()
    K.diagonal().add_(NOISE_VAR)
    L = torch.linalg.cholesky(K)
    del K
    alpha = torch.cholesky_solve(y[:, None], L)[:, 0]
    Kinv = torch.cholesky_inverse(L)
    del L
    K0 = K1 * D
    K00 = K0 * (D - 2)
    del D
    Ks = [K0, K1]
    M = [Kinv @ K0, Kinv @ K1]
    u = [K0 @ alpha, K1 @ alpha]
    Kab = [[K00, K0], [K0, K1]]
    H = torch.empty(2, 2, dtype=x.dtype, device=x.device)
    F = torch.empty_like(H)
    S = torch.empty_like(H)
    for a in range(2):
        for b in range(2):
            trMM = (M[a] * M[b].T).sum()
            terms = torch.stack([0.5 * (Kinv * Kab[a][b]).sum(), -0.5 * trMM,
                                 u[a] @ (Kinv @ u[b]),
                                 -0.5 * alpha @ (Kab[a][b] @ alpha)])
            F[a, b] = 0.5 * trMM + (a == b)
            H[a, b] = terms.sum() + (a == b)
            S[a, b] = terms.abs().sum() + (a == b)
    del Ks, M, Kab, Kinv, K0, K1, K00
    return H, F, S


def counts_since(before):
    now = read_counts()
    return {k: now[k] - before[k] for k in now}


def second_order_phase(fitted, dev='cuda'):
    """The dense model's second-order path at n = N in float32: from the
    BFGS fit's MAP, empbayes_fit with covariance='hess' (the Hessian by
    double backward: C′ and C″ once per hyperparameter) and 'fisher'
    (Chol.fisher of the forward-mode (K, r) tangents: C′ once per
    hyperparameter), each 2 × 2 covariance against the inverse of its
    float64 oracle (`plain_curvature64`) within 10 cond eps32 relative;
    then a method='fisher' fit (trust-ncg on the Hessian) from the start
    point, which must land within one posterior standard deviation of
    the BFGS fit's MAP.  Returns the phase's launch counts."""
    import torch
    import lsqfitgp_torch as lgp

    def sync():
        if dev == 'cuda':
            torch.cuda.synchronize()

    f32 = torch.float32
    torch.set_default_dtype(f32)
    eps32 = torch.finfo(f32).eps
    gpfactory, hyperprior, xt, yt = dense_model(dev)
    x64, y64 = xt.double(), yt.double()
    P = 2
    log(f'second order: n = {N}, float32, the dense slice\'s model, from '
        f'the BFGS fit\'s MAP {fitted}')
    reset_counts()
    for cov in ('hess', 'fisher'):
        before = read_counts()
        sync()
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            # a few BFGS iterations from the MAP, where float32's line
            # searches end on 'precision loss' or the cap
            warnings.simplefilter('ignore')
            fit = lgp.empbayes_fit(hyperprior, gpfactory, {'y': yt},
                                   initial=fitted, covariance=cov,
                                   minkw={'maxiter': 3}, raises=False)
        sync()
        wall = time.perf_counter() - t0
        c = counts_since(before)
        evals = len(fit.evaltimes)
        ls, la = fit.pmean.buf.tolist()
        with torch.no_grad():
            H64, F64, S64 = plain_curvature64(x64, y64, ls, la)
            K = gpfactory({'scale': torch.tensor(math.exp(ls)),
                           'amp': torch.tensor(math.exp(la))}).prior(
                               'y', raw=True)
            cond = float(lgp.linalg.Chol(K).cond_estimate)
            del K
        # the matrix the fit inverted (the prior is N(0, I), so the
        # whitened and stored parameters coincide): against the oracle,
        # entry by entry, within 10 cond eps32 of its terms' magnitudes
        # (the gradient's bound, `check_points`)
        ref, scale = (H64, S64) if cov == 'hess' else (F64, F64)
        pcov = fit.pcov.double()
        got = torch.linalg.inv(pcov)
        limit = 10 * cond * eps32 * scale
        excess = float(((got - ref).abs() / limit).max())
        log(f'  covariance={cov!r}: {wall:.2f} s wall ({evals} BFGS '
            f'evaluations, then the covariance in {fit.covtime:.3f} s) at '
            f'log scale {ls:.6g}, log amp {la:.6g}; pcov {pcov.tolist()}; '
            f'its inverse {got.tolist()}, float64 oracle {ref.tolist()}, '
            f'relative error {float((got - ref).norm() / ref.norm()):.3e}, '
            f'max error over its limit {excess:.3f} (limit 10 cond eps32 '
            f'times {scale.tolist()}, cond_estimate {cond:.4g}); launches '
            f'{nonzero(c)}')
        if not bool(torch.isfinite(pcov).all()):
            fail(f'covariance={cov!r}: non-finite')
        if excess > 1:
            fail(f'covariance={cov!r} disagrees with the float64 oracle')
        if cov == 'hess':
            # one create_graph gradient (C's backward as a Function) and
            # P passes, each C′, C″ and C's backward once
            require_counts(c, {'gram_jvp': P, 'gram_bwd_jvp': P,
                               'gram': evals + 1,
                               'gram_bwd': evals + 1 + P},
                           'the Hessian')
            # the posterior standard deviations at the MAP, float64
            sdev = torch.linalg.inv(H64).diagonal().sqrt().cpu()
        else:
            # the primal (K, r) and P forward-mode passes, each C and C′
            require_counts(c, {'gram_jvp': P, 'gram_bwd_jvp': 0,
                               'gram': evals + 1 + P, 'gram_bwd': evals},
                           'the Fisher information')
        if dev == 'cuda':
            torch.cuda.empty_cache()

    # the method='fisher' fit from the start point
    before = read_counts()
    sync()
    t0 = time.perf_counter()
    fit = lgp.empbayes_fit(hyperprior, gpfactory, {'y': yt},
                           method='fisher', minkw={'maxiter': FISHER_ITERS},
                           raises=False)
    sync()
    wall = time.perf_counter() - t0
    c = counts_since(before)
    res = fit.minresult
    got = torch.tensor(fit.pmean.buf.tolist(), dtype=torch.float64)
    shift = ((got - torch.tensor(fitted, dtype=torch.float64)).abs()
             / sdev)
    log(f'  method=\'fisher\' (trust-ncg): {wall:.2f} s wall, {res.nit} '
        f'iterations, {fit.counts["fun"]} evaluations, '
        f'{fit.counts["hess"]} Hessians, median '
        f'{statistics.median(fit.evaltimes) * 1e3:.1f} ms per evaluation, '
        f'covariance={fit.covariance!r} in {fit.covtime:.3f} s; exit '
        f'{res.message!r}; MAP {got.tolist()} against BFGS {fitted}: '
        f'{shift.tolist()} posterior sdev (limit 1); launches {nonzero(c)}')
    if not bool((shift <= 1).all()):
        fail('method=\'fisher\' lands away from the BFGS fit\'s MAP')
    hessians = fit.counts['hess'] + (fit.covariance == 'hess')
    require_counts(c, {'gram_jvp': P * hessians,
                       'gram_bwd_jvp': P * hessians},
                   'the method=\'fisher\' fit')
    return read_counts()


def fishvec_phase(dev='cuda'):
    """The P > 20 path: the dense model with the noise in FISHVEC_GROUPS
    contiguous groups (P = 26) at n = N_FISHVEC, method='fisher' (trust-ncg
    on Fisher-vector products, FISHVEC_ITERS iterations) and
    covariance='fisher' (its columns from Fisher-vector products): C′
    once per product, no C″; the covariance finite and positive
    definite.  Returns the phase's launch counts."""
    import torch
    import lsqfitgp_torch as lgp
    torch.set_default_dtype(torch.float32)
    gpfactory, hyperprior, _, yt = dense_model(dev, N_FISHVEC,
                                               FISHVEC_GROUPS)
    P = 2 + FISHVEC_GROUPS
    log(f'fisher-vector products: n = {N_FISHVEC}, float32, P = {P}')
    if dev == 'cuda':
        torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        fit = lgp.empbayes_fit(hyperprior, gpfactory, {'y': yt},
                               method='fisher', covariance='fisher',
                               minkw={'maxiter': FISHVEC_ITERS},
                               raises=False)
    if dev == 'cuda':
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c = read_counts()
    eig = torch.linalg.eigvalsh(fit.pcov.double())
    log(f'  {wall:.2f} s wall, {fit.minresult.nit} iterations, '
        f'{fit.counts["fun"]} evaluations, {fit.counts["hess"]} '
        f'Fisher-vector products, the covariance in {fit.covtime:.3f} s; '
        f'pcov eigenvalues {eig.min().item():.4g} to {eig.max().item():.4g};'
        f' launches {nonzero(c)}')
    if fit.counts['hess'] == 0:
        fail('the P > 20 fit took no Fisher-vector product')
    require_counts(c, {'gram_jvp': fit.counts['hess'] + P,
                       'gram_bwd_jvp': 0}, 'the P > 20 fit')
    if not bool(torch.isfinite(eig).all()) or float(eig.min()) <= 0:
        fail('the P > 20 Fisher covariance is not positive definite')
    return c


def halfmatrix_hess_phase(fitted, dev='cuda'):
    """covariance='hess' at the dense fit's MAP on the halfmatrix model
    (E′ and E″ twice each) and with halfmatrix=False (C′ and C″), each
    held to the float64 oracle as in `second_order_phase` (the two sum
    in other orders, so they differ by float32 rounding of the same
    size).  Returns the halfmatrix run's launch counts."""
    import torch
    import lsqfitgp_torch as lgp
    f32 = torch.float32
    torch.set_default_dtype(f32)
    eps32 = torch.finfo(f32).eps
    log('halfmatrix second order: covariance=\'hess\' at the MAP, '
        'halfmatrix=True against False')
    out = {}
    for hm in (False, True):
        gpfactory, hyperprior, xt, yt = dense_model(dev, halfmatrix=hm)
        if dev == 'cuda':
            torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        with warnings.catch_warnings():
            warnings.simplefilter('ignore')
            fit = lgp.empbayes_fit(hyperprior, gpfactory, {'y': yt},
                                   initial=fitted, covariance='hess',
                                   minkw={'maxiter': 0}, raises=False)
        if dev == 'cuda':
            torch.cuda.synchronize()
        out[hm] = (torch.linalg.inv(fit.pcov.double()),
                   time.perf_counter() - t0, read_counts())
        log(f'  halfmatrix={hm}: the Hessian {out[hm][0].tolist()}, '
            f'{out[hm][1]:.2f} s, launches {nonzero(out[hm][2])}')
    require_counts(out[True][2], {'gram_sym_jvp': 2, 'gram_sym_bwd_jvp': 2,
                                  'gram_jvp': 0, 'gram_bwd_jvp': 0},
                   'the halfmatrix Hessian')
    require_counts(out[False][2], {'gram_jvp': 2, 'gram_bwd_jvp': 2,
                                   'gram_sym_jvp': 0,
                                   'gram_sym_bwd_jvp': 0},
                   'the full Hessian')
    ls, la = fit.pmean.buf.tolist()
    with torch.no_grad():
        H64, _, S64 = plain_curvature64(xt.double(), yt.double(), ls, la)
        K = gpfactory({'scale': torch.tensor(math.exp(ls)),
                       'amp': torch.tensor(math.exp(la))}).prior(
                           'y', raw=True)
        cond = float(lgp.linalg.Chol(K).cond_estimate)
        del K
    limit = 10 * cond * eps32 * S64
    rel = float((out[True][0] - out[False][0]).norm() / H64.norm())
    excess = [float(((out[hm][0] - H64).abs() / limit).max())
              for hm in (False, True)]
    log(f'  relative difference {rel:.3e}; max error over the oracle\'s '
        f'limit (as in the second-order phase): full {excess[0]:.3f}, '
        f'halfmatrix {excess[1]:.3f}')
    if max(excess) > 1:
        fail('a Hessian of the halfmatrix check disagrees with the float64 '
             'oracle')
    return out[True][2]


def main(argv):
    sys.path.insert(0, ROOT)
    header()
    try:
        import lsqfitgp_torch  # noqa: F401
    except ImportError as exc:
        fail(f'lsqfitgp_torch not found beside chip_smoke.py: {exc}')
    import torch
    if argv[:1] == ['--dense-at']:
        torch.set_default_dtype(torch.float32)
        dense_memory(int(argv[1]))
        return 0
    if argv == ['--memory-probe']:
        memory_probe()
        return 0
    if argv == ['--compare-fits']:
        compare_fits()
        return 0
    if argv == ['--compare-highest']:
        build()
        compare_highest()
        return 0
    if argv == ['--gram-route']:
        build()
        gram_route()
        return 0
    if argv == ['--dense64']:
        build()
        dense64_phase(OPTIMUM)
        return 0
    if argv:
        fail(f'unknown arguments {argv}')
    t0 = time.perf_counter()
    build()
    records = kernel_phase()
    torch.cuda.empty_cache()
    paths = {}
    paths['rescue'] = rescue_phase()
    log(f'elapsed {time.perf_counter() - t0:.1f} s')
    torch.cuda.empty_cache()
    paths['dense'], fitted = slice_phase()
    log(f'elapsed {time.perf_counter() - t0:.1f} s')
    torch.cuda.empty_cache()
    paths['dense64'] = dense64_phase(fitted)
    log(f'elapsed {time.perf_counter() - t0:.1f} s')
    torch.cuda.empty_cache()
    paths['stream'], end = stream_phase(fitted)
    log(f'elapsed {time.perf_counter() - t0:.1f} s')
    torch.cuda.empty_cache()
    stream_check_phase(end)
    log(f'elapsed {time.perf_counter() - t0:.1f} s')
    torch.cuda.empty_cache()
    paths['halfmatrix'] = halfmatrix_phase()
    log(f'elapsed {time.perf_counter() - t0:.1f} s')
    torch.cuda.empty_cache()
    paths['second'] = second_order_phase(fitted)
    log(f'elapsed {time.perf_counter() - t0:.1f} s')
    torch.cuda.empty_cache()
    paths['fishvec'] = fishvec_phase()
    log(f'elapsed {time.perf_counter() - t0:.1f} s')
    torch.cuda.empty_cache()
    paths['halfmatrix_hess'] = halfmatrix_hess_phase(fitted)
    # each kernel's launches are those of its own path's run: the dense
    # fit's, but for A, C and C's backward in float64 the float64 dense
    # evaluation's.  C's and E's counters do not tell the dtypes apart:
    # their records count the paths of their dtype only (no path runs E
    # in float64)
    own = {'schur_update': 'dense', 'syrk_t_full': 'dense',
           'syrk_t_full_': 'dense', 'gram': 'dense', 'gram_bwd': 'dense',
           'schur_update_gram': 'stream', 'gram_sym': 'halfmatrix',
           'gram_sym_bwd': 'halfmatrix', 'gram_jvp': 'second',
           'gram_bwd_jvp': 'second', 'gram_sym_jvp': 'halfmatrix_hess',
           'gram_sym_bwd_jvp': 'halfmatrix_hess'}
    own64 = {'schur_update': 'dense64', 'gram': 'dense64',
             'gram_bwd': 'dense64'}
    # A's SIMT kernel ('highest') runs on the rescue phase's ladder
    own_key = {'schur_update': 'rescue'}
    dtype_paths = {'float32': ['rescue', 'dense', 'stream', 'halfmatrix',
                               'second', 'fishvec', 'halfmatrix_hess'],
                   'float64': ['dense64']}
    for rec in records:
        base = rec['name'].split('/')[0]
        is_gram = 'key' in rec
        key = rec.pop('key', None) or base + COUNTERS[rec['counter']]
        if rec['name'].endswith('/float64') and (
                is_gram or base == 'schur_update'):
            path = own64.get(base)
        elif not is_gram and key in own_key:
            path = own_key[key]
        else:
            path = own[base]
        names = dtype_paths[rec['dtype']] if is_gram else list(paths)
        rec['launches'] = paths[path][key] if path else 0
        rec['launches_by_path'] = {p: paths[p][key] for p in names}
    log(f'total {time.perf_counter() - t0:.1f} s')
    keys = ['name', 'route', 'source', 'replaces', 'launches',
            'max_abs_err', 'ms', 'plain_ms', 'bound_ms', 'bound_by',
            'share_of_bound', 'library_ms', 'precision', 'dtype', 'library',
            'launches_by_path', 'wrapper_ms']
    print(json.dumps({'kernels': [{k: r.get(k) for k in keys}
                                  for r in records]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
