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
   (E's and its backward's with '/float64' off every path), and C and
   its backward at p = 2 ('gram/p2' and 'gram_bwd/p2', the derivative
   path's, checked at that path's shape too) and at p = 10 ('gram/p10'
   and 'gram_bwd/p10', the multidim path's), in float32 and float64
   (with '/float64', off every path); the fused backward must give the
   same bits in two calls and make one launch for all p, and E the same
   entries as C; each record has its share of the bound; and the zoo's
   profiles (kernel C and its backward on Maternp(p=2), Expon, GammaExp
   and Cauchy with dynamic arguments and the multiscale term sum, at
   p = 1 and 10, in float32 and float64, 'gram/<profile>' and
   'gram_bwd/<profile>'; E and its backward, C′ and C″ on Maternp(p=2);
   D on the term sum at 'high' and in float64), and the 1-D time-series
   cores and the rest of the 'abs'/'posabs' zoo (C and its backward on
   Celerite, Periodic, Harmonic at Q = 2 and 0.4, Cos, Sinc, HoleEffect,
   CausalExpQuad, Log, Wendland (k = 2) and Circular with dynamic
   arguments at p = 1, CausalExpQuad and Log at p = 10 too; E and its
   backward, C′ and C″ on Periodic; D on Celerite at 'high' and in
   float64), and the last spec-carrying cores (C and its backward on
   StationaryFracBrownian, the real-order Matérn, Bessel, Pink and Color
   at p = 1, Bessel at p = 2 and Matérn-ν at p = 10; E, its backward, C′
   and C″ on Matérn-ν; D on StationaryFracBrownian and Matérn-ν; the
   plain versions of the special-function cores held and timed on a
   block, ZOO_BLOCK), C's and E's timed by the device time of the named
   kernel;
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
   ``empbayes_fit`` (L-BFGS-B, at most STREAM_MAXFUN evaluations, from the
   dense MAP) to
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
9. the derivative path (BASELINE config #2): ``amp * ExpQuad(scale)`` on
   points of two fields (x, t), 8192 function values and 4096
   observations of ∂f/∂x (``addx(..., deriv='x')``), fitted with the
   default ``gram`` (kernel C at p = 2 for the value block, once
   forward and once backward per evaluation; the derivative blocks
   broadcast), then ∂F/∂t predicted; NLL, gradient and both posterior
   means held to a closed-form float64 oracle, the peak memory, the
   blocks' times and a profile;
10. the multidim path: ``amp * ExpQuad(scale)`` fitted (at most 10 BFGS
   iterations) to the Friedman #1 response at n = 16384 points uniform
   on [0, 1]^10, one structured field with a (10,) tail, standardized,
   the noise through ``givencov``, the default ``gram`` (kernel C at
   p = 10, forward and single-launch fused backward once per
   evaluation), then predicted at 64 held-out points; NLL, gradient and
   posterior mean held to a float64 oracle (K from broadcast
   differences, ``torch.linalg.cholesky``), the peak memory and a
   profile;
11. the Matérn path: ``amp * Maternp(p=2, scale)`` on the dense slice's
   data and noise, the default ``gram`` (kernel C on the Maternp
   profile, forward and backward once per evaluation), at most 10 BFGS
   iterations, held to a closed-form float64 oracle as in 5, its time
   per evaluation beside the ExpQuad fit's;
12. the multiscale path: ``a1 * Maternp(p=2, s1) + a2 * ExpQuad(s2)`` at
   a fixed point, one dense value+gradient at n = 16384 and two
   streaming ones at n = 65536 (kernels C and D on the term sum),
   checked against float64 at n = 16384 and, streaming, at n = 32768;
   launches are also counted by profile ('gram@maternp+expquad');
13. the time-series path (examples/timeseries_streaming.py's model, amp
   * Celerite(gamma, B=0.05) + noise * White(), its hyperprior, data of
   its true values and density): a dense fit at n = 16384 (kernel C on
   the celerite profile, forward and backward once per evaluation, the
   noise as the data's scalar givencov) held to float64 at the start,
   at the fit and in its posterior mean past the data; a streaming fit
   at n = 65536 from the dense MAP (kernel D on the celerite profile),
   its NLL and exact gradient held to float64 at n = 32768, and a
   forecast past the end whose sdev must grow;
14. the Hurst path: ``amp * StationaryFracBrownian(H)`` on t = 0 … n−1
   plus white noise, data of H = 0.75 by circulant embedding, a dense
   fit at n = 16384 (kernel C on 'sfb' with its H-derivative, each
   launch after one of the coefficient builder ``sfb_table_kernel``)
   held to a Toeplitz float64 truth, the fitted H within 3 posterior
   sdev of 0.75, and a streaming fit at n = 65536 (kernel D on 'sfb'),
   checked at n = 32768;
15. the model-comparison path: examples/model_comparison.py at
   n = 16384, its four candidates' evidence held to float64 (ExpQuad
   must win), then ``amp * Matern(nu=1.7, scale)`` fitted (kernel C on
   'matern') against a float64 truth from ``scipy.special.kv``;
16. prints a JSON line of kernel records and, last, the device line.

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
float64 dense evaluation, at the dense fit's optimum; ``--gram-route``
times the point block through the GP by kernel C and by the broadcast
core, square and against 64 prediction points (the table of ``gram='auto'``'s cutover, where the package has
structured points), kernels C and E with their backward through the
public API, and dense float32 value+gradients at the optimum and the
multidim model's at a fixed point, each with a profile (``--gram-route
evals``: all but the table; ``--dense64`` and ``--gram-route`` run from
an older checkout too, to time its route in the same call);
``--deriv`` runs only kernel C's float32 p = 2 records (step 3) and the
derivative path; ``--multidim`` kernel C's p = 2 and p = 10 records in
both dtypes and the multidim path; ``--zoo`` the zoo's records of PR 11
and the Matérn and multiscale paths; ``--timeseries`` the time-series
cores' records and the time-series path; ``--hurst`` the 'sfb' records
and the Hurst path (``--hurst-evals LABEL`` only the timing of its dense
value + gradient, for checkouts in turns); ``--evidence`` the records of
the other four cores and the model-comparison path.
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
# the streaming slice's fit from the dense MAP: 3 BFGS iterations until
# the time-series path joined the run (42 evaluations, 321 s; 1 iteration
# took 48, its line search failing at the start point), since then
# L-BFGS-B capped at STREAM_MAXFUN evaluations (the time-series and
# Hurst paths run streaming BFGS fits at the same n): 8 until the Hurst
# and model-comparison paths joined the run, then 4 (10 evaluations, 77 s
# on one H100 80GB HBM3 at 700.00 W), 2 since the build alone took 350
# of the run's 1200 s there
STREAM_MAXFUN = 2
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
# the derivative phase (BASELINE config #2): function values and
# observations of ∂f/∂x at points (x, t) on [-25, 25]², and the cap of
# its BFGS fit
N_DF, N_DD, DERIV_SPAN, DERIV_ITERS = 8192, 4096, 25.0, 10
# the multidim phase (Friedman #1): n points uniform on the unit cube of
# MD_P dimensions, 64 held out, and the cap of its BFGS fit
N_MD, MD_P, MD_ITERS = 16384, 10, 10

# the card's peak rates (NVIDIA's H100 SXM data sheet, at 700 W): HBM
# bandwidth, and FP32 and FP64 outside the tensor cores (the Gram
# family's kernels and the SIMT kernels), FP64 on the tensor cores
# (DMMA: kernels A, B and D in float64) and TF32 (tensor core, dense)
# operations; a 3xTF32 product costs three TF32 passes, so its useful
# rate is the TF32 peak over 3
PEAK_BYTES = 3.35e12
PEAK_OPS = {'float32': 67e12, 'float64': 33.5e12, 'dmma': 67e12,
            'tf32': 495e12}


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


def device_ms(fn, calls=GRAM_BATCH, kernel=None):
    """Device time of one ``fn()`` in ms: the sum of the durations of all
    the kernels it launches (torch.profiler, CUPTI), over ``calls`` calls
    after one warm-up, divided by ``calls``; with ``kernel``, of the
    kernels of that name only (the Gram kernels of csrc/gram.cu, apart
    from the wrapper's small torch kernels that fold the parameter
    vector; a kernel launched once a call, by its median launch, one
    launched k times, by its mean launch times k, so that a launch the
    profiler loses does not count as time saved).  Unlike CUDA events
    around the calls it leaves out the time
    the card waits for the host, which a wrapper of a few small torch
    operations around a sub-millisecond kernel can take up; where the
    profiler sees no device time, the median of ``calls`` calls on CUDA
    events."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    named = []
    for e in prof.events():
        if 'CUDA' in str(getattr(e, 'device_type', '')):
            t = getattr(e, 'self_device_time_total',
                        getattr(e, 'self_cuda_time_total', 0))
            total += t
            if kernel is not None and f'{kernel}<' in e.name:
                named.append(t)
    if total <= 0:
        # CUDA events around the calls instead (the card's wait for the
        # host included)
        log(f'    (the profiler saw no device time: {calls} calls timed on '
            f'CUDA events)')
        return median_ms(fn, reps=calls)
    if kernel is not None:
        if named:
            # the profiler has been seen to lose one launch of a slow
            # kernel's 3 calls (2/3 of its time) and to report one long:
            # a kernel launched once a call is timed by its median launch,
            # the launches logged where one is missing or lies 20 % off
            # the median; one launched k times a call by its mean launch
            # times k
            per_call = max(1, round(len(named) / calls))
            if per_call == 1:
                med = statistics.median(named)
                if len(named) != calls or any(abs(v - med) > 0.2 * med
                                              for v in named):
                    log(f'    ({kernel}: {len(named)} launches over '
                        f'{calls} calls, of '
                        f'{[round(v / 1e3, 4) for v in named]} ms, timed '
                        f'by their median)')
                return med / 1e3
            if len(named) != per_call * calls:
                log(f'    ({kernel}: {len(named)} launches over {calls} '
                    f'calls, timed as {per_call} a call)')
            return sum(named) / len(named) * per_call / 1e3
        log(f'    (no kernel named {kernel} in the profile: all of its '
            f'kernels counted)')
    return total / 1e3 / calls


# a kernel slower than this many ms per call is timed over SLOW_CALLS
# calls, and its wrapper's time is not taken apart (a few tenths of a
# millisecond of host time are lost in its own)
SLOW_MS, SLOW_CALLS = 5.0, 3


def kernel_calls(fn):
    """GRAM_BATCH, or SLOW_CALLS for a call of ``fn`` slower than SLOW_MS
    (one call after a warm-up, CUDA events)."""
    return GRAM_BATCH if median_ms(fn, reps=1) < SLOW_MS else SLOW_CALLS


def gram_times(fn, plain, kernel, plain_calls=GRAM_BATCH):
    """(ms, plain_ms, wrapper_ms) of kernel C's or E's wrapper ``fn`` and
    its plain version: the device time per call of the CUDA kernel named
    ``kernel`` (`device_ms`, over `kernel_calls` calls) and of the plain
    version (all its kernels, over ``plain_calls`` calls), and the
    wrapper's mean over GRAM_BATCH calls back to back on CUDA events
    (None for a slow kernel)."""
    calls = kernel_calls(fn)
    wrap = median_ms(fn, batch=GRAM_BATCH) if calls == GRAM_BATCH else None
    return device_ms(fn, calls, kernel=kernel), \
        device_ms(plain, plain_calls), wrap


def unit_roundoff(dtype):
    import torch
    return torch.finfo(dtype).eps / 2


def bound(nbytes, ops, dtype, passes=0, dmma=False):
    """(ms, 'bytes' | 'operations'): the least time the card could take
    to move ``nbytes`` and do ``ops`` operations of ``dtype`` outside the
    tensor cores, or, with ``passes``, ``ops`` useful operations as that
    many TF32 passes; with ``dmma``, float64's on its tensor cores."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    label = str(dtype).split('.')[-1]
    if passes:
        t_ops = passes * ops / PEAK_OPS['tf32'] * 1e3
    else:
        t_ops = ops / PEAK_OPS['dmma' if dmma and label == 'float64'
                               else label] * 1e3
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


# the TF32 tensor-core kernels' designs by pass count (csrc/schur_tc.cu),
# printed beside kernels A's and D's records
TC_DESIGN = {3: 'schur_tc3_kernel: 128 x 128 tile, 4 stages of 32 k, each '
                'stage\'s products added into an IEEE accumulator',
             1: 'schur_tc1_kernel: 256 x 128 tile, 32 k a stage in 4 row '
                'and 5 column slots, one wgmma accumulator over the '
                'k-loop'}


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
    # each nvcc process's wall time (all started together; an older
    # checkout, timed in turns with this one, does not report them)
    for name, sec in sorted(info.get('nvcc', {}).items(),
                            key=lambda kv: -kv[1]):
        log(f'  nvcc {name}: {sec:.1f} s')
    # ptxas reports each kernel's spills, then its registers, after the
    # line that names it (mangled, in full: the template arguments at its
    # end tell the instantiations apart)
    for line in info['log'].splitlines():
        if 'Compiling entry function' in line:
            log(f'  ptxas: {line.split(chr(39))[1]}')
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
        if passes in TC_DESIGN:
            log(f'    {TC_DESIGN[passes]}')
        del got, tol
        ms = median_ms(lambda: _syrk.schur_update(B, A, precision=prec,
                                                  **args))
        bd = bound(nbytes, flops, dtype, passes, dmma=True)
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
    bd = bound(isz * (N * N / 2 + N * N), N ** 3 / 3, dtype, dmma=True)
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


def check_bwd_cols(what, G, X, amp, u):
    """Kernel C's fused backward at p = X.shape[1] > 1 (X both of K's
    arguments, the amp chain) against its plain version on the card, on
    the x and amp gradients, and against itself: two calls must agree to
    the bit.  Tolerance: the sums' order as at p = 1 (`bwd_bounds`),
    plus the p-term r² rounding of the forward's tolerance, 16 (p + 1) u,
    on each term.  Returns the max abs error."""
    import torch
    from lsqfitgp_torch.ops import gram_plain, gram_backward, \
        gram_backward_plain
    n, p = X.shape
    post = (('mul', amp),)
    got = gram_backward(G, 'expquad', X, post=post)
    again = gram_backward(G, 'expquad', X, post=post)
    for a, b in zip(got, again):
        if not torch.equal(a, b):
            fail(f'{what}: two calls differ')
    del again
    ref = gram_backward_plain(G, 'expquad', X, post=post)
    with torch.no_grad():
        # |C| + |C|ᵀ with C = G ∘ Wr: x is both of K's arguments
        Kb = gram_plain('expquad', X)
        A = G.abs() * (0.5 * amp) * Kb
        A = A + A.T
        tx = torch.stack([2 * (A * (X[:, d, None] - X[None, :, d]).abs())
                          .sum(1) for d in range(p)], 1)
        ta = (G.abs() * Kb).sum()
        del A, Kb
    rel = 16 * (p + 1) * u
    err = check_close(f'{what} dx', got[0] + got[1], ref[0] + ref[1],
                      (8 * math.sqrt(n) * u + rel) * tx)
    err = max(err, check_close(
        f'{what} damp', got[2][0], ref[2][0],
        (math.ceil(math.log2(n * n)) * 4 * u + rel) * ta))
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
    version on the card, at p = 1 and p = 8 (one launch each), and against
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
        lambda: gram_plain('expquad', x, post=post, noise=noise),
        'gram_kernel')
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
        lambda: gram_backward_plain(G, *args, **akw), 'gram_bwd_kernel')
    # G read once, the points read and the gradients written once; per
    # entry about 12 operations (r², the exp, the weight, three sums)
    bd_b = bound(isz * (N * N + 3 * N), 12 * N * N, dtype)
    log(f'  C backward {dtype}: fused kernel {ms_b:.3f} ms (the wrapper '
        f'{wrap_b:.3f} ms), plain {plain_b:.3f} ms, bound {bd_b[0]:.3f} ms '
        f'({bd_b[1]})')

    # p = 8: the staged coordinates, one launch
    G8 = torch.randn(N // 2, N // 2, **kw)
    check_bwd_cols(f'C gram backward p=8 {dtype}', G8, X8, amp, u)
    del G8, X8

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


def kernel_gram_p(dtype, gen, p):
    """Kernel C at p > 1 with the amp chain, forward and fused backward
    against their plain versions at 16384² (x both arguments), where
    each is timed: the records 'gram/p{p}' and 'gram_bwd/p{p}' ('/float64'
    appended in float64).  At p = 2 the derivative phase's value block
    (points of two fields on its square, also checked at its shape,
    N_DF x 2), whose launches the float32 records count; at p = MD_P the
    multidim phase's points (uniform on the unit cube), likewise."""
    import torch
    from lsqfitgp_torch.ops import (gram, gram_plain, gram_backward,
                                    gram_backward_plain)
    u = unit_roundoff(dtype)
    isz = torch.finfo(dtype).bits // 8
    amp = torch.tensor(1.3, device='cuda', dtype=dtype)
    post = (('mul', amp),)
    errs = []
    sizes = (N_DF, N) if p == 2 else (N,)
    for n in sizes:
        X = torch.rand(n, p, device='cuda', dtype=dtype, generator=gen)
        if p == 2:
            X = (X - 0.5) * 2 * DERIV_SPAN
        # tolerance as for C's p = 8 block: 16 (p + 1) u max|K|
        K = gram('expquad', X, post=post)
        Kp = gram_plain('expquad', X, post=post)
        err = check_close(f'C gram p={p} n={n} {dtype}', K, Kp,
                          16 * (p + 1) * u * float(Kp.abs().max()))
        del K, Kp
        G = torch.randn(n, n, device='cuda', dtype=dtype, generator=gen)
        err_b = check_bwd_cols(f'C gram backward p={p} n={n} {dtype}', G, X,
                               amp, u)
        errs.append((err, err_b))
    err, err_b = errs[-1]
    ms, plain_ms, wrap = gram_times(lambda: gram('expquad', X, post=post),
                                    lambda: gram_plain('expquad', X,
                                                       post=post),
                                    'gram_kernel')
    # the output written once and the p columns read for the rows and for
    # the columns; per entry p differences, p squares, p - 1 additions,
    # the exp's argument, the exp and the amp: 3 p + 2 operations
    bd = bound(isz * (N * N + 2 * N * p), (3 * p + 2) * N * N, dtype)
    log(f'  C p={p} {dtype}: kernel {ms:.3f} ms (the wrapper {wrap:.3f} '
        f'ms), plain {plain_ms:.3f} ms, bound {bd[0]:.3f} ms ({bd[1]}), '
        f'share {bd[0] / ms:.2f}')
    n0 = gram.launches_bwd
    gram_backward(G, 'expquad', X, post=post)
    if gram.launches_bwd != n0 + 1:
        fail(f'C backward p={p}: {gram.launches_bwd - n0} launches, '
             f'expected one for all coordinates')
    ms_b, plain_b, wrap_b = gram_times(
        lambda: gram_backward(G, 'expquad', X, post=post),
        lambda: gram_backward_plain(G, 'expquad', X, post=post),
        'gram_bwd_kernel')
    # G read once, the p columns read and the two gradients written once;
    # per entry the forward's 3 p + 2 operations, the weight and the amp
    # sum, and per coordinate a product and the row and column sums:
    # 6 p + 4
    bd_b = bound(isz * (N * N + 3 * N * p), (6 * p + 4) * N * N, dtype)
    log(f'  C backward p={p} {dtype}: fused kernel {ms_b:.3f} ms (the '
        f'wrapper {wrap_b:.3f} ms), plain {plain_b:.3f} ms, bound '
        f'{bd_b[0]:.3f} ms ({bd_b[1]}), share {bd_b[0] / ms_b:.2f}')
    del G, X
    label = str(dtype).split('.')[-1]
    suffix = '' if label == 'float32' else '/' + label
    # the path whose launches the record counts: the counters do not
    # tell p or the dtype apart, and no path runs p > 1 in float64
    path = ({2: 'deriv', MD_P: 'multidim'}[p] if label == 'float32'
            else None)
    rec = record(err, ms, plain_ms, bd, wrapper_ms=wrap)
    rec.update(name=f'gram/p{p}{suffix}', key='gram', counter='launches',
               dtype=label, path=path)
    rec_b = record(err_b, ms_b, plain_b, bd_b, wrapper_ms=wrap_b)
    rec_b.update(name=f'gram_bwd/p{p}{suffix}', key='gram_bwd',
                 counter='launches_bwd', dtype=label, path=path,
                 replaces=BWD_REPLACES['gram'])
    return [rec, rec_b]


def kernel_schur_gram(dtype, gen, zoo=None):
    """Kernel D at the top trailing update of the streaming factorization
    (size = h = offset = n/2, float32 at n = 65536 as on the streaming
    path, at each precision, a record each; float64 at n = 32768, the
    size whose plain version's temporaries fit the card): points on the
    path's scale, the smoke's post chain, eps, and a ragged nreal (the
    last 300 rows are pad).  With ``zoo``, the zoo profile of that name
    (`zoo_desc`) in place of the amp chain on ExpQuad, at the path's
    precision 'high' and in float64; where ZOO_BLOCK names it, the
    kernel is held to its plain version at n = 2 ZOO_BLOCK (the plain
    version timed there, ``plain_n`` in the record) and timed at n."""
    import torch
    from lsqfitgp_torch import ops
    from lsqfitgp_torch.ops import _syrk
    n = N_STREAM if dtype == torch.float32 else N_CHECK
    tile = 512
    kw = dict(device='cuda', dtype=dtype, generator=gen)

    def inputs(n):
        size = n // 2
        X = (torch.rand(n, 1, **kw) - 0.5) * (400 * n / N_STREAM)
        A = torch.randn(size, size, **kw) / math.sqrt(size)
        return X, A, dict(nreal=n - 300, size=size, offset=size, tile=tile)

    amp = torch.tensor(1.3, device='cuda', dtype=dtype)
    eps = torch.tensor(NOISE_VAR, device='cuda', dtype=dtype)
    prof, post = 'expquad', (('mul', amp),)
    k0 = 1.3
    if zoo is not None:
        prof, post = zoo_desc(zoo, dtype), ()
        k0 = float(ops.k0(prof, like=eps))
    nc = 2 * ZOO_BLOCK[zoo] if zoo in ZOO_BLOCK else n
    X, A, geom = inputs(nc)
    args = dict(post=post, eps=eps, **geom)
    size = h = geom['size']
    ref = _syrk.schur_update_gram_plain(prof, X, A, **args)
    reps = 3
    plain_ms = median_ms(
        lambda: _syrk.schur_update_gram_plain(prof, X, A, **args), reps)
    # tolerance: the kernel sums the h products into an accumulator that
    # starts at the Gram entry, so each rounding is relative to a partial
    # sum bounded by |K_ij + eps| + (|A||A|ᵀ)_ij: 4 sqrt(h) u times that
    # (a probabilistic bound for sums taken in another order), plus
    # 16 u (amp + eps) for the Gram entry itself (exp differs by a few
    # ulps between the two implementations; r² is computed identically;
    # a zoo profile, by another formula, 32 u (k(0) + eps) times its
    # `zoo_amp`); the TF32 passes add their per-product rounding
    # (tc_extra) times (|A||A|ᵀ)_ij
    u = unit_roundoff(dtype)
    Aa = A.abs()
    S = torch.mm(Aa, Aa.T)
    del Aa
    mask = _syrk._tile_mask(size, tile, A.device)
    variants = PRECISIONS if dtype == torch.float32 else FLOAT64
    if zoo is not None:
        variants = variants[:1]
    entry = (16 if zoo is None else 32 * zoo_amp(zoo, dtype)) * u \
        * (k0 + NOISE_VAR)
    errs = {}
    for precision, source, passes, counter in variants:
        prec = None if precision == 'float64' else precision
        got = _syrk.schur_update_gram(prof, X, A, precision=prec, **args)
        got.masked_fill_(~mask, 0)
        tol = (S + (k0 + NOISE_VAR)).mul_(4 * math.sqrt(h) * u) \
            .add_(S, alpha=tc_extra(passes)).add_(entry)
        errs[precision] = check_close(
            f'D schur_update_gram n={nc} {dtype} {precision}', got, ref, tol)
        bias = float(((got.diagonal() - ref.diagonal()) / S.diagonal())
                     .mean())
        log(f'    mean (got - plain) / (|A||A|ᵀ) on the diagonal: '
            f'{bias:.3e}')
        if passes in TC_DESIGN:
            log(f'    {TC_DESIGN[passes]}')
        del got, tol
    del ref, S
    if nc != n:
        X, A, geom = inputs(n)
        args = dict(post=post, eps=eps, **geom)
        size = h = geom['size']
    # useful work: the lower 512-tiles, 2h flops per entry (the in-tile
    # Gram, ~5 operations per entry, or the zoo core's `zoo_ops`, beside
    # it); A read once, the lower tiles written once
    f = lower_fraction(size, tile)
    nbytes = A.element_size() * (size * h + f * size * size)
    core = 5 if zoo is None else zoo_ops(zoo, dtype, X)[0]
    flops = f * size * size * (2 * h + core)
    records = []
    for precision, source, passes, counter in variants:
        prec = None if precision == 'float64' else precision
        ms = median_ms(lambda: _syrk.schur_update_gram(
            prof, X, A, precision=prec, **args), reps)
        bd = bound(nbytes, flops, dtype, passes, dmma=True)
        at = '' if nc == n else f' (plain at n = {nc})'
        log(f'  D {dtype} {precision}: kernel {ms:.3f} ms, plain '
            f'{plain_ms:.3f} ms{at}, bound {bd[0]:.3f} ms ({bd[1]}), '
            f'{2 * f * size * size * h / ms / 1e9:.1f} TFLOP/s useful')
        rec = record(errs[precision], ms, plain_ms, bd, precision=precision,
                     dtype=str(dtype), source='lsqfitgp_torch/csrc/' + source,
                     counter=counter)
        if nc != n:
            rec['plain_n'] = nc
        if zoo is not None:
            rec.update(profile=ZOO_KEYS[zoo],
                       path=ZOO_PATHS.get(zoo) if dtype == torch.float32
                       else None)
        records.append(rec)
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
        lambda: gram_sym_plain('expquad', x, post=post), 'gram_sym_kernel')
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
        lambda: gram_sym_backward_plain(G, 'expquad', x, **akw),
        'gram_sym_bwd_kernel')
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


def tangent_path_args(x, dx, amp, damp, dnoise, profile='expquad'):
    """(X, dX, st, fv, dfv, one, coef): the points and their tangent as
    (n, 1), the profile's structure, the folded parameter vector of the
    amp chain and the nugget and its tangent, the profile's one term and
    C″'s coefficients [α, dα], as the autograd Functions hand them to the
    tangent kernels."""
    import torch
    from lsqfitgp_torch.ops import _gram
    X = x[:, None]
    _, st, _, _, pvec = _gram._args(profile, X, None, (('mul', amp),),
                                    amp.new_tensor(NOISE_VAR))
    dpvec = torch.zeros_like(pvec)
    dpvec[-2], dpvec[-1] = damp, dnoise
    fv, dfv = torch.func.jvp(lambda q: _gram._fold(st, q), (pvec,),
                             (dpvec,))
    one = _gram._Single(st, fv)
    return X, dx[:, None], st, fv, dfv, one, torch.stack([fv[2], dfv[2]])


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


# FP64 instructions outside the tensor cores, each one slot of the FP64
# pipe (a DFMA two of the peak's operations)
FP64_SIMT = ('DFMA', 'DADD', 'DMUL', 'DSETP', 'DMNMX')
# the 1.5 2^52 shift that rounds x / ln 2 in a float64 exponential
# (csrc/special.cuh dexp_nonpos, as CUDA's exp), once per entry of C″
EXP_SHIFT = '6.755399441055744'


def sass_fp64_per_exp(*parts):
    """FP64 SIMT instructions per float64 exponential in the SASS of the
    built kernel whose mangled name holds every string of ``parts``
    (cuobjdump on the library, the name from ptxas's log beside it):
    the kernel's FP64 instructions over the number of exponentials in its
    code, which counts the entry loop's copies however the compiler
    unrolled it (its prologue and epilogue's few sums add to the count).
    None where cuobjdump or the kernel is not found."""
    import shutil
    from lsqfitgp_torch import ops
    path = ops.build_info()['path']
    log = path[:-3] + '.log'
    names = []
    if os.path.exists(log):
        names = [line.split("'")[1] for line in open(log)
                 if 'Compiling entry function' in line]
    names = [n for n in names if all(p in n for p in parts)]
    exe = shutil.which('cuobjdump') or '/usr/local/cuda/bin/cuobjdump'
    if not names or not os.path.exists(exe):
        return None
    try:
        sass = subprocess.run([exe, '-sass', '-fun', names[0], path],
                              capture_output=True, text=True,
                              timeout=300).stdout
    except subprocess.TimeoutExpired:
        return None
    ops_ = [line.split()[1] if line.split()[1][0] != '@' else
            line.split()[2] for line in sass.splitlines()
            if line.strip().startswith('/*') and len(line.split()) > 2]
    fp64 = sum(o.split('.')[0] in FP64_SIMT for o in ops_)
    exps = sum(EXP_SHIFT in line and 'DFMA' in line
               for line in sass.splitlines())
    return fp64 / exps if exps else None


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
    X, dX, st, fv, dfv, one, coef = tangent_path_args(x, dx, amp, damp,
                                                      dnoise)
    ms = device_ms(lambda: _gram._tangent(st, X, X, dX, dX, fv, dfv, True),
                   kernel='gram_jvp_kernel')
    plain_ms = device_ms(
        lambda: _gram._tangent_plain(st, X, X, dX, dX, fv, dfv, True))
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
    ms_b = device_ms(lambda: _gram._bwd_tangent(G, one, X, X, dX, dX,
                                                coef, True, True),
                     kernel='gram_bwd_jvp_kernel')
    plain_b = device_ms(lambda: _gram._bwd_tangent_plain(
        G, one, X, X, dX, dX, coef, True, True))
    wrap_b = median_ms(
        lambda: gram_backward_jvp(G, 'expquad', x, None, dx, **bkw),
        batch=GRAM_BATCH)
    # G read once; the points, their tangents and the sums' slots; in
    # float64 the FP64 instructions an entry from the SASS, each two
    # operations at the FP64 SIMT rate (else 20 operations an entry)
    per_entry = None
    if dtype == torch.float64:
        per_entry = sass_fp64_per_exp('gram_bwd_jvp_kernelId',
                                      '12FixedExpQuadIdEELb1ELb1ELb1')
        log(f'    C\'\' {dtype}: FP64 instructions an entry (SASS): '
            f'{per_entry}')
    ops_b = 20 * N * N if per_entry is None else 2 * per_entry * N * N
    bd_b = bound(isz * (N * N + 4 * N), ops_b, dtype)
    bd_bytes = bound(isz * (N * N + 4 * N), 0, dtype)[0]
    bd_ops = bound(0, ops_b, dtype)[0]
    log(f'  C\'\' {dtype}: kernel {ms_b:.3f} ms (the wrapper {wrap_b:.3f} '
        f'ms), plain {plain_b:.3f} ms, bound {bd_b[0]:.3f} ms ({bd_b[1]}; '
        f'bytes {bd_bytes:.4f}, operations {bd_ops:.4f} ms)')
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
    X, dX, st, fv, dfv, one, coef = tangent_path_args(x, dx, amp, damp,
                                                      dnoise)
    ms = device_ms(lambda: _gram._sym_tangent(st, X, dX, fv, dfv, True),
                   kernel='gram_sym_jvp_kernel')
    plain_ms = device_ms(
        lambda: _gram._tangent_plain(st, X, X, dX, dX, fv, dfv, True))
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
    ms_b = device_ms(lambda: _gram._sym_bwd_tangent(G, one, X, dX, coef,
                                                    True, True),
                     kernel='gram_sym_bwd_jvp_kernel')
    plain_b = device_ms(lambda: _gram._sym_bwd_tangent_plain(
        G, one, X, dX, coef, True, True))
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


# -- the zoo's profiles in kernels C, D and E ------------------------------------

# the zoo records' profiles: the Matérn path's, the multiscale paths' term
# sum, three more cores of the zoo and a four-term sum (kernel phase
# only), each with the
# records' p (the isotropic cores also at the multidim cell's p) and the
# operations per entry beside r²'s 3 p, counted from profiles.cuh (a sqrt,
# exp or log one each): the forward's core and chain, the backward's core
# with its derivatives, weight and parameter sums
ZOO_RECORDS = {'maternp2': ((1, MD_P), 9, 22), 'expon': ((1,), 6, 16),
               'gammaexp': ((1, MD_P), 8, 22), 'cauchy': ((1, MD_P), 11, 30),
               'terms': ((1, MD_P), 17, 44), 'terms4': ((1,), 29, 76)}
# the 1-D time-series cores and the rest of the 'abs'/'posabs' zoo (their
# forward's core with the mode's square root and the chain; the
# backward's core with its two derivatives, the chain rule, the weight
# and the parameter sums), at p = 1, and at the multidim cell's p the two
# without maxdim 1
TS_RECORDS = {'celerite': ((1,), 10, 30), 'periodic': ((1,), 9, 26),
              'harmonic2': ((1,), 16, 42), 'harmonic04': ((1,), 16, 42),
              'cos': ((1,), 5, 14), 'sinc': ((1,), 9, 24),
              'holeeffect': ((1,), 7, 18), 'causalexpquad': ((1, MD_P), 9, 28),
              'log': ((1, MD_P), 7, 20), 'wendland': ((1,), 25, 64),
              'circular': ((1,), 16, 42)}
ZOO_RECORDS.update(TS_RECORDS)
# the last spec-carrying cores (StationaryFracBrownian, the real-order
# Matérn and Bessel, Pink, Color) at p = 1, Bessel at p = 2 (within its
# maxdim) and Matérn-ν at the multidim cell's p: their operations per
# entry depend on the branch each entry takes (`zoo_ops`)
CORE_RECORDS = {'sfb': ((1,), None, None), 'sfbpath': ((1,), None, None),
                'matern': ((1, MD_P), None, None),
                'matern07': ((1, MD_P), None, None),
                'bessel': ((1, 2), None, None), 'pink': ((1,), None, None),
                'color': ((1,), None, None)}
# the order of the real-order Matérn record besides the evidence path's
# (EV_NU): 0.7, whose first derivative takes the raw form's table (ν ≤ 1)
ZOO_NU = {'matern07': 0.7}
ZOO_RECORDS.update(CORE_RECORDS)
# the block at which a record's plain version is held and timed where
# its broadcast temporaries at N² would not fit the card (the
# quadrature's (n², 100) nodes, Bessel's (n², 40) series terms, the
# continued fraction's complex steps, the series' and Ci's dozens of n²
# temporaries) or would take seconds; the kernel is timed at N²
ZOO_BLOCK = {'matern': 2048, 'matern07': 2048, 'bessel': 4096, 'color': 4096,
             'sfb': 4096, 'sfbpath': 4096, 'pink': 4096}
# the launch tallies' profile key of each (ops.gram.by_profile), and the
# path whose launches its float32 p = 1 records count
ZOO_KEYS = {'maternp2': 'maternp', 'expon': 'expon', 'gammaexp': 'gammaexp',
            'cauchy': 'cauchy', 'terms': 'maternp+expquad',
            'terms4': 'expquad+periodic+cauchy2+maternp',
            **{name: name for name in TS_RECORDS},
            'harmonic2': 'harmonic', 'harmonic04': 'harmonic',
            **{name: name for name in CORE_RECORDS}, 'matern07': 'matern',
            'sfbpath': 'sfb'}
ZOO_PATHS = {'maternp2': 'matern', 'terms': 'multiscale',
             'celerite': 'timeseries', 'sfb': 'hurst', 'sfbpath': 'hurst',
             'matern': 'evidence'}
# the multiscale model's point (log a1, log s1, log a2, log s2)
MS_POINT = [0.0, 0.3, -0.7, 1.6]


# the calls over which a zoo record's plain version is timed (3 until
# the last five cores' records joined the run)
ZOO_PLAIN_CALLS = 1


def zoo_desc(name, dtype, amp=1.3):
    """A zoo profile as ``ops.gram`` takes it, its numbers on the card:
    Matérn-5/2, the exponential ('abs' mode), GammaExp with a dynamic
    γ, Cauchy with dynamic α and β, the time-series path's Celerite(γ,
    B), the other cores of TS_RECORDS with dynamic arguments and those
    of CORE_RECORDS (each times ``amp``; 'sfbpath' is 'sfb' on the
    Hurst path's points, `record_points`), the multiscale path's term
    sum a1 Maternp(p=2, s1) + a2 ExpQuad(s2) at MS_POINT and a four-term
    sum of mixed modes ('terms4')."""
    import torch
    from lsqfitgp_torch import ops
    P, T, S = ops.PROFILES, ops.Term, ops.Terms

    def t(v):
        return torch.tensor(v, device='cuda', dtype=dtype)

    chain = (('mul', t(amp)),)
    if name == 'terms':
        a1, s1, a2, s2 = (math.exp(v) for v in MS_POINT)
        return S((T(P['maternp'], k=2, scale=t(s1), post=(('mul', t(a1)),)),
                  T(P['expquad'], scale=t(s2), post=(('mul', t(a2)),))))
    if name == 'terms4':
        # a long trend, a seasonal term of period 1, a medium-term
        # rational quadratic (α dynamic) and a short-term Matérn-3/2: the
        # four components of Rasmussen and Williams' Mauna Loa model
        # (§5.4.3), its products left out, each with its amplitude
        return S((T(P['expquad'], scale=t(20.0), post=(('mul', t(1.0)),)),
                  T(P['periodic'], 'abs', args=(t(1.4),),
                    scale=t(1 / (2 * math.pi)), post=(('mul', t(0.5)),)),
                  T(P['cauchy2'], args=(t(0.8),), scale=t(3.0),
                    post=(('mul', t(0.3)),)),
                  T(P['maternp'], k=1, scale=t(0.5),
                    post=(('mul', t(0.1)),))))
    term = {'maternp2': T(P['maternp'], k=2),
            'expon': T(P['expon'], 'abs'),
            'gammaexp': T(P['gammaexp'], args=(t(1.3),)),
            'cauchy': T(P['cauchy'], args=(t(1.4), t(0.8))),
            # the time-series path's (γ, B) and the rest, every argument
            # dynamic; Wendland (k = 2) scaled to the span
            'celerite': T(P['celerite'], 'abs',
                          args=(t(TS_TRUE['gamma']), t(TS_TRUE['B']))),
            'periodic': T(P['periodic'], 'abs', args=(t(1.4),)),
            'harmonic2': T(P['harmonic'], 'abs', args=(t(2.0),)),
            'harmonic04': T(P['harmonic'], 'abs', args=(t(0.4),)),
            'cos': T(P['cos'], 'abs'),
            'sinc': T(P['sinc'], 'posabs'),
            'holeeffect': T(P['holeeffect'], 'abs'),
            'causalexpquad': T(P['causalexpquad'], 'posabs',
                               args=(t(1.7),)),
            'log': T(P['log'], 'posabs'),
            'wendland': T(P['wendland'], 'posabs', k=2, args=(t(1.6),),
                          scale=t(50.0)),
            'circular': T(P['circular'], 'posabs',
                          args=(t(4.5), t(0.4))),
            # the Hurst path's H (dynamic) and the evidence path's ν
            # (static, the term's argument without a gradient); Bessel's
            # ν, Pink's δω (dynamic), Color's n
            'sfb': T(P['sfb'], 'abs', args=(t(HURST_TRUE['H']),)),
            'sfbpath': T(P['sfb'], 'abs', args=(t(HURST_TRUE['H']),)),
            'matern': T(P['matern'], args=(EV_NU,)),
            'matern07': T(P['matern'], args=(ZOO_NU['matern07'],)),
            'bessel': T(P['bessel'], args=(1.0,)),
            'pink': T(P['pink'], 'abs', args=(t(1.5),)),
            'color': T(P['color'], 'abs', k=3)}[name]
    return S((term,), chain)


# the operations per entry of the Matérn-ν core by its table besides its
# Clenshaw sums (forward, backward): x = √x², the panel from its bits,
# the exponential and the rounding's correction, the chain; the
# backward's second value, its recurrence, the weight and the parameter
# sums
MTAB_OPS = (20, 30)
# the operations per entry of StationaryFracBrownian's series from t = 2
# on at J(t) = 1 (csrc/profiles.cuh sfb_core; forward, backward): the
# mode's square root, z = t^-2, log t, t^(alpha - 2), J's bucket and
# lookup, the product and the chain; the backward's two more products,
# the chain rule, the weight and the parameter sums.  Each further term
# is a Horner step of each sum (one forward; three backward: g, g' and
# the H-derivative).  Below t = 2 the three powers (10, 27).
SFB_OPS = (20, 40)


def zoo_ops(name, dtype, X):
    """(forward, backward) operations per Gram entry of a zoo record's
    core: ZOO_RECORDS's counts, or for CORE_RECORDS the counts of the
    device code's branches (csrc/profiles.cuh, csrc/special.cuh),
    weighted by the share of this record's entries that take each (on
    256 rows of the points X): StationaryFracBrownian's three powers
    below t = 2 and its series above (`SFB_OPS` and a Horner step for
    each term past the first of J(t), ``ops.sfb_terms``, of its
    forward's and its backward's sums); Matérn-ν's table
    from x = 2^E_LO on (`MTAB_OPS`: the panel's Clenshaw sum, 2 a
    coefficient, and about 20 more, a square root and an exponential
    among them; the backward two sums and its weight and sums) and below
    it the 100-node quadrature, about 20 operations a node (a cosh, a
    log1p, two exponentials), once forward and twice backward (at every
    entry before the tables: 2020, 4050); Bessel's 40-term
    series below its cut (x = 8 or 20) or its 20-term Hankel expansion,
    once forward and twice backward; Pink's two cosine integrals
    (rational functions of about 20 operations below 4, 70 with the
    auxiliary functions above); Color's 40-term series for each order
    (three backward) below t = 1, its 130 complex Lentz steps of about
    34 operations above.  A special function counts as one operation, so
    the bound is a least time."""
    import torch
    _, fwd, bwd = ZOO_RECORDS[name]
    if fwd is not None:
        return fwd, bwd
    if ZOO_KEYS[name] == 'matern':
        from lsqfitgp_torch.ops import _mtable
        elo, _, nc, _ = _mtable.layout(dtype)
        nu = ZOO_NU.get(name, EV_NU)
        x = math.sqrt(2 * nu) * torch.cdist(X[:256], X).flatten()
        f = float(((x > 0) & (x < 2.0 ** elo)).double().mean())
        fwd, bwd = MTAB_OPS[0] + 2 * nc, MTAB_OPS[1] + 4 * nc
        return f * 2020 + (1 - f) * fwd, f * 4050 + (1 - f) * bwd
    f64 = dtype == torch.float64
    cut = 20.0 if f64 else 8.0
    d = torch.cdist(X[:256], X).flatten()
    if ZOO_KEYS[name] == 'sfb':
        from lsqfitgp_torch import ops
        far = d >= 2
        more = [float(ops.sfb_terms(d[far].to(dtype), kind).double()
                      .mean()) - 1 for kind in (0, 1)]
        f = float((~far).double().mean())
        return (f * 10 + (1 - f) * (SFB_OPS[0] + more[0]),
                f * 27 + (1 - f) * (SFB_OPS[1] + 3 * more[1]))
    mask, lo, hi = {
        'bessel': (2.5 * d < cut, (205, 410), (150, 300)),
        'pink': (2.5 * d <= 4, (50, 60), (150, 170)),
        'color': (d < 1, (250, 750), (4425, 4440))}[name]
    f = float(mask.double().mean())
    return tuple(f * a + (1 - f) * b for a, b in zip(lo, hi))


def zoo_amp(name, dtype):
    """The factor by which a zoo record's rounding tolerance, 32 (p + 1)
    u of the largest entry, grows with its core's cancellation (1 for the
    closed forms): Bessel's alternating series in float64, whose terms
    reach I_0(x) in sum at the cut x = 20, each in the plain version the
    exponential of a logarithm of size ~x: 20 I_0(20) (the float32
    kernel, which sums its series in float64, is held to the float64
    plain version, `bessel_truth`: 1); Pink's difference of two cosine
    integrals of size |log t| over log1p(δω) near t = 0: 64; the
    quadrature's exponent of up to 45 and the continued fraction's 130
    complex steps: 4.  The `gpu` tests' `_CANCEL` holds other numbers
    because it scales another tolerance, 1e-4 (float32) or 1e-12
    (float64) of each entry, at other points (x ≤ 10)."""
    import numpy as np
    import torch
    if name == 'bessel':
        return 20.0 * float(np.i0(20.0)) if dtype == torch.float64 else 1.0
    return {'pink': 64.0, 'matern': 4.0, 'matern07': 4.0,
            'color': 4.0}.get(name, 1.0)


def bessel_truth(name, dtype):
    """Whether a zoo record holds its kernel to the float64 plain version:
    Bessel in float32, whose plain series (each term the exponential of
    its logarithm, as the JAX package's) errs by ~I_0(8) u near the cut,
    hundreds of times what the kernel, which sums it in float64, errs."""
    import torch
    return name == 'bessel' and dtype == torch.float32


def check_typical(what, tol, K):
    """Fail unless the tolerance ``tol`` of a zoo record with a large
    `zoo_amp` stays below a hundredth of the median |entry| of K: a
    kernel that zeroed the entries past the series' cut would then
    fail."""
    import torch
    med = float(K.abs().median())
    log(f'    {what}: tolerance {tol:.3e}, median |entry| {med:.3e}')
    if not tol <= 1e-2 * med:
        fail(f'{what}: the tolerance is not below a hundredth of a typical '
             f'entry')


def matern_rel_tol(name, dtype, p, r2):
    """The per-entry relative tolerance of a Matérn-ν record's kernel
    against the float64 plain version at the float64 squared distances
    ``r2``: 4 (p + 1) (1 + x + ν |log x|) eps + 4e-14, x = √(2ν r²).
    The table is within 4 eps (float32) or 2e-14 (float64) of f at the
    kernel's argument, whose x² rounds by about (p + 3) u in r² and the
    scaling (moving f by x/2 times that), and the float64 quadrature is
    within 2e-14 + 1.5 (x + ν |log x|) eps₆₄ (ops/_mtable.py); below the
    tables and above NU_MAX the kernel's own quadrature, whose exponent
    rounds to about (x + ν |log x|) eps."""
    import torch
    nu = ZOO_NU.get(name, EV_NU)
    x = (2 * nu * r2).sqrt()
    lx = torch.where(x > 0, x.log().abs(), torch.zeros_like(x))
    eps = torch.finfo(dtype).eps
    return 4 * (p + 1) * (1 + x + nu * lx) * eps + 4e-14


def check_entries(what, got, ref, tol, dtype):
    """Fail unless each entry of ``got`` is within ``tol`` (relative, per
    entry) of the float64 ``ref`` wherever |ref| is at least the dtype's
    smallest normal number (a kernel that zeroed or misplaced any panel
    of its tables would fail); returns the largest error over its
    tolerance."""
    import torch
    tiny = torch.finfo(dtype).tiny
    ok = ref.abs() >= tiny
    rel = (got.double() - ref).abs() / ref.abs().clamp_min(tiny)
    worst = float((rel / tol)[ok].max())
    log(f'    {what}: per entry, the largest error is {worst:.3f} of its '
        f'relative tolerance ({int(ok.sum())} entries)')
    if not worst <= 1:
        fail(f'{what}: an entry beyond its relative tolerance '
             f'({worst:.3f} of it)')
    return worst


def matern_probe(name, dtype, p):
    """Kernel C and its fused backward on a Matérn-ν record's core over
    the whole of its tables: 4096 points along the first axis at
    log-uniform x from 2^-13 (below the tables) to past the dtype's
    underflow point (120 in float32, 760 in float64: every panel, the
    split exponential from 80 or 700 and the tables' end), against the
    origin; each entry, and each entry's x-gradient (the backward with G
    all ones on one column), against the float64 plain version within
    `matern_rel_tol`."""
    import torch
    from lsqfitgp_torch.ops import gram, gram_plain, _gram
    nu = ZOO_NU.get(name, EV_NU)
    xend = 120.0 if dtype == torch.float32 else 760.0
    x = torch.exp(torch.linspace(math.log(2.0 ** -13), math.log(xend), 4096,
                                 device='cuda', dtype=torch.float64))
    X = torch.zeros(4096, p, device='cuda', dtype=dtype)
    X[:, 0] = (x / math.sqrt(2 * nu)).to(dtype)
    Y = torch.zeros(1, p, device='cuda', dtype=dtype)
    X64, Y64 = X.double(), Y.double()
    desc, desc64 = zoo_desc(name, dtype), zoo_desc(name, torch.float64)
    r2 = _gram._sqdist_plain(X64, Y64)
    tol = matern_rel_tol(name, dtype, p, r2)
    what = f'C gram {name} p={p} {dtype} over the tables'
    check_entries(what, gram(desc, X, Y), gram_plain(desc64, X64, Y64), tol,
                  dtype)
    _, st, _, _, pvec = _gram._args(desc, X, Y, (), None)
    fv = _gram._fold(st, pvec)
    G = torch.ones(4096, 1, device='cuda', dtype=dtype)
    gx = _gram._backward(G, st, X, Y, fv, False, True, False)[0]
    ref = _gram._backward_plain(G.double(), st, X64, Y64, fv.double(), False,
                                True, False)[0]
    check_entries(f'C gram backward {name} p={p} {dtype} over the tables',
                  gx[:, :1], ref[:, :1], tol, dtype)


def zoo_points(p, n, dtype, gen):
    """The records' points: the dense path's span at p = 1, the unit cube
    (the multidim cell's) at p > 1."""
    import torch
    X = torch.rand(n, p, device='cuda', dtype=dtype, generator=gen)
    return (X - 0.5) * 100 if p == 1 else X


def record_points(name, p, n, dtype, gen):
    """A zoo record's points: `zoo_points`, but for 'sfbpath' the Hurst
    path's, t = 0 … n−1 (lags to n − 1; its launches come from there)."""
    import torch
    if name == 'sfbpath':
        return torch.arange(n, device='cuda', dtype=dtype)[:, None]
    return zoo_points(p, n, dtype, gen)


# the 'sfb' records' per-entry tolerance, in eps of each entry's scale
# (`sfb_scales`), as tests/test_torch_randomwalk.py holds the plain
# version in float32; and the number of lags at which the backward is
# held entry by entry
SFB_REL, SFB_LAGS = 16, 192


def sfb_scales(t, H, amp):
    """The scales of 'sfb' entries at the float64 lags t, times ``amp``:
    of the value, |H(2H−1)| t^(2H−2) (the leading term of its series) from
    t = 2 on and (1 + t)^2H below (the three powers'); of the
    t-derivative, that times (1 + |2H − 2|)/t, and 2H (1 + t)^2H below;
    of the H-derivative, 2 (|2H − ½| + |H(2H−1)| log t) t^(2H−2) (the
    leading term's, dC(2H, 2)/d(2H) = 2H − ½) and 2 (1 + t)^2H (1 +
    log(1 + t)) below."""
    import torch
    a = 2 * H
    c1 = abs(H * (2 * H - 1))
    far = t >= 2
    tf = t.clamp(min=2)
    p = tf ** (a - 2)
    lo = (1 + t) ** a
    value = torch.where(far, c1 * p, lo)
    dt = torch.where(far, c1 * p * (1 + abs(a - 2)) / tf, a * lo)
    dh = torch.where(far, 2 * (abs(a - 0.5) + c1 * tf.log()) * p,
                     2 * lo * (1 + (1 + t).log()))
    return amp * value, amp * dt, amp * dh


def check_scaled(what, got, ref, tol):
    """Fail unless |got − ref| <= tol at every entry; log the largest
    error over its tolerance and return the max abs error."""
    err = (got.double() - ref).abs()
    worst = float((err / tol).max())
    log(f'    {what}: per entry, the largest error is {worst:.3f} of its '
        f'tolerance ({err.numel()} entries)')
    if not worst <= 1:
        fail(f'{what}: an entry beyond {SFB_REL} eps of its scale '
             f'({worst:.3f} of it)')
    return float(err.max())


def sfb_divergence(name, dtype, X):
    """How far J(t) and the t < 2 branch part a warp's lanes in kernel C
    on an 'sfb' record, computed on the host from the points and the
    kernel's lane layout (csrc/gram.cu Geo: a thread owns V adjacent
    columns of every TY-th row of a 64 × 64 tile; a warp's 32 lanes are
    32 / TX rows of TX column groups, entry k of each group at a time), on
    three 64-row tiles (top, middle, bottom) against all columns: the
    share of entries below t = 2 beside the share of warp steps with a
    lane there (which all then take the three powers' time), and the mean
    J(t) beside the mean over warp steps of the largest; logged."""
    import torch
    from lsqfitgp_torch import ops
    v = 16 // (torch.finfo(dtype).bits // 8)
    tx = 64 // v
    ty, lanes = 256 // tx, 32 // tx
    n = X.shape[0]

    def warps(a):
        a = a.reshape(64 // ty, ty // lanes, lanes, n // 64, tx, v)
        return a.permute(0, 1, 3, 5, 2, 4).reshape(-1, 32)

    out = []
    for i0 in (0, n // 128 * 64, n - 64):
        t = (X[i0:i0 + 64, :1] - X[:, 0]).abs().double()
        J = ops.sfb_terms(t.clamp(min=2).to(dtype), 0).double()
        small = warps((t < 2).double())
        out.append((float(small.mean()), float(small.amax(1).mean()),
                    float(J[t >= 2].mean()),
                    float(warps(torch.where(t < 2, 0 * J, J)).amax(1)
                          .mean())))
    m = [statistics.mean(c) for c in zip(*out)]
    log(f'    {name} {dtype}: entries below t = 2 {m[0]:.4f}, warp steps '
        f'with such a lane {m[1]:.4f}; mean J(t) {m[2]:.3f}, mean over '
        f'warp steps of the largest {m[3]:.3f} (host, from the points)')


def sfb_entries(name, dtype, X, nb):
    """The 'sfb' records' per-entry checks against the float64 plain
    version, within SFB_REL eps of each entry's scale (`sfb_scales`):
    kernel C's values on the block of the first ``nb`` points and on the
    first and last 128 rows against all of X (every lag of the path
    record), and the fused backward's per-entry H-derivative and
    x-gradient, one 1 × 1 Gram at a time (G = 1: the gradient is the
    entry's), at SFB_LAGS lags |X_0 − X_k|, k log-spaced over the points.
    These see a truncated series, which the absolute check of the
    largest entry does not at the path's lags (its tolerance is about a
    hundred times the entries there)."""
    import torch
    from lsqfitgp_torch.ops import gram, gram_plain, _gram
    H, amp = HURST_TRUE['H'], 1.3
    tol = SFB_REL * torch.finfo(dtype).eps
    desc, desc64 = zoo_desc(name, dtype), zoo_desc(name, torch.float64)
    n = X.shape[0]
    X64 = X.double()
    rows = torch.cat([torch.arange(128), torch.arange(n - 128, n)]).to(
        X.device)
    for label, a, b in (('block', X[:nb], X[:nb]), ('rows', X[rows], X)):
        t = _gram._sqdist_plain(a.double(), b.double()).sqrt()
        check_scaled(f'C gram {name} {dtype} ({label}, the float64 plain '
                     f'version)', gram(desc, a, b),
                     gram_plain(desc64, a.double(), b.double()),
                     tol * sfb_scales(t, H, amp)[0])
    ks = torch.unique(torch.logspace(0, math.log10(n - 1), SFB_LAGS).round()
                      .long()).tolist()
    _, st, _, _, pvec = _gram._args(desc, X[:1], None, (), None)
    fv = _gram._fold(st, pvec).detach()
    one = torch.ones(1, 1, device=X.device, dtype=dtype)
    got, ref = [], []
    for k in ks:
        gx, _, gf = _gram._backward(one, st, X[:1], X[k:k + 1], fv, False,
                                    True, True)
        got.append(torch.stack([gx[0, 0], gf[4]]))
        gx, _, gf = _gram._backward_plain(one.double(), st, X64[:1],
                                          X64[k:k + 1], fv.double(), False,
                                          True, True)
        ref.append(torch.stack([gx[0, 0], gf[4]]))
    got, ref = torch.stack(got), torch.stack(ref)
    t = (X64[ks, 0] - X64[0, 0]).abs()
    _, dt, dh = sfb_scales(t, H, amp)
    err = check_scaled(f'C gram backward {name} {dtype}: dK/dH',
                       got[:, 1], ref[:, 1], tol * dh)
    check_scaled(f'C gram backward {name} {dtype}: dK/dx', got[:, 0],
                 ref[:, 0], tol * dt)
    return err


def took(fn, attr, call):
    """The evaluator (csrc/profiles.cuh) of the launches that ``call()``
    made on the wrapper ``fn``'s counter ``attr``, by its
    ``by_evaluator`` tally ('ZooOne', 'Zoo', ...)."""
    before = dict(fn.by_evaluator)
    call()
    return '+'.join(ev for (a, ev), c in sorted(fn.by_evaluator.items())
                    if a == attr and c > before.get((a, ev), 0))


def zoo_record(rec, kind, name, p, dtype, counter):
    label = str(dtype).split('.')[-1]
    suffix = ('' if p == 1 else f'/p{p}') + \
        ('' if label == 'float32' else '/' + label)
    path = ZOO_PATHS.get(name) if (p == 1 and label == 'float32') else None
    rec.update(name=f'{kind}/{name}{suffix}', key=kind, counter=counter,
               dtype=label, path=path, profile=ZOO_KEYS[name])
    if kind.endswith('_bwd'):
        rec['replaces'] = BWD_REPLACES[kind[:-4]]
    return rec


def zoo_bwd_check(what, st, X, fv, G, dtype, amp=1.0, truth64=False):
    """Kernel C's fused backward on a zoo profile (x both of K's
    arguments) against its plain version on the card (with
    ``truth64``, in float64 on the same inputs), and against itself
    to the bit: the x gradient within (8 sqrt(n) u + 32 (p + 1) u) times
    the sums of |G Wr Δ| over rows and columns (`check_bwd_cols`'s, with
    the profile's evaluation by another formula, 32 (p + 1) u of each
    term); each slot of the folded parameter vector's gradient within
    (ceil(log2(n²)) 4 u + 32 (p + 1) u) Σ|G ∂K/∂θ|, the per-term part
    times ``amp`` (`zoo_amp`).  Returns the max abs error."""
    import torch
    from lsqfitgp_torch.ops import _gram
    u = unit_roundoff(dtype)
    n, p = X.shape
    got = _gram._backward(G, st, X, X, fv, True, True, True)
    again = _gram._backward(G, st, X, X, fv, True, True, True)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail(f'{what}: two calls differ')
    del again
    if truth64:
        G, X, fv = G.double(), X.double(), fv.double()
    ref = _gram._backward_plain(G, st, X, X, fv, True, True, True)
    rel = 32 * (p + 1) * u * amp
    with torch.no_grad():
        r2 = _gram._sqdist_plain(X, X)
        evals = _gram._terms_plain(st, fv, r2, d1=True, da=True)
        A = G.abs() * _gram._deriv_plain(st, X, X, fv, evals, r2).abs()
        A = A + A.T
        tx = torch.stack([2 * (A * (X[:, d, None] - X[None, :, d]).abs())
                          .sum(1) for d in range(p)], 1)
        del A
        mags = [G.abs().sum(), G.diagonal().abs().sum()] + [
            G.new_zeros(()) if m is None else (G.abs() * m.abs()).sum()
            for m in _gram._partials(st, fv, r2, evals)]
        del evals, r2
    err = check_close(f'{what} dx', got[0] + got[1], ref[0] + ref[1],
                      (8 * math.sqrt(n) * u + rel) * tx)
    tp = (math.ceil(math.log2(n * n)) * 4 * u + rel) * torch.stack(mags)
    err = max(err, check_close(f'{what} dparams', got[2], ref[2], tp))
    log(f'    {what}: two calls agree to the bit; the parameter vector\'s '
        f'gradient {got[2].tolist()}')
    return err


def kernel_zoo(dtype, gen, name, p):
    """Kernel C and its fused backward on a zoo profile (`zoo_desc`) at
    16384², p coordinates, with the nugget: the forward against the plain
    version within 32 (p + 1) u max|K| (r² in another order, and the
    profile by another formula: the kernel takes exp, log and a Horner
    polynomial where the plain version takes torch's pow and its own
    polynomial, a few ulps each) times the core's `zoo_amp` (where that
    exceeds 1e3, below a hundredth of the median entry, `check_typical`;
    Bessel in float32 against the float64 plain version, `bessel_truth`;
    Matérn-ν's entries each against the float64 plain version too,
    `check_entries`, and over its tables' whole range, `matern_probe`;
    the 'sfb' records' entries too, `sfb_entries`), the backward by
    `zoo_bwd_check`; where ZOO_BLOCK names the profile, both
    held on the first ZOO_BLOCK points (the plain version timed there,
    ``plain_n`` in the record) and the kernel timed at 16384²; the
    records 'gram/<name>' and 'gram_bwd/<name>' ('/p10', '/float64'
    appended)."""
    import torch
    from lsqfitgp_torch.ops import (gram, gram_plain, gram_backward,
                                    gram_backward_plain, gram_sym, _gram)
    u = unit_roundoff(dtype)
    isz = torch.finfo(dtype).bits // 8
    amp = zoo_amp(name, dtype)
    desc = zoo_desc(name, dtype)
    noise = torch.tensor(NOISE_VAR, device='cuda', dtype=dtype)
    X = record_points(name, p, N, dtype, gen)
    nb = ZOO_BLOCK.get(name, N)
    Xb = X[:nb]
    ev_c = took(gram, 'launches', lambda: gram(desc, X, noise=noise))
    if name not in CORE_RECORDS:
        # E (on Zoo) writes C's bits (on ZooOne at p = 1: the same core
        # expression, r² w rounded as Zoo rounds it)
        K = gram(desc, X, noise=noise)
        if not torch.equal(gram_sym(desc, X, noise=noise), K):
            fail(f'E gram_sym {name} p={p} {dtype}: differs from kernel C '
                 f'({ev_c})')
        log(f'    E gram_sym {name} p={p} {dtype}: equal to kernel C '
            f'({ev_c}) to the bit')
        del K
    K = gram(desc, Xb, noise=noise)
    truth64 = bessel_truth(name, dtype)
    if truth64:
        Kp = gram_plain(zoo_desc(name, torch.float64), Xb.double(),
                        noise=noise.double())
    else:
        Kp = gram_plain(desc, Xb, noise=noise)
    what = f'C gram {name} p={p} {dtype}' + \
        (' (the plain version in float64)' if truth64 else '')
    tol = 32 * (p + 1) * u * amp * float(Kp.abs().max())
    if amp > 1e3:
        check_typical(what, tol, Kp)
    err = check_close(what, K, Kp, tol)
    if ZOO_KEYS[name] == 'matern':
        # each entry too, against the float64 plain version: the
        # tolerance above is of the largest entry, and most of this
        # block's entries are far smaller
        Xb64 = Xb.double()
        check_entries(what + ' (float64 plain)', K,
                      gram_plain(zoo_desc(name, torch.float64), Xb64,
                                 noise=noise.double()),
                      matern_rel_tol(name, dtype, p,
                                     _gram._sqdist_plain(Xb64, Xb64)), dtype)
        del Xb64
        matern_probe(name, dtype, p)
    del K, Kp
    if ZOO_KEYS[name] == 'sfb':
        sfb_entries(name, dtype, X, nb)
        sfb_divergence(name, dtype, X)
    ms, plain_ms, wrap = gram_times(
        lambda: gram(desc, X, noise=noise),
        lambda: gram_plain(desc, Xb, noise=noise), 'gram_kernel',
        plain_calls=ZOO_PLAIN_CALLS)
    fwd_ops, bwd_ops = zoo_ops(name, dtype, X)
    bd = bound(isz * (N * N + 2 * N * p), (3 * p + fwd_ops) * N * N, dtype)
    at = '' if nb == N else f' (plain at {nb}²)'
    log(f'  C {name} p={p} {dtype}: kernel {ms:.3f} ms (the wrapper '
        f'{wrap} ms), plain {plain_ms:.3f} ms{at}, bound {bd[0]:.3f} ms '
        f'({bd[1]}), share {bd[0] / ms:.2f}')
    _, st, _, _, pvec = _gram._args(desc, X, None, (), noise)
    fv = _gram._fold(st, pvec)
    G = torch.randn(N, N, device='cuda', dtype=dtype, generator=gen)
    Gb = G[:nb, :nb].contiguous() if nb < N else G
    err_b = zoo_bwd_check(f'C gram backward {name} p={p} {dtype}', st, Xb,
                          fv, Gb, dtype, amp, truth64)
    n0 = gram.launches_bwd
    ev_b = took(gram, 'launches_bwd',
                lambda: gram_backward(G, desc, X, noise=noise))
    if gram.launches_bwd != n0 + 1:
        fail(f'C backward {name}: {gram.launches_bwd - n0} launches, '
             f'expected one')
    log(f'    C {name} p={p} {dtype}: evaluator {ev_c}; its backward '
        f'{ev_b}')
    ms_b, plain_b, wrap_b = gram_times(
        lambda: gram_backward(G, desc, X, noise=noise),
        lambda: gram_backward_plain(Gb, desc, Xb, noise=noise),
        'gram_bwd_kernel', plain_calls=ZOO_PLAIN_CALLS)
    bd_b = bound(isz * (N * N + 3 * N * p), (6 * p + bwd_ops) * N * N, dtype)
    log(f'  C backward {name} p={p} {dtype}: fused kernel {ms_b:.3f} ms '
        f'(the wrapper {wrap_b} ms), plain {plain_b:.3f} ms{at}, bound '
        f'{bd_b[0]:.3f} ms ({bd_b[1]}), share {bd_b[0] / ms_b:.2f}')
    del G, Gb, X, Xb
    extra = {} if nb == N else dict(plain_n=nb)
    return [zoo_record(record(err, ms, plain_ms, bd, wrapper_ms=wrap,
                              evaluator=ev_c, **extra), 'gram', name, p,
                       dtype, 'launches'),
            zoo_record(record(err_b, ms_b, plain_b, bd_b, wrapper_ms=wrap_b,
                              evaluator=ev_b, **extra),
                       'gram_bwd', name, p, dtype, 'launches_bwd')]


def kernel_zoo_sym(dtype, gen, name='maternp2'):
    """Kernel E and its fused backward on a zoo profile at 16384², p = 1:
    E equal to C to the bit, against the plain version as C
    (`kernel_zoo`), its backward against the plain one as C's
    (`zoo_bwd_check`'s bounds, G and Gᵀ both entering) and to the bit in
    two calls; the plain versions held and timed on ZOO_BLOCK's block
    where it names the profile; the records 'gram_sym/<name>' and
    'gram_sym_bwd/<name>'."""
    import torch
    from lsqfitgp_torch.ops import (gram, gram_sym, gram_sym_plain,
                                    gram_sym_backward,
                                    gram_sym_backward_plain, _gram)
    u = unit_roundoff(dtype)
    isz = torch.finfo(dtype).bits // 8
    amp = zoo_amp(name, dtype)
    desc = zoo_desc(name, dtype)
    noise = torch.tensor(NOISE_VAR, device='cuda', dtype=dtype)
    X = zoo_points(1, N, dtype, gen)
    nb = ZOO_BLOCK.get(name, N)
    Xb = X[:nb]
    K = gram_sym(desc, X, noise=noise)
    if not torch.equal(K, gram(desc, X, noise=noise)):
        fail(f'E gram_sym {name} {dtype}: differs from kernel C')
    del K
    K = gram_sym(desc, Xb, noise=noise)
    Kp = gram_sym_plain(desc, Xb, noise=noise)
    err = check_close(f'E gram_sym {name} {dtype}', K, Kp,
                      64 * u * amp * float(Kp.abs().max()))
    log(f'    E gram_sym {name} {dtype}: equal to kernel C to the bit')
    del K, Kp
    ms, plain_ms, wrap = gram_times(
        lambda: gram_sym(desc, X, noise=noise),
        lambda: gram_sym_plain(desc, Xb, noise=noise), 'gram_sym_kernel',
        plain_calls=3)
    fwd_ops, bwd_ops = zoo_ops(name, dtype, X)
    bd = bound(isz * (N * N + N), (3 + fwd_ops) * N * (N + 1) / 2, dtype)
    at = '' if nb == N else f' (plain at {nb}²)'
    log(f'  E {name} {dtype}: kernel {ms:.3f} ms (the wrapper {wrap} '
        f'ms), plain {plain_ms:.3f} ms{at}, bound {bd[0]:.3f} ms ({bd[1]})')
    _, st, _, _, pvec = _gram._args(desc, X, None, (), noise)
    fv = _gram._fold(st, pvec)
    G = torch.randn(N, N, device='cuda', dtype=dtype, generator=gen)
    got = _gram._sym_backward(G, st, X, fv, True, True, True)
    again = _gram._sym_backward(G, st, X, fv, True, True, True)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail(f'E backward {name} {dtype}: two calls differ')
    del again
    Gb = G[:nb, :nb].contiguous() if nb < N else G
    if nb < N:
        got = _gram._sym_backward(Gb, st, Xb, fv, True, True, True)
    # E's sums are C's with G + Gᵀ: held to C's plain backward
    gx, gy, gf = _gram._backward_plain(Gb, st, Xb, Xb, fv, True, True, True)
    rel = 64 * u * amp
    with torch.no_grad():
        r2 = _gram._sqdist_plain(Xb, Xb)
        evals = _gram._terms_plain(st, fv, r2, d1=True, da=True)
        A = Gb.abs() * _gram._deriv_plain(st, Xb, Xb, fv, evals, r2).abs()
        A = A + A.T
        tx = 2 * (A * (Xb - Xb.T).abs()).sum(1)
        del A
        mags = [Gb.abs().sum(), Gb.diagonal().abs().sum()] + [
            Gb.new_zeros(()) if m is None else (Gb.abs() * m.abs()).sum()
            for m in _gram._partials(st, fv, r2, evals)]
        del evals, r2
    err_b = check_close(f'E backward {name} {dtype} dx', got[0][:, 0],
                        (gx + gy)[:, 0], (8 * math.sqrt(nb) * u + rel) * tx)
    err_b = max(err_b, check_close(
        f'E backward {name} {dtype} dparams', got[1], gf,
        (math.ceil(math.log2(nb * nb)) * 4 * u + rel) * torch.stack(mags)))
    log(f'    E backward {name} {dtype}: two calls agree to the bit')
    del gx, gy, gf, got
    ms_b, plain_b, wrap_b = gram_times(
        lambda: gram_sym_backward(G, desc, X, noise=noise),
        lambda: gram_sym_backward_plain(Gb, desc, Xb, noise=noise),
        'gram_sym_bwd_kernel', plain_calls=3)
    bd_b = bound(isz * (N * N + 2 * N), (6 + bwd_ops) * N * (N + 1) / 2,
                 dtype)
    log(f'  E backward {name} {dtype}: fused kernel {ms_b:.3f} ms (the '
        f'wrapper {wrap_b} ms), plain {plain_b:.3f} ms{at}, bound '
        f'{bd_b[0]:.3f} ms ({bd_b[1]})')
    extra = {} if nb == N else dict(plain_n=nb)
    recs = [zoo_record(record(err, ms, plain_ms, bd, wrapper_ms=wrap,
                              **extra), 'gram_sym', name, 1, dtype,
                       'launches'),
            zoo_record(record(err_b, ms_b, plain_b, bd_b, wrapper_ms=wrap_b,
                              **extra), 'gram_sym_bwd', name, 1, dtype,
                       'launches_bwd')]
    for r in recs:
        r['path'] = None   # no path runs E on this profile
    return recs


def kernel_zoo_tangent(dtype, gen, name='maternp2'):
    """Kernels C′ and C″ on a one-term zoo profile at 16384², p = 1 (the
    amp chain and the nugget with their tangents): against their plain
    versions (C′ within 32 u times the sum of its terms' magnitudes, as
    `tangent_tol` with the profile's evaluation by another formula; C″
    within `zoo_bwd_check`'s bounds on its weights' sums; both times the
    core's `zoo_amp`), on ZOO_BLOCK's block where it names the profile
    (the plain versions timed there), C″ to the bit in two calls; the
    records 'gram_jvp/<name>' and 'gram_bwd_jvp/<name>'."""
    import torch
    from lsqfitgp_torch.ops import _gram
    u = unit_roundoff(dtype)
    isz = torch.finfo(dtype).bits // 8
    zamp = zoo_amp(name, dtype)
    x, dx, amp, _ = tangent_inputs(dtype, gen)
    desc = zoo_desc(name, dtype, amp=1.0)
    X, dX, st, fv, dfv, one, coef = tangent_path_args(x, dx, amp, 0.3, 0.5,
                                                      desc)
    nb = ZOO_BLOCK.get(name, N)
    Xb, dXb = X[:nb], dX[:nb]
    got = _gram._tangent(st, Xb, Xb, dXb, dXb, fv, dfv, True)
    ref = _gram._tangent_plain(st, Xb, Xb, dXb, dXb, fv, dfv, True)
    with torch.no_grad():
        r2 = _gram._sqdist_plain(Xb, Xb)
        dr2 = _gram._dsqdist_plain(Xb, Xb, dXb, dXb)
        terms = (float(amp) * one.deriv(r2) * dr2).abs() \
            + 0.3 * one.value(r2).abs() + 0.5
        del dr2
    err = check_close(f'C\' gram_jvp {name} {dtype}', got, ref,
                      64 * u * zamp * terms)
    del got, ref, terms
    fn = lambda: _gram._tangent(st, X, X, dX, dX, fv, dfv, True)
    ms = device_ms(fn, kernel_calls(fn), kernel='gram_jvp_kernel')
    plain_ms = device_ms(
        lambda: _gram._tangent_plain(st, Xb, Xb, dXb, dXb, fv, dfv, True), 3)
    fwd_ops = zoo_ops(name, dtype, X)[0]
    bd = bound(isz * (N * N + 2 * N), (8 + fwd_ops) * N * N, dtype)
    at = '' if nb == N else f' (plain at {nb}²)'
    log(f'  C\' {name} {dtype}: kernel {ms:.3f} ms, plain {plain_ms:.3f} '
        f'ms{at}, bound {bd[0]:.3f} ms ({bd[1]})')
    G = torch.randn(N, N, device='cuda', dtype=dtype, generator=gen)
    got = _gram._bwd_tangent(G, one, X, X, dX, dX, coef, True, True)
    again = _gram._bwd_tangent(G, one, X, X, dX, dX, coef, True, True)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        fail(f'C\'\' gram_backward_jvp {name} {dtype}: two calls differ')
    del again
    Gb = G[:nb, :nb].contiguous() if nb < N else G
    if nb < N:
        got = _gram._bwd_tangent(Gb, one, Xb, Xb, dXb, dXb, coef, True, True)
    ref = _gram._bwd_tangent_plain(Gb, one, Xb, Xb, dXb, dXb, coef, True,
                                   True)
    with torch.no_grad():
        w1, w2, dr2, r2 = _gram._tangent_weights_plain(one, Xb, Xb, dXb, dXb,
                                                       coef[0], coef[1])
        D = Xb - Xb.T
        dD = dXb - dXb.T
        T = Gb.abs() * (w1.abs() * D.abs() + w2.abs() * dD.abs())
        tx = 2 * (T.sum(1) + T.sum(0))
        del T, w1, w2, D, dD
        ta = (Gb.abs() * (one.deriv(r2) * dr2).abs()).sum()
        del r2, dr2
    rel = 64 * u * zamp
    err_b = check_close(f'C\'\' gram_backward_jvp {name} {dtype} dx',
                        (got[0] + got[1])[:, 0], (ref[0] + ref[1])[:, 0],
                        (8 * math.sqrt(nb) * u + rel) * tx)
    err_b = max(err_b, check_close(
        f'C\'\' gram_backward_jvp {name} {dtype} damp', got[2][0], ref[2][0],
        (math.ceil(math.log2(nb * nb)) * 4 * u + rel) * ta))
    log(f'    C\'\' gram_backward_jvp {name} {dtype}: two calls agree to '
        f'the bit')
    del got, ref
    fn = lambda: _gram._bwd_tangent(G, one, X, X, dX, dX, coef, True, True)
    ms_b = device_ms(fn, kernel_calls(fn), kernel='gram_bwd_jvp_kernel')
    plain_b = device_ms(lambda: _gram._bwd_tangent_plain(
        Gb, one, Xb, Xb, dXb, dXb, coef, True, True), 3)
    # the real-order Matérn's g'' takes the quadrature (2020 operations)
    g2 = 2020 if ZOO_KEYS[name] == 'matern' else 0
    bd_b = bound(isz * (N * N + 4 * N), (14 + 2 * fwd_ops + g2) * N * N,
                 dtype)
    log(f'  C\'\' {name} {dtype}: kernel {ms_b:.3f} ms, plain {plain_b:.3f} '
        f'ms{at}, bound {bd_b[0]:.3f} ms ({bd_b[1]})')
    extra = {} if nb == N else dict(plain_n=nb)
    recs = []
    for kind, rec in (('gram_jvp', record(err, ms, plain_ms, bd, **extra)),
                      ('gram_bwd_jvp', record(err_b, ms_b, plain_b, bd_b,
                                              **extra))):
        rec = tangent_record(kind, dtype, rec)
        rec.update(name=f'{kind}/{name}' + rec['name'][len(kind):],
                   path=None, profile=ZOO_KEYS[name])
        recs.append(rec)
    return recs


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
        ('gram p=2', lambda dtype, gen: kernel_gram_p(dtype, gen, 2),
         'lsqfitgp_torch/csrc/gram.cu', 'lsqfitgp_tpu/ops/_gram.py:68',
         [f32, f64]),
        (f'gram p={MD_P}', lambda dtype, gen: kernel_gram_p(dtype, gen, MD_P),
         'lsqfitgp_torch/csrc/gram.cu', 'lsqfitgp_tpu/ops/_gram.py:68',
         [f32, f64]),
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
    # the zoo's profiles: C and its backward on each at p = 1 and the
    # multidim cell's p, E and its backward, C′ and C″ on Matérn-5/2, D on
    # the multiscale term sum (the time-series cores' records follow)
    for name, (ps, _, _) in ZOO_RECORDS.items():
        if name in TS_RECORDS or name in CORE_RECORDS:
            continue
        for p in ps:
            specs.append((f'gram {name} p={p}',
                          lambda dtype, gen, name=name, p=p:
                          kernel_zoo(dtype, gen, name, p),
                          'lsqfitgp_torch/csrc/gram.cu',
                          'lsqfitgp_tpu/ops/_gram.py:68', [f32, f64]))
    specs += [
        ('gram_sym maternp2', kernel_zoo_sym, 'lsqfitgp_torch/csrc/gram.cu',
         'lsqfitgp_tpu/ops/_gram.py:157', [f32, f64]),
        # E (on Zoo) against C (on ZooSum) to the bit on the multiscale sum
        ('gram_sym terms',
         lambda dtype, gen: kernel_zoo_sym(dtype, gen, 'terms'),
         'lsqfitgp_torch/csrc/gram.cu', 'lsqfitgp_tpu/ops/_gram.py:157',
         [f32, f64]),
        ('gram tangents maternp2', kernel_zoo_tangent,
         'lsqfitgp_torch/csrc/gram.cu', None, [f32, f64]),
        ('schur_update_gram/terms',
         lambda dtype, gen: kernel_schur_gram(dtype, gen, 'terms'),
         'lsqfitgp_torch/csrc/syrk.cu', 'lsqfitgp_tpu/ops/_syrk.py:334',
         [f32, f64]),
    ] + ts_kernel_specs() + core_kernel_specs()
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

def sqdist64(x, xs=None, rows=512):
    """|x_i − xs_j|² (xs defaults to x) from broadcast differences, for
    points of shape (n,) or (n, p), at p > 1 by blocks of ``rows`` rows
    (one (rows, m, p) temporary); no port code."""
    xs = x if xs is None else xs
    if x.dim() == 1:
        d2 = x[:, None] - xs[None, :]
        return d2.mul_(d2)
    out = x.new_empty((x.shape[0], xs.shape[0]))
    for i in range(0, x.shape[0], rows):
        D = x[i:i + rows, None, :] - xs[None, :, :]
        out[i:i + rows] = D.mul_(D).sum(-1)
    return out


def plain_nll64(x, y, log_scale, log_amp, jitter=0.0, noise=NOISE_VAR,
                kern=None):
    """Independent float64 reference of the objective's likelihood part
    and its gradient in (log scale, log amp), with ``jitter`` more on K's
    diagonal beside the noise variance ``noise``, for points x of shape
    (n,) or (n, p): dense K, ``torch.linalg.cholesky`` and the textbook
    gradient
    ½ <K⁻¹ − α αᵀ, ∂K>, α = K⁻¹ y, with ∂K/∂log amp = amp E and
    ∂K/∂log scale = amp E ∘ Δ²/scale², E = exp(−Δ²/(2 scale²)); no port
    code.  Four float64 n × n buffers at the peak (autograd through the
    same computation keeps about eight, too many at n = 32768).  With
    ``kern``, the kernel ``amp kern(Δ²/scale²)[0]``, ``kern`` giving the
    unit kernel and its derivative in log scale (`matern52`)."""
    import torch
    if kern is not None:
        return plain_terms64(x, y, [(kern, log_scale, log_amp)],
                             jitter=jitter, noise=noise)
    scale, amp = math.exp(log_scale), math.exp(log_amp)
    d2 = sqdist64(x)
    d2.div_(scale * scale)
    E = torch.exp(d2 * -0.5)
    K = E * amp
    K.diagonal().add_(noise + jitter)
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


def expquad64(d2s):
    """ExpQuad at the scaled squared distance and its derivative in log
    scale: (E, E d2s)."""
    import torch
    E = torch.exp(d2s * -0.5)
    return E, E * d2s


def matern52(d2s):
    """Matérn-5/2 (Maternp(p=2)) at the scaled squared distance, in closed
    form, and its derivative in log scale: x = √(5 d2s), (e^{−x}(1 + x +
    x²/3), e^{−x} x² (1 + x)/3); no port code."""
    import torch
    x = torch.sqrt(5 * d2s)
    e = torch.exp(-x)
    return e * (1 + x + x * x / 3), e * x * x * (1 + x) / 3


def kernel64(x, xs, terms, rows=4096):
    """Σ_t amp_t kern_t(|x_i − xs_j|²/scale_t²) for ``terms`` a list of
    (kern, log scale, log amp), assembled by blocks of ``rows`` rows (a
    few (rows, m) temporaries); no port code."""
    out = x.new_empty((x.shape[0], xs.shape[0]))
    for i in range(0, x.shape[0], rows):
        d2 = sqdist64(x[i:i + rows], xs)
        out[i:i + rows] = sum(math.exp(la) * kern(d2 / math.exp(2 * ls))[0]
                              for kern, ls, la in terms)
    return out


def plain_terms64(x, y, terms, jitter=0.0, noise=NOISE_VAR, rows=4096):
    """Independent float64 reference of the likelihood part of the
    objective of K = Σ_t amp_t kern_t(Δ²/scale_t²) + (noise + jitter) I
    and its gradient in each term's (log scale, log amp), for ``terms`` a
    list of (kern, log scale, log amp): dense K, ``torch.linalg.cholesky``
    and the textbook gradient ½ <K⁻¹ − α αᵀ, ∂K>, its products taken by
    blocks of rows (three float64 n × n buffers at the peak); no port
    code."""
    import torch
    K = kernel64(x, x, terms, rows)
    K.diagonal().add_(noise + jitter)
    L = torch.linalg.cholesky(K)
    del K
    z = torch.linalg.solve_triangular(L, y[:, None], upper=False)
    nll = 0.5 * float(z.T @ z) + float(torch.log(L.diagonal()).sum()) \
        + 0.5 * len(x) * math.log(2 * math.pi)
    alpha = torch.cholesky_solve(y[:, None], L)[:, 0]
    G = torch.cholesky_inverse(L)
    del L
    G.addr_(alpha, alpha, alpha=-1).mul_(0.5)
    grads = [x.new_zeros(()) for _ in range(2 * len(terms))]
    for i in range(0, x.shape[0], rows):
        d2 = sqdist64(x[i:i + rows], x)
        for t, (kern, ls, la) in enumerate(terms):
            E, dE = kern(d2 / math.exp(2 * ls))
            grads[2 * t] += math.exp(la) * (G[i:i + rows] * dE).sum()
            grads[2 * t + 1] += math.exp(la) * (G[i:i + rows] * E).sum()
    return nll, torch.stack(grads)


def plain_mean64(x, y, xs, scale, amp, noise=NOISE_VAR, kern=None,
                 terms=None):
    """Independent float64 reference of the posterior mean (points of
    shape (n,) or (n, p), noise variance ``noise``), of ``amp
    kern(Δ²/scale²)`` (ExpQuad by default) or of the sum of ``terms`` as
    `plain_terms64` takes them."""
    import torch
    if kern is not None:
        terms = [(kern, math.log(scale), math.log(amp))]

    def k(a, b):
        if terms is None:
            return amp * torch.exp(sqdist64(a, b) * (-0.5 / scale ** 2))
        return kernel64(a, b, terms)

    K = k(x, x)
    K.diagonal().add_(noise)
    L = torch.linalg.cholesky(K)
    return k(x, xs).T @ torch.cholesky_solve(y[:, None], L)[:, 0]


KERNELS = ['schur_update', 'syrk_t_full', 'syrk_t_full_', 'gram',
           'schur_update_gram', 'gram_sym', 'matern_table', 'sfb_table']

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
    from lsqfitgp_torch import ops
    for _, fn, attr in _counters():
        setattr(fn, attr, 0)
    for name in ('gram', 'gram_sym', 'schur_update_gram'):
        getattr(ops, name).by_profile.clear()
        getattr(ops, name).by_evaluator.clear()


def read_counts():
    """The launch counts by key, by key and profile ('key@profile', the
    terms' profile names joined by '+') and by key and evaluator
    ('key#evaluator': FixedExpQuad, ZooOne, Zoo, ZooSpecial) for C, D
    and E."""
    from lsqfitgp_torch import ops
    counts = {key: getattr(fn, attr) for key, fn, attr in _counters()}
    for name in ('gram', 'gram_sym', 'schur_update_gram'):
        fn = getattr(ops, name)
        for (attr, prof), c in fn.by_profile.items():
            counts[f'{name}{COUNTERS[attr]}@{prof}'] = c
        for (attr, ev), c in fn.by_evaluator.items():
            counts[f'{name}{COUNTERS[attr]}#{ev}'] = c
    return counts


def evaluators(counts, key):
    """The evaluators the launches of ``key`` ('gram', 'gram_bwd', ...)
    took, with their counts ('ZooOne: 12')."""
    took = {k.split('#')[1]: c for k, c in counts.items()
            if k.startswith(key + '#') and c}
    return ', '.join(f'{ev}: {c}' for ev, c in sorted(took.items())) or \
        "none"


def nonzero(counts):
    return {k: c for k, c in counts.items() if c}


def require_launched(counts, names, what):
    for name in names:
        if counts.get(name, 0) == 0:
            fail(f'kernel {name} was not launched during {what}')


def require_counts(counts, expected, what):
    """Launch counts that must be exact: kernel C's and E's forward and
    fused backward, one of each per evaluation they serve, so that no
    other Gram evaluation (such as the derivative weights of an unfused
    backward) ran on the card."""
    for name, n in expected.items():
        if counts.get(name, 0) != n:
            fail(f'{what}: {counts.get(name, 0)} launches of {name}, '
                 f'expected {n}')


def check_points(n, value_grad32, cond_at, x64, y64, points, grad64=None,
                 dmax=None, noise=NOISE_VAR):
    """The port's float32 NLL and its gradient against the float64
    reference (`plain_nll64`, or ``grad64(lp)``) at each (label, [log
    scale, log amp], near_optimum) point; ``value_grad32(lp,
    precision=None)`` is the port's NLL at the float32 tensor lp,
    ``cond_at(ls, la)`` the float32 condition estimate there, ``dmax(ls,
    la)`` the largest diagonal entry of the model's K (default: amp +
    the noise), ``noise`` the data's noise variance.  Away from the optimum the gradient's error at
    precision 'highest' is printed beside the default's ('high'); the
    limits hold the default."""
    import torch
    eps32 = torch.finfo(torch.float32).eps
    if grad64 is None:
        def grad64(lp):
            return plain_nll64(x64, y64, *lp)
    if dmax is None:
        def dmax(ls, la):
            return math.exp(la) + noise

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
        # (since λmin(K) >= σ²), doubled for rounding; amp + σ² is the
        # largest diagonal entry, dmax.
        if dnll > 4 * eps32 * n * dmax(ls, la) / noise:
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


# the ExpQuad dense fit's time per evaluation (ms), evaluations and
# iterations, printed beside the Matérn fit's
DENSE_STATS = {}


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
    DENSE_STATS.update(ms=statistics.median(fit.evaltimes) * 1e3,
                       evals=len(fit.evaltimes), nit=fit.minresult.nit)
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


# the gram='auto' measurement (`gram_route_table`): point-block sizes
# n, numbers of coordinates p (p > 1 as StructuredArray fields), and the
# blocks' second side: m = n (the fit's blocks) and m = NPRED (a
# prediction's cross block)
ROUTE_NS = (256, 1024, 4096, 6144, 8192, 16384)
ROUTE_PS = (1, 2, 4, 8, 16)


def gram_route_table():
    """The point block through the GP (`GP._covblock` of ``amp *
    ExpQuad(scale)`` at n x m points, checks off, as the fit evaluates
    it), by kernel C (``gram='tiled'``) and by the broadcast core
    (``gram='broadcast'``), the forward alone and forward + backward
    (the gradient in log scale and log amp), at each n of ROUTE_NS, p
    of ROUTE_PS, m = n and m = NPRED, in float32 and float64; each a
    median of 7 runs on CUDA events, a run being a few calls back to
    back (their mean).  The two routes' blocks must agree.  Prints a
    line per case and a JSON line of the table; the rule of
    ``gram='auto'`` comes from it (PERF.md)."""
    import torch
    import lsqfitgp_torch as lgp
    gen = torch.Generator(device='cuda').manual_seed(SEED)
    table = []
    for dtype in (torch.float32, torch.float64):
        torch.set_default_dtype(dtype)
        u = unit_roundoff(dtype)
        for p in ROUTE_PS:
            for n, m in [(n, m) for n in ROUTE_NS for m in (n, NPRED)]:
                X = (torch.rand(n, p, device='cuda', dtype=dtype,
                                generator=gen) - 0.5) * 50
                Y = X[:m] if m == n else (torch.rand(
                    m, p, device='cuda', dtype=dtype, generator=gen)
                    - 0.5) * 50
                pts = [Z[:, 0] if p == 1 else lgp.asarray(
                    {f'f{i}': Z[:, i] for i in range(p)}) for Z in (X, Y)]
                G = torch.randn(n, m, device='cuda', dtype=dtype,
                                generator=gen)
                lp = torch.tensor([0.5, 0.2], device='cuda', dtype=dtype,
                                  requires_grad=True)
                batch = 20 if n * m <= 4096 ** 2 else 5 if n * m <= 8192 ** 2 \
                    else 3
                row = dict(dtype=str(dtype).split('.')[-1], p=p, n=n, m=m)
                blocks = {}
                for gram in ('tiled', 'broadcast'):
                    def block(gram=gram):
                        with lgp.disable_checks():
                            gp = lgp.GP(lp[1].exp()
                                        * lgp.ExpQuad(scale=lp[0].exp()),
                                        gram=gram).addx(pts[0], 'a')
                            if m == n:
                                return gp._covblock('a', 'a', cache=False)
                            return gp.addx(pts[1], 'b')._covblock(
                                'a', 'b', cache=False)
                    with torch.no_grad():
                        blocks[gram] = block()
                        fwd = median_ms(block, batch=batch)
                    both = median_ms(
                        lambda: torch.autograd.grad(block(), lp, G),
                        batch=batch)
                    row[gram] = [fwd, both]
                err = float((blocks['tiled'] - blocks['broadcast']).abs()
                            .max())
                del blocks
                # the two routes round the p-term r² in other orders and
                # take other exps: 16 (p + 1) u max|K|, max|K| = amp
                tol = 16 * (p + 1) * u * math.exp(0.2)
                if not err <= tol:
                    fail(f'gram route {row}: the kernel-C block and the '
                         f'broadcast block differ by {err:.3e} > {tol:.3e}')
                row['max_abs_diff'] = err
                t, b = row['tiled'], row['broadcast']
                log(f'  {row["dtype"]} p={p:2d} {n:5d} x {m:5d}: forward C '
                    f'{t[0]:.4f} ms, broadcast {b[0]:.4f} ms (x{b[0] / t[0]:.2f}'
                    f'); forward + backward C {t[1]:.4f} ms, broadcast '
                    f'{b[1]:.4f} ms (x{b[1] / t[1]:.2f})')
                table.append(row)
                del G, X, Y, pts
                torch.cuda.empty_cache()
    print(json.dumps({'gram_route': table}), flush=True)
    return table


def gram_route(evals=7, table=True):
    """Kernels C and E as the main path calls them, through the public API
    only (`ops.gram`, `ops.gram_sym` and autograd), so that the same
    script times the parent's route from the parent's checkout: at the
    dense slice's shape (n = 16384, p = 1, the amp chain; C with the
    nugget), in float32 and float64, the forward alone and forward +
    backward, each a mean over GRAM_BATCH calls back to back (median of
    7), their difference the backward's time; then ``evals`` dense
    float32 value+gradients at the dense fit's optimum and as many of
    the multidim model (`multidim_evals`; host clock up to the read of
    the result, checks off), their median, and the profile of one.
    First, with ``table``, `gram_route_table`."""
    import numpy as np
    import torch
    import lsqfitgp_torch as lgp
    from lsqfitgp_torch import ops
    gen = torch.Generator(device='cuda').manual_seed(SEED)
    if table:
        log('point blocks through the GP, kernel C against the broadcast '
            'core:')
        gram_route_table()
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
    multidim_evals(evals)


def multidim_evals(evals, lp0=(0.0, 0.0)):
    """``evals`` float32 value+gradients of the multidim phase's model
    (`multidim_data`, kernel C at p = MD_P through gram='auto') at log
    scale, log amp ``lp0``, host clock up to the read of the result,
    checks off: their median, the peak memory of one above its inputs
    and the profile of one.  Public API only."""
    import torch
    import lsqfitgp_torch as lgp
    torch.set_default_dtype(torch.float32)
    xt, yt, _, _, noise = multidim_data('cuda')

    def value_grad():
        lp = torch.tensor(lp0, device='cuda', requires_grad=True)
        with lgp.disable_checks():
            gp = multidim_gp({'scale': lp[0].exp(), 'amp': lp[1].exp()}, xt)
            nll = -gp.marginal_likelihood({'y': yt}, noise)
        g, = torch.autograd.grad(nll, lp)
        return float(nll.detach()), g.tolist()

    times = []
    for _ in range(evals):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        value_grad()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    value_grad()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    log(f'  multidim float32 value+gradient at n = {N_MD}, p = {MD_P}, log '
        f'scale, log amp {list(lp0)}: {statistics.median(times) * 1e3:.1f} '
        f'ms median (each: {[round(t * 1e3, 1) for t in times]} ms); peak '
        f'{peak / N_MD ** 2:.2f} B/n² above its inputs')
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
    """The streaming slice at n = 65536 from numpy inputs: a fit of at
    most STREAM_MAXFUN evaluations (L-BFGS-B) and predfromdata; returns
    the launch counts and the end point.

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
                           {'f': y}, initial=start,
                           minkw={'method': 'L-BFGS-B',
                                  'options': {'maxfun': STREAM_MAXFUN}},
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
    device's busy share of the host wall time; returns (host ms under the
    profiler, device busy ms)."""
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
    return wall * 1e3, busy


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
    return {k: now[k] - before.get(k, 0) for k in now}


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


# -- the derivative phase ---------------------------------------------------


def deriv_truth(x, t):
    """The derivative phase's truth f(x, t) and ∂f/∂x, smooth on the
    scale of a few units."""
    import numpy as np
    return (np.sin(x / 3) * np.cos(t / 4),
            np.cos(x / 3) / 3 * np.cos(t / 4))


def deriv_data():
    """The derivative phase's points and data from numpy seed SEED:
    ``(pf, yf, pd, yd, ps)``, each set of points an (n, 2) array of
    (x, t); ps the 64 prediction points, on the diagonal of the square."""
    import numpy as np
    rng = np.random.default_rng(SEED)
    pf = rng.uniform(-DERIV_SPAN, DERIV_SPAN, (N_DF, 2))
    pd = rng.uniform(-DERIV_SPAN, DERIV_SPAN, (N_DD, 2))
    sd = math.sqrt(NOISE_VAR)
    yf = deriv_truth(*pf.T)[0] + sd * rng.standard_normal(N_DF)
    yd = deriv_truth(*pd.T)[1] + sd * rng.standard_normal(N_DD)
    s = np.linspace(-0.9 * DERIV_SPAN, 0.9 * DERIV_SPAN, NPRED)
    ps = np.stack([s, s[::-1] / 2], 1)
    return pf, yf, pd, yd, ps


def deriv_blocks64(pa, pb, scale, amp, da, db):
    """The closed-form float64 covariance between the observations at the
    (n, 2) points pa and pb of amp * ExpQuad(scale) on (x, t): ``da``,
    ``db`` each None (the value), 'x' or 't' (the first derivative along
    that coordinate); no port code.  With k = amp exp(-r²/(2 s²)) and
    Δ = pa - pb: Cov(f, f) = k, Cov(f(p), ∂_c f(q)) = k Δ_c/s²,
    Cov(∂_c f(p), f(q)) = -k Δ_c/s², Cov(∂_c f(p), ∂_e f(q)) = k
    (δ_ce/s² - Δ_c Δ_e/s⁴)."""
    import torch
    col = {'x': 0, 't': 1}
    D = pa[:, None, :] - pb[None, :, :]
    k = amp * torch.exp(-0.5 * (D * D).sum(-1) / scale ** 2)
    if da is None and db is None:
        return k
    if da is None:
        return k * D[..., col[db]] / scale ** 2
    if db is None:
        return -k * D[..., col[da]] / scale ** 2
    dd = D[..., col[da]] * D[..., col[db]]
    return k * ((da == db) / scale ** 2 - dd / scale ** 4)


def deriv_oracle64(pf, yf, pd, yd, log_scale, log_amp):
    """Independent float64 NLL of the derivative model's data and its
    gradient in (log scale, log amp): the three closed-form blocks
    (`deriv_blocks64`), the noise on the diagonal,
    ``torch.linalg.cholesky`` and autograd through that computation."""
    import torch
    lp = torch.tensor([log_scale, log_amp], dtype=torch.float64,
                      device=pf.device, requires_grad=True)
    s, a = lp[0].exp(), lp[1].exp()
    K = torch.cat([
        torch.cat([deriv_blocks64(pf, pf, s, a, None, None),
                   deriv_blocks64(pf, pd, s, a, None, 'x')], 1),
        torch.cat([deriv_blocks64(pd, pf, s, a, 'x', None),
                   deriv_blocks64(pd, pd, s, a, 'x', 'x')], 1)], 0)
    K.diagonal().add_(NOISE_VAR)
    L = torch.linalg.cholesky(K)
    del K
    y = torch.cat([yf, yd])
    z = torch.linalg.solve_triangular(L, y[:, None], upper=False)
    nll = 0.5 * (z * z).sum() + torch.log(L.diagonal()).sum() \
        + 0.5 * len(y) * math.log(2 * math.pi)
    g, = torch.autograd.grad(nll, lp)
    return float(nll.detach()), g.detach()


def deriv_mean64(pf, yf, pd, yd, ps, scale, amp, ds):
    """Independent float64 posterior mean at the points ps of the value
    (``ds`` None) or of its derivative along ``ds``, from the closed-form
    blocks."""
    import torch
    with torch.no_grad():
        K = torch.cat([
            torch.cat([deriv_blocks64(pf, pf, scale, amp, None, None),
                       deriv_blocks64(pf, pd, scale, amp, None, 'x')], 1),
            torch.cat([deriv_blocks64(pd, pf, scale, amp, 'x', None),
                       deriv_blocks64(pd, pd, scale, amp, 'x', 'x')], 1)],
            0)
        K.diagonal().add_(NOISE_VAR)
        alpha = torch.cholesky_solve(torch.cat([yf, yd])[:, None],
                                     torch.linalg.cholesky(K))[:, 0]
        del K
        Ks = torch.cat([deriv_blocks64(ps, pf, scale, amp, ds, None),
                        deriv_blocks64(ps, pd, scale, amp, ds, 'x')], 1)
        return Ks @ alpha


def gram_p_recorder():
    """Wrap kernel C's launching functions so that each CUDA launch's
    number of point coordinates p is recorded: returns the list of
    ('fwd' | 'bwd', p) and a function that undoes the wrapping."""
    from lsqfitgp_torch.ops import _gram
    seen = []
    ev, bw = _gram._eval_cuda, _gram._backward_cuda

    def eval_cuda(st, x, *args):
        seen.append(('fwd', x.shape[1]))
        return ev(st, x, *args)

    def backward_cuda(G, st, x, *args):
        seen.append(('bwd', x.shape[1]))
        return bw(G, st, x, *args)

    _gram._eval_cuda, _gram._backward_cuda = eval_cuda, backward_cuda

    def restore():
        _gram._eval_cuda, _gram._backward_cuda = ev, bw

    return seen, restore


def deriv_phase(dev='cuda'):
    """BASELINE config #2 at full width: ``amp * ExpQuad(scale)`` on
    structured points with fields ('x', 't'), n_f = 8192 function values
    and n_d = 4096 observations of ∂f/∂x (``addx(..., deriv='x')``), the
    noise 0.09 I through ``givencov``, float32, the default ``gram``
    ('auto': kernel C on the card for the value block).  Fits the two
    hyperparameters with ``empbayes_fit`` (at most DERIV_ITERS BFGS
    iterations), predicts F and ∂F/∂t at 64 points; checks that kernel C
    ran at p = 2, its forward and fused backward once per evaluation,
    and that A and B ran; holds the NLL and gradient at the start and at
    the fit, and both posterior means, to the closed-form float64 oracle
    (`deriv_oracle64`, `deriv_mean64`); prints the time per evaluation,
    the peak memory of one value+gradient in B/n², the block times
    (kernel C's value block against the broadcast derivative blocks) and
    a profile.  Returns the launch counts of the fit and the
    predictions."""
    import torch
    import lsqfitgp_torch as lgp
    f32 = torch.float32
    torch.set_default_dtype(f32)
    t_phase = time.perf_counter()

    def sync():
        if dev == 'cuda':
            torch.cuda.synchronize()

    pf, yf, pd, yd, ps = deriv_data()
    n = N_DF + N_DD

    def points(p):
        return lgp.asarray({'x': p[:, 0], 't': p[:, 1]}, dtype=f32,
                           device=dev)

    xf, xd, xs = points(pf), points(pd), points(ps)
    data = {'f': torch.as_tensor(yf, dtype=f32, device=dev),
            'd': torch.as_tensor(yd, dtype=f32, device=dev)}

    def gpfactory(hp, precision=None):
        kw = {} if precision is None else dict(precision=precision)
        gp = lgp.GP(hp['amp'] * lgp.ExpQuad(scale=hp['scale']), **kw)
        return gp.addx(xf, 'f').addx(xd, 'd', deriv='x')

    hyperprior = {'log(scale)': (0., 1.), 'log(amp)': (0., 1.)}
    log(f'derivative phase: n = {N_DF} values + {N_DD} x-derivatives = '
        f'{n}, points (x, t) on [-{DERIV_SPAN}, {DERIV_SPAN}]², float32, '
        f'amp * ExpQuad(scale), gram=\'auto\', givencov {NOISE_VAR} I')
    seen, restore = gram_p_recorder()
    try:
        sync()
        reset_counts()
        t0 = time.perf_counter()
        fit = lgp.empbayes_fit(hyperprior, gpfactory, (data, NOISE_VAR),
                               minkw={'maxiter': DERIV_ITERS}, raises=False)
        sync()
        wall = time.perf_counter() - t0
        fit_launches = read_counts()
        fit_seen = list(seen)
        gp = fit.gp().addx(xs, 'F').addx(xs, 'dFdt', deriv='t')
        post = gp.predfromdata(data, ['F', 'dFdt'], NOISE_VAR)
        means = {k: post[k].mean for k in ('F', 'dFdt')}
        sync()
        launches = read_counts()
    finally:
        restore()
    evals = len(fit.evaltimes)
    log(f'  fit: {wall:.2f} s wall, {fit.minresult.nit} BFGS iterations '
        f'(cap {DERIV_ITERS}), {evals} evaluations, median '
        f'{statistics.median(fit.evaltimes) * 1e3:.1f} ms per evaluation '
        f'(value + gradient); {fit.minresult.message}')
    log(f'  launches during the fit: {nonzero(fit_launches)}; fit + '
        f'predfromdata: {nonzero(launches)}')
    ps_seen = sorted(set(fit_seen))
    log(f'  kernel C launches (direction, p) during the fit: {ps_seen}')
    if dev == 'cuda':
        require_launched(fit_launches, ['schur_update_tc',
                                        'syrk_t_full__dmma'], 'the '
                         'derivative fit')
        require_counts(fit_launches, {'gram': evals, 'gram_bwd': evals},
                       'the derivative fit')
        if ps_seen != [('bwd', 2), ('fwd', 2)]:
            fail(f'kernel C ran at {ps_seen}, expected p = 2 only')
    scale = float(fit.pmean['scale'])
    amp = float(fit.pmean['amp'])
    fitted = [math.log(scale), math.log(amp)]
    log(f'  fitted scale {scale:.6g}, amp {amp:.6g}; pmean '
        f'{fit.pmean.buf.tolist()}, pcov {fit.pcov.tolist()}')

    def value_grad32(lp, precision=None):
        gp0 = gpfactory({'scale': lp[0].exp(), 'amp': lp[1].exp()},
                        precision)
        return -gp0.marginal_likelihood(data, NOISE_VAR)

    def value_grad():
        lp = torch.tensor(fitted, device=dev, requires_grad=True)
        with lgp.disable_checks():
            nll = value_grad32(lp)
        g, = torch.autograd.grad(nll, lp)
        return float(nll.detach()), g.tolist()

    times = []
    for _ in range(5):
        sync()
        t0 = time.perf_counter()
        value_grad()
        times.append(time.perf_counter() - t0)
    log(f'  value+gradient at the fit: median '
        f'{statistics.median(times) * 1e3:.1f} ms (each: '
        f'{[round(t * 1e3, 1) for t in times]} ms)')

    if dev == 'cuda':
        # the peak memory of one value+gradient above its inputs
        sync()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        value_grad()
        sync()
        peak = torch.cuda.max_memory_allocated() - base
        log(f'  peak memory of one value+gradient above its inputs: '
            f'{peak / n ** 2:.2f} B/n² ({peak / 2 ** 30:.2f} GiB)')
        # the blocks alone, forward + backward: kernel C's value block
        # against the broadcast derivative blocks
        lp = torch.tensor(fitted, device=dev, requires_grad=True)
        for a, b in (('f', 'f'), ('f', 'd'), ('d', 'd')):
            def block():
                with lgp.disable_checks():
                    gp0 = gpfactory({'scale': lp[0].exp(),
                                     'amp': lp[1].exp()})
                    K = gp0._covblock(a, b, cache=False)
                torch.autograd.grad(K, lp, torch.ones_like(K))
            log(f'  block ({a}, {b}) forward + backward: '
                f'{median_ms(block):.3f} ms')
        profile_phase(value_grad, top=16)

    # the port's NLL and gradient against the oracle, at the start point
    # and at the fit
    p64 = {k: torch.as_tensor(v, dtype=torch.float64, device=dev)
           for k, v in (('pf', pf), ('pd', pd), ('ps', ps))}
    # the oracle takes the data as the port sees them, rounded to float32
    yf64, yd64 = data['f'].double(), data['d'].double()

    def grad64(lp):
        nll, g = deriv_oracle64(p64['pf'], yf64, p64['pd'], yd64, *lp)
        return nll, g

    def dmax(ls, la):
        # the derivative block's diagonal amp/scale² or the value's amp
        return math.exp(la) * max(1, math.exp(-2 * ls)) + NOISE_VAR

    def cond_at(ls, la):
        with torch.no_grad():
            gp0 = gpfactory({'scale': torch.tensor(math.exp(ls)),
                             'amp': torch.tensor(math.exp(la))})
            K = gp0._assemble(['f', 'd'], ['f', 'd'])
            K.diagonal().add_(NOISE_VAR)
            return float(lgp.linalg.Chol(K).cond_estimate)

    cond = cond_at(*fitted)
    check_points(n, value_grad32, cond_at, p64['pf'], None,
                 [('start point', [0., 0.], False),
                  ('fitted point', fitted, True)], grad64=grad64, dmax=dmax)

    eps32 = torch.finfo(f32).eps
    for key, ds in (('F', None), ('dFdt', 't')):
        ref = deriv_mean64(p64['pf'], yf64, p64['pd'], yd64, p64['ps'],
                           scale, amp, ds)
        got = means[key]
        dmean = float((got.double() - ref).abs().max())
        log(f'  posterior mean of {key} at {NPRED} points: max |port - '
            f'float64| {dmean:.3e}, max |mean| {float(ref.abs().max()):.4g}'
            f' (limit {10 * cond * eps32 * float(ref.abs().max()):.3e})')
        if not bool(torch.isfinite(got).all()) or got.shape != (NPRED,):
            fail(f'posterior mean of {key} not finite or of the wrong shape')
        if dmean > 10 * cond * eps32 * float(ref.abs().max()):
            fail(f'posterior mean of {key} disagrees with the float64 '
                 f'oracle')
    log(f'  derivative phase: {time.perf_counter() - t_phase:.1f} s')
    return launches


# -- the multidim phase -------------------------------------------------------


def friedman1(X):
    """The Friedman #1 regression function of the first five of the
    points' coordinates (Friedman 1991; Chipman, George & McCulloch
    2010, §5); the others do not enter."""
    import numpy as np
    return (10 * np.sin(np.pi * X[:, 0] * X[:, 1])
            + 20 * (X[:, 2] - 0.5) ** 2 + 10 * X[:, 3] + 5 * X[:, 4])


def multidim_data(dev):
    """The multidim phase's data from numpy seed SEED: N_MD + NPRED points
    uniform on [0, 1]^MD_P, the response Friedman #1 + N(0, 1) at the
    first N_MD, standardized (centred, divided by its sample sd).
    Returns ``(x, y, xs, fs, noise)``: the training and the NPRED
    held-out points, each as one structured field 'x' with a (MD_P,)
    tail (the kernel sees p = MD_P coordinates), and the response, in
    float32 on ``dev``; the standardized truth at the held-out points
    (numpy), and the noise variance on the standardized scale, 1/sd², as
    float32 holds it."""
    import numpy as np
    import torch
    import lsqfitgp_torch as lgp
    rng = np.random.default_rng(SEED)
    Xall = rng.uniform(0, 1, (N_MD + NPRED, MD_P))
    y = friedman1(Xall[:N_MD]) + rng.standard_normal(N_MD)
    mu, sd = y.mean(), y.std(ddof=1)
    pts = np.empty(len(Xall), dtype=[('x', float, (MD_P,))])
    pts['x'] = Xall

    def put(a):
        return lgp.asarray(a, dtype=torch.float32, device=dev)

    return (put(pts[:N_MD]), put((y - mu) / sd), put(pts[N_MD:]),
            (friedman1(Xall[N_MD:]) - mu) / sd, float(np.float32(1 / sd ** 2)))


def multidim_gp(hp, x, precision=None):
    """The multidim model, ``amp * ExpQuad(scale)`` with the default
    ``gram`` at the points ``x``, as 'y'."""
    import lsqfitgp_torch as lgp
    kw = {} if precision is None else dict(precision=precision)
    return lgp.GP(hp['amp'] * lgp.ExpQuad(scale=hp['scale']),
                  **kw).addx(x, 'y')


def multidim_phase(dev='cuda'):
    """A full-width multi-dimensional fit: ``amp * ExpQuad(scale)`` on the
    Friedman #1 data (`multidim_data`), n = N_MD points in MD_P = 10
    dimensions as one structured field, the noise through ``givencov``,
    float32, the default ``gram`` ('auto': kernel C at p = 10 on the
    card).  Fits the two hyperparameters with ``empbayes_fit`` (at most
    MD_ITERS BFGS iterations) and predicts at the 64 held-out points;
    checks that kernel C ran at p = 10 only, its forward and its fused
    backward (one launch for all coordinates) once per evaluation, and
    that A and B ran; holds the NLL and gradient at the start and at the
    fit, and the posterior mean, to an independent float64 oracle
    (`plain_nll64`, `plain_mean64`: K from broadcast differences,
    ``torch.linalg.cholesky``); prints the time per evaluation, the peak
    memory of one value+gradient in B/n², the point block's time and a
    profile.  Returns the launch counts of the fit and the
    predictions."""
    import numpy as np
    import torch
    import lsqfitgp_torch as lgp
    f32 = torch.float32
    torch.set_default_dtype(f32)
    t_phase = time.perf_counter()

    def sync():
        if dev == 'cuda':
            torch.cuda.synchronize()

    xt, yt, xst, fs, noise = multidim_data(dev)
    data = {'y': yt}

    def gpfactory(hp, precision=None):
        return multidim_gp(hp, xt, precision)

    hyperprior = {'log(scale)': (0., 1.), 'log(amp)': (0., 1.)}
    log(f'multidim phase: Friedman #1, n = {N_MD} points uniform on '
        f'[0, 1]^{MD_P} (one field of {MD_P} coordinates), y standardized, '
        f'float32, amp * ExpQuad(scale), gram=\'auto\', givencov '
        f'{noise:.6g}')
    seen, restore = gram_p_recorder()
    try:
        sync()
        reset_counts()
        t0 = time.perf_counter()
        fit = lgp.empbayes_fit(hyperprior, gpfactory, (data, noise),
                               minkw={'maxiter': MD_ITERS}, raises=False)
        sync()
        wall = time.perf_counter() - t0
        fit_launches = read_counts()
        fit_seen = list(seen)
        gp = fit.gp().addx(xst, 'pred')
        mean = gp.predfromdata(data, 'pred', noise).mean
        sync()
        launches = read_counts()
    finally:
        restore()
    evals = len(fit.evaltimes)
    log(f'  fit: {wall:.2f} s wall, {fit.minresult.nit} BFGS iterations '
        f'(cap {MD_ITERS}), {evals} evaluations, median '
        f'{statistics.median(fit.evaltimes) * 1e3:.1f} ms per evaluation '
        f'(value + gradient); {fit.minresult.message}')
    log(f'  launches during the fit: {nonzero(fit_launches)}; fit + '
        f'predfromdata: {nonzero(launches)}')
    ps_seen = sorted(set(fit_seen))
    log(f'  kernel C launches (direction, p) during the fit: {ps_seen}')
    if dev == 'cuda':
        require_launched(fit_launches, ['schur_update_tc',
                                        'syrk_t_full__dmma'],
                         'the multidim fit')
        # the backward's one launch per evaluation covers all MD_P
        # coordinates
        require_counts(fit_launches, {'gram': evals, 'gram_bwd': evals},
                       'the multidim fit')
        if ps_seen != [('bwd', MD_P), ('fwd', MD_P)]:
            fail(f'kernel C ran at {ps_seen}, expected p = {MD_P} only')
    scale = float(fit.pmean['scale'])
    amp = float(fit.pmean['amp'])
    fitted = [math.log(scale), math.log(amp)]
    log(f'  fitted scale {scale:.6g}, amp {amp:.6g}; pmean '
        f'{fit.pmean.buf.tolist()}, pcov {fit.pcov.tolist()}')

    def value_grad32(lp, precision=None):
        gp0 = gpfactory({'scale': lp[0].exp(), 'amp': lp[1].exp()},
                        precision)
        return -gp0.marginal_likelihood(data, noise)

    def value_grad():
        lp = torch.tensor(fitted, device=dev, requires_grad=True)
        with lgp.disable_checks():
            nll = value_grad32(lp)
        g, = torch.autograd.grad(nll, lp)
        return float(nll.detach()), g.tolist()

    times = []
    for _ in range(5):
        sync()
        t0 = time.perf_counter()
        value_grad()
        times.append(time.perf_counter() - t0)
    log(f'  value+gradient at the fit: median '
        f'{statistics.median(times) * 1e3:.1f} ms (each: '
        f'{[round(t * 1e3, 1) for t in times]} ms)')

    if dev == 'cuda':
        sync()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        value_grad()
        sync()
        peak = torch.cuda.max_memory_allocated() - base
        log(f'  peak memory of one value+gradient above its inputs: '
            f'{peak / N_MD ** 2:.2f} B/n² ({peak / 2 ** 30:.2f} GiB)')
        lp = torch.tensor(fitted, device=dev, requires_grad=True)

        def block():
            with lgp.disable_checks():
                K = gpfactory({'scale': lp[0].exp(), 'amp': lp[1].exp()}
                              )._covblock('y', 'y', cache=False)
            torch.autograd.grad(K, lp, torch.ones_like(K))
        log(f'  point block (kernel C at p = {MD_P}) forward + backward: '
            f'{median_ms(block):.3f} ms')
        profile_phase(value_grad, top=16)

    # the oracle takes the points and the data as the port sees them,
    # rounded to float32
    X64 = xt['x'].double()
    Xs64 = xst['x'].double()
    y64 = data['y'].double()

    def grad64(lp):
        return plain_nll64(X64, y64, *lp, noise=noise)

    def cond_at(ls, la):
        with torch.no_grad():
            gp0 = gpfactory({'scale': torch.tensor(math.exp(ls)),
                             'amp': torch.tensor(math.exp(la))})
            K = gp0.prior('y', raw=True)
            K.diagonal().add_(noise)
            return float(lgp.linalg.Chol(K).cond_estimate)

    cond = cond_at(*fitted)
    check_points(N_MD, value_grad32, cond_at, X64, None,
                 [('start point', [0., 0.], False),
                  ('fitted point', fitted, True)], grad64=grad64,
                 noise=noise)

    eps32 = torch.finfo(f32).eps
    with torch.no_grad():
        ref = plain_mean64(X64, y64, Xs64, scale, amp, noise=noise)
    dmean = float((mean.double() - ref).abs().max())
    rmse = float(np.sqrt(np.mean((mean.double().cpu().numpy() - fs) ** 2)))
    log(f'  posterior mean at {NPRED} held-out points: max |port - '
        f'float64| {dmean:.3e}, max |mean| {float(ref.abs().max()):.4g} '
        f'(limit {10 * cond * eps32 * float(ref.abs().max()):.3e}); RMSE '
        f'against the standardized truth {rmse:.4g}')
    if not bool(torch.isfinite(mean).all()) or mean.shape != (NPRED,):
        fail('posterior mean not finite or of the wrong shape')
    if dmean > 10 * cond * eps32 * float(ref.abs().max()):
        fail('posterior mean disagrees with the float64 oracle')
    log(f'  multidim phase: {time.perf_counter() - t_phase:.1f} s')
    return launches


# -- the zoo's paths: Matérn-5/2 and the multiscale term sum ---------------------

# the cap of the Matérn fit's BFGS iterations
MATERN_ITERS = 10


def matern_phase(dev='cuda'):
    """Path 1 of the zoo: ``amp * Maternp(p=2, scale)`` plus 0.09 I on the
    dense slice's data (n = 16384 on [−50, 50], ``addcov`` +
    ``addlintransf``), float32, the default ``gram`` (kernel C on the
    Maternp profile, forward and fused backward once per evaluation),
    fitted with at most MATERN_ITERS BFGS iterations, then predicted at
    64 points; NLL and gradient at the start and at the fit, and the
    posterior mean, held to a closed-form float64 oracle (`matern52`) as
    the dense slice's are (`check_points`); the time per evaluation and
    the evaluation count beside the ExpQuad dense fit's."""
    import numpy as np
    import torch
    import lsqfitgp_torch as lgp
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
        gp = lgp.GP(hp['amp'] * lgp.Maternp(p=2, scale=hp['scale']), **kw)
        gp = gp.addx(xt, 'f').addcov(noise, 'e')
        return gp.addlintransf(lambda f, e: f + e, ['f', 'e'], 'y')

    hyperprior = {'log(scale)': (0., 1.), 'log(amp)': (0., 1.)}
    log(f'matern path: n = {N}, float32, amp * Maternp(p=2, scale) + '
        f'{NOISE_VAR} I, default gram, at most {MATERN_ITERS} BFGS '
        f'iterations')
    if dev == 'cuda':
        torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    fit = lgp.empbayes_fit(hyperprior, gpfactory, {'y': yt},
                           minkw={'maxiter': MATERN_ITERS}, raises=False)
    if dev == 'cuda':
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fit_launches = read_counts()
    gp = fit.gp().addx(xst, 'pred')
    mean = gp.predfromdata({'y': yt}, 'pred').mean
    launches = read_counts()
    evals = len(fit.evaltimes)
    ms = statistics.median(fit.evaltimes) * 1e3
    log(f'  fit: {wall:.2f} s wall, {fit.minresult.nit} BFGS iterations, '
        f'{evals} evaluations, median {ms:.1f} ms per evaluation (value + '
        f'gradient); the ExpQuad dense fit: '
        f'{DENSE_STATS.get("ms", float("nan")):.1f} ms per evaluation, '
        f'{DENSE_STATS.get("evals")} evaluations, '
        f'{DENSE_STATS.get("nit")} iterations')
    log(f'  launches during the fit: {nonzero(fit_launches)}; fit + '
        f'predfromdata: {nonzero(launches)}')
    if dev == 'cuda':
        require_launched(fit_launches, ['schur_update_tc',
                                        'syrk_t_full__dmma', 'gram@maternp',
                                        'gram_bwd@maternp'], 'the Matérn fit')
        require_counts(fit_launches, {'gram@maternp': evals,
                                      'gram_bwd@maternp': evals,
                                      'gram': evals, 'gram_bwd': evals,
                                      'gram#ZooOne': evals,
                                      'gram_bwd#ZooOne': evals},
                       'the Matérn fit')
    log(f'  evaluators: C {evaluators(fit_launches, "gram")}; its backward '
        f'{evaluators(fit_launches, "gram_bwd")}')
    scale = float(fit.pmean['scale'])
    amp = float(fit.pmean['amp'])
    fitted = [math.log(scale), math.log(amp)]
    log(f'  fitted scale {scale:.6g}, amp {amp:.6g}; pcov '
        f'{fit.pcov.tolist()}')
    K = gp.prior('y', raw=True)
    cond = float(lgp.linalg.Chol(K).cond_estimate)
    del K
    eps32 = torch.finfo(f32).eps
    log(f'  Chol.cond_estimate at the fit: {cond:.4g}')
    if not cond < 0.1 / eps32:
        fail('conditioning beyond the float32 factorization limit')
    x64, y64 = xt.double(), yt.double()

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
                  ('fitted point', fitted, True)],
                 grad64=lambda lp: plain_nll64(x64, y64, *lp,
                                               kern=matern52))
    with torch.no_grad():
        ref = plain_mean64(x64, y64, xst.double(), scale, amp, kern=matern52)
    dmean = float((mean.double() - ref).abs().max())
    log(f'  posterior mean at {NPRED} points: max |port - float64| '
        f'{dmean:.3e}, max |mean| {float(ref.abs().max()):.4g}')
    if not bool(torch.isfinite(mean).all()) or mean.shape != (NPRED,):
        fail('posterior mean not finite or of the wrong shape')
    if dmean > 10 * cond * eps32 * float(ref.abs().max()):
        fail('Matérn posterior mean disagrees with the float64 reference')
    return launches


def ms_terms(lp):
    """The multiscale model's terms for `plain_terms64`: (kern, log scale,
    log amp) of a1 Maternp(p=2, s1) and a2 ExpQuad(s2)."""
    return [(matern52, lp[1], lp[0]), (expquad64, lp[3], lp[2])]


def ms_kernel(lgp, lp):
    """a1 * Maternp(p=2, scale=s1) + a2 * ExpQuad(scale=s2) at the log
    parameters lp = (log a1, log s1, log a2, log s2)."""
    e = lp.exp()
    return e[0] * lgp.Maternp(p=2, scale=e[1]) \
        + e[2] * lgp.ExpQuad(scale=e[3])


def ms_check(what, n, nll32, g32, x64, y64, cond):
    """The port's float32 NLL and gradient in the multiscale model's four
    log parameters against `plain_terms64` at MS_POINT: the NLL within
    4 eps32 n dmax / σ² (the float32 path's diagonal anchor, as
    `check_points`), the gradient within 10 cond eps32 relative."""
    import torch
    eps32 = torch.finfo(torch.float32).eps
    nll64, g64 = plain_terms64(x64, y64, ms_terms(MS_POINT))
    # plain_terms64 gives (log scale, log amp) per term: to (log a1, log
    # s1, log a2, log s2)
    g64 = g64[[1, 0, 3, 2]]
    dnll = abs(float(nll32) - nll64)
    rel = float((g32.double() - g64).norm() / g64.norm())
    dmax = math.exp(MS_POINT[0]) + math.exp(MS_POINT[2]) + NOISE_VAR
    log(f'  {what}: NLL port float32 {float(nll32):.8g}, plain float64 '
        f'{nll64:.8g}, |diff| {dnll:.3e} (limit '
        f'{4 * eps32 * n * dmax / NOISE_VAR:.3e}); gradient port '
        f'{g32.tolist()}, plain {g64.tolist()}, relative diff {rel:.3e} '
        f'(limit {10 * cond * eps32:.3e})')
    if dnll > 4 * eps32 * n * dmax / NOISE_VAR:
        fail(f'{what}: NLL disagrees with the float64 reference')
    if rel > 10 * cond * eps32:
        fail(f'{what}: gradient disagrees with the float64 reference')


def ms_dense_data(dev):
    """The multiscale path's dense data, float32 on ``dev``: n = N points
    on [-50, 50], y = sin(x) plus noise of the dense slice's variance,
    and that variance's diagonal as a matrix."""
    import numpy as np
    import torch
    rng = np.random.default_rng(20261016)
    x = rng.uniform(-50, 50, N)
    y = np.sin(x) + math.sqrt(NOISE_VAR) * rng.standard_normal(N)
    f32 = torch.float32
    return (torch.as_tensor(x, dtype=f32, device=dev),
            torch.as_tensor(y, dtype=f32, device=dev),
            NOISE_VAR * torch.eye(N, dtype=f32, device=dev))


def ms_dense_gp(lgp, lp, xt, noise):
    """The multiscale model's dense GP at the log parameters lp: the
    default gram, the noise as a component of its own, 'y' their sum."""
    gp = lgp.GP(ms_kernel(lgp, lp)).addx(xt, 'f').addcov(noise, 'e')
    return gp.addlintransf(lambda f, e: f + e, ['f', 'e'], 'y')


def ms_stream_gp(lgp, lp):
    """The multiscale model plus its white noise, streaming."""
    k = ms_kernel(lgp, lp) + NOISE_VAR * lgp.White()
    return lgp.GP(k, solver='chol-stream', block=STREAM_BLOCK, b1=128)


def multiscale_phase(dev='cuda'):
    """Path 2 of the zoo: the multiscale model a1 Maternp(p=2, s1) + a2
    ExpQuad(s2) at MS_POINT, float32.  Dense: one value+gradient at
    n = 16384 on the dense slice's data with the noise as the dense
    slice's, the default gram (kernel C on the two-term profile and its
    fused backward, once each, four parameter sums), held to float64.
    Streaming: ``+ 0.09 * White()``, ``solver='chol-stream'``, n = 65536
    on the streaming slice's data, two value+gradients with the exact
    gradient (C and D on the term sum, C's float64 backward once per
    strip); then at n = 32768 the streaming NLL, gradient and posterior
    mean held to float64.  Returns the dense and streaming runs' launch
    counts."""
    import torch
    import lsqfitgp_torch as lgp
    f32 = torch.float32
    torch.set_default_dtype(f32)
    key = 'maternp+expquad'
    lp0 = torch.tensor(MS_POINT, dtype=f32, device=dev)
    # dense
    xt, yt, noise = ms_dense_data(dev)

    def dense_gp(lp):
        return ms_dense_gp(lgp, lp, xt, noise)

    log(f'multiscale path: a1 * Maternp(p=2, scale=s1) + a2 * '
        f'ExpQuad(scale=s2) at (log a1, log s1, log a2, log s2) = '
        f'{MS_POINT}, float32')
    times = []
    reset_counts()
    for _ in range(3):
        if dev == 'cuda':
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        lp = lp0.clone().requires_grad_()
        nll = -dense_gp(lp).marginal_likelihood({'y': yt})
        g, = torch.autograd.grad(nll, lp)
        if dev == 'cuda':
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    counts = read_counts()
    log(f'  dense, n = {N}: {statistics.median(times) * 1e3:.1f} ms per '
        f'value+gradient (median of 3, the first with the build of its '
        f'route); launches {nonzero(counts)}')
    log(f'  evaluators: C {evaluators(counts, "gram")}; its backward '
        f'{evaluators(counts, "gram_bwd")}')
    if dev == 'cuda':
        require_counts(counts, {f'gram@{key}': 3, f'gram_bwd@{key}': 3,
                                'gram#ZooSum': 3, 'gram_bwd#ZooSum': 3},
                       'the dense multiscale evaluations')
        require_launched(counts, ['schur_update_tc', 'syrk_t_full__dmma'],
                         'the dense multiscale evaluations')
    with torch.no_grad():
        K = dense_gp(lp0).prior('y', raw=True)
        cond = float(lgp.linalg.Chol(K).cond_estimate)
        del K
    log(f'  Chol.cond_estimate: {cond:.4g}')
    ms_check(f'dense n = {N}', N, nll.detach(), g, xt.double(),
             yt.double(), cond)
    del noise
    torch.cuda.empty_cache()

    # streaming
    def stream_gp(lp):
        return ms_stream_gp(lgp, lp)

    xs_, ys_, _ = stream_data(N_STREAM)
    log(f'  streaming: n = {N_STREAM}, + {NOISE_VAR} * White(), '
        f'solver=chol-stream, block={STREAM_BLOCK}, two value+gradients')
    if dev == 'cuda':
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        lp = lp0.clone().requires_grad_()
        # as a fit evaluates it: checks off
        with lgp.disable_checks():
            nll = -stream_gp(lp).addx(xs_, 'f').marginal_likelihood(
                {'f': ys_})
        g, = torch.autograd.grad(nll, lp)
        if dev == 'cuda':
            torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        log(f'    NLL {float(nll.detach()):.8g}, gradient {g.tolist()}, '
            f'{times[-1]:.3f} s')
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() if dev == 'cuda' else 0
    log(f'  streaming: {[round(t, 3) for t in times]} s per value+gradient, '
        f'peak {peak / N_STREAM ** 2:.2f} B/n²; launches {nonzero(counts)}')
    if not (math.isfinite(float(nll.detach()))
            and bool(torch.isfinite(g).all())):
        fail('streaming multiscale: non-finite NLL or gradient')
    if dev == 'cuda':
        strips = -(-N_STREAM // (4 * STREAM_BLOCK))
        require_launched(counts, [f'schur_update_gram_tc@{key}',
                                  f'gram@{key}', 'schur_update_tc'],
                         'the streaming multiscale evaluations')
        require_counts(counts, {f'gram_bwd@{key}': 3 + 2 * strips,
                                'gram_bwd#ZooSum': 3 + 2 * strips},
                       'the streaming multiscale evaluations')

    # the streaming check at n = 32768 against float64
    x, y, xs = stream_data(N_CHECK)
    x64 = torch.as_tensor(x, dtype=f32, device=dev).double()
    y64 = torch.as_tensor(y, dtype=f32, device=dev).double()
    lp = lp0.clone().requires_grad_()
    nll = -stream_gp(lp).addx(x, 'f').marginal_likelihood({'f': y})
    g, = torch.autograd.grad(nll, lp)
    with torch.no_grad():
        xt = torch.as_tensor(x, dtype=f32, device=dev)
        K = lgp.GP(ms_kernel(lgp, lp0), gram='tiled').addx(xt, 'f') \
            .prior('f', raw=True)
        K.diagonal().add_(NOISE_VAR)
        cond = float(lgp.linalg.Chol(K).cond_estimate)
        del K
    log(f'  streaming check, n = {N_CHECK}: Chol.cond_estimate (dense '
        f'float32) {cond:.4g}')
    ms_check(f'streaming n = {N_CHECK}', N_CHECK, nll.detach(), g, x64, y64,
             cond)
    gp = stream_gp(lp0).addx(x, 'f').addx(xs, 'pred')
    mean = gp.predfromdata({'f': y}, 'pred').mean
    with torch.no_grad():
        xs64 = torch.as_tensor(xs, dtype=f32, device=dev).double()
        ref = plain_mean64(x64, y64, xs64, None, None,
                           terms=ms_terms(MS_POINT))
    dmean = float((mean.double() - ref).abs().max())
    eps32 = torch.finfo(f32).eps
    log(f'  streaming posterior mean at {NPRED} points: max |port - '
        f'float64| {dmean:.3e}, limit '
        f'{10 * cond * eps32 * float(ref.abs().max()):.3e}')
    if not bool(torch.isfinite(mean).all()) or mean.shape != (NPRED,):
        fail('streaming posterior mean not finite or of the wrong shape')
    if dmean > 10 * cond * eps32 * float(ref.abs().max()):
        fail('streaming multiscale posterior mean disagrees with the '
             'float64 reference')
    return counts


# -- the time-series path: examples/timeseries_streaming.py's model --------------

# the example's true values and hyperprior (log amp, log γ, log noise)
TS_TRUE = dict(amp=1.2, gamma=0.1, B=0.05, noise=0.04)
TS_PRIOR = {'log(amp)': (0., 1.), 'log(gamma)': (math.log(0.2), 1.),
            'log(noise)': (math.log(0.02), 1.)}
TS_KEYS = ('amp', 'gamma', 'noise')
TS_ITERS = 10          # the dense fit's BFGS iterations, at most
# the streaming fit's, from the dense MAP: 3 until the Hurst path (its
# own streaming fit) joined the run
TS_STREAM_ITERS = 1
TS_WINDOW = 4096       # the data's independent windows
TS_SEED = 20261019
TS_FORECAST = 60


def ts_kernel_specs():
    """The kernel phase's specs of the time-series records: C and its
    backward on each core of TS_RECORDS (p = 1, and p = 10 for the two
    without maxdim 1), E and its backward, C′ and C″ on Periodic, D on
    Celerite at 'high' (n = 65536) and in float64 (n = 32768)."""
    import torch
    f32, f64 = torch.float32, torch.float64
    gram_cu = 'lsqfitgp_torch/csrc/gram.cu'
    specs = []
    for name, (ps, _, _) in TS_RECORDS.items():
        for p in ps:
            specs.append((f'gram {name} p={p}',
                          lambda dtype, gen, name=name, p=p:
                          kernel_zoo(dtype, gen, name, p), gram_cu,
                          'lsqfitgp_tpu/ops/_gram.py:68', [f32, f64]))
    return specs + [
        ('gram_sym periodic',
         lambda dtype, gen: kernel_zoo_sym(dtype, gen, 'periodic'), gram_cu,
         'lsqfitgp_tpu/ops/_gram.py:157', [f32, f64]),
        ('gram tangents periodic',
         lambda dtype, gen: kernel_zoo_tangent(dtype, gen, 'periodic'),
         gram_cu, None, [f32, f64]),
        ('schur_update_gram/celerite',
         lambda dtype, gen: kernel_schur_gram(dtype, gen, 'celerite'),
         'lsqfitgp_torch/csrc/syrk.cu', 'lsqfitgp_tpu/ops/_syrk.py:334',
         [f32, f64])]


def kernel_matern_table(dtype, gen):
    """The real-order Matérn's table builder, ``matern_table_kernel``
    (csrc/special.cuh), on the tables of the evidence path's order
    (f_ν, and f_{ν−1}, its first derivative's) and of ν = 0.7's raw
    form, each built anew (the cache emptied), held to the plain builder
    on the host (`ops.matern_table_plain`): each coefficient within (eps
    + 64 eps₆₄) of its panel's largest (the two quadratures' exponentials
    and logarithms differ by an ulp or two; a float32 coefficient may
    round the other way).  Timed: one build (device time) against the
    plain builder on the card; bound: the quadrature's operations at the
    table's nodes in float64 (100 nodes of about 20 operations, a special
    function one) or the table's bytes.  The record 'matern_table' counts
    the evidence path's builds (float32; none in float64)."""
    import torch
    from lsqfitgp_torch import ops
    from lsqfitgp_torch.ops import _mtable
    dev = torch.device('cuda', torch.cuda.current_device())
    nu = float(torch.tensor(EV_NU, dtype=dtype))
    elo, ehi, nc, npan = _mtable.layout(dtype)
    err = 0.0
    for order, kind in ((nu, 0), (nu - 1, 0), (0.7, 1)):
        _mtable._CACHE.pop((order, kind, dtype, dev), None)
        n0 = ops.matern_table.launches
        got = ops.matern_table(order, kind, dtype, dev).double().reshape(
            npan, nc)
        if ops.matern_table.launches != n0 + 1:
            fail(f'matern_table {order} {kind}: not built by its kernel')
        ref = ops.matern_table_plain(order, kind, dtype).double().reshape(
            npan, nc).to(dev)
        tol = (torch.finfo(dtype).eps + 64 * torch.finfo(torch.float64).eps) \
            * ref.abs().amax(1, keepdim=True)
        err = max(err, check_close(
            f'matern_table_kernel order {order:.8g} kind {kind} {dtype}',
            got, ref, tol))

    def build():
        _mtable._CACHE.pop((nu, 0, dtype, dev), None)
        return ops.matern_table(nu, 0, dtype, dev)

    ms = device_ms(build, 5, kernel='matern_table_kernel')
    plain_ms = median_ms(
        lambda: _mtable.matern_table_plain(nu, 0, dtype, device='cuda'), 3)
    nodes = npan * nc
    bd = bound(torch.finfo(dtype).bits // 8 * nodes, nodes * 100 * 20,
               torch.float64)
    isz = torch.finfo(dtype).bits // 8
    log(f'  matern_table_kernel {dtype}: {npan} panels of {nc} '
        f'coefficients on [2^{elo}, 2^{ehi}), {nodes * isz} bytes; build '
        f'{ms:.4f} ms, plain builder {plain_ms:.3f} ms, bound {bd[0]:.2e} '
        f'ms ({bd[1]})')
    label = str(dtype).split('.')[-1]
    return [record(err, ms, plain_ms, bd, dtype=label, counter='launches',
                   path='evidence' if label == 'float32' else None,
                   precision=label)]


def kernel_sfb_table(dtype, gen):
    """StationaryFracBrownian's coefficient builder, ``sfb_table_kernel``
    (csrc/profiles.cuh), at the Hurst path's true H and at 0.3 and 1:
    its table against the plain builder (`ops.sfb_coeffs_plain`), each
    entry within (eps + 64 eps₆₄) of its column's largest (the float64
    recurrence's multiply-adds may fuse on the card; a float32 entry is
    the float64 one rounded).  Timed: one build (device time) against
    the plain builder (host arithmetic, and the copy to the card); bound:
    its table's bytes or its 2 J recurrence steps of about 8 float64
    operations, two divisions among them, each one (its single thread's
    latency bounds it).  The record 'sfb_table' counts the Hurst path's
    builds (float32; none in float64)."""
    import torch
    from lsqfitgp_torch import ops
    from lsqfitgp_torch.ops import _gram
    J = _gram.SFB_TERMS[dtype]
    err = 0.0
    for H in (HURST_TRUE['H'], 0.3, 1.0):
        Ht = torch.tensor(H, device='cuda', dtype=dtype)
        n0 = ops.sfb_table.launches
        got = ops.sfb_table(Ht).double()
        if ops.sfb_table.launches != n0 + 1:
            fail(f'sfb_table H={H}: not built by its kernel')
        ref = ops.sfb_coeffs_plain(Ht, J).to('cuda')
        tol = (torch.finfo(dtype).eps + 64 * torch.finfo(torch.float64).eps) \
            * ref.abs().amax(0, keepdim=True)
        err = max(err, check_close(f'sfb_table_kernel H={H} {dtype}', got,
                                   ref, tol))
    Ht = torch.tensor(HURST_TRUE['H'], device='cuda', dtype=dtype)
    ms = device_ms(lambda: ops.sfb_table(Ht), GRAM_BATCH,
                   kernel='sfb_table_kernel')
    plain_ms = median_ms(lambda: ops.sfb_coeffs_plain(Ht, J).to(
        device='cuda', dtype=dtype), 5)
    isz = torch.finfo(dtype).bits // 8
    bd = bound(isz * (6 + 4 * J), 2 * J * 8, torch.float64)
    log(f'  sfb_table_kernel {dtype}: {J} rows of {_gram.SFB_COLS}; build '
        f'{ms:.4f} ms, plain builder {plain_ms:.3f} ms, bound {bd[0]:.2e} '
        f'ms ({bd[1]})')
    label = str(dtype).split('.')[-1]
    return [record(err, ms, plain_ms, bd, dtype=label, counter='launches',
                   path='hurst' if label == 'float32' else None,
                   precision=label)]


def core_kernel_specs():
    """The kernel phase's specs of the last spec-carrying cores: C and
    its backward on each of CORE_RECORDS (p = 1; Bessel at p = 2 and
    Matérn-ν, of the evidence path's order and of 0.7, at the multidim
    cell's p too), E and its backward, C′ and C″ on Matérn-ν, D on
    StationaryFracBrownian and on Matérn-ν at 'high' (n = 65536) and in
    float64 (n = 32768), and the tables' builders (Matérn-ν's and
    StationaryFracBrownian's; the latter stands in for no TPU kernel:
    its 'replaces' names the JAX kernel whose coefficients it forms)."""
    import torch
    f32, f64 = torch.float32, torch.float64
    gram_cu = 'lsqfitgp_torch/csrc/gram.cu'
    specs = [('matern_table', kernel_matern_table,
              'lsqfitgp_torch/csrc/special.cuh',
              'lsqfitgp_tpu/special/_kv.py:88', [f32, f64]),
             ('sfb_table', kernel_sfb_table,
              'lsqfitgp_torch/csrc/profiles.cuh',
              'lsqfitgp_tpu/kernels/_randomwalk.py:121', [f32, f64])]
    for name, (ps, _, _) in CORE_RECORDS.items():
        for p in ps:
            specs.append((f'gram {name} p={p}',
                          lambda dtype, gen, name=name, p=p:
                          kernel_zoo(dtype, gen, name, p), gram_cu,
                          'lsqfitgp_tpu/ops/_gram.py:68', [f32, f64]))
    specs += [
        ('gram_sym matern',
         lambda dtype, gen: kernel_zoo_sym(dtype, gen, 'matern'), gram_cu,
         'lsqfitgp_tpu/ops/_gram.py:157', [f32, f64]),
        ('gram tangents matern',
         lambda dtype, gen: kernel_zoo_tangent(dtype, gen, 'matern'),
         gram_cu, None, [f32, f64])]
    for name in ('sfb', 'matern'):
        specs.append((f'schur_update_gram/{name}',
                      lambda dtype, gen, name=name:
                      kernel_schur_gram(dtype, gen, name),
                      'lsqfitgp_torch/csrc/syrk.cu',
                      'lsqfitgp_tpu/ops/_syrk.py:334', [f32, f64]))
    return specs


def ts_data(n, seed=TS_SEED):
    """The time-series path's data, in float64 on the host with numpy
    only: t sorted uniform on [0, 120 n / 700] (the example's 5.8 points
    per unit time), rounded to float32; y from the true model
    (TS_TRUE), drawn by a Cholesky of the true covariance in independent
    windows of TS_WINDOW consecutive points (each window exact, the
    correlation across a window's edge dropped: e^{−γΔ} of the points
    there), rounded to float32."""
    import numpy as np
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0.0, 120.0 * n / 700, n)).astype(np.float32)
    t64 = t.astype(np.float64)
    y = np.empty(n)
    a, g, B, s2 = (TS_TRUE[k] for k in ('amp', 'gamma', 'B', 'noise'))
    for i in range(0, n, TS_WINDOW):
        tw = t64[i:i + TS_WINDOW]
        d = np.abs(tw[:, None] - tw[None, :])
        K = a * np.exp(-g * d) * (np.cos(d) + B * np.sin(d))
        K[np.diag_indices_from(K)] += s2
        y[i:i + TS_WINDOW] = np.linalg.cholesky(K) \
            @ rng.standard_normal(tw.size)
    return t, y.astype(np.float32)


def ts_kernel(lgp, hp):
    return hp['amp'] * lgp.Celerite(gamma=hp['gamma'], B=TS_TRUE['B']) \
        + hp['noise'] * lgp.White()


def celerite64(t, ts, gamma, rows=4096):
    """Celerite(γ, B) between the float64 points t and ts, and its
    derivative in log γ, by blocks of rows: (C, −γ|Δ| C); no port
    code."""
    import torch
    C = t.new_empty((t.shape[0], ts.shape[0]))
    dC = torch.empty_like(C)
    B = TS_TRUE['B']
    for i in range(0, t.shape[0], rows):
        d = (t[i:i + rows, None] - ts[None, :]).abs_()
        E = torch.exp(-gamma * d)
        C[i:i + rows] = E * (torch.cos(d) + B * torch.sin(d))
        dC[i:i + rows] = -gamma * d * C[i:i + rows]
    return C, dC


def ts_nll64(t, y, lp):
    """Independent float64 reference of the likelihood part of the
    objective of K = amp C + noise I, C = Celerite(γ, B), and its
    gradient in (log amp, log γ, log noise): dense K,
    ``torch.linalg.cholesky``, ½ <K⁻¹ − α αᵀ, ∂K>; no port code."""
    import torch
    amp, gamma, noise = (math.exp(v) for v in lp)
    C, dC = celerite64(t, t, gamma)
    K = C * amp
    K.diagonal().add_(noise)
    L = torch.linalg.cholesky(K)
    del K
    z = torch.linalg.solve_triangular(L, y[:, None], upper=False)
    nll = 0.5 * float(z.T @ z) + float(torch.log(L.diagonal()).sum()) \
        + 0.5 * len(t) * math.log(2 * math.pi)
    alpha = torch.cholesky_solve(y[:, None], L)[:, 0]
    G = torch.cholesky_inverse(L)
    del L
    G.addr_(alpha, alpha, alpha=-1).mul_(0.5)
    g = torch.stack([amp * (G * C).sum(), amp * (G * dC).sum(),
                     noise * G.diagonal().sum()])
    return nll, g


def ts_mean64(t, y, ts, lp):
    """Float64 reference of the posterior mean at ts."""
    import torch
    amp, gamma, noise = (math.exp(v) for v in lp)
    K = celerite64(t, t, gamma)[0] * amp
    K.diagonal().add_(noise)
    L = torch.linalg.cholesky(K)
    del K
    return (celerite64(t, ts, gamma)[0] * amp).T \
        @ torch.cholesky_solve(y[:, None], L)[:, 0]


def ts_check(what, n, nll32, g32, truth, lp, cond, near_optimum):
    """The port's float32 NLL and gradient in lp = (log amp, θ, log
    noise) against the float64 reference ``truth(lp)`` -> (nll,
    gradient[, the gradient's scale]) (`ts_nll64`, `hurst_nll64`), for a
    kernel of unit variance: the NLL within 4 eps32 n (amp + noise) /
    noise (the float32 path's diagonal anchor, as `check_points`); away
    from an optimum the gradient within 10 cond eps32 of its scale (its
    norm, or that of its terms' sizes); near one the optimum's shift
    H⁻¹ dg within a tenth of the posterior standard deviation, H the
    float64 Hessian of the objective (central differences of the float64
    gradient plus the N(·, 1) priors' identity), whose inverse's
    diagonal's square root, the posterior standard deviations, it
    returns (None away from an optimum)."""
    import torch
    eps32 = torch.finfo(torch.float32).eps
    nll64, g64, *scale = truth(lp)
    # the gradient's scale: its own size, or where ``truth`` gives them
    # the sizes of its two terms, ½|tr(K⁻¹ ∂K)| + ½|αᵀ ∂K α| (they
    # cancel to a gradient far smaller than either, whose error follows
    # theirs)
    scale = scale[0] if scale else g64.abs()
    dnll = abs(float(nll32) - nll64)
    amp, noise = math.exp(lp[0]), math.exp(lp[2])
    lim = 4 * eps32 * n * (amp + noise) / noise
    dg = g32.double() - g64
    log(f'  {what} at {[round(v, 6) for v in lp]}: cond_estimate '
        f'{cond:.4g}; NLL port '
        f'float32 {float(nll32):.8g}, plain float64 {nll64:.8g}, |diff| '
        f'{dnll:.3e} (limit {lim:.3e}); gradient port {g32.tolist()}, '
        f'plain {g64.tolist()}')
    if dnll > lim:
        fail(f'{what}: NLL disagrees with the float64 reference')
    if not near_optimum:
        rel = float(dg.norm() / scale.norm())
        log(f'    diff relative to the gradient\'s scale {rel:.3e} (limit '
            f'{10 * cond * eps32:.3e})')
        if rel > 10 * cond * eps32:
            fail(f'{what}: gradient disagrees with the float64 reference')
        return None
    h = 1e-3
    H = torch.stack([
        (truth([v + h * (k == j) for j, v in enumerate(lp)])[1]
         - truth([v - h * (k == j) for j, v in enumerate(lp)])[1]) / (2 * h)
        for k in range(3)], 1)
    Hinv = torch.linalg.inv(0.5 * (H + H.T)
                            + torch.eye(3, dtype=H.dtype, device=H.device))
    shift = (Hinv @ dg).abs() / Hinv.diagonal().sqrt()
    log(f'    optimum shift from the gradient error: {shift.tolist()} '
        f'posterior sdev (limit 0.1)')
    if not bool((shift <= 0.1).all()):
        fail(f'{what}: the gradient error moves the optimum too far')
    return Hinv.diagonal().sqrt()


def timeseries_phase(dev='cuda'):
    """The time-series path: examples/timeseries_streaming.py's model,
    ``amp * Celerite(gamma, B=0.05) + noise * White()``, its hyperprior
    and its data's true values and density (`ts_data`), float32.

    Dense, n = N: ``empbayes_fit`` with at most TS_ITERS BFGS
    iterations, the default gram (kernel C on the celerite profile,
    forward and fused backward once per evaluation), the noise the
    scalar ``givencov`` of the data (``data=lambda hp: ({'obs': y},
    hp['noise'])``): a White component in the kernel makes the dense GP
    broadcast the block (its δ needs the x == y comparison, in the JAX
    package too), while the streaming solver takes it as the same iid
    diagonal; NLL and gradient at the start and at the fit and the
    posterior mean at NPRED points past the data held to float64
    (`ts_check`, `ts_mean64`).  Streaming, n = N_STREAM:
    ``solver='chol-stream'``, at most TS_STREAM_ITERS iterations from the
    dense MAP (kernel D on the celerite profile at every internal node,
    C's fused backward once per gradient strip); the NLL and its exact
    gradient at the prior mean held to float64 at n = N_CHECK; a forecast
    of TS_FORECAST points across the end of the data by
    ``fit.gp().addx`` and ``predfromdata``, finite, its sdev growing past
    the data, as the example asserts.  Returns the launch counts of the
    whole phase."""
    import numpy as np
    import torch
    import lsqfitgp_torch as lgp
    f32 = torch.float32
    cuda = dev == 'cuda'
    torch.set_default_dtype(f32)
    key = 'celerite'
    reset_counts()
    t0 = time.perf_counter()
    t, y = ts_data(N)
    log(f'timeseries path: amp * Celerite(gamma, B={TS_TRUE["B"]}) + noise '
        f'* White(), true {TS_TRUE}, data seed {TS_SEED}, drawn in '
        f'independent windows of {TS_WINDOW} points '
        f'({time.perf_counter() - t0:.1f} s on the host)')
    tt = torch.as_tensor(t, device=dev)
    yt = torch.as_tensor(y, device=dev)
    span = 120.0 * N / 700

    def gpfactory(hp):
        k = hp['amp'] * lgp.Celerite(gamma=hp['gamma'], B=TS_TRUE['B'])
        return lgp.GP(k).addx(tt, 'obs')

    log(f'  dense: n = {N} on [0, {span:.1f}], float32, default gram, the '
        f'noise as givencov, at most {TS_ITERS} BFGS iterations')
    if cuda:
        torch.cuda.synchronize()
    before = read_counts()
    t1 = time.perf_counter()
    fit = lgp.empbayes_fit(TS_PRIOR, gpfactory,
                           lambda hp: ({'obs': yt}, hp['noise']),
                           minkw={'maxiter': TS_ITERS}, raises=False)
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    fit_counts = counts_since(before)
    evals = len(fit.evaltimes)
    ms = statistics.median(fit.evaltimes) * 1e3
    q1, _, q3 = statistics.quantiles(fit.evaltimes, n=4) if evals > 1 \
        else [fit.evaltimes[0]] * 3
    log(f'  fit: {wall:.2f} s wall, {fit.minresult.nit} BFGS iterations, '
        f'{evals} evaluations, median {ms:.1f} ms per evaluation (value + '
        f'gradient; quartiles {q1 * 1e3:.1f}, {q3 * 1e3:.1f}, range '
        f'{min(fit.evaltimes) * 1e3:.1f} to {max(fit.evaltimes) * 1e3:.1f});'
        f' launches {nonzero(fit_counts)}')
    if cuda:
        require_launched(fit_counts, ['schur_update_tc', 'syrk_t_full__dmma',
                                      f'gram@{key}', f'gram_bwd@{key}'],
                         'the dense time-series fit')
        require_counts(fit_counts, {f'gram@{key}': evals,
                                    f'gram_bwd@{key}': evals,
                                    'gram': evals, 'gram_bwd': evals,
                                    'gram#ZooOne': evals,
                                    'gram_bwd#ZooOne': evals},
                       'the dense time-series fit')
    log(f'  evaluators: C {evaluators(fit_counts, "gram")}; its backward '
        f'{evaluators(fit_counts, "gram_bwd")}')
    fitted = [math.log(float(fit.pmean[k])) for k in TS_KEYS]
    log(f'  fitted amp, gamma, noise {[float(fit.pmean[k]) for k in TS_KEYS]}'
        f' (true {[TS_TRUE[k] for k in TS_KEYS]}); pcov '
        f'{fit.pcov.tolist()}')
    t64, y64 = tt.double(), yt.double()

    def value_grad32(lp):
        lp = torch.tensor(lp, dtype=f32, device=dev, requires_grad=True)
        hp = dict(zip(TS_KEYS, lp.exp()))
        nll = -gpfactory(hp).marginal_likelihood({'obs': yt}, hp['noise'])
        g, = torch.autograd.grad(nll, lp)
        with torch.no_grad():
            K = gpfactory(hp).prior('obs', raw=True)
            K.diagonal().add_(hp['noise'])
            cond = float(lgp.linalg.Chol(K).cond_estimate)
        return nll.detach(), g, cond

    start = [TS_PRIOR[f'log({k})'][0] for k in TS_KEYS]
    for label, lp, near in (('start point', start, False),
                            ('fitted point', fitted, True)):
        nll, g, cond = value_grad32(lp)
        if not cond < 0.1 / torch.finfo(f32).eps:
            fail('conditioning beyond the float32 factorization limit')
        ts_check(f'dense n = {N}, {label}', N, nll, g,
                 lambda q: ts_nll64(t64, y64, q), lp, cond, near)
    xs = np.linspace(span, span + 20, NPRED)
    xst = torch.as_tensor(xs, dtype=f32, device=dev)
    mean = fit.gp().addx(xst, 'pred').predfromdata(
        {'obs': yt}, 'pred', fit.pmean['noise']).mean
    with torch.no_grad():
        ref = ts_mean64(t64, y64, xst.double(), fitted)
    dmean = float((mean.double() - ref).abs().max())
    eps32 = torch.finfo(f32).eps
    lim = 10 * cond * eps32 * float(ref.abs().max())
    log(f'  posterior mean at {NPRED} points past the data: max |port - '
        f'float64| {dmean:.3e} (limit {lim:.3e}), max |mean| '
        f'{float(ref.abs().max()):.4g}')
    if not bool(torch.isfinite(mean).all()) or mean.shape != (NPRED,):
        fail('time-series posterior mean not finite or of the wrong shape')
    if dmean > lim:
        fail('time-series posterior mean disagrees with the float64 '
             'reference')
    del fit, mean
    if cuda:
        torch.cuda.empty_cache()

    # streaming
    t, y = ts_data(N_STREAM)
    span = 120.0 * N_STREAM / 700

    def stream_gp(hp):
        return lgp.GP(ts_kernel(lgp, hp), solver='chol-stream',
                      block=STREAM_BLOCK, b1=128)

    log(f'  streaming: n = {N_STREAM} on [0, {span:.1f}], solver='
        f'chol-stream, block={STREAM_BLOCK}, at most {TS_STREAM_ITERS} BFGS '
        f'iterations from the dense MAP')
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    before = read_counts()
    t1 = time.perf_counter()
    sfit = lgp.empbayes_fit(TS_PRIOR, lambda hp: stream_gp(hp).addx(t, 'obs'),
                            {'obs': y}, initial=fitted,
                            minkw={'maxiter': TS_STREAM_ITERS}, raises=False)
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    counts = counts_since(before)
    ev = sfit.evaltimes
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    log(f'  streaming fit: {wall:.2f} s wall, {sfit.minresult.nit} BFGS '
        f'iterations, {len(ev)} evaluations, {statistics.median(ev):.3f} s '
        f'median per value + gradient, peak {peak / N_STREAM ** 2:.2f} B/n²;'
        f' launches {nonzero(counts)}')
    if cuda:
        strips = -(-N_STREAM // (4 * STREAM_BLOCK))
        require_launched(counts, [f'schur_update_gram_tc@{key}',
                                  f'gram@{key}', 'schur_update_tc'],
                         'the streaming time-series fit')
        require_counts(counts, {f'gram_bwd@{key}': strips * len(ev),
                                'gram_bwd#ZooOne': strips * len(ev)},
                       'the streaming time-series fit')
    log(f'  evaluators: C {evaluators(counts, "gram")}; its backward '
        f'{evaluators(counts, "gram_bwd")}')
    end = [math.log(float(sfit.pmean[k])) for k in TS_KEYS]
    log(f'  end point amp, gamma, noise '
        f'{[float(sfit.pmean[k]) for k in TS_KEYS]}')
    tstar = np.linspace(span - 20, span + 20, TS_FORECAST)
    post = sfit.gp().addx(tstar, 'forecast').predfromdata({'obs': y},
                                                          'forecast')
    fmean, fsdev = post.mean, post.sdev
    log(f'  forecast of {TS_FORECAST} points on [{tstar[0]:.1f}, '
        f'{tstar[-1]:.1f}]: sdev {float(fsdev[0]):.4f} -> '
        f'{float(fsdev[-1]):.4f} (prior level '
        f'{math.sqrt(float(sfit.pmean["amp"])):.4f})')
    if not (bool(torch.isfinite(fmean).all())
            and bool(torch.isfinite(fsdev).all())
            and bool((fsdev >= 0).all())):
        fail('time-series forecast not finite')
    if not float(fsdev[-1]) > float(fsdev[0]):
        fail('time-series forecast: the sdev does not grow past the data')
    del sfit, post
    if cuda:
        torch.cuda.empty_cache()

    # the streaming check at n = N_CHECK against float64
    t, y = ts_data(N_CHECK)
    tt = torch.as_tensor(t, device=dev)
    yt = torch.as_tensor(y, device=dev)
    lp = torch.tensor(start, dtype=f32, device=dev, requires_grad=True)
    with lgp.disable_checks():
        nll = -stream_gp(dict(zip(TS_KEYS, lp.exp()))).addx(tt, 'obs') \
            .marginal_likelihood({'obs': yt})
    g, = torch.autograd.grad(nll, lp)
    with torch.no_grad():
        # the condition of the matrix the streaming solver factors, K +
        # noise I (a White kernel would make duplicate points singular)
        hp = dict(zip(TS_KEYS, lp.exp()))
        K = lgp.GP(hp['amp'] * lgp.Celerite(gamma=hp['gamma'],
                                            B=TS_TRUE['B'])).addx(
            tt, 'obs').prior('obs', raw=True)
        K.diagonal().add_(hp['noise'])
        cond = float(lgp.linalg.Chol(K).cond_estimate)
        del K
    t64, y64 = tt.double(), yt.double()
    ts_check(f'streaming n = {N_CHECK}', N_CHECK, nll.detach(), g,
             lambda q: ts_nll64(t64, y64, q), start, cond, False)
    counts = read_counts()
    log(f'  the phase: {time.perf_counter() - t0:.1f} s; launches '
        f'{nonzero(counts)}')
    return counts


# -- the Hurst path -------------------------------------------------------------

HURST_TRUE = dict(amp=1.0, H=0.75, noise=0.3)
# priors on (log amp, h, log noise), H = 1 / (1 + e^{-h}); h's mean puts
# the start at H = 0.62, away from H = 1/2 (white noise, where amp and
# the noise cannot be told apart)
HURST_PRIOR = {'log(amp)': (0., 1.), 'h': (0.5, 1.),
               'log(noise)': (math.log(0.2), 1.)}
HURST_KEYS = ('amp', 'h', 'noise')
HURST_ITERS = 10         # the dense fit's BFGS iterations, at most
HURST_STREAM_ITERS = 1   # the streaming fit's, from the dense MAP
HURST_SEED = 20261020
FGN_TERMS = 40           # the reference's binomial series, from lag 2 on


def fgn_cov64(n, H):
    """The fractional Gaussian noise autocovariance γ(k) = ½(|k+1|^2H +
    |k−1|^2H − 2k^2H) at lags 0 … n−1 and its H-derivative, float64 on
    the host (numpy and scipy; no port code): lags 0 and 1 as written,
    from lag 2 on the binomial series k^α Σ_{j≥1} C(α, 2j) k^{−2j}, α =
    2H, whose terms do not cancel (the expression as written loses the
    value at large lags), FGN_TERMS terms, its α-derivative through
    dC(α, m)/dα = C(α, m)(ψ(α+1) − ψ(α−m+1))."""
    import numpy as np
    from scipy.special import binom, digamma
    a = 2 * H
    g = np.empty(n)
    dg = np.empty(n)
    g[0], dg[0] = 1.0, 0.0
    if n > 1:
        g[1] = 2 ** (a - 1) - 1
        dg[1] = 2 ** (a - 1) * math.log(2)
    k = np.arange(2, n, dtype=np.float64)
    j = np.arange(1, FGN_TERMS + 1)
    C = binom(a, 2 * j)
    dC = C * (digamma(a + 1) - digamma(a - 2 * j + 1))
    P = k[:, None] ** (-2.0 * j)
    ka = k ** a
    s0 = P @ C
    g[2:] = ka * s0
    dg[2:] = np.log(k) * ka * s0 + ka * (P @ dC)
    return g, 2 * dg


def fgn_cov32_cancelling(n, H):
    """γ(k) and its H-derivative at lags 0 … n−1 by the expression as
    the JAX package writes it, ½(|k+1|^2H + |k−1|^2H − 2k^2H), in float32
    on the host, then widened: the control of the Hurst gradient check
    (`hurst_controls`), a Gram whose three powers cancel."""
    import numpy as np
    k = np.arange(n, dtype=np.float32)
    a = np.float32(2 * H)
    bases = (k + 1, np.abs(k - 1), k)
    wts = (np.float32(0.5), np.float32(0.5), np.float32(-1))
    g = np.zeros(n, np.float32)
    dg = np.zeros(n, np.float32)
    for b, w in zip(bases, wts):
        pw = b ** a
        g += w * pw
        with np.errstate(divide='ignore'):
            lb = np.where(b > 0, np.log(b), np.float32(0))
        dg += 2 * w * pw * lb
    return g.astype(np.float64), dg.astype(np.float64)


def hurst_data(n, seed=HURST_SEED):
    """The Hurst path's data: t = 0 … n−1 (float32, exact) and y = √amp
    fGn(H) + √noise ε at HURST_TRUE, drawn exactly in float64 on the host
    by circulant embedding (Davies–Harte: the 2n-circulant of γ(0 … n),
    nonnegative for every H in (0, 1), its square root applied by numpy's
    FFT to complex normals), rounded to float32."""
    import numpy as np
    rng = np.random.default_rng(seed)
    g, _ = fgn_cov64(n + 1, HURST_TRUE['H'])
    lam = np.fft.fft(np.concatenate([g, g[-2:0:-1]])).real
    if lam.min() < -1e-9 * lam.max():
        fail('fGn circulant embedding: a negative eigenvalue')
    m = 2 * n
    z = rng.standard_normal(m) + 1j * rng.standard_normal(m)
    x = np.fft.fft(np.sqrt(np.clip(lam, 0, None) / m) * z).real[:n]
    y = math.sqrt(HURST_TRUE['amp']) * x \
        + math.sqrt(HURST_TRUE['noise']) * rng.standard_normal(n)
    return np.arange(n, dtype=np.float32), y.astype(np.float32)


def hurst_nll64(y, lp, rows=4096, cov=fgn_cov64):
    """Independent float64 reference of the likelihood part of the
    objective of K = amp Γ + noise I on the unit grid (Γ Toeplitz in
    the γ of ``cov``, `fgn_cov64`), its gradient in (log amp, h, log
    noise) and the sizes of the gradient's two terms: K by blocks of
    rows, ``torch.linalg.cholesky``, ½ <K⁻¹ − α αᵀ, ∂K>, the Toeplitz ∂K
    by the sums of K⁻¹'s diagonals and α's autocorrelation; no port
    code."""
    import torch
    amp, h, noise = math.exp(lp[0]), lp[1], math.exp(lp[2])
    H = 1 / (1 + math.exp(-h))
    n = y.shape[0]
    g, dg = (torch.as_tensor(v, device=y.device) for v in cov(n, H))
    ar = torch.arange(n, device=y.device)
    K = y.new_empty((n, n))
    for i in range(0, n, rows):
        K[i:i + rows] = g[(ar[i:i + rows, None] - ar[None, :]).abs_()]
    K.mul_(amp).diagonal().add_(noise)
    L = torch.linalg.cholesky(K)
    del K
    z = torch.linalg.solve_triangular(L, y[:, None], upper=False)
    nll = 0.5 * float(z.T @ z) + float(torch.log(L.diagonal()).sum()) \
        + 0.5 * n * math.log(2 * math.pi)
    alpha = torch.cholesky_solve(y[:, None], L)[:, 0]
    Kinv = torch.cholesky_inverse(L)
    del L
    # <M, T(v)> = Σ_k v_k d_k, d_0 = tr M, d_k = 2 Σ_i M[i, i+k]: for M =
    # K⁻¹ by its diagonals' sums, for M = α αᵀ by α's autocorrelation
    di = torch.stack([torch.diagonal(Kinv, k).sum() for k in range(n)])
    del Kinv
    f = torch.fft.rfft(alpha, 2 * n)
    da = torch.fft.irfft(f * f.conj(), 2 * n)[:n]
    tr_i, tr_a = di[0].clone(), da[0].clone()
    di[1:] *= 2
    da[1:] *= 2
    # each gradient entry is ½ <K⁻¹ − α αᵀ, ∂K>: its two terms apart
    ti = 0.5 * torch.stack([amp * (g @ di), amp * H * (1 - H) * (dg @ di),
                            noise * tr_i])
    ta = 0.5 * torch.stack([amp * (g @ da), amp * H * (1 - H) * (dg @ da),
                            noise * tr_a])
    return nll, ti - ta, ti.abs() + ta.abs()


def hurst_controls(what, y64, lp, cond):
    """Two controls of the streaming Hurst gradient check (`ts_check`
    away from an optimum: |dg| over the norm of the gradient's two
    terms' sizes, limit 10 cond eps32): the float64 gradient with H moved
    by 1e-3, and with γ and ∂γ/∂H from the cancelling expression in
    float32 (`fgn_cov32_cancelling`; at n = 32768 its K is not positive
    definite, which is logged), each read against the float64 gradient
    at ``lp`` as the check reads the port's; fails if either stays
    within the limit, a check that could not tell them from the
    truth."""
    import torch
    eps32 = torch.finfo(torch.float32).eps
    _, g64, scale = hurst_nll64(y64, lp)
    H = 1 / (1 + math.exp(-lp[1]))
    dh = 1e-3 / (H * (1 - H))
    lim = 10 * cond * eps32
    for label, q, cov in (('H + 1e-3', [lp[0], lp[1] + dh, lp[2]],
                           fgn_cov64),
                          ('the cancelling expression in float32', lp,
                           fgn_cov32_cancelling)):
        try:
            g = hurst_nll64(y64, q, cov=cov)[1]
        except torch.linalg.LinAlgError as exc:
            # an indefinite K: no gradient, which the check would refuse
            log(f'    {what}, control {label}: K is not positive definite '
                f'({str(exc).split("(")[-1].rstrip(").")})')
            continue
        rel = float((g - g64).norm() / scale.norm())
        log(f'    {what}, control {label}: diff relative to the '
            f'gradient\'s scale {rel:.3e} (limit {lim:.3e})')
        if not rel > lim:
            fail(f'{what}: the gradient check cannot tell the control '
                 f'{label} from the truth')


def hurst_phase(dev='cuda'):
    """The Hurst path: a fractional-Gaussian-noise fit, ``amp *
    StationaryFracBrownian(H)`` on the integer times t = 0 … n−1 with
    unit scale, plus white noise, hyperparameters (log amp, h, log
    noise), H = 1/(1 + e^{-h}), data from `hurst_data` at HURST_TRUE,
    float32.

    Dense, n = N: ``empbayes_fit`` with at most HURST_ITERS BFGS
    iterations, ``gram='tiled'`` (kernel C on the 'sfb' profile, forward
    and fused backward with its H-derivative once per evaluation, each
    after one launch of the coefficient builder ``sfb_table_kernel``), the
    noise the data's scalar ``givencov``, covariance 'auto'; NLL and
    gradient at the start and at the fit held to the Toeplitz float64
    reference (`ts_check` with `hurst_nll64`), and the fitted H within 3
    posterior standard deviations of HURST_TRUE's.  Streaming, n =
    N_STREAM: ``+ noise * White()``, ``solver='chol-stream'``, at most
    HURST_STREAM_ITERS iterations from the dense MAP (kernel D on 'sfb'
    at every internal node, C's fused backward once per gradient strip);
    its NLL and exact gradient at the start point held to float64 at n =
    N_CHECK, and the check's two controls (`hurst_controls`).  Returns
    the launch counts of the whole phase."""
    import torch
    import lsqfitgp_torch as lgp
    f32 = torch.float32
    cuda = dev == 'cuda'
    torch.set_default_dtype(f32)
    key = 'sfb'
    reset_counts()
    t0 = time.perf_counter()
    t, y = hurst_data(N)
    log(f'hurst path: amp * StationaryFracBrownian(H) + noise * White() on '
        f't = 0 … n−1, true {HURST_TRUE}, data seed {HURST_SEED} by '
        f'circulant embedding ({time.perf_counter() - t0:.1f} s on the '
        f'host)')
    tt = torch.as_tensor(t, device=dev)
    yt = torch.as_tensor(y, device=dev)

    def kernel(hp):
        return hp['amp'] * lgp.StationaryFracBrownian(
            H=torch.sigmoid(hp['h']))

    def gpfactory(hp):
        return lgp.GP(kernel(hp), gram='tiled').addx(tt, 'obs')

    log(f'  dense: n = {N}, float32, gram=\'tiled\', the noise as '
        f'givencov, at most {HURST_ITERS} BFGS iterations')
    if cuda:
        torch.cuda.synchronize()
    before = read_counts()
    t1 = time.perf_counter()
    fit = lgp.empbayes_fit(HURST_PRIOR, gpfactory,
                           lambda hp: ({'obs': yt}, hp['noise']),
                           minkw={'maxiter': HURST_ITERS}, raises=False)
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    fit_counts = counts_since(before)
    evals = len(fit.evaltimes)
    ms = statistics.median(fit.evaltimes) * 1e3
    log(f'  fit: {wall:.2f} s wall, {fit.minresult.nit} BFGS iterations, '
        f'{evals} evaluations, median {ms:.1f} ms per evaluation (value + '
        f'gradient); launches {nonzero(fit_counts)}')
    if cuda:
        require_launched(fit_counts, ['schur_update_tc', 'syrk_t_full__dmma',
                                      f'gram@{key}', f'gram_bwd@{key}'],
                         'the dense Hurst fit')
        require_counts(fit_counts, {f'gram@{key}': evals,
                                    f'gram_bwd@{key}': evals,
                                    'gram': evals, 'gram_bwd': evals,
                                    'sfb_table': 2 * evals},
                       'the dense Hurst fit')

    def lp_of(pmean):
        return [math.log(float(pmean['amp'])), float(pmean['h']),
                math.log(float(pmean['noise']))]

    fitted = lp_of(fit.pmean)
    Hfit = 1 / (1 + math.exp(-fitted[1]))
    log(f'  fitted amp, H, noise {math.exp(fitted[0]):.6g}, {Hfit:.6g}, '
        f'{math.exp(fitted[2]):.6g} (true {HURST_TRUE}); pcov '
        f'{fit.pcov.tolist()}')
    y64 = yt.double()

    def value_grad32(lp):
        lp = torch.tensor(lp, dtype=f32, device=dev, requires_grad=True)
        hp = {'amp': lp[0].exp(), 'h': lp[1], 'noise': lp[2].exp()}
        nll = -gpfactory(hp).marginal_likelihood({'obs': yt}, hp['noise'])
        g, = torch.autograd.grad(nll, lp)
        with torch.no_grad():
            K = gpfactory(hp).prior('obs', raw=True)
            K.diagonal().add_(hp['noise'])
            cond = float(lgp.linalg.Chol(K).cond_estimate)
        return nll.detach(), g, cond

    start = [HURST_PRIOR[k][0] for k in ('log(amp)', 'h', 'log(noise)')]
    sdev = None
    for label, lp, near in (('start point', start, False),
                            ('fitted point', fitted, True)):
        nll, g, cond = value_grad32(lp)
        if not cond < 0.1 / torch.finfo(f32).eps:
            fail('conditioning beyond the float32 factorization limit')
        sdev = ts_check(f'dense n = {N}, {label}', N, nll, g,
                        lambda q: hurst_nll64(y64, q), lp, cond, near)
    sd_H = Hfit * (1 - Hfit) * float(sdev[1])
    log(f'  fitted H {Hfit:.6g}, posterior sdev {sd_H:.3g} (float64 '
        f'Hessian): {abs(Hfit - HURST_TRUE["H"]) / sd_H:.2f} sdev from the '
        f'true {HURST_TRUE["H"]} (limit 3)')
    if not abs(Hfit - HURST_TRUE['H']) <= 3 * sd_H:
        fail('the fitted H is more than 3 posterior sdev from the true H')
    del fit
    if cuda:
        torch.cuda.empty_cache()

    # streaming
    t, y = hurst_data(N_STREAM)

    def stream_gp(hp):
        return lgp.GP(kernel(hp) + hp['noise'] * lgp.White(),
                      solver='chol-stream', block=STREAM_BLOCK, b1=128)

    log(f'  streaming: n = {N_STREAM}, solver=chol-stream, block='
        f'{STREAM_BLOCK}, at most {HURST_STREAM_ITERS} BFGS iterations from '
        f'the dense MAP')
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    before = read_counts()
    t1 = time.perf_counter()
    sfit = lgp.empbayes_fit(HURST_PRIOR,
                            lambda hp: stream_gp(hp).addx(t, 'obs'),
                            {'obs': y}, initial=fitted,
                            minkw={'maxiter': HURST_STREAM_ITERS},
                            raises=False)
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    counts = counts_since(before)
    ev = sfit.evaltimes
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    log(f'  streaming fit: {wall:.2f} s wall, {sfit.minresult.nit} BFGS '
        f'iterations, {len(ev)} evaluations, {statistics.median(ev):.3f} s '
        f'median per value + gradient, peak {peak / N_STREAM ** 2:.2f} B/n²;'
        f' launches {nonzero(counts)}')
    if cuda:
        strips = -(-N_STREAM // (4 * STREAM_BLOCK))
        require_launched(counts, [f'schur_update_gram_tc@{key}',
                                  f'gram@{key}', 'schur_update_tc'],
                         'the streaming Hurst fit')
        # one build before each launch on the 'sfb' profile
        builds = sum(c for k, c in counts.items() if k.endswith(f'@{key}'))
        require_counts(counts, {f'gram_bwd@{key}': strips * len(ev),
                                'sfb_table': builds},
                       'the streaming Hurst fit')
    end = lp_of(sfit.pmean)
    log(f'  end point amp, H, noise {math.exp(end[0]):.6g}, '
        f'{1 / (1 + math.exp(-end[1])):.6g}, {math.exp(end[2]):.6g}')
    if not all(math.isfinite(v) for v in end):
        fail('the streaming Hurst fit ended at a non-finite point')
    del sfit
    if cuda:
        torch.cuda.empty_cache()

    # the streaming check at n = N_CHECK against float64
    t, y = hurst_data(N_CHECK)
    tt = torch.as_tensor(t, device=dev)
    yt = torch.as_tensor(y, device=dev)
    lp = torch.tensor(start, dtype=f32, device=dev, requires_grad=True)
    hp = {'amp': lp[0].exp(), 'h': lp[1], 'noise': lp[2].exp()}
    with lgp.disable_checks():
        nll = -stream_gp(hp).addx(tt, 'obs').marginal_likelihood({'obs': yt})
    g, = torch.autograd.grad(nll, lp)
    with torch.no_grad():
        hp = {k: v.detach() for k, v in hp.items()}
        K = lgp.GP(kernel(hp)).addx(tt, 'obs').prior('obs', raw=True)
        K.diagonal().add_(hp['noise'])
        cond = float(lgp.linalg.Chol(K).cond_estimate)
        del K
    y64 = yt.double()
    ts_check(f'streaming n = {N_CHECK}', N_CHECK, nll.detach(), g,
             lambda q: hurst_nll64(y64, q), start, cond, False)
    hurst_controls(f'streaming n = {N_CHECK}', y64, start, cond)
    counts = read_counts()
    log(f'  the phase: {time.perf_counter() - t0:.1f} s; launches '
        f'{nonzero(counts)}')
    return counts


# -- the model-comparison path -----------------------------------------------------

# examples/model_comparison.py's kernels, noise and point density (60
# points per 10 units), at n = N; the data's windows and seed; the cap
# of the real-order Matérn fit
EV_NU, EV_SCALE, EV_NOISE, EV_DENSITY = 1.7, 1.5, 0.1, 6.0
EV_WINDOW, EV_SEED, EV_ITERS = 4096, 20261021, 10
# the float64 Matérn-ν reference's table in r: step and end (f(40) <
# 1e-30)
EV_TABLE_H, EV_TABLE_END = 2e-3, 40.0


def ev_data(n, seed=EV_SEED):
    """The model-comparison path's data: x sorted uniform at EV_DENSITY
    points per unit around 0, y from ExpQuad(scale=EV_SCALE) drawn in
    float64 on the host in independent windows of EV_WINDOW consecutive
    points (each exact, with 1e-8 of jitter), plus EV_NOISE times a
    standard normal, both rounded to float32."""
    import numpy as np
    rng = np.random.default_rng(seed)
    half = n / EV_DENSITY / 2
    x = np.sort(rng.uniform(-half, half, n)).astype(np.float32)
    x64 = x.astype(np.float64)
    y = np.empty(n)
    for i in range(0, n, EV_WINDOW):
        xw = x64[i:i + EV_WINDOW]
        K = np.exp(-0.5 * ((xw[:, None] - xw[None, :]) / EV_SCALE) ** 2)
        K[np.diag_indices_from(K)] += 1e-8
        y[i:i + EV_WINDOW] = np.linalg.cholesky(K) \
            @ rng.standard_normal(xw.size)
    y += EV_NOISE * rng.standard_normal(n)
    return x, y.astype(np.float32)


def matern_table64(nu=EV_NU, device='cuda'):
    """The real-order Matérn f(r) = 2^{1−ν}/Γ(ν) z^ν K_ν(z), z = √(2ν) r,
    and f'(r) = −√(2ν) 2^{1−ν}/Γ(ν) z^ν K_{ν−1}(z), tabulated in float64
    on the host with ``scipy.special.kv`` on [0, EV_TABLE_END] at step
    EV_TABLE_H (f(0) = 1, f'(0) = 0); no port code."""
    import numpy as np
    import torch
    from scipy.special import gammaln, kv
    r = np.arange(0, EV_TABLE_END + 2 * EV_TABLE_H, EV_TABLE_H)
    z = np.sqrt(2 * nu) * r
    c = np.exp((1 - nu) * math.log(2) - gammaln(nu))
    with np.errstate(invalid='ignore', divide='ignore'):
        f = c * z ** nu * kv(nu, z)
        df = -np.sqrt(2 * nu) * c * z ** nu * kv(nu - 1, z)
    f[0], df[0] = 1.0, 0.0
    return (torch.as_tensor(f, device=device),
            torch.as_tensor(df, device=device))


def matern_nu64(d2s, table):
    """The real-order Matérn at the scaled squared distance and its
    derivative in log scale, −r f'(r), by cubic Hermite interpolation of
    `matern_table64`'s f and f' (error ~h⁴ f''''/384, below 1e-9 beside
    the r^(2ν) cusp at 0), 0 past the table's end; no port code."""
    import torch
    f, df = table
    h = EV_TABLE_H
    r = torch.sqrt(d2s)
    u = r / h
    i = torch.clamp(torch.floor(u), max=f.shape[0] - 2).long()
    s = torch.clamp(u - i, 0, 1)
    f0, f1, d0, d1 = f[i], f[i + 1], df[i] * h, df[i + 1] * h
    s2, s3 = s * s, s * s * s
    val = (2 * s3 - 3 * s2 + 1) * f0 + (s3 - 2 * s2 + s) * d0 \
        + (-2 * s3 + 3 * s2) * f1 + (s3 - s2) * d1
    dval = ((6 * s2 - 6 * s) * f0 + (3 * s2 - 4 * s + 1) * d0
            + (-6 * s2 + 6 * s) * f1 + (3 * s2 - 2 * s) * d1) / h
    far = r >= EV_TABLE_END
    zero = torch.zeros((), dtype=val.dtype, device=val.device)
    return torch.where(far, zero, val), torch.where(far, zero, -r * dval)


def white64(d2s):
    """White noise at the scaled squared distance: 1 where the points
    coincide (float32-rounded points may), 0 elsewhere; no scale."""
    return (d2s == 0).to(d2s.dtype), d2s * 0


def expon64(d2s):
    """The exponential kernel e^{−r} at the scaled squared distance and
    its derivative in log scale, r e^{−r}."""
    import torch
    r = torch.sqrt(d2s)
    e = torch.exp(-r)
    return e, r * e


def below_table_share(x, nu, scale, xlo):
    """The share of the n² pairs of the sorted 1-D points x whose
    Matérn argument √(2ν) |x_i − x_j| / scale lies in (0, xlo)."""
    import numpy as np
    x = np.sort(np.asarray(x, np.float64))
    d = xlo * scale / math.sqrt(2 * nu)
    close = np.searchsorted(x, x + d, side='left') - np.arange(x.size) - 1
    same = np.searchsorted(x, x, side='right') - np.arange(x.size) - 1
    return 2 * float(np.maximum(close - same, 0).sum()) / x.size ** 2


def evidence_phase(dev='cuda'):
    """The model-comparison path: examples/model_comparison.py at n = N
    (`ev_data`): the log evidence of its four candidates, in its order,
    ExpQuad(1.5), Expon(1.5), Matern(nu=1.7, scale=1.5) and White, each
    one float32 ``marginal_likelihood`` with the noise variance as the
    scalar givencov (the default gram: kernel C on expquad, expon and
    'matern'; White broadcasts its δ), held to a float64 reference
    (`plain_terms64` on ExpQuad's and Expon's closed forms, on
    `matern_nu64`'s table of ``scipy.special.kv`` and on White's δ of
    the float32-rounded points, a few of which coincide) within
    `check_points`'s NLL bound, and
    ExpQuad must win, as the example asserts; then ``amp *
    Matern(nu=1.7, scale)`` fitted with at most EV_ITERS BFGS
    iterations (C on 'matern' and its backward, once per evaluation,
    both on the order's tables: f_ν's and, for the backward, f_{ν−1}'s,
    each built once in the phase, the cache emptied at its start), its
    NLL and gradient at the start and at the fit held to the table's
    float64 reference as the Matérn path holds Maternp's
    (`check_points`), and its posterior mean at NPRED points.  Logs the
    share of the Gram's entries below the tables (0 < x < 2^E_LO, where
    the kernels take the quadrature).  Returns the launch counts of the
    whole phase."""
    import torch
    import lsqfitgp_torch as lgp
    from lsqfitgp_torch.ops import _mtable
    f32 = torch.float32
    cuda = dev == 'cuda'
    torch.set_default_dtype(f32)
    reset_counts()
    _mtable._CACHE.clear()
    t0 = time.perf_counter()
    x, y = ev_data(N)
    noise = EV_NOISE ** 2
    xt = torch.as_tensor(x, device=dev)
    yt = torch.as_tensor(y, device=dev)
    x64, y64 = xt.double(), yt.double()
    table = matern_table64(device=dev)
    log(f'evidence path: examples/model_comparison.py at n = {N} on '
        f'[{x[0]:.1f}, {x[-1]:.1f}], noise {EV_NOISE}, data from '
        f'ExpQuad(scale={EV_SCALE}) in windows of {EV_WINDOW}, seed '
        f'{EV_SEED} ({time.perf_counter() - t0:.1f} s on the host, with '
        f'the Matérn table)')
    ls = math.log(EV_SCALE)
    candidates = [
        ('ExpQuad(1.5)', lambda: lgp.ExpQuad(scale=EV_SCALE), expquad64),
        ('Expon(1.5)', lambda: lgp.Expon(scale=EV_SCALE), expon64),
        (f'Matern nu={EV_NU}', lambda: lgp.Matern(nu=EV_NU, scale=EV_SCALE),
         lambda d2s: matern_nu64(d2s, table)),
        ('White', lgp.White, white64)]
    eps32 = torch.finfo(f32).eps
    lim = 4 * eps32 * N * (1 + noise) / noise
    scores = {}
    for name, make, kern in candidates:
        before = read_counts()
        with torch.no_grad():
            s32 = float(lgp.GP(make()).addx(xt, 'data').marginal_likelihood(
                {'data': yt}, givencov=noise))
        counts = counts_since(before)
        nll64 = plain_terms64(x64, y64, [(kern, ls, 0.0)], noise=noise)[0]
        scores[name] = s32
        log(f'  {name:15s} log evidence port float32 {s32:.8g}, plain '
            f'float64 {-nll64:.8g}, |diff| {abs(s32 + nll64):.3e} (limit '
            f'{lim:.3e}); launches {nonzero(counts)}')
        if not abs(s32 + nll64) <= lim:
            fail(f'evidence of {name}: disagrees with the float64 reference')
        if cuda and name.startswith('Matern'):
            require_launched(counts, ['gram@matern', 'gram@tables',
                                      'matern_table'], 'the Matérn evidence')
    best = max(scores, key=scores.get)
    log(f'  the evidence prefers {best}')
    if best != 'ExpQuad(1.5)':
        fail(f'the evidence prefers {best}, not the generating ExpQuad')

    def gpfactory(hp, precision=None):
        kw = {} if precision is None else dict(precision=precision)
        k = hp['amp'] * lgp.Matern(nu=EV_NU, scale=hp['scale'])
        return lgp.GP(k, **kw).addx(xt, 'y')

    hyperprior = {'log(scale)': (ls, 1.), 'log(amp)': (0., 1.)}
    log(f'  fit: amp * Matern(nu={EV_NU}, scale), float32, the noise as '
        f'givencov, default gram, at most {EV_ITERS} BFGS iterations')
    if cuda:
        torch.cuda.synchronize()
    before = read_counts()
    t1 = time.perf_counter()
    fit = lgp.empbayes_fit(hyperprior, gpfactory,
                           lambda hp: ({'y': yt}, noise),
                           minkw={'maxiter': EV_ITERS}, raises=False)
    if cuda:
        torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    fit_counts = counts_since(before)
    evals = len(fit.evaltimes)
    ms = statistics.median(fit.evaltimes) * 1e3
    log(f'  fit: {wall:.2f} s wall, {fit.minresult.nit} BFGS iterations, '
        f'{evals} evaluations, median {ms:.1f} ms per evaluation (value + '
        f'gradient); launches {nonzero(fit_counts)}')
    if cuda:
        require_launched(fit_counts, ['schur_update_tc', 'syrk_t_full__dmma',
                                      'gram@matern', 'gram_bwd@matern'],
                         'the Matérn-ν fit')
        require_counts(fit_counts, {'gram@matern': evals,
                                    'gram_bwd@matern': evals,
                                    'gram@tables': evals,
                                    'gram_bwd@tables': evals,
                                    'gram': evals, 'gram_bwd': evals,
                                    'matern_table': 0},
                       'the Matérn-ν fit')
    scale, amp = float(fit.pmean['scale']), float(fit.pmean['amp'])
    fitted = [math.log(scale), math.log(amp)]
    elo = _mtable.layout(f32)[0]
    for what, s in (('start', EV_SCALE), ('fitted', scale)):
        log(f'  entries below the tables (0 < x < 2^{elo}, the quadrature) '
            f'at the {what} scale {s:.6g}: '
            f'{below_table_share(x, EV_NU, s, 2.0 ** elo):.3e} of n²')
    log(f'  fitted scale {scale:.6g}, amp {amp:.6g}; pcov '
        f'{fit.pcov.tolist()}')

    def value_grad32(lp, precision=None):
        gp0 = gpfactory({'scale': lp[0].exp(), 'amp': lp[1].exp()},
                        precision)
        return -gp0.marginal_likelihood({'y': yt}, givencov=noise)

    def cond_at(lsc, la):
        with torch.no_grad():
            gp0 = gpfactory({'scale': torch.tensor(math.exp(lsc)),
                             'amp': torch.tensor(math.exp(la))})
            K = gp0.prior('y', raw=True)
            K.diagonal().add_(noise)
            return float(lgp.linalg.Chol(K).cond_estimate)

    kern = lambda d2s: matern_nu64(d2s, table)
    check_points(N, value_grad32, cond_at, x64, y64,
                 [('start point', [ls, 0.], False),
                  ('fitted point', fitted, True)],
                 grad64=lambda lp: plain_nll64(x64, y64, *lp, kern=kern,
                                               noise=noise),
                 noise=noise)
    xs = torch.linspace(float(x[0]), float(x[0]) + 20, NPRED, device=dev)
    mean = fit.gp().addx(xs, 'pred').predfromdata(
        {'y': yt}, 'pred', noise).mean
    with torch.no_grad():
        ref = plain_mean64(x64, y64, xs.double(), scale, amp, noise=noise,
                           kern=kern)
    cond = cond_at(*fitted)
    dmean = float((mean.double() - ref).abs().max())
    log(f'  posterior mean at {NPRED} points: max |port - float64| '
        f'{dmean:.3e} (limit {10 * cond * eps32 * float(ref.abs().max()):.3e}'
        f'), max |mean| {float(ref.abs().max()):.4g}')
    if not bool(torch.isfinite(mean).all()) or mean.shape != (NPRED,):
        fail('Matérn-ν posterior mean not finite or of the wrong shape')
    if dmean > 10 * cond * eps32 * float(ref.abs().max()):
        fail('Matérn-ν posterior mean disagrees with the float64 reference')
    counts = read_counts()
    log(f'  the phase: {time.perf_counter() - t0:.1f} s; launches '
        f'{nonzero(counts)}')
    if cuda:
        # each of the order's two tables (f_ν, f_{ν−1}) built once
        require_counts(counts, {'matern_table': 2}, 'the evidence phase')
    return counts


# the records `zoo_times` times: FixedExpQuad ('expquad', the main path's
# single term), every closed-form record of ZOO_RECORDS and TS_RECORDS at
# its p (ZooOne at p = 1 for one term, Zoo for the sum and at p > 1),
# ZooSpecial (the special cores) at p = 1, and the real-order Matérn at
# the multidim cell's p too
ZOO_TIMES = [('expquad', 1)] + [
    (name, p) for name, (ps, _, _) in ZOO_RECORDS.items()
    if name not in CORE_RECORDS for p in ps] + [
    ('sfb', 1), ('sfbpath', 1), ('bessel', 1), ('pink', 1), ('color', 1),
    ('matern', 1), ('matern07', 1), ('matern', MD_P), ('matern07', MD_P)]


def schur_times(label, out):
    """`zoo_times`'s 'schur' row: kernel A at `kernel_schur`'s shape in
    float32 at 'high', 'default' and 'highest' and in float64, beside
    cuBLAS's product of the full square (TF32 and IEEE); B in float64 in
    place at `kernel_syrk`'s; D at `kernel_schur_gram`'s at 'high' and
    'default' (n = N_STREAM) and in float64 (n = N_CHECK); CUDA events,
    no check and no plain version.  Adds the times to ``out``."""
    import torch
    from lsqfitgp_torch import ops
    from lsqfitgp_torch.ops import _syrk
    gen = torch.Generator(device='cuda').manual_seed(SEED)
    for dtype in (torch.float32, torch.float64):
        label_dt = str(dtype).split('.')[-1]
        f32 = dtype == torch.float32
        kw = dict(device='cuda', dtype=dtype, generator=gen)
        size = h = N // 2
        offset = tile = 512
        mb = offset + size
        A = torch.randn(size, h, **kw)
        B = torch.randn(mb, mb, **kw)
        s = 0.5 + 1.5 * torch.rand(mb, **kw)
        eps = torch.tensor(0.5, device='cuda', dtype=dtype)
        args = dict(s=s, eps=eps, size=size, offset=offset, tile=tile,
                    nreal=offset + size - 300)
        for prec in ('high', 'default', 'highest') if f32 else (None,):
            key = f'schur_update/{prec or label_dt}'
            out[key] = median_ms(lambda: _syrk.schur_update(
                B, A, precision=prec, **args))
            log(f'  {label} {key}: {out[key]:.4f} ms')
        Bs = (B[offset:, offset:] * s[offset:, None] * s[None, offset:]
              ).contiguous()
        for tf32 in (True, False) if f32 else (False,):
            torch.backends.cuda.matmul.allow_tf32 = tf32
            key = f'addmm/{"tf32" if tf32 else label_dt}'
            out[key] = median_ms(lambda: torch.addmm(Bs, A, A.T, alpha=-1))
            log(f'  {label} {key}: {out[key]:.4f} ms')
        torch.backends.cuda.matmul.allow_tf32 = False
        del A, B, Bs, s
        if not f32:
            W = torch.randn(N, N, **kw).tril_()
            Wc = W.clone()
            key = 'syrk_t_full_/float64'
            out[key] = median_ms(lambda: ops.syrk_t_full_(Wc),
                                 setup=lambda: Wc.copy_(W))
            log(f'  {label} {key}: {out[key]:.4f} ms')
            del W, Wc
        torch.cuda.empty_cache()
        n = N_STREAM if f32 else N_CHECK
        size = n // 2
        X = (torch.rand(n, 1, **kw) - 0.5) * (400 * n / N_STREAM)
        A = torch.randn(size, size, **kw) / math.sqrt(size)
        amp = torch.tensor(1.3, device='cuda', dtype=dtype)
        noise = torch.tensor(NOISE_VAR, device='cuda', dtype=dtype)
        for prec in ('high', 'default') if f32 else (None,):
            key = f'schur_update_gram/{prec or label_dt}'
            out[key] = median_ms(lambda: _syrk.schur_update_gram(
                'expquad', X, A, post=(('mul', amp),), eps=noise,
                nreal=n - 300, size=size, offset=size, tile=512,
                precision=prec), 3)
            log(f'  {label} {key}: {out[key]:.3f} ms')
        del X, A
        torch.cuda.empty_cache()


def zoo_times(label, names=()):
    """`--zoo-times LABEL [NAME ...]`: kernel C's and its fused backward's
    device time (`device_ms` of the named kernel, as `kernel_zoo` times
    them) on each of ZOO_TIMES at 16384² (`record_points`), in float32 and
    float64, E, C′, C″ on Matérn-ν at p = 1, and D on Matérn-ν and on
    'sfb' at the Hurst path's points ('high', n = 65536; float64, n =
    32768), with no check and no plain version, so that two
    checkouts can be timed in turns in one call (copy this script into the
    other checkout); the times in a JSON line, the checkout's ``LABEL``
    with them.  Given ``names``, only the rows of ZOO_TIMES with those
    names: C and its backward, and at p = 1 on one term C′, C″ and E″
    too;
    the name 'schur' (also without names) times kernels A, B and D
    (`schur_times`)."""
    import torch
    from lsqfitgp_torch import ops
    from lsqfitgp_torch.ops import _gram, _syrk
    gen = torch.Generator(device='cuda').manual_seed(SEED)
    out = {}
    if not names or 'schur' in names:
        schur_times(label, out)
    for dtype in (torch.float32, torch.float64):
        label_dt = str(dtype).split('.')[-1]
        noise = torch.tensor(NOISE_VAR, device='cuda', dtype=dtype)
        for name, p in ZOO_TIMES:
            if names and name not in names:
                continue
            X = record_points(name, p, N, dtype, gen)
            desc = ('expquad' if name == 'expquad'
                    else zoo_desc(name, dtype))
            post = (('mul', torch.tensor(1.3, device='cuda', dtype=dtype)),) \
                if name == 'expquad' else ()
            G = torch.randn(N, N, device='cuda', dtype=dtype, generator=gen)
            fwd = lambda: ops.gram(desc, X, post=post, noise=noise)
            bwd = lambda: ops.gram_backward(G, desc, X, post=post,
                                            noise=noise)
            key = f'{name}/p{p}/{label_dt}'
            out[key] = [device_ms(fwd, kernel_calls(fwd), 'gram_kernel'),
                        device_ms(bwd, kernel_calls(bwd), 'gram_bwd_kernel')]
            log(f'  {label} {key}: C {out[key][0]:.4f} ms, backward '
                f'{out[key][1]:.4f} ms')
            del X
            if names and p == 1 and (name == 'expquad'
                                     or len(desc.terms) == 1):
                # C′ and C″ take one term
                x, dx, amp, _ = tangent_inputs(dtype, gen)
                X1, dX, st, fv, dfv, one, coef = tangent_path_args(
                    x, dx, amp, 0.3, 0.5, 'expquad' if name == 'expquad'
                    else zoo_desc(name, dtype, amp=1.0))
                jvp = lambda: _gram._tangent(st, X1, X1, dX, dX, fv, dfv,
                                             True)
                bjvp = lambda: _gram._bwd_tangent(G, one, X1, X1, dX, dX,
                                                  coef, True, True)
                sjvp = lambda: _gram._sym_bwd_tangent(G, one, X1, dX, coef,
                                                      True, True)
                out[key] += [device_ms(jvp, kernel_calls(jvp),
                                       'gram_jvp_kernel'),
                             device_ms(bjvp, kernel_calls(bjvp),
                                       'gram_bwd_jvp_kernel'),
                             device_ms(sjvp, kernel_calls(sjvp),
                                       'gram_sym_bwd_jvp_kernel')]
                log(f'  {label} {key}: C′ {out[key][2]:.4f} ms, C″ '
                    f'{out[key][3]:.4f} ms, E″ {out[key][4]:.4f} ms')
                del X1, dX
            del G
            torch.cuda.empty_cache()
        if names:
            continue
        desc = zoo_desc('matern', dtype)
        X = zoo_points(1, N, dtype, gen)
        G = torch.randn(N, N, device='cuda', dtype=dtype, generator=gen)
        fns = {'gram_sym': (lambda: ops.gram_sym(desc, X, noise=noise),
                            'gram_sym_kernel'),
               'gram_sym_bwd': (lambda: ops.gram_sym_backward(
                   G, desc, X, noise=noise), 'gram_sym_bwd_kernel')}
        x, dx, amp, _ = tangent_inputs(dtype, gen)
        X1, dX, st, fv, dfv, one, coef = tangent_path_args(
            x, dx, amp, 0.3, 0.5, zoo_desc('matern', dtype, amp=1.0))
        fns['gram_jvp'] = (lambda: _gram._tangent(st, X1, X1, dX, dX, fv,
                                                  dfv, True),
                           'gram_jvp_kernel')
        fns['gram_bwd_jvp'] = (lambda: _gram._bwd_tangent(
            G, one, X1, X1, dX, dX, coef, True, True), 'gram_bwd_jvp_kernel')
        for kind, (fn, kname) in fns.items():
            key = f'{kind}/matern/{label_dt}'
            out[key] = device_ms(fn, kernel_calls(fn), kname)
            log(f'  {label} {key}: {out[key]:.4f} ms')
        del G, X, X1
        torch.cuda.empty_cache()
        n = N_STREAM if dtype == torch.float32 else N_CHECK
        size = n // 2
        kw = dict(device='cuda', dtype=dtype, generator=gen)
        A = torch.randn(size, size, **kw) / math.sqrt(size)
        # D on Matérn-ν at the streaming span's points, on 'sfb' at the
        # Hurst path's (t = 0 … n−1)
        for dname in ('matern', 'sfb'):
            desc = zoo_desc(dname, dtype)
            Xd = record_points('sfbpath', 1, n, dtype, gen) \
                if dname == 'sfb' else \
                (torch.rand(n, 1, **kw) - 0.5) * (400 * n / N_STREAM)
            key = f'schur_update_gram/{dname}/{label_dt}'
            out[key] = median_ms(lambda: _syrk.schur_update_gram(
                desc, Xd, A, eps=noise, nreal=n - 300, size=size,
                offset=size, tile=512), 3)
            log(f'  {label} {key}: {out[key]:.3f} ms')
            del Xd
        del A
        torch.cuda.empty_cache()
    print(json.dumps({'zoo_times': label, 'times': out}), flush=True)


def hurst_evals(label, evals=9):
    """`--hurst-evals LABEL`: the Hurst path's dense float32 value +
    gradient (`hurst_phase`'s model and data, n = N, ``gram='tiled'``, the
    noise as givencov) at the prior's mean, ``evals`` times after one
    warm-up, host clock to a synchronize; no check, the public API only,
    so that two checkouts can be timed in turns in one call.  Prints the
    times in a JSON line with the checkout's ``LABEL``."""
    import torch
    import lsqfitgp_torch as lgp
    torch.set_default_dtype(torch.float32)
    t, y = hurst_data(N)
    tt, yt = torch.as_tensor(t, device='cuda'), torch.as_tensor(y,
                                                               device='cuda')
    lp = torch.tensor([HURST_PRIOR[k][0] for k in ('log(amp)', 'h',
                                                   'log(noise)')],
                      device='cuda', requires_grad=True)

    def step():
        k = lp[0].exp() * lgp.StationaryFracBrownian(H=torch.sigmoid(lp[1]))
        nll = -lgp.GP(k, gram='tiled').addx(tt, 'obs').marginal_likelihood(
            {'obs': yt}, lp[2].exp())
        torch.autograd.grad(nll, lp)
        torch.cuda.synchronize()

    step()
    times = []
    for _ in range(evals):
        t0 = time.perf_counter()
        step()
        times.append((time.perf_counter() - t0) * 1e3)
    log(f'  {label} hurst dense value + gradient, n = {N}: median '
        f'{statistics.median(times):.2f} ms of {[round(v, 2) for v in times]}')
    print(json.dumps({'hurst_evals': label, 'ms': times}), flush=True)


def ts_evals(label, evals=9):
    """`--ts-evals LABEL`: the time-series path's dense float32 value +
    gradient (`timeseries_phase`'s model and data, n = N, the default
    gram, the noise as givencov) at the prior's mean, ``evals`` times
    after one warm-up, host clock to a synchronize, then one more under
    torch.profiler (its device busy time); no check, the public API only,
    so that two checkouts can be timed in turns in one call.  Prints the
    times in a JSON line with the checkout's ``LABEL``."""
    import torch
    import lsqfitgp_torch as lgp
    torch.set_default_dtype(torch.float32)
    t, y = ts_data(N)
    tt, yt = torch.as_tensor(t, device='cuda'), torch.as_tensor(y,
                                                               device='cuda')
    lp = torch.tensor([TS_PRIOR[k][0] for k in ('log(amp)', 'log(gamma)',
                                                'log(noise)')],
                      device='cuda', requires_grad=True)

    def step():
        k = lp[0].exp() * lgp.Celerite(gamma=lp[1].exp(), B=TS_TRUE['B'])
        nll = -lgp.GP(k).addx(tt, 'obs').marginal_likelihood({'obs': yt},
                                                             lp[2].exp())
        torch.autograd.grad(nll, lp)
        torch.cuda.synchronize()

    step()
    times = []
    for _ in range(evals):
        t0 = time.perf_counter()
        step()
        times.append((time.perf_counter() - t0) * 1e3)
    log(f'  {label} time-series dense value + gradient, n = {N}: median '
        f'{statistics.median(times):.2f} ms of {[round(v, 2) for v in times]}')
    wall, busy = profile_phase(step)
    print(json.dumps({'ts_evals': label, 'ms': times, 'profiled_ms': wall,
                      'busy_ms': busy}), flush=True)


def ms_evals(label, evals=9, stream_evals=3):
    """`--ms-evals LABEL`: the multiscale path's dense float32 value +
    gradient (`multiscale_phase`'s model and data at MS_POINT, n = N, the
    default gram) ``evals`` times and its streaming one (n = N_STREAM,
    `ms_stream_gp`, checks off as a fit evaluates it) ``stream_evals``
    times, each after one warm-up, host clock to a synchronize; no check,
    the public API only, so that two checkouts can be timed in turns in
    one call.  Prints the times in a JSON line with the checkout's
    ``LABEL``."""
    import torch
    import lsqfitgp_torch as lgp
    torch.set_default_dtype(torch.float32)
    lp0 = torch.tensor(MS_POINT, device='cuda')
    xt, yt, noise = ms_dense_data('cuda')
    xs_, ys_, _ = stream_data(N_STREAM)

    def dense():
        lp = lp0.clone().requires_grad_()
        nll = -ms_dense_gp(lgp, lp, xt, noise).marginal_likelihood({'y': yt})
        torch.autograd.grad(nll, lp)

    def stream():
        lp = lp0.clone().requires_grad_()
        with lgp.disable_checks():
            nll = -ms_stream_gp(lgp, lp).addx(xs_, 'f').marginal_likelihood(
                {'f': ys_})
        torch.autograd.grad(nll, lp)

    out = {}
    for what, fn, count in (('dense', dense, evals),
                            ('stream', stream, stream_evals)):
        times = []
        for i in range(count + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            if i:
                times.append((time.perf_counter() - t0) * 1e3)
        out[what] = times
        log(f'  {label} multiscale {what} value + gradient: median '
            f'{statistics.median(times):.2f} ms of '
            f'{[round(v, 2) for v in times]}')
    print(json.dumps({'ms_evals': label, 'ms': out}), flush=True)


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
    if argv[:1] == ['--gram-route'] and argv[1:] in ([], ['evals']):
        build()
        gram_route(table=argv[1:] == [])
        return 0
    if argv == ['--dense64']:
        build()
        dense64_phase(OPTIMUM)
        return 0
    if argv[:1] == ['--hurst-evals'] and len(argv) == 2:
        build()
        hurst_evals(argv[1])
        return 0
    if argv[:1] == ['--zoo-times'] and len(argv) >= 2:
        build()
        zoo_times(argv[1], argv[2:])
        return 0
    if argv[:1] == ['--ts-evals'] and len(argv) == 2:
        build()
        ts_evals(argv[1])
        return 0
    if argv[:1] == ['--ms-evals'] and len(argv) == 2:
        build()
        ms_evals(argv[1])
        return 0
    if argv == ['--deriv']:
        build()
        kernel_gram_p(torch.float32,
                      torch.Generator(device='cuda').manual_seed(SEED), 2)
        deriv_phase()
        return 0
    if argv == ['--multidim']:
        build()
        gen = torch.Generator(device='cuda').manual_seed(SEED)
        for p in (2, MD_P):
            for dtype in (torch.float32, torch.float64):
                kernel_gram_p(dtype, gen, p)
                torch.cuda.empty_cache()
        multidim_phase()
        return 0
    if argv == ['--zoo']:
        build()
        gen = torch.Generator(device='cuda').manual_seed(SEED)
        for name, (ps, _, _) in ZOO_RECORDS.items():
            if name in TS_RECORDS or name in CORE_RECORDS:
                continue
            for p in ps:
                for dtype in (torch.float32, torch.float64):
                    kernel_zoo(dtype, gen, name, p)
                    torch.cuda.empty_cache()
        for fn in (kernel_zoo_sym,
                   lambda dtype, gen: kernel_zoo_sym(dtype, gen, 'terms'),
                   kernel_zoo_tangent,
                   lambda dtype, gen: kernel_schur_gram(dtype, gen,
                                                        'terms')):
            for dtype in (torch.float32, torch.float64):
                fn(dtype, gen)
                torch.cuda.empty_cache()
        matern_phase()
        torch.cuda.empty_cache()
        multiscale_phase()
        return 0
    if argv == ['--timeseries']:
        build()
        gen = torch.Generator(device='cuda').manual_seed(SEED)
        for name, fn, _, _, variants in ts_kernel_specs():
            log(f'kernel {name}:')
            for dtype in variants:
                fn(dtype, gen)
                torch.cuda.empty_cache()
        timeseries_phase()
        return 0
    if argv in (['--hurst'], ['--evidence']):
        build()
        gen = torch.Generator(device='cuda').manual_seed(SEED)
        names = ('sfb', 'sfbpath', 'sfb_table') if argv == ['--hurst'] else (
            'matern', 'matern07', 'matern_table', 'bessel', 'pink', 'color')
        for name, fn, _, _, variants in core_kernel_specs():
            if any(f' {k} ' in f' {name} '.replace('/', ' ')
                   for k in names):
                log(f'kernel {name}:')
                for dtype in variants:
                    fn(dtype, gen)
                    torch.cuda.empty_cache()
        (hurst_phase if argv == ['--hurst'] else evidence_phase)()
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
    log(f'elapsed {time.perf_counter() - t0:.1f} s')
    torch.cuda.empty_cache()
    paths['deriv'] = deriv_phase()
    log(f'elapsed {time.perf_counter() - t0:.1f} s')
    torch.cuda.empty_cache()
    paths['multidim'] = multidim_phase()
    log(f'elapsed {time.perf_counter() - t0:.1f} s')
    torch.cuda.empty_cache()
    paths['matern'] = matern_phase()
    log(f'elapsed {time.perf_counter() - t0:.1f} s')
    torch.cuda.empty_cache()
    paths['multiscale'] = multiscale_phase()
    log(f'elapsed {time.perf_counter() - t0:.1f} s')
    torch.cuda.empty_cache()
    paths['timeseries'] = timeseries_phase()
    log(f'elapsed {time.perf_counter() - t0:.1f} s')
    torch.cuda.empty_cache()
    paths['hurst'] = hurst_phase()
    log(f'elapsed {time.perf_counter() - t0:.1f} s')
    torch.cuda.empty_cache()
    paths['evidence'] = evidence_phase()
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
                               'second', 'fishvec', 'halfmatrix_hess',
                               'deriv', 'multidim', 'matern', 'multiscale',
                               'timeseries', 'hurst', 'evidence'],
                   'float64': ['dense64']}
    for rec in records:
        base = rec['name'].split('/')[0]
        is_gram = 'key' in rec
        key = rec.pop('key', None) or base + COUNTERS[rec['counter']]
        prof = rec.pop('profile', None)
        if prof:
            # a zoo profile's record counts its profile's launches
            key = f'{key}@{prof}'
        names = dtype_paths[rec['dtype']] if is_gram else list(paths)
        if 'path' in rec:
            # a record of a path of its own (C at p > 1: the derivative
            # phase's at p = 2, the multidim phase's at p = 10; None in
            # float64) counts only that path's launches
            path = rec.pop('path')
            names = [path] if path else []
        elif rec['name'].endswith('/float64') and (
                is_gram or base == 'schur_update'):
            path = own64.get(base)
        elif not is_gram and key in own_key:
            path = own_key[key]
        else:
            path = own[base]
        rec['launches'] = paths[path].get(key, 0) if path else 0
        rec['launches_by_path'] = {p: paths[p].get(key, 0) for p in names}
    log(f'total {time.perf_counter() - t0:.1f} s')
    keys = ['name', 'route', 'source', 'replaces', 'launches',
            'max_abs_err', 'ms', 'plain_ms', 'bound_ms', 'bound_by',
            'share_of_bound', 'library_ms', 'precision', 'dtype', 'library',
            'launches_by_path', 'wrapper_ms', 'plain_n', 'evaluator']
    print(json.dumps({'kernels': [{k: r.get(k) for k in keys}
                                  for r in records]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
