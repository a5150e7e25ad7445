"""lsqfitgp_torch's CUDA kernels against their plain PyTorch versions.

This file imports no JAX, so it also runs where the card is (``python
-m pytest --noconftest -o addopts='' tests/test_torch_kernels.py``).
The tests marked ``gpu`` need a CUDA device and skip without one; the
others check, on the CPU, that the wrappers take their plain versions
for CPU tensors only and that the package imports no JAX.

Tolerances on the card: the kernels sum the same products in another
order, so a length-k dot product may differ by ~sqrt(k) u Σ|terms|
(u the unit roundoff); with k <= 1000 and unit-scale inputs, rtol/atol
of 1e-4 (float32) and 1e-12 (float64) hold with a wide margin.  Kernels
A and D in float32 at precision 'high' and 'default' run on the tensor
cores in TF32 and are held to the bound `chip_smoke.py` states: 4 sqrt(h)
u (|A||A|ᵀ)ᵢⱼ for the order of the sums, plus 4·2⁻²² (|A||A|ᵀ)ᵢⱼ for
3xTF32's split or 2·2⁻¹¹ (|A||A|ᵀ)ᵢⱼ for one TF32 pass, plus 16 u times
the tile's initial value.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import lsqfitgp_torch as lt
from lsqfitgp_torch import ops
from lsqfitgp_torch.ops import _syrk

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TOL = {torch.float32: dict(rtol=1e-4, atol=1e-4),
       torch.float64: dict(rtol=1e-12, atol=1e-12)}


@pytest.fixture(scope='module', autouse=True)
def cpu_device():
    """The package computes on the CUDA card unless asked for the CPU."""
    with lt.using_device('cpu'):
        yield


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


@pytest.fixture
def gen():
    return np.random.default_rng(20261016)


def test_import_without_jax():
    code = ('import sys, lsqfitgp_torch; '
            'bad = [m for m in sys.modules if m == "jax" '
            'or m.startswith(("jax.", "jaxlib", "lsqfitgp_tpu"))]; '
            'assert not bad, bad')
    subprocess.run([sys.executable, '-c', code], cwd=ROOT, check=True,
                   timeout=120)


def test_cpu_tensors_take_the_plain_version(gen):
    A = torch.as_tensor(gen.standard_normal((256, 128)))
    W = torch.as_tensor(np.tril(gen.standard_normal((256, 256))))
    x = torch.as_tensor(gen.standard_normal(50))
    X = torch.as_tensor(gen.standard_normal((256, 2)))
    counters = [ops.schur_update, ops.schur_update_gram, ops.syrk_t_full,
                ops.syrk_t_full_, ops.gram, ops.gram_sym]
    before = [vars(c).copy() for c in counters]
    S = ops.schur_update(None, A, eps=0.5, tile=128)
    torch.testing.assert_close(
        S, _syrk.schur_update_plain(None, A, eps=0.5, size=256, tile=128))
    torch.testing.assert_close(ops.syrk_t_full(W),
                               _syrk.syrk_t_full_plain(W))
    torch.testing.assert_close(ops.syrk_t_full_(W.clone()),
                               _syrk.syrk_t_full_plain(W))
    torch.testing.assert_close(ops.gram('expquad', x),
                               ops.gram_plain('expquad', x))
    torch.testing.assert_close(ops.gram_sym('expquad', x),
                               ops.gram_sym_plain('expquad', x))
    G = torch.as_tensor(gen.standard_normal((50, 50)))
    for got, ref in ((ops.gram_backward(G, 'expquad', x),
                      ops.gram_backward_plain(G, 'expquad', x)),
                     (ops.gram_sym_backward(G, 'expquad', x),
                      ops.gram_sym_backward_plain(G, 'expquad', x))):
        for a, b in zip(got, ref):
            torch.testing.assert_close(a, b)
    torch.testing.assert_close(
        ops.schur_update_gram('expquad', X, A[:, :64], eps=0.5, tile=128,
                              nreal=200),
        _syrk.schur_update_gram_plain('expquad', X, A[:, :64], eps=0.5,
                                      size=256, tile=128, nreal=200))
    assert [vars(c) for c in counters] == before


def test_cpu_tensors_take_the_plain_tangents(gen):
    """The tangent kernels' wrappers (C′, C″, E′, E″) run their plain
    versions for CPU tensors and count no launch."""
    x = torch.as_tensor(gen.standard_normal(50))
    dx = torch.as_tensor(gen.standard_normal(50))
    G = torch.as_tensor(gen.standard_normal((50, 50)))
    kw = dict(post=(('mul', 1.3),), noise=0.1, dpost=(0.2,))
    before = [vars(c).copy() for c in (ops.gram, ops.gram_sym)]
    torch.testing.assert_close(
        ops.gram_jvp('expquad', x, None, dx, dnoise=0.5, **kw),
        ops.gram_jvp_plain('expquad', x, None, dx, dnoise=0.5, **kw))
    torch.testing.assert_close(
        ops.gram_sym_jvp('expquad', x, dx, dnoise=0.5, **kw),
        ops.gram_sym_jvp_plain('expquad', x, dx, dnoise=0.5, **kw))
    for got, ref in ((ops.gram_backward_jvp(G, 'expquad', x, None, dx, **kw),
                      ops.gram_backward_jvp_plain(G, 'expquad', x, None, dx,
                                                  **kw)),
                     (ops.gram_sym_backward_jvp(G, 'expquad', x, dx, **kw),
                      ops.gram_sym_backward_jvp_plain(G, 'expquad', x, dx,
                                                      **kw))):
        for a, b in zip(got, ref):
            torch.testing.assert_close(a, b)
    assert [vars(c) for c in (ops.gram, ops.gram_sym)] == before


def test_in_place_syrk_takes_square_w():
    with pytest.raises(ValueError, match='square'):
        ops.syrk_t_full_(torch.zeros((8, 6)))


def test_unsupported_device_raises():
    A = torch.zeros((128, 128), device='meta')
    with pytest.raises(ValueError, match='unsupported device'):
        ops.schur_update(None, A, tile=128)
    with pytest.raises(ValueError, match='multiples of tile'):
        ops.schur_update(None, torch.zeros(100, 8), tile=128)


@pytest.mark.parametrize('precision', ['medium', 'HIGH', 'fastest', 0])
def test_unknown_precision_raises(precision):
    """Only the JAX package's names (and None) are precisions."""
    A = torch.zeros((128, 8))
    X = torch.zeros((128, 1))
    with pytest.raises(ValueError, match='unknown precision'):
        ops.schur_update(None, A, tile=128, precision=precision)
    with pytest.raises(ValueError, match='unknown precision'):
        ops.schur_update_gram('expquad', X, A, tile=128, precision=precision)
    with pytest.raises(ValueError, match='unknown precision'):
        ops.syrk_t_full(torch.zeros((8, 8)), precision=precision)


def test_kernel_routes():
    """Which CUDA kernel each (dtype, precision) takes, by its launch
    counter: 3xTF32 for float32 at 'high' (and None), 1xTF32 at
    'default', the SIMT kernel at 'highest', and the DMMA kernel for
    float64 at every precision."""
    f32, f64 = torch.float32, torch.float64
    names = (None, 'high', 'default', 'highest')
    assert [_syrk._passes(f32, p) for p in names] == [3, 3, 1, 0]
    assert [_syrk._passes(f64, p) for p in names] == [0, 0, 0, 0]
    assert [_syrk._counter(f32, p) for p in names] == [
        'launches_tc', 'launches_tc', 'launches_tc1', 'launches']
    assert [_syrk._counter(f64, p) for p in names] == ['launches_dmma'] * 4


PRECISIONS = ['high', 'default', 'highest']


def _tc_tol(A, init, dtype, precision):
    """The elementwise bound of the module docstring, for the entries of
    init − A Aᵀ."""
    u = torch.finfo(dtype).eps / 2
    extra = {3: 4 * 2.0 ** -22, 1: 2 * 2.0 ** -11, 0: 0.0}[
        _syrk._passes(dtype, precision)]
    Aa = A.abs()
    return (4 * A.shape[1] ** 0.5 * u + extra) * (Aa @ Aa.T) \
        + 16 * u * (init.abs() + 1)


COUNTERS = ('launches', 'launches_tc', 'launches_tc1', 'launches_dmma')


def _launches(wrapper):
    return tuple(getattr(wrapper, c) for c in COUNTERS)


def _expect(before, dtype, precision):
    k = COUNTERS.index(_syrk._counter(dtype, precision))
    return tuple(c + (i == k) for i, c in enumerate(before))


@pytest.mark.gpu
@pytest.mark.parametrize('precision', PRECISIONS)
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('offset,nreal,h', [(0, None, 384), (256, 700, 384),
                                            (256, 650, 100), (256, 650, 101)])
def test_schur_update_cuda(cuda, gen, dtype, offset, nreal, h, precision):
    """Kernel A at each precision: a nonzero offset into B, a ragged
    nreal and a k-depth that is not a multiple of the tensor-core
    kernels' 32- and 16-column stages (its tail is zero-filled); with
    odd h (rows not 16-byte aligned) the DMMA and SIMT kernels run and
    the TF32 kernel raises."""
    size, tile = 512, 256
    mb = offset + size
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=cuda)
    A = t(gen.standard_normal((size, h)))
    B = t(gen.standard_normal((mb, mb)))
    s = t(gen.uniform(0.5, 2, mb))
    kw = dict(s=s, eps=0.5, size=size, offset=offset, tile=tile,
              nreal=nreal)
    n0 = _launches(ops.schur_update)
    if h % 4 and _syrk._passes(dtype, precision):
        with pytest.raises(ValueError, match='16-byte aligned'):
            ops.schur_update(B, A, precision=precision, **kw)
        assert _launches(ops.schur_update) == n0
        return
    got = ops.schur_update(B, A, precision=precision, **kw)
    assert _launches(ops.schur_update) == _expect(n0, dtype, precision)
    ref = _syrk.schur_update_plain(B, A, **kw)
    keep = _syrk._tile_mask(size, tile, cuda)
    init = _syrk.schur_update_plain(B, torch.zeros_like(A), **kw)
    err = (got - ref).abs()[keep]
    assert bool((err <= _tc_tol(A, init, dtype, precision)[keep]).all()), \
        float(err.max())


@pytest.mark.gpu
def test_tensor_core_kernel_raises_on_unaligned_rows(cuda):
    A = torch.zeros((256, 30), device=cuda)
    with pytest.raises(ValueError, match='16-byte aligned'):
        ops.schur_update(None, A, tile=128)
    with pytest.raises(ValueError, match='multiple of 128'):
        ops.schur_update(None, torch.zeros((192, 32), device=cuda), tile=64)
    ops.schur_update(None, A, tile=128, precision='highest')


@pytest.mark.gpu
@pytest.mark.parametrize('dtype,inplace', [(torch.float32, False),
                                           (torch.float64, False),
                                           (torch.float64, True)])
@pytest.mark.parametrize('m', [512, 300, 1000, 301])
def test_syrk_t_full_cuda(cuda, gen, dtype, inplace, m):
    """Kernel B out of place (SIMT in float32, DMMA in float64) and in
    place (DMMA): exactly symmetric, in W's own storage when in place,
    with ragged edges (m not a multiple of the 128 tile; odd m, rows not
    16-byte aligned)."""
    W = torch.as_tensor(np.tril(gen.standard_normal((m, m))) / m ** 0.5,
                        dtype=dtype, device=cuda)
    ref = _syrk.syrk_t_full_plain(W)
    wrapper = ops.syrk_t_full_ if inplace else ops.syrk_t_full
    counter = 'launches_dmma' if dtype == torch.float64 else 'launches'
    n0 = getattr(wrapper, counter)
    got = wrapper(W)
    torch.cuda.synchronize()
    assert getattr(wrapper, counter) == n0 + 1
    assert (got is W) == inplace
    assert torch.equal(got, got.T)
    torch.testing.assert_close(got, ref, **TOL[dtype])


@pytest.mark.gpu
def test_in_place_syrk_takes_float64(cuda):
    with pytest.raises(TypeError, match='float64'):
        ops.syrk_t_full_(torch.zeros((8, 8), device=cuda))


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('p', [1, 3])
def test_gram_cuda(cuda, gen, dtype, p):
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=cuda)
    x = t(gen.standard_normal((300, p)) * 2).requires_grad_()
    y = t(gen.standard_normal((70, p)) * 2).requires_grad_()
    a = t(1.3).requires_grad_()
    c = t(0.2).requires_grad_()
    noise = t(0.1).requires_grad_()
    post = (('mul', a), ('add', c))
    G = t(gen.standard_normal((300, 70)))
    got = ops.gram('expquad', x, y, post=post, noise=noise)
    ref = ops.gram_plain('expquad', x, y, post=post, noise=noise)
    torch.testing.assert_close(got, ref, **TOL[dtype])
    leaves = (x, y, a, c, noise)
    for g, r in zip(torch.autograd.grad((got * G).sum(), leaves),
                    torch.autograd.grad((ref * G).sum(), leaves)):
        torch.testing.assert_close(g, r, **TOL[dtype])


def _bwd_tol(G, Wr, x, y, dtype, sym, cancel=1.0):
    """Bounds of the backward's sums taken in another order: 8 sqrt(k) u
    times the sum of |terms| over the k terms of each, plus the p-term
    r² rounding of the forward, 16 (p + 1) u per term (times the
    profile's ``cancel``, `_CANCEL`).  A term's
    coordinate factor is taken as |x_i| + |y_j|, not |x_i - y_j|: at
    p > 1 the plain version sums the two apart (rowsum(C) x - C y).
    ``sym``: x is both of K's arguments (G enters as G + Gᵀ)."""
    u = torch.finfo(dtype).eps / 2
    n, p = x.shape
    m = y.shape[0]
    A = G.abs() * Wr.abs()
    if sym:
        A = A + A.T
    rel = 16 * (p + 1) * u * cancel
    D = x[:, None, :].abs() + y[None, :, :].abs()
    tx = 2 * (A[:, :, None] * D).sum(1) * (8 * m ** 0.5 * u + rel)
    ty = 2 * (A[:, :, None] * D).sum(0) * (8 * n ** 0.5 * u + rel)
    return tx, ty, (8 * (n * m) ** 0.5 * u + rel)


def _spread(p):
    """The test points' coordinate scale: 2 up to p = 6, then shrinking
    as 1/sqrt(p), so that r² stays near the p = 6 points' and K does not
    underflow to subnormals, where the bounds' relative terms fail."""
    return 2 * min(1, (6 / p) ** 0.5)


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('n,m,p', [(300, 128, 1), (301, 70, 1), (64, 64, 1),
                                   (257, 131, 3), (130, 67, 6),
                                   (131, 70, 10), (200, 97, 16),
                                   (75, 129, 33)])
def test_gram_forward_cuda(cuda, gen, dtype, n, m, p):
    """Kernels C and E against their plain versions with a ragged n and
    m and unaligned m (rows not 16-byte aligned), and C and E equal to
    the bit on the same points; at p > 1 C stages the coordinates 16 at
    a time (p = 33 takes three slabs, the last of one coordinate)."""
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=cuda)
    x = t(gen.standard_normal((n, p)) * _spread(p))
    y = t(gen.standard_normal((m, p)) * _spread(p))
    post = (('mul', t(1.3)), ('add', t(0.2)), ('mul', t(0.7)))
    for noise in (None, t(0.1)):
        n0 = ops.gram.launches
        got = ops.gram('expquad', x, y, post=post, noise=noise)
        assert ops.gram.launches == n0 + 1
        torch.testing.assert_close(
            got, ops.gram_plain('expquad', x, y, post=post, noise=noise),
            **TOL[dtype])
        full = ops.gram('expquad', x, post=post, noise=noise)
        half = ops.gram_sym('expquad', x, post=post, noise=noise)
        assert torch.equal(full, half)
        torch.testing.assert_close(
            half, ops.gram_sym_plain('expquad', x, post=post, noise=noise),
            **TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('n,m,p', [(300, 128, 1), (301, 70, 1), (64, 64, 1),
                                   (257, 131, 3), (130, 67, 6),
                                   (131, 70, 10), (75, 129, 33)])
def test_gram_backward_cuda(cuda, gen, dtype, n, m, p):
    """Kernel C's fused backward against its plain version: ragged n
    and m, unaligned m, p from 1 to 33 (one launch for every p; p = 33
    sweeps three slabs of staged coordinates); each subset of the
    outputs; y given and y = x; two calls equal to the bit; a G that is
    the transpose of a contiguous matrix (read in place) within the same
    bounds."""
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=cuda)
    x = t(gen.standard_normal((n, p)) * _spread(p))
    y = t(gen.standard_normal((m, p)) * _spread(p))
    x[3] = x[5]   # coincident points: the weight is zero at r² = 0
    post = (('mul', t(1.3)), ('add', t(0.2)), ('mul', t(0.7)))
    noise = t(0.1)
    for yy in (y, None):
        G = t(gen.standard_normal((n, m if yy is not None else n)))
        core = ops.gram_plain('expquad', x, yy)
        Wr = 0.5 * 1.3 * 0.7 * core
        tx, ty, ts = _bwd_tol(G, Wr, x, x if yy is None else yy, dtype,
                              False)
        # the parameters' gradients: sums of n m terms times the chain's
        # scalars (< 4)
        tp = ts * 4 * (G.abs().sum() + (G.abs() * core).sum())
        kw = dict(post=post, noise=noise)
        ref = ops.gram_backward_plain(G, 'expquad', x, yy, **kw)
        for need_xy, need_p in ((True, True), (True, False), (False, True)):
            n0 = ops.gram.launches_bwd
            got = ops.gram_backward(G, 'expquad', x, yy, need_xy=need_xy,
                                    need_p=need_p, **kw)
            assert ops.gram.launches_bwd == n0 + 1
            again = ops.gram_backward(G, 'expquad', x, yy, need_xy=need_xy,
                                      need_p=need_p, **kw)
            for a, b in zip(got, again):
                assert (a is None) == (b is None)
                assert a is None or torch.equal(a, b)
            assert (got[0] is None) != need_xy
            assert (got[2] is None) != need_p
            Gt = G.T.contiguous().T   # G, laid out transposed
            flip = ops.gram_backward(Gt, 'expquad', x, yy, need_xy=need_xy,
                                     need_p=need_p, **kw)
            for res in (got, flip):
                if need_xy:
                    assert bool(((res[0] - ref[0]).abs() <= tx).all())
                    assert bool(((res[1] - ref[1]).abs() <= ty).all())
                if need_p:
                    assert bool(((res[2] - ref[2]).abs() <= tp).all()), \
                        (res[2], ref[2])


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('n,p', [(300, 1), (301, 1), (64, 1), (257, 3),
                                 (130, 6)])
def test_gram_sym_backward_cuda(cuda, gen, dtype, n, p):
    """Kernel E's fused backward against its plain version: ragged and
    unaligned n, p = 3 and p = 6; each subset of the outputs; two calls
    equal to the bit; G laid out transposed within the same bounds."""
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=cuda)
    x = t(gen.standard_normal((n, p)) * 2)
    x[3] = x[5]
    post = (('mul', t(1.3)), ('add', t(0.2)), ('mul', t(0.7)))
    kw = dict(post=post, noise=t(0.1))
    G = t(gen.standard_normal((n, n)))
    core = ops.gram_plain('expquad', x)
    Wr = 0.5 * 1.3 * 0.7 * core
    tx, _, ts = _bwd_tol(G, Wr, x, x, dtype, True)
    tp = ts * 4 * (G.abs().sum() + (G.abs() * core).sum())
    ref = ops.gram_sym_backward_plain(G, 'expquad', x, **kw)
    for need_x, need_p in ((True, True), (True, False), (False, True)):
        n0 = ops.gram_sym.launches_bwd
        got = ops.gram_sym_backward(G, 'expquad', x, need_x=need_x,
                                    need_p=need_p, **kw)
        runs = -(-p // 4) if need_x and p > 1 else 1
        assert ops.gram_sym.launches_bwd == n0 + runs
        again = ops.gram_sym_backward(G, 'expquad', x, need_x=need_x,
                                      need_p=need_p, **kw)
        for a, b in zip(got, again):
            assert (a is None) == (b is None)
            assert a is None or torch.equal(a, b)
        # G laid out transposed, read in place
        flip = ops.gram_sym_backward(G.T.contiguous().T, 'expquad', x,
                                     need_x=need_x, need_p=need_p, **kw)
        for res in (got, flip):
            if need_x:
                assert bool(((res[0] - ref[0]).abs() <= tx).all())
            else:
                assert res[0] is None
            if need_p:
                assert bool(((res[1] - ref[1]).abs() <= tp).all()), \
                    (res[1], ref[1])
            else:
                assert res[1] is None


@pytest.mark.gpu
def test_gp_on_cuda_matches_cpu(cuda, gen):
    """The slice on the card (blocked factorization with kernel A, the
    gradient through kernel B, point blocks through kernel C) against
    the same model on the CPU, in float64."""
    n = 1536
    x = gen.uniform(-20, 20, n)
    y = np.sin(x) + 0.3 * gen.standard_normal(n)
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    n0 = (ops.schur_update.launches_dmma, ops.syrk_t_full_.launches_dmma)
    try:
        out = []
        for dev in ('cpu', cuda):
            lp = torch.tensor([0.1, -0.2], device=dev, requires_grad=True)
            gp = lt.GP(lp[1].exp() * lt.ExpQuad(scale=lp[0].exp()),
                       gram='tiled')
            gp = gp.addx(torch.as_tensor(x, device=dev), 'f')
            gp = gp.addcov(0.09 * torch.eye(n, device=dev), 'e')
            gp = gp.addlintransf(lambda f, e: f + e, ['f', 'e'], 'y')
            ml = gp.marginal_likelihood({'y': torch.as_tensor(y,
                                                              device=dev)})
            g, = torch.autograd.grad(ml, lp)
            out.append((float(ml.detach()), g.cpu()))
        # the factorization and the gradient ran the DMMA kernels
        assert ops.schur_update.launches_dmma > n0[0]
        assert ops.syrk_t_full_.launches_dmma == n0[1] + 1
        np.testing.assert_allclose(out[1][0], out[0][0], rtol=1e-10)
        torch.testing.assert_close(out[1][1], out[0][1], rtol=1e-8,
                                   atol=1e-8)
    finally:
        torch.set_default_dtype(old)


@pytest.mark.gpu
@pytest.mark.parametrize('precision', PRECISIONS)
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('p,h', [(1, 384), (3, 384), (1, 100)])
def test_schur_update_gram_cuda(cuda, gen, dtype, p, h, precision):
    """Kernel D at each precision, at an offset, with a ragged nreal (pad
    tail inside the square), a post chain, with and without eps, and a
    k-depth that is not a multiple of the tensor-core kernel's stage."""
    size, tile, offset = 512, 256, 256
    npad = offset + size
    nreal = npad - 70
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=cuda)
    X = t(gen.standard_normal((npad, p)) * 2)
    A = t(gen.standard_normal((size, h)) / h ** 0.5)
    post = (('mul', t(1.7)), ('add', t(0.1)))
    keep = _syrk._tile_mask(size, tile, cuda)
    for eps in (None, t(0.25)):
        kw = dict(post=post, eps=eps, nreal=nreal, size=size, offset=offset,
                  tile=tile)
        n0 = _launches(ops.schur_update_gram)
        got = ops.schur_update_gram('expquad', X, A, precision=precision,
                                    **kw)
        assert _launches(ops.schur_update_gram) == _expect(n0, dtype,
                                                           precision)
        ref = _syrk.schur_update_gram_plain('expquad', X, A, **kw)
        init = _syrk.schur_update_gram_plain('expquad', X,
                                             torch.zeros_like(A), **kw)
        err = (got - ref).abs()[keep]
        tol = _tc_tol(A, init, dtype, precision)[keep]
        assert bool((err <= tol).all()), float(err.max())


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('p', [1, 3])
def test_gram_sym_cuda(cuda, gen, dtype, p):
    """Kernel E (ragged edge, post chain, nugget) and its backward."""
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=cuda)
    x = t(gen.standard_normal((300, p)) * 2).requires_grad_()
    a = t(1.3).requires_grad_()
    c = t(0.2).requires_grad_()
    noise = t(0.1).requires_grad_()
    post = (('mul', a), ('add', c))
    G = t(gen.standard_normal((300, 300)))
    n0 = ops.gram_sym.launches
    got = ops.gram_sym('expquad', x, post=post, noise=noise)
    assert ops.gram_sym.launches == n0 + 1
    assert torch.equal(got, got.T)
    ref = ops.gram_sym_plain('expquad', x, post=post, noise=noise)
    torch.testing.assert_close(got, ref, **TOL[dtype])
    leaves = (x, a, c, noise)
    for g, r in zip(torch.autograd.grad((got * G).sum(), leaves),
                    torch.autograd.grad((ref * G).sum(), leaves)):
        torch.testing.assert_close(g, r, **TOL[dtype])


@pytest.mark.gpu
def test_stream_and_halfmatrix_on_cuda_match_cpu(cuda, gen):
    """The streaming GP (kernels C and D in the factorization, C in the
    gradient strips) and the halfmatrix GP (kernel E) on the card
    against the same models on the CPU, in float64."""
    n = 1400
    x = gen.uniform(-20, 20, n)
    y = np.sin(x) + 0.3 * gen.standard_normal(n)
    xs = np.linspace(-21, 21, 16)
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        out = []
        launches = [ops.schur_update_gram.launches_dmma,
                    ops.gram_sym.launches]
        for dev in ('cpu', cuda):
            with lt.using_device(dev):
                res = []
                for kw, cov in ((dict(solver='chol-stream', block=256),
                                 0.09),
                                (dict(halfmatrix=True, gram='tiled'),
                                 {('f', 'f'): 0.09 * np.eye(n)})):
                    lp = torch.tensor([0.1, -0.2], device=dev,
                                      requires_grad=True)
                    k = lp[1].exp() * lt.ExpQuad(scale=lp[0].exp())
                    gp = lt.GP(k, **kw).addx(x, 'f').addx(xs, 's')
                    ml = gp.marginal_likelihood({'f': y}, cov)
                    g, = torch.autograd.grad(ml, lp)
                    with torch.no_grad():
                        mean = gp.predfromdata({'f': y}, 's', cov).mean
                    res += [ml.detach().cpu(), g.cpu(), mean.cpu()]
                out.append(res)
        # float64: kernel D on the DMMA kernel
        assert ops.schur_update_gram.launches_dmma > launches[0]
        assert ops.gram_sym.launches > launches[1]
        for got, ref in zip(out[1], out[0]):
            torch.testing.assert_close(got, ref, rtol=1e-8, atol=1e-8)
    finally:
        torch.set_default_dtype(old)


def _misaligned(a):
    """A copy of ``a`` whose storage starts 4 bytes past a 16-byte
    boundary, so that its rows are never 16-byte aligned."""
    buf = torch.empty(a.numel() + 1, dtype=a.dtype, device=a.device)
    out = buf[1:].view(a.shape)
    out.copy_(a)
    assert out.data_ptr() % 16
    return out


@pytest.mark.gpu
@pytest.mark.parametrize('h,misaligned', [
    (0, False), (5, False), (16, False), (16, True), (17, False),
    (102, False), (128, True), (131, False), (300, False), (300, True)])
def test_simt_schur_update_ragged(cuda, gen, h, misaligned):
    """Kernel A's SIMT kernel (float32, 'highest') at depths below, at and
    off its 16-deep k-slab, with rows that are not 16-byte aligned (h % 4
    != 0, or a base 4 bytes off), and an nreal inside the last 128-tile;
    held to the plain version with the bound of the module docstring."""
    size, tile, offset = 384, 128, 128
    mb = offset + size
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=cuda)
    A = t(gen.standard_normal((size, h)))
    if misaligned:
        A = _misaligned(A)
    B = t(gen.standard_normal((mb, mb)))
    s = t(gen.uniform(0.5, 2, mb))
    kw = dict(s=s, eps=0.5, size=size, offset=offset, tile=tile,
              nreal=mb - 37)
    n0 = ops.schur_update.launches
    got = ops.schur_update(B, A, precision='highest', **kw)
    torch.cuda.synchronize()
    assert ops.schur_update.launches == n0 + 1
    ref = _syrk.schur_update_plain(B, A, **kw)
    init = _syrk.schur_update_plain(B, torch.zeros_like(A), **kw)
    keep = _syrk._tile_mask(size, tile, cuda)
    err = (got - ref).abs()[keep]
    tol = _tc_tol(A, init, torch.float32, 'highest')[keep]
    assert bool((err <= tol).all()), float(err.max())


@pytest.mark.gpu
@pytest.mark.parametrize('p,h', [(1, 7), (2, 33), (3, 130), (5, 256)])
def test_simt_schur_update_gram_ragged(cuda, gen, p, h):
    """Kernel D's SIMT kernel at p > 1 and ragged depths, with the pad
    tail starting inside the last 128-tile."""
    size, tile, offset = 384, 128, 256
    npad = offset + size
    t = lambda a: torch.as_tensor(a, dtype=torch.float32, device=cuda)
    X = t(gen.standard_normal((npad, p)))
    A = t(gen.standard_normal((size, h)) / h ** 0.5)
    kw = dict(post=(('mul', t(1.3)),), eps=t(0.09), nreal=npad - 45,
              size=size, offset=offset, tile=tile)
    n0 = ops.schur_update_gram.launches
    got = ops.schur_update_gram('expquad', X, A, precision='highest', **kw)
    torch.cuda.synchronize()
    assert ops.schur_update_gram.launches == n0 + 1
    ref = _syrk.schur_update_gram_plain('expquad', X, A, **kw)
    init = _syrk.schur_update_gram_plain('expquad', X, torch.zeros_like(A),
                                         **kw)
    keep = _syrk._tile_mask(size, tile, cuda)
    err = (got - ref).abs()[keep]
    tol = _tc_tol(A, init, torch.float32, 'highest')[keep]
    assert bool((err <= tol).all()), float(err.max())


@pytest.mark.gpu
@pytest.mark.parametrize('h,m', [(128, 128), (200, 130), (257, 257),
                                 (300, 383), (700, 644), (5, 20)])
@pytest.mark.parametrize('misaligned', [False, True])
def test_simt_syrk_t_full_ragged(cuda, gen, h, m, misaligned):
    """Kernel B's SIMT kernel (float32) on its lower-tile work list: m
    off the 128-tile (the last row and column of tiles partial), m % 4
    != 0 and a misaligned base (4-byte loads and stores), and h != m
    (W tall or short); exactly symmetric, and held to the plain version
    with 4 sqrt(h) u (|W|ᵀ|W|)ᵢⱼ."""
    W = torch.as_tensor(np.tril(gen.standard_normal((h, m))) / h ** 0.5,
                        dtype=torch.float32, device=cuda)
    if misaligned:
        W = _misaligned(W)
    n0 = ops.syrk_t_full.launches
    got = ops.syrk_t_full(W)
    torch.cuda.synchronize()
    assert ops.syrk_t_full.launches == n0 + 1
    assert torch.equal(got, got.T)
    ref = _syrk.syrk_t_full_plain(W)
    u = torch.finfo(torch.float32).eps / 2
    tol = 4 * h ** 0.5 * u * _syrk.syrk_t_full_plain(W.abs()) + 1e-30
    assert bool(((got - ref).abs() <= tol).all()), \
        float((got - ref).abs().max())


def _tangent_inputs(gen, dtype, device, n, m, p):
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    x = t(gen.standard_normal((n, p)) * 2)
    y = t(gen.standard_normal((m, p)) * 2)
    x[3] = x[5]   # coincident points: the weights are zero at r² = 0
    dx = t(gen.standard_normal((n, p)))
    dy = t(gen.standard_normal((m, p)))
    post = (('mul', t(1.3)), ('add', t(0.2)), ('mul', t(0.7)))
    return t, x, y, dx, dy, post, (0.3, -0.4, 0.5)


def _tangent_tol(x, y, dx, dy, dtype):
    """Per-entry bound of the tangent Gram's rounding: 16 (p + 1) u times
    the sum of its terms' magnitudes (α g' dr² with dr²'s terms summed in
    magnitude, dα g, dβ, dnoise), with the chain ((1.3 g + 0.2) 0.7)
    and tangents (0.3, -0.4, 0.5, 0.5)."""
    u = torch.finfo(dtype).eps / 2
    p = x.shape[1]
    core = ops.gram_plain('expquad', x, y)
    adr2 = 2 * ((x[:, None, :] - y[None, :, :]).abs()
                * (dx[:, None, :] - dy[None, :, :]).abs()).sum(-1)
    terms = 0.5 * 1.3 * 0.7 * core * adr2 + 1.0 * core + 1.0
    return 16 * (p + 1) * u * terms


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('n,m,p', [(300, 128, 1), (301, 70, 1), (64, 64, 1),
                                   (257, 131, 3), (130, 67, 6)])
def test_gram_jvp_cuda(cuda, gen, dtype, n, m, p):
    """Kernels C′ and E′ (the tangent Gram) against their plain version:
    ragged and unaligned n and m, p > 1, the chain's and the nugget's
    tangents; E′ writes C′'s entries to the bit."""
    t, x, y, dx, dy, post, dpost = _tangent_inputs(gen, dtype, cuda, n, m, p)
    kw = dict(post=post, noise=t(0.1), dpost=dpost, dnoise=0.5)
    for yy, dyy in ((y, dy), (None, None)):
        n0 = ops.gram.launches_jvp
        got = ops.gram_jvp('expquad', x, yy, dx, dyy, **kw)
        assert ops.gram.launches_jvp == n0 + 1
        ref = ops.gram_jvp_plain('expquad', x, yy, dx, dyy, **kw)
        tol = _tangent_tol(x, x if yy is None else yy, dx,
                           dx if yy is None else dyy, dtype)
        assert bool(((got - ref).abs() <= tol).all())
    n0 = ops.gram_sym.launches_jvp
    half = ops.gram_sym_jvp('expquad', x, dx, **kw)
    assert ops.gram_sym.launches_jvp == n0 + 1
    assert torch.equal(half, got)
    assert torch.equal(half, half.T)


def _bwd_jvp_tol(G, x, y, dx, dy, dtype, sym):
    """Bounds of the backward tangent's sums taken in another order, as
    `_bwd_tol`: the terms' weights |G| (|dα g'| + |α g'' dr²|) on the
    coordinates and |G α g'| on their tangents, with the chain's
    α = 0.91 and dα = 0.3 0.7 + 1.3 0.5 (the tangents of 1.3 and 0.7)."""
    u = torch.finfo(dtype).eps / 2
    n, p = x.shape
    m = y.shape[0]
    core = ops.gram_plain('expquad', x, y)
    alpha, dalpha = 1.3 * 0.7, 0.3 * 0.7 + 1.3 * 0.5
    adr2 = 2 * ((x[:, None, :] - y[None, :, :]).abs()
                * (dx[:, None, :] - dy[None, :, :]).abs()).sum(-1)
    A1 = G.abs() * (0.5 * abs(dalpha) * core + 0.25 * alpha * core * adr2)
    A2 = G.abs() * (0.5 * alpha * core)
    if sym:
        A1, A2 = A1 + A1.T, A2 + A2.T
    rel = 16 * (p + 1) * u
    D = x[:, None, :].abs() + y[None, :, :].abs()
    dD = dx[:, None, :].abs() + dy[None, :, :].abs()
    T = A1[:, :, None] * D + A2[:, :, None] * dD
    tx = 2 * T.sum(1) * (8 * m ** 0.5 * u + rel)
    ty = 2 * T.sum(0) * (8 * n ** 0.5 * u + rel)
    ts = (8 * (n * m) ** 0.5 * u + rel) * 4 * (
        G.abs().sum() + (G.abs() * core).sum()
        + (G.abs() * 0.5 * core * adr2).sum())
    return tx, ty, ts


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('n,m,p', [(300, 128, 1), (301, 70, 1), (64, 64, 1),
                                   (257, 131, 3), (130, 67, 6)])
def test_gram_backward_jvp_cuda(cuda, gen, dtype, n, m, p):
    """Kernel C″ (the tangent of C's backward at fixed G) against its
    plain version: ragged n and m, unaligned m, p = 3 (one launch) and
    p = 6 (two); each subset of the outputs; y given and y = x; two calls
    equal to the bit; G laid out transposed within the same bounds."""
    t, x, y, dx, dy, post, dpost = _tangent_inputs(gen, dtype, cuda, n, m, p)
    kw = dict(post=post, noise=t(0.1), dpost=dpost)
    for yy, dyy in ((y, dy), (None, None)):
        G = t(gen.standard_normal((n, m if yy is not None else n)))
        tx, ty, tp = _bwd_jvp_tol(G, x, x if yy is None else yy, dx,
                                  dx if yy is None else dyy, dtype, False)
        ref = ops.gram_backward_jvp_plain(G, 'expquad', x, yy, dx, dyy, **kw)
        for need_xy, need_p in ((True, True), (True, False), (False, True)):
            n0 = ops.gram.launches_bwd_jvp
            got = ops.gram_backward_jvp(G, 'expquad', x, yy, dx, dyy,
                                        need_xy=need_xy, need_p=need_p, **kw)
            runs = -(-p // 4) if need_xy and p > 1 else 1
            assert ops.gram.launches_bwd_jvp == n0 + runs
            again = ops.gram_backward_jvp(G, 'expquad', x, yy, dx, dyy,
                                          need_xy=need_xy, need_p=need_p,
                                          **kw)
            for a, b in zip(got, again):
                assert (a is None) == (b is None)
                assert a is None or torch.equal(a, b)
            # G laid out transposed, read in place
            flip = ops.gram_backward_jvp(G.T.contiguous().T, 'expquad', x,
                                         yy, dx, dyy, need_xy=need_xy,
                                         need_p=need_p, **kw)
            for res in (got, flip):
                if need_xy:
                    assert bool(((res[0] - ref[0]).abs() <= tx).all())
                    assert bool(((res[1] - ref[1]).abs() <= ty).all())
                else:
                    assert res[0] is None and res[1] is None
                if need_p:
                    assert bool(((res[2] - ref[2]).abs() <= tp).all()), \
                        (res[2], ref[2])
                else:
                    assert res[2] is None


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('n,p', [(300, 1), (301, 1), (64, 1), (257, 3),
                                 (130, 6)])
def test_gram_sym_backward_jvp_cuda(cuda, gen, dtype, n, p):
    """Kernel E″ against its plain version: ragged and unaligned n,
    p = 3 and p = 6; each subset of the outputs; two calls equal to the
    bit; G laid out transposed within the same bounds."""
    t, x, _, dx, _, post, dpost = _tangent_inputs(gen, dtype, cuda, n, 8, p)
    kw = dict(post=post, noise=t(0.1), dpost=dpost)
    G = t(gen.standard_normal((n, n)))
    tx, _, tp = _bwd_jvp_tol(G, x, x, dx, dx, dtype, True)
    ref = ops.gram_sym_backward_jvp_plain(G, 'expquad', x, dx, **kw)
    for need_x, need_p in ((True, True), (True, False), (False, True)):
        n0 = ops.gram_sym.launches_bwd_jvp
        got = ops.gram_sym_backward_jvp(G, 'expquad', x, dx, need_x=need_x,
                                        need_p=need_p, **kw)
        runs = -(-p // 4) if need_x and p > 1 else 1
        assert ops.gram_sym.launches_bwd_jvp == n0 + runs
        again = ops.gram_sym_backward_jvp(G, 'expquad', x, dx, need_x=need_x,
                                          need_p=need_p, **kw)
        for a, b in zip(got, again):
            assert (a is None) == (b is None)
            assert a is None or torch.equal(a, b)
        # G laid out transposed, read in place
        flip = ops.gram_sym_backward_jvp(G.T.contiguous().T, 'expquad', x,
                                         dx, need_x=need_x, need_p=need_p,
                                         **kw)
        for res in (got, flip):
            if need_x:
                assert bool(((res[0] - ref[0]).abs() <= tx).all())
            else:
                assert res[0] is None
            if need_p:
                assert bool(((res[1] - ref[1]).abs() <= tp).all()), \
                    (res[1], ref[1])
            else:
                assert res[1] is None


@pytest.mark.gpu
@pytest.mark.parametrize('halfmatrix', [False, True])
def test_gram_double_backward_cuda(cuda, gen, halfmatrix):
    """The Hessian of <G, K> + |K|²/2 in the points and the chain's
    scalar through the Functions' double backward (C″ for the points and
    the scalar, C′ for the output gradient G + K; or E″ and E′) on the
    card against the same on the CPU, in float64."""
    x0 = gen.standard_normal(90) * 2
    G0 = gen.standard_normal((90, 90))

    def hessian(device):
        x = torch.as_tensor(x0, device=device).requires_grad_()
        a = torch.tensor(1.3, dtype=torch.float64, device=device,
                         requires_grad=True)
        fn = ops.gram_sym if halfmatrix else ops.gram
        K = fn('expquad', x, post=(('mul', a),),
               noise=torch.tensor(0.1, dtype=torch.float64, device=device))
        v = (K * torch.as_tensor(G0, device=device)).sum() \
            + 0.5 * (K * K).sum()
        g = torch.cat([t.reshape(-1) for t in
                       torch.autograd.grad(v, (x, a), create_graph=True)])
        return torch.stack([
            torch.cat([t.reshape(-1) for t in torch.autograd.grad(
                g[k], (x, a), retain_graph=True)]) for k in (0, 7, 90)])

    counter = ops.gram_sym if halfmatrix else ops.gram
    n0 = counter.launches_jvp, counter.launches_bwd_jvp
    got = hessian(cuda)
    assert (counter.launches_jvp, counter.launches_bwd_jvp) == \
        (n0[0] + 3, n0[1] + 3)
    torch.testing.assert_close(got.cpu(), hessian('cpu'), rtol=1e-10,
                               atol=1e-10)


@pytest.mark.gpu
@pytest.mark.parametrize('p,n,halfmatrix,above', [(1, 8192, False, True),
                                                  (1, 6144, False, True),
                                                  (1, 4096, False, False),
                                                  (2, 8192, False, True),
                                                  (2, 4096, False, False),
                                                  (8, 256, True, True)])
def test_auto_gram_launches_kernel_c_cuda(cuda, gen, p, n, halfmatrix,
                                          above):
    """A default-gram GP (gram='auto') on CUDA points evaluates its point
    block with kernel C (kernel E with halfmatrix), forward and fused
    backward, where the measured cutover puts the block (n x n, p
    coordinates, p > 1 as StructuredArray fields), and broadcasts the
    core below it; either way the block is gram='broadcast''s, in
    float32 within 16 (p + 1) u max|K| (the routes round the p-term r²
    in other orders and take other exps)."""
    from lsqfitgp_torch.gp._gp import _auto_tiles
    X = torch.as_tensor(gen.uniform(-5, 5, (n, p)), dtype=torch.float32,
                        device=cuda)
    pts = X[:, 0] if p == 1 else lt.asarray(
        {f'f{i}': X[:, i] for i in range(p)})
    lp = torch.tensor([0.3, 0.2], device=cuda, requires_grad=True)

    def block(gram):
        gp = lt.GP(lp[1].exp() * lt.ExpQuad(scale=lp[0].exp()), gram=gram,
                   halfmatrix=halfmatrix, checkpos=False)
        return gp.addx(pts, 'a')._covblock('a', 'a')

    fn = ops.gram_sym if halfmatrix else ops.gram
    before = fn.launches, fn.launches_bwd
    K = block('auto')
    torch.autograd.grad(K.sum(), lp)
    launched = (fn.launches - before[0], fn.launches_bwd - before[1])
    # above or below the cutover of PERF.md's table
    assert _auto_tiles(cuda, n, n, p) == above
    chunks = -(-p // 4)  # the backward's launches, 4 coordinates each
    assert launched == ((1, chunks) if above else (0, 0))
    with torch.no_grad():
        Kb = block('broadcast')
    u = torch.finfo(torch.float32).eps / 2
    tol = 16 * (p + 1) * u * float(Kb.abs().max())
    assert float((K.detach() - Kb).abs().max()) <= tol


# -- the zoo's profiles ----------------------------------------------------------

def _zoo_descs(t):
    """The profiles of the zoo that kernels C, D and E evaluate, as
    descriptions with numbers made by ``t``: single cores in each mode,
    dynamic and static arguments, and 2- and 3-term sums."""
    P = ops.PROFILES
    T, S = ops.Term, ops.Terms
    amp = (('mul', t(1.3)),)
    return {
        'maternp0': S((T(P['maternp'], k=0),), amp),
        'maternp1': S((T(P['maternp'], k=1),), amp),
        'maternp2': S((T(P['maternp'], k=2),), amp),
        'maternp5': S((T(P['maternp'], k=5),), amp),
        'expon': S((T(P['expon'], 'abs'),), amp + (('add', t(0.2)),)),
        'gammaexp': S((T(P['gammaexp'], args=(t(1.3),)),), amp),
        'gammaexp2': S((T(P['gammaexp2']),), amp),
        'cauchy': S((T(P['cauchy'], args=(t(1.4), t(0.8))),), amp),
        'cauchy2': S((T(P['cauchy2'], args=(t(0.8),)),), amp),
        'posabs': S((T(P['expquad'], 'posabs'),), amp),
        'terms': S((T(P['maternp'], k=2, scale=t(0.7),
                      post=(('mul', t(1.1)),)),
                    T(P['expquad'], scale=t(3.0),
                      post=(('mul', t(0.6)),)))),
        'terms3': S((T(P['maternp'], k=1, scale=t(0.5)),
                     T(P['gammaexp'], args=(t(1.6),), scale=t(2.0),
                       post=(('mul', t(0.4)),)),
                     T(P['expon'], 'abs', scale=t(1.5))),
                    (('mul', t(0.9)), ('add', t(0.05)))),
        # the 1-D time-series cores and the rest of the 'abs'/'posabs'
        # zoo, their arguments dynamic
        'periodic': S((T(P['periodic'], 'abs', args=(t(1.4),)),), amp),
        'holeeffect': S((T(P['holeeffect'], 'abs'),), amp),
        'causalexpquad': S((T(P['causalexpquad'], 'posabs',
                              args=(t(1.7),)),), amp),
        'log': S((T(P['log'], 'posabs'),), amp),
        # scaled so that the test's points stay well inside its support:
        # near the edge (1 − t)^(ν+k−1) amplifies r²'s rounding by
        # (ν+k−1)/(1 − t), beyond `_bwd_tol`'s per-term bound (the smoke's
        # record holds the edge, on a quarter of its pairs, by row sums)
        'wendland2': S((T(P['wendland'], 'posabs', k=2, args=(t(1.6),),
                          scale=t(20.0)),), amp),
        'circular': S((T(P['circular'], 'posabs',
                         args=(t(4.5), t(0.4))),), amp),
        'celerite': S((T(P['celerite'], 'abs', args=(t(0.3), t(0.1))),),
                      amp),
        'harmonic-hi': S((T(P['harmonic'], 'abs', args=(t(2.0),)),), amp),
        'harmonic-lo': S((T(P['harmonic'], 'abs', args=(t(0.4),)),), amp),
        'harmonic-1': S((T(P['harmonic'], 'abs', args=(t(1.0),)),), amp),
        'cos': S((T(P['cos'], 'abs'),), amp),
        'sinc': S((T(P['sinc'], 'posabs'),), amp),
        'ts-terms': S((T(P['celerite'], 'abs', args=(t(0.3), t(0.1))),
                       T(P['harmonic'], 'abs', args=(t(2.0),),
                         scale=t(2.0), post=(('mul', t(0.5)),)))),
        # StationaryFracBrownian (H dynamic), the real-order Matérn and
        # Bessel (static orders; Bessel scaled so that its series, whose
        # terms reach e^x, stays below x = 9 in float64), Pink (δω
        # dynamic), Color and a sum of the two spectral cores
        'sfb': S((T(P['sfb'], 'abs', args=(t(0.7),)),), amp),
        'matern1.7': S((T(P['matern'], args=(1.7,)),), amp),
        'matern4.2': S((T(P['matern'], args=(4.2,)),), amp),
        'bessel': S((T(P['bessel'], args=(1.0,), scale=t(3.0)),), amp),
        'pink': S((T(P['pink'], 'abs', args=(t(1.5),)),), amp),
        'color3': S((T(P['color'], 'abs', k=3),), amp),
        'spectral-terms': S((T(P['pink'], 'abs', args=(t(0.5),)),
                             T(P['color'], 'abs', k=4, scale=t(2.0),
                               post=(('mul', t(0.5)),)))),
    }


ZOO = sorted(_zoo_descs(lambda v: torch.tensor(v)))

# the factor by which a profile's evaluation by another formula errs
# beyond TOL: Bessel's alternating series in float64, whose terms reach
# I_0(x) in sum, x ≤ 10 at the tests' points (I_0(10) ≈ 2.8e3), summed
# by their recurrence on the card and as exponentials of logarithms in
# the plain version (the float32 kernel, which sums its series in
# float64, is held to the float64 plain version with no factor);
# Color's 130 complex continued-fraction steps.  `chip_smoke.py`'s
# `zoo_amp` has other numbers because it scales another tolerance, 32
# (p + 1) u of the largest entry, on points that reach Bessel's cut
_CANCEL = {'bessel': 2.8e3, 'color3': 4.0, 'spectral-terms': 4.0}


def _zoo_setup(cuda, gen, dtype, n, m, p, name):
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=cuda)
    x = t(gen.standard_normal((n, p)) * _spread(p))
    y = t(gen.standard_normal((m, p)) * _spread(p))
    x[3] = x[5]   # coincident points: the weight is zero at r² = 0
    y[1] = x[7]
    return t, x, y, _zoo_descs(t)[name]


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('n,m,p', [(300, 128, 1), (131, 70, 3),
                                   (75, 129, 10)])
@pytest.mark.parametrize('name', ZOO)
def test_zoo_gram_cuda(cuda, gen, dtype, n, m, p, name):
    """Kernels C and E on each zoo profile against the plain version,
    with a nugget, ragged n and m and unaligned m, C and E equal to the
    bit; C's fused backward (two calls equal to the bit, one launch)
    against the plain backward in float64 on the same inputs, within the
    bounds of `_bwd_tol` (the parameter vector's slots: its sums times
    the sum of |G ∂K/∂θ|); C′ (forward AD on `ops.gram`, along the
    points and every number of the description) against the plain
    version's tangent, to rtol 1e-4 (float32) or 1e-11 (float64) of
    the tangent's largest entry."""
    import torch.autograd.forward_ad as fwAD
    from lsqfitgp_torch.ops import _gram
    t, x, y, desc = _zoo_setup(cuda, gen, dtype, n, m, p, name)
    noise = t(0.1)
    # Bessel's plain series in float32 (each term the exponential of its
    # logarithm, as the JAX package's) errs by ~I_0(x) u near its cut:
    # the float32 kernel is held to the float64 plain version instead
    exact = name == 'bessel' and dtype == torch.float32
    t64 = lambda a: torch.as_tensor(a, dtype=torch.float64, device=cuda)
    rt = t64 if exact else t
    got = ops.gram(desc, x, y, noise=noise)
    ref = ops.gram_plain(_zoo_descs(rt)[name], rt(x), rt(y), noise=rt(0.1))
    f = 1.0 if exact else _CANCEL.get(name, 1.0)
    torch.testing.assert_close(got, ref.to(dtype), rtol=TOL[dtype]['rtol'] * f,
                               atol=TOL[dtype]['atol'] * f)
    full = ops.gram(desc, x, noise=noise)
    half = ops.gram_sym(desc, x, noise=noise)
    assert torch.equal(full, half)
    # the backward through the wrappers' internals: the folded vector
    _, st, _, _, pvec = _gram._args(desc, x, None, (), noise)
    fv = _gram._fold(st, pvec)
    G = t(gen.standard_normal((n, m)))
    n0 = ops.gram.launches_bwd
    res = _gram._backward(G, st, x, y, fv, True, True, True)
    assert ops.gram.launches_bwd == n0 + 1
    again = _gram._backward(G, st, x, y, fv, True, True, True)
    assert all(torch.equal(a, b) for a, b in zip(res, again))
    d = lambda a: a.double()
    G64, x64, y64, fv64 = d(G), d(x), d(y), d(fv)
    ref = _gram._backward_plain(G64, st, x64, y64, fv64, True, True, True)
    r2 = _gram._sqdist_plain(x64, y64)
    evals = _gram._terms_plain(st, fv64, r2, d1=True, da=True)
    Wr = _gram._deriv_plain(st, x64, y64, fv64, evals, r2)
    tx, ty, ts = _bwd_tol(G64, Wr, x64, y64, dtype, False, f)
    assert bool(((d(res[0]) - ref[0]).abs() <= tx).all())
    assert bool(((d(res[1]) - ref[1]).abs() <= ty).all())
    mags = [G64.abs().sum(), G64.diagonal().abs().sum()] + [
        G64.new_zeros(()) if mt is None else (G64.abs() * mt.abs()).sum()
        for mt in _gram._partials(st, fv64, r2, evals)]
    tp = ts * 4 * torch.stack(mags) + 1e-30
    assert bool(((d(res[2]) - ref[2]).abs() <= tp).all()), (res[2], ref[2])
    # C′ along the points and the description's numbers
    vals = _gram._flat(desc)
    dx, dy = t(gen.standard_normal((n, p))), t(gen.standard_normal((m, p)))
    dv = [t(gen.standard_normal(())) for _ in vals]

    def tangent(fn, c=t):
        with fwAD.dual_level():
            num = [fwAD.make_dual(c(v), c(dvi)) for v, dvi in zip(vals, dv)]
            out = fn(_gram._rebuild(st, num), fwAD.make_dual(c(x), c(dx)),
                     fwAD.make_dual(c(y), c(dy)), noise=c(noise))
            return fwAD.unpack_dual(out).tangent

    n0 = ops.gram.launches_jvp
    tg = tangent(ops.gram)
    assert ops.gram.launches_jvp == n0 + 1
    tr = tangent(ops.gram_plain, rt).to(dtype)
    rtol = 1e-4 if dtype == torch.float32 else 1e-11
    assert float((tg - tr).abs().max()) <= rtol * float(tr.abs().max())


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('n,p', [(300, 1), (257, 3)])
@pytest.mark.parametrize('name', ZOO)
def test_zoo_gram_sym_cuda(cuda, gen, dtype, n, p, name):
    """Kernel E's fused backward on each zoo profile against C's (the
    same sums: G and Gᵀ both enter), two calls equal to the bit."""
    from lsqfitgp_torch.ops import _gram
    t, x, _, desc = _zoo_setup(cuda, gen, dtype, n, n, p, name)
    _, st, _, _, pvec = _gram._args(desc, x, None, (), t(0.1))
    fv = _gram._fold(st, pvec)
    G = t(gen.standard_normal((n, n)))
    got = _gram._sym_backward(G, st, x, fv, True, True, True)
    again = _gram._sym_backward(G, st, x, fv, True, True, True)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    gx, gy, gf = _gram._backward_plain(G.double(), st, x.double(),
                                       x.double(), fv.double(), True, True,
                                       True)
    rtol = 1e-4 if dtype == torch.float32 else 1e-11
    ref = gx + gy
    assert float((got[0].double() - ref).norm()) <= rtol * float(ref.norm())
    assert float((got[1].double() - gf).abs().max()) \
        <= rtol * float(gf.abs().max() + 1)


@pytest.mark.gpu
@pytest.mark.parametrize('precision', ['high', 'highest'])
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('p', [1, 3])
@pytest.mark.parametrize('name', ['maternp2', 'expon', 'gammaexp', 'cauchy',
                                  'terms', 'terms3', 'celerite',
                                  'harmonic-lo', 'wendland2', 'ts-terms',
                                  'sfb', 'matern1.7', 'bessel', 'pink',
                                  'color3'])
def test_zoo_schur_update_gram_cuda(cuda, gen, dtype, p, name, precision):
    """Kernel D on the zoo's profiles and term sums, at an offset with a
    ragged nreal and eps, against its plain version within `_tc_tol`."""
    size, tile, offset = 512, 256, 256
    npad = offset + size
    nreal = npad - 70
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=cuda)
    X = t(gen.standard_normal((npad, p)) * 2)
    A = t(gen.standard_normal((size, 384)) / 384 ** 0.5)
    desc = _zoo_descs(t)[name]
    keep = _syrk._tile_mask(size, tile, cuda)
    kw = dict(eps=t(0.25), nreal=nreal, size=size, offset=offset, tile=tile)
    got = ops.schur_update_gram(desc, X, A, precision=precision, **kw)
    # Bessel's float32 plain series errs by ~I_0(x) u (as in
    # `test_zoo_gram_cuda`): held to the float64 plain version
    exact = name == 'bessel' and dtype == torch.float32
    rt = (lambda a: torch.as_tensor(a, dtype=torch.float64, device=cuda)) \
        if exact else t
    kw64 = dict(kw, eps=rt(0.25))
    ref = _syrk.schur_update_gram_plain(_zoo_descs(rt)[name], rt(X), rt(A),
                                        **kw64).to(dtype)
    init = _syrk.schur_update_gram_plain(desc, X, torch.zeros_like(A), **kw)
    err = (got - ref).abs()[keep]
    # the profile by another formula: 32 u more of the entry; for the
    # cores of `_CANCEL`, whose error is absolute (a series' or a
    # continued fraction's), that times the factor and the largest entry
    if exact or name not in _CANCEL:
        entry = init.abs()
    else:
        entry = _CANCEL[name] * float(init.abs().max())
    tol = (_tc_tol(A, init, dtype, precision)
           + 32 * torch.finfo(dtype).eps * entry)[keep]
    assert bool((err <= tol).all()), float(err.max())


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('name', ['maternp2', 'maternp5', 'gammaexp2',
                                  'cauchy2', 'periodic', 'matern4.2',
                                  'bessel'])
def test_zoo_gram_backward_jvp_cuda(cuda, gen, dtype, name):
    """Kernels C″ and E″ on one-term zoo profiles along the points and the
    chain against their plain versions (norm-wise rtol 1e-4 in float32,
    1e-11 in float64), two calls equal to the bit.  The profiles are
    twice differentiable at r² = 0: on the others (Maternp p < 2, Expon,
    GammaExp γ < 2, Celerite, Harmonic) g'' grows without bound near
    coincident points and amplifies the rounding of r² into the tangent,
    whatever the route (their plain versions are held to the double
    backward on the CPU, tests/test_torch_zoo.py and
    tests/test_torch_timeseries.py; the real-order Matérn is twice
    differentiable at 0 from ν > 2 on, Bessel everywhere)."""
    t, x, y, desc = _zoo_setup(cuda, gen, dtype, 200, 90, 1, name)
    dx, dy = t(gen.standard_normal((200, 1))), t(gen.standard_normal((90, 1)))
    G = t(gen.standard_normal((200, 90)))
    rtol = 1e-4 if dtype == torch.float32 else 1e-11
    for fn, ref_fn, args in (
            (ops.gram_backward_jvp, ops.gram_backward_jvp_plain,
             (G, desc, x, y, dx, dy)),
            (ops.gram_sym_backward_jvp, ops.gram_sym_backward_jvp_plain,
             (G[:, :90] @ G[:, :90].T / 10, desc, x, dx))):
        kw = dict(post=(('mul', t(0.8)),), dpost=(0.3,))
        got, again = fn(*args, **kw), fn(*args, **kw)
        assert all(a is None or torch.equal(a, b)
                   for a, b in zip(got, again))
        ref = ref_fn(*args, **kw)
        for a, b in zip(got, ref):
            if a is not None:
                assert float((a - b).norm()) <= rtol * float(b.norm() + 1)


@pytest.mark.gpu
def test_zoo_models_on_cuda_match_cpu(cuda, gen):
    """The Matérn-5/2 model (dense, default gram: kernel C) and the
    multi-scale term sum (dense and chol-stream: C and D) on the card
    give the CPU's likelihood and gradient in float64 (rtol 1e-9 and
    1e-8), the Matérn model's Hessian too (C′ and C″)."""
    x = np.sort(gen.uniform(-20, 20, 700))
    y = np.sin(x) + 0.3 * gen.standard_normal(700)
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        def models(lp):
            def k2():
                return lp[1].exp() * lt.Maternp(p=2, scale=lp[0].exp()) \
                    + lp[2].exp() * lt.ExpQuad(scale=lp[3].exp()) \
                    + 0.09 * lt.White()
            k1 = lp[1].exp() * lt.Maternp(p=2, scale=lp[0].exp())
            yield lt.GP(k1 + 0.09 * lt.White(), gram='tiled'), True
            yield lt.GP(k2(), gram='tiled'), False
            yield lt.GP(k2(), solver='chol-stream', block=128), False

        out = {}
        for dev in ('cpu', 'cuda'):
            with lt.using_device(dev):
                lp = torch.tensor([0.3, 0.1, -0.5, 1.0], device=dev,
                                  requires_grad=True)
                res = []
                for gp, hess in models(lp):
                    with lt.linalg.second_order():
                        v = gp.addx(x, 'y').marginal_likelihood({'y': y})
                        (g,) = torch.autograd.grad(v, lp, create_graph=hess)
                        res += [v.detach().cpu(), g.detach().cpu()]
                        if hess:
                            H = torch.stack([torch.autograd.grad(
                                g[k], lp, retain_graph=True)[0]
                                for k in range(2)])
                            res.append(H.cpu())
                out[dev] = res
        for a, b in zip(out['cuda'], out['cpu']):
            torch.testing.assert_close(a, b, rtol=1e-8, atol=1e-9)
    finally:
        torch.set_default_dtype(old)


@pytest.mark.gpu
def test_timeseries_models_on_cuda_match_cpu(cuda, gen):
    """The time-series example's model, amp * Celerite(gamma, B) + noise *
    White(), dense (default gram: kernel C on the celerite profile) and
    chol-stream (C and D), and a Celerite + Harmonic sum dense, on the
    card give the CPU's likelihood and gradient in float64 (rtol 1e-8)."""
    t = np.sort(gen.uniform(0, 120, 900))
    y = np.cos(t) * np.exp(-0.01 * t) + 0.2 * gen.standard_normal(900)
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        def celerite(lp):
            e = lp.exp()
            return e[0] * lt.Celerite(gamma=e[1], B=0.05) \
                + e[2] * lt.White()

        def models(lp):
            yield lt.GP(celerite(lp), gram='tiled')
            yield lt.GP(celerite(lp), solver='chol-stream', block=128)
            yield lt.GP(celerite(lp) + lt.Harmonic(Q=lp[3].exp(), scale=2.0),
                        gram='tiled')

        out = {}
        for dev in ('cpu', 'cuda'):
            with lt.using_device(dev):
                lp = torch.tensor([0.2, -2.0, -3.0, 0.7], device=dev,
                                  requires_grad=True)
                res = []
                for gp in models(lp):
                    v = gp.addx(t, 'y').marginal_likelihood({'y': y})
                    (g,) = torch.autograd.grad(v, lp)
                    res += [v.detach().cpu(), g.detach().cpu()]
                out[dev] = res
        for a, b in zip(out['cuda'], out['cpu']):
            torch.testing.assert_close(a, b, rtol=1e-8, atol=1e-9)
    finally:
        torch.set_default_dtype(old)


@pytest.mark.gpu
def test_new_cores_models_on_cuda_match_cpu(cuda, gen):
    """The fractional-Gaussian-noise model, amp * StationaryFracBrownian(H)
    on the unit grid with white noise, dense (the noise as the data's
    scalar givencov, so that kernel C evaluates 'sfb') and chol-stream
    (+ noise * White(): C and D), and amp * Matern(nu=1.7, scale) dense
    (C on 'matern'), on the card give the CPU's likelihood and gradient
    in float64 (rtol 1e-8)."""
    t = np.arange(900, dtype=float)
    y = gen.standard_normal(900)
    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        def sfb(lp):
            H = 1 / (1 + (-lp[1]).exp())
            return lp[0].exp() * lt.StationaryFracBrownian(H=H)

        def values(lp):
            # each model its own graph: the gradients free theirs
            yield lt.GP(sfb(lp), gram='tiled').addx(t, 'y') \
                .marginal_likelihood({'y': y}, givencov=lp[2].exp())
            yield lt.GP(sfb(lp) + lp[2].exp() * lt.White(),
                        solver='chol-stream', block=128).addx(t, 'y') \
                .marginal_likelihood({'y': y})
            k = lp[0].exp() * lt.Matern(nu=1.7, scale=30 * lp[1].exp())
            yield lt.GP(k, gram='tiled').addx(t, 'y') \
                .marginal_likelihood({'y': y}, givencov=lp[2].exp())

        out = {}
        for dev in ('cpu', 'cuda'):
            with lt.using_device(dev):
                lp = torch.tensor([0.2, 1.0, -1.0], device=dev,
                                  requires_grad=True)
                res = []
                for v in values(lp):
                    (g,) = torch.autograd.grad(v, lp)
                    res += [v.detach().cpu(), g.detach().cpu()]
                out[dev] = res
        for a, b in zip(out['cuda'], out['cpu']):
            torch.testing.assert_close(a, b, rtol=1e-8, atol=1e-9)
    finally:
        torch.set_default_dtype(old)
