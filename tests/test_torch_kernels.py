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


def _bwd_tol(G, Wr, x, y, dtype, sym):
    """Bounds of the backward's sums taken in another order: 8 sqrt(k) u
    times the sum of |terms| over the k terms of each, plus the p-term
    r² rounding of the forward, 16 (p + 1) u per term.  A term's
    coordinate factor is taken as |x_i| + |y_j|, not |x_i - y_j|: at
    p > 1 the plain version sums the two apart (rowsum(C) x - C y).
    ``sym``: x is both of K's arguments (G enters as G + Gᵀ)."""
    u = torch.finfo(dtype).eps / 2
    n, p = x.shape
    m = y.shape[0]
    A = G.abs() * Wr.abs()
    if sym:
        A = A + A.T
    rel = 16 * (p + 1) * u
    D = x[:, None, :].abs() + y[None, :, :].abs()
    tx = 2 * (A[:, :, None] * D).sum(1) * (8 * m ** 0.5 * u + rel)
    ty = 2 * (A[:, :, None] * D).sum(0) * (8 * n ** 0.5 * u + rel)
    return tx, ty, (8 * (n * m) ** 0.5 * u + rel)


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('n,m,p', [(300, 128, 1), (301, 70, 1), (64, 64, 1),
                                   (257, 131, 3), (130, 67, 6)])
def test_gram_forward_cuda(cuda, gen, dtype, n, m, p):
    """Kernels C and E against their plain versions with a ragged n and
    m and unaligned m (rows not 16-byte aligned), and C and E equal to
    the bit on the same points."""
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=cuda)
    x = t(gen.standard_normal((n, p)) * 2)
    y = t(gen.standard_normal((m, p)) * 2)
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
                                   (257, 131, 3), (130, 67, 6)])
def test_gram_backward_cuda(cuda, gen, dtype, n, m, p):
    """Kernel C's fused backward against its plain version: ragged n
    and m, unaligned m, p = 3 (one launch) and p = 6 (two); each subset
    of the outputs; y given and y = x; two calls equal to the bit."""
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=cuda)
    x = t(gen.standard_normal((n, p)) * 2)
    y = t(gen.standard_normal((m, p)) * 2)
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
            runs = -(-p // 4) if need_xy and p > 1 else 1
            assert ops.gram.launches_bwd == n0 + runs
            again = ops.gram_backward(G, 'expquad', x, yy, need_xy=need_xy,
                                      need_p=need_p, **kw)
            for a, b in zip(got, again):
                assert (a is None) == (b is None)
                assert a is None or torch.equal(a, b)
            assert (got[0] is None) != need_xy
            assert (got[2] is None) != need_p
            if need_xy:
                assert bool(((got[0] - ref[0]).abs() <= tx).all())
                assert bool(((got[1] - ref[1]).abs() <= ty).all())
            if need_p:
                assert bool(((got[2] - ref[2]).abs() <= tp).all()), \
                    (got[2], ref[2])


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('n,p', [(300, 1), (301, 1), (64, 1), (257, 3),
                                 (130, 6)])
def test_gram_sym_backward_cuda(cuda, gen, dtype, n, p):
    """Kernel E's fused backward against its plain version: ragged and
    unaligned n, p = 3 and p = 6; each subset of the outputs; two calls
    equal to the bit."""
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
        if need_x:
            assert bool(((got[0] - ref[0]).abs() <= tx).all())
        else:
            assert got[0] is None
        if need_p:
            assert bool(((got[1] - ref[1]).abs() <= tp).all()), \
                (got[1], ref[1])
        else:
            assert got[1] is None


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
    equal to the bit."""
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
            if need_xy:
                assert bool(((got[0] - ref[0]).abs() <= tx).all())
                assert bool(((got[1] - ref[1]).abs() <= ty).all())
            else:
                assert got[0] is None and got[1] is None
            if need_p:
                assert bool(((got[2] - ref[2]).abs() <= tp).all()), \
                    (got[2], ref[2])
            else:
                assert got[2] is None


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('n,p', [(300, 1), (301, 1), (64, 1), (257, 3),
                                 (130, 6)])
def test_gram_sym_backward_jvp_cuda(cuda, gen, dtype, n, p):
    """Kernel E″ against its plain version: ragged and unaligned n,
    p = 3 and p = 6; each subset of the outputs; two calls equal to the
    bit."""
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
        if need_x:
            assert bool(((got[0] - ref[0]).abs() <= tx).all())
        else:
            assert got[0] is None
        if need_p:
            assert bool(((got[1] - ref[1]).abs() <= tp).all()), \
                (got[1], ref[1])
        else:
            assert got[1] is None


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
