"""lsqfitgp_torch's CUDA kernels against their plain PyTorch versions.

This file imports no JAX, so it also runs where the card is (``python
-m pytest --noconftest -o addopts='' tests/test_torch_kernels.py``).
The tests marked ``gpu`` need a CUDA device and skip without one; the
others check, on the CPU, that the wrappers take their plain versions
for CPU tensors only and that the package imports no JAX.

Tolerances on the card: the kernels sum the same products in another
order, so a length-k dot product may differ by ~sqrt(k) u Σ|terms|
(u the unit roundoff); with k <= 512 and unit-scale inputs, rtol/atol
of 1e-4 (float32) and 1e-12 (float64) hold with a wide margin.
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
    before = [ops.schur_update.launches, ops.syrk_t_full.launches,
              ops.gram.launches]
    S = ops.schur_update(None, A, eps=0.5, tile=128)
    torch.testing.assert_close(
        S, _syrk.schur_update_plain(None, A, eps=0.5, size=256, tile=128))
    torch.testing.assert_close(ops.syrk_t_full(W),
                               _syrk.syrk_t_full_plain(W))
    torch.testing.assert_close(ops.gram('expquad', x),
                               ops.gram_plain('expquad', x))
    assert [ops.schur_update.launches, ops.syrk_t_full.launches,
            ops.gram.launches] == before


def test_unsupported_device_raises():
    A = torch.zeros((128, 128), device='meta')
    with pytest.raises(ValueError, match='unsupported device'):
        ops.schur_update(None, A, tile=128)
    with pytest.raises(ValueError, match='multiples of tile'):
        ops.schur_update(None, torch.zeros(100, 8), tile=128)


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('offset,nreal', [(0, None), (256, 700)])
def test_schur_update_cuda(cuda, gen, dtype, offset, nreal):
    size, h, tile = 512, 384, 256
    mb = offset + size
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=cuda)
    A = t(gen.standard_normal((size, h)))
    B = t(gen.standard_normal((mb, mb)))
    s = t(gen.uniform(0.5, 2, mb))
    kw = dict(s=s, eps=0.5, size=size, offset=offset, tile=tile,
              nreal=nreal)
    n0 = ops.schur_update.launches
    got = ops.schur_update(B, A, **kw)
    assert ops.schur_update.launches == n0 + 1
    ref = _syrk.schur_update_plain(B, A, **kw)
    keep = _syrk._tile_mask(size, tile, cuda)
    torch.testing.assert_close(got[keep], ref[keep], **TOL[dtype])


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', [torch.float32, torch.float64])
@pytest.mark.parametrize('m', [512, 300])
def test_syrk_t_full_cuda(cuda, gen, dtype, m):
    W = torch.as_tensor(np.tril(gen.standard_normal((m, m))) / m ** 0.5,
                        dtype=dtype, device=cuda)
    got = ops.syrk_t_full(W)
    assert torch.equal(got, got.T)
    torch.testing.assert_close(got, _syrk.syrk_t_full_plain(W),
                               **TOL[dtype])


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
        np.testing.assert_allclose(out[1][0], out[0][0], rtol=1e-10)
        torch.testing.assert_close(out[1][1], out[0][1], rtol=1e-8,
                                   atol=1e-8)
    finally:
        torch.set_default_dtype(old)
