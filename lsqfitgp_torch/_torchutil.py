"""PyTorch utility layer.

Counterpart of the parts of ``lsqfitgp_tpu/_jaxutil.py`` that the port
uses, plus the tensor conversion every entry point shares.

JAX's ``skipifabstract`` runs a sanity check only when the values are
concrete, so checks vanish under ``jit``.  PyTorch has no abstract
values; `check` runs a check unless checks are disabled, which
`empbayes_fit` does inside its objective.
"""

from __future__ import annotations

import numpy
import torch

from . import _config

__all__ = ['check', 'asarray']


def check(fn):
    """Run the sanity check ``fn()`` unless checks are disabled."""
    if _config.checks_enabled():
        fn()


def asarray(x, dtype=None, device=None):
    """A tensor from ``x``: tensors keep their dtype and device (unless
    given); numpy arrays and scalars become tensors of the default
    float dtype (integers and booleans keep their kind) on the default
    device, as ``jnp.asarray`` follows JAX's x64 switch."""
    if isinstance(x, torch.Tensor):
        if dtype is None and device is None:
            return x
        return x.to(dtype=dtype, device=device)
    a = numpy.asarray(x)
    if dtype is None and a.dtype.kind in 'fc':
        dtype = _config.default_float()
    if device is None:
        device = _config.default_device()
    return torch.tensor(a, dtype=dtype, device=device)

