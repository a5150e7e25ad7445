"""Global configuration for lsqfitgp_torch.

Counterpart of ``lsqfitgp_tpu/_config.py``.  The working float dtype is
PyTorch's default dtype (float32 unless the caller sets float64 with
``torch.set_default_dtype``), playing the part of JAX's x64 switch:
array-likes entering the package become tensors of that dtype, while
tensors keep their own dtype and device.

Matrix products in float32 on CUDA are set to IEEE fp32 here
(``torch.backends.cuda.matmul.allow_tf32 = False``, and the same for
cuDNN): the blocked Cholesky's panel products and the plain reference
versions of the kernels must not drop to TF32's ~3 decimal digits.
"""

from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ['default_float', 'default_device', 'checks_enabled',
           'disable_checks', 'set_checks']

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def default_float():
    """The working float dtype: ``torch.get_default_dtype()``."""
    return torch.get_default_dtype()


def default_device():
    """Where array-likes that are not tensors are placed."""
    return torch.get_default_device()


class _State(threading.local):
    def __init__(self):
        self.checks = True


_state = _State()


def checks_enabled():
    """Whether eager sanity checks (finite/symmetric/posdef/linear and
    the decomposition's degradation warnings) run.  `empbayes_fit`
    turns them off inside its objective, where the JAX package skips
    them because its values are traced."""
    return _state.checks


@contextlib.contextmanager
def disable_checks():
    old = _state.checks
    _state.checks = False
    try:
        yield
    finally:
        _state.checks = old


def set_checks(value):
    _state.checks = bool(value)
