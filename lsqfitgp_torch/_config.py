"""Global configuration for lsqfitgp_torch.

Counterpart of ``lsqfitgp_tpu/_config.py``.  The working float dtype is
PyTorch's default dtype (float32 unless the caller sets float64 with
``torch.set_default_dtype``), playing the part of JAX's x64 switch:
array-likes entering the package become tensors of that dtype, while
tensors keep their own dtype and device.

Array-likes are placed on the CUDA card unless the caller asks for
another device with `set_default_device` or `using_device` (the tests
ask for the CPU).  Without a card and without such a request the first
placement raises: the package never computes on the CPU unasked.

Matrix products in float32 on CUDA are set to IEEE fp32 here
(``torch.backends.cuda.matmul.allow_tf32 = False``, and the same for
cuDNN): the blocked Cholesky's panel products and the plain reference
versions of the kernels must not drop to TF32's ~3 decimal digits.  The
TF32 of kernels A and D at precision 'high' (3xTF32, about fp32's
accuracy) and 'default' (one TF32 pass) is those kernels' own explicit
choice, made by the ``precision`` keyword (``ops._syrk``), not this
switch.
"""

from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ['default_float', 'default_device', 'set_default_device',
           'using_device', 'checks_enabled', 'disable_checks', 'set_checks']

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def default_float():
    """The working float dtype: ``torch.get_default_dtype()``."""
    return torch.get_default_dtype()


# the device asked for with set_default_device / using_device, or None
_device = None


def default_device():
    """Where array-likes that are not tensors are placed: the device the
    caller asked for, else the CUDA card.  Raises when there is neither
    a request nor a card."""
    if _device is not None:
        return _device
    if not torch.cuda.is_available():
        raise RuntimeError(
            'lsqfitgp_torch runs on the CUDA card, and torch sees none; '
            "to compute on the CPU, ask for it with "
            "lsqfitgp_torch.set_default_device('cpu') (or the "
            "lsqfitgp_torch.using_device('cpu') context manager)")
    return torch.device('cuda')


def set_default_device(device):
    """Place array-likes on ``device`` from now on (None: back to the
    CUDA card).  Tensors keep their own device."""
    global _device
    _device = None if device is None else torch.device(device)


@contextlib.contextmanager
def using_device(device):
    """`set_default_device` for the duration of a ``with`` block."""
    old = _device
    set_default_device(device)
    try:
        yield
    finally:
        set_default_device(old)


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
