"""Special functions in PyTorch for the Matérn and Bessel kernels.

Counterpart of the Bessel parts of ``lsqfitgp_tpu/special``
(``_bessel.py``, ``_kv.py``): the same series, asymptotic and quadrature
branches, with the JAX custom JVP rules written as
`torch.autograd.Function`s whose backward is the exact recurrence, so
derivatives at zero distance are exact to every order.  The rest of the
JAX package's ``special`` waits for the kernels that use it.
"""

from ._bessel import j0, kv_half, kvmodx2_hi
from ._kv import iv, kv, kvmodx2, jv, jvmodx2

__all__ = ['j0', 'kv_half', 'kvmodx2_hi', 'iv', 'kv', 'kvmodx2', 'jv',
           'jvmodx2']
