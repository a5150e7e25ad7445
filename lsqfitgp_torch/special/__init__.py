"""Special functions in PyTorch for the Matérn, Bessel and spectral
kernels.

Counterpart of the Bessel and exponential-integral parts of
``lsqfitgp_tpu/special`` (``_bessel.py``, ``_kv.py``, ``_expint.py``):
the same series, asymptotic, quadrature and continued-fraction
branches, with the JAX custom JVP rules written as
`torch.autograd.Function`s (the Matérn recurrence, so derivatives at
zero distance are exact to every order; Si′ and Ci′).  The rest of the
JAX package's ``special`` waits for the kernels that use it.
"""

from ._bessel import j0, kv_half, kvmodx2_hi
from ._kv import iv, kv, kvmodx2, jv, jvmodx2
from ._expint import si, ci, expn_imag_real

__all__ = ['j0', 'kv_half', 'kvmodx2_hi', 'iv', 'kv', 'kvmodx2', 'jv',
           'jvmodx2', 'si', 'ci', 'expn_imag_real']
