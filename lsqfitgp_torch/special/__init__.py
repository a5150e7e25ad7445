"""Special functions in PyTorch.

Counterpart of ``lsqfitgp_tpu/special``, module for module: the Bessel
functions and the Matérn and Bessel profiles (``_bessel.py``,
``_kv.py``), the exponential integrals (``_expint.py``), the Riemann,
Hurwitz and periodic zeta functions (``_zeta.py``), the inverse
incomplete gamma and beta functions (``_invinc.py``), ``expm1x``
(``_exp.py``) and the Taylor-series evaluator (``_taylor.py``): the
same series, asymptotic, quadrature and continued-fraction branches,
with the JAX custom JVP rules written as `torch.autograd.Function`s.
Where PyTorch ships a function (Hurwitz ζ), it is re-exported.
"""

from torch.special import zeta as hurwitz_zeta  # ζ(s, q)

from ._exp import expm1x
from ._bessel import j0, kv_half, kvmodx2_hi
from ._expint import ci, si, expn_imag_real
from ._invinc import gammaincinv, gammainccinv, betaincinv
from ._zeta import zeta_real, periodic_zeta, periodic_bernoulli
from ._kv import iv, kv, kvmodx2, jv, jvmodx2
from ._taylor import taylor

__all__ = ['hurwitz_zeta', 'expm1x', 'j0', 'kv_half', 'kvmodx2_hi', 'ci',
           'si', 'expn_imag_real', 'gammaincinv', 'gammainccinv',
           'betaincinv', 'zeta_real', 'periodic_zeta', 'periodic_bernoulli',
           'iv', 'kv', 'kvmodx2', 'jv', 'jvmodx2', 'taylor']
