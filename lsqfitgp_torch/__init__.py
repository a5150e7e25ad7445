"""lsqfitgp_torch: Gaussian-process inference in PyTorch, with CUDA
kernels for the NVIDIA H100.

The PyTorch port of ``lsqfitgp_tpu`` (the JAX package stays in the
repository as the reference), module for module under the same names.
This version carries the hyperparameter-fit path: ``GP(amp *
ExpQuad(scale=...))`` with points, explicit noise covariance and linear
transformations, the regularized blocked Cholesky with the fused
marginal likelihood and its hand-derived gradient, ``empbayes_fit``
with scipy BFGS, and ``predfromdata``; the streaming solver
(``GP(solver='chol-stream')``), which never forms the Gram matrix; and
``GP(halfmatrix=True)``.  Five kernels are hand-written CUDA for
``sm_90a`` (``ops``): the Schur update of the factorization, the same
with the Gram computed in the tile, the gradient's WᵀW, and the tiled
Gram in full and on the upper triangle.  On CPU tensors each runs its
plain PyTorch version.

Array-likes go to the CUDA card unless the caller asks for another
device (`set_default_device`, `using_device`).

The package imports ``torch`` and never ``jax``.
"""

__version__ = '0.1.0'

from ._config import (default_float, default_device, set_default_device,
                      using_device, disable_checks, set_checks)
from ._deriv import Deriv

from . import linalg
from . import ops
from . import uncert

from .kernelalg import (
    CrossKernel, Kernel,
    CrossStationaryKernel, StationaryKernel,
    CrossIsotropicKernel, IsotropicKernel, CrossConstant, Zero,
    crosskernel, kernel,
    crossstationarykernel, stationarykernel,
    crossisotropickernel, isotropickernel,
)
from .kernels import *  # noqa: F401,F403
from .kernels import __all__ as _zoo_all

from .gp import GP, DefaultProcess
from .fit import empbayes_fit
from .uncert import BufferDict, add_distribution

__all__ = [
    'Deriv', 'GP', 'DefaultProcess', 'empbayes_fit', 'BufferDict',
    'CrossKernel', 'Kernel', 'StationaryKernel', 'IsotropicKernel',
    'kernel', 'crosskernel', 'stationarykernel', 'isotropickernel',
    'crossstationarykernel', 'crossisotropickernel',
    *_zoo_all,
]
