"""Kernel algebra: class lattice, transformation registry, decorators.

Import order matters: ops/alg register transformations on CrossKernel
before the subclasses inherit them.
"""

from . import _core
from . import _ops    # registers linops  (needs _core)
from . import _alg    # registers algops  (needs _core)
from . import _stationary
from . import _isotropic
from . import _decorators

from ._core import (CrossKernel, Kernel, AffineSpan, PreservedBySwap,
                    least_common_superclass)
from ._stationary import CrossStationaryKernel, StationaryKernel
from ._isotropic import (
    CrossIsotropicKernel, IsotropicKernel, CrossConstant, Constant, Zero,
)
from ._decorators import (
    crosskernel, kernel,
    crossstationarykernel, stationarykernel,
    crossisotropickernel, isotropickernel,
)
