"""The kernel zoo: ``_basic.py``, the Matérn family, the random walks,
the Wendland kernels, the celerite family, the spectral kernels, the
Zeta family and the AR/MA kernels."""

from ._basic import *  # noqa: F401,F403
from ._matern import *  # noqa: F401,F403
from ._randomwalk import *  # noqa: F401,F403
from ._wendland import *  # noqa: F401,F403
from ._celerite import *  # noqa: F401,F403
from ._spectral import *  # noqa: F401,F403
from ._zeta import *  # noqa: F401,F403
from ._arma import *  # noqa: F401,F403
from . import (_basic, _matern, _randomwalk, _wendland, _celerite,
               _spectral, _zeta, _arma)

__all__ = (_basic.__all__ + _matern.__all__ + _randomwalk.__all__
           + _wendland.__all__ + _celerite.__all__ + _spectral.__all__
           + _zeta.__all__ + _arma.__all__)
