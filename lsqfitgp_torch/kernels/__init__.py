"""The kernel zoo: ``_basic.py``, the Matérn family and the Wendland
kernels."""

from ._basic import *  # noqa: F401,F403
from ._matern import *  # noqa: F401,F403
from ._wendland import *  # noqa: F401,F403
from . import _basic, _matern, _wendland

__all__ = _basic.__all__ + _matern.__all__ + _wendland.__all__
