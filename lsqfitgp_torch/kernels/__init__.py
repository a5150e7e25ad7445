"""The kernel zoo (Constant, White, ExpQuad in this version)."""

from ._basic import *  # noqa: F401,F403
from ._basic import __all__
