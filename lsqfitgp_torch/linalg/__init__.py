"""PSD decompositions and the blocked Cholesky."""

from ._decomp import (Decomposition, Chol, chol_nll, diag_scale_pow2,
                      eigval_bound)
from . import _blocked
