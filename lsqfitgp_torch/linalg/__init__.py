"""PSD decompositions, the blocked Cholesky, the streaming solver and
the structured solvers (Toeplitz, row-sequential)."""

from ._decomp import (Decomposition, Chol, chol_nll, second_order,
                      diag_scale_pow2, eigval_bound, chol_nll_stream,
                      chol_nll_stream_grad, chol_pred_stream,
                      solve_batched_triangular, solve_batched)
from . import _blocked
from . import _toeplitz as toeplitz
from . import _seqalg as seqalg
