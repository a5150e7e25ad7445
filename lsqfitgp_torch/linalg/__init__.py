"""PSD decompositions, the blocked Cholesky and the streaming solver."""

from ._decomp import (Decomposition, Chol, chol_nll, second_order,
                      diag_scale_pow2, eigval_bound, chol_nll_stream,
                      chol_nll_stream_grad, chol_pred_stream,
                      solve_batched_triangular, solve_batched)
from . import _blocked
