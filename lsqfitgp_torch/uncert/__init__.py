"""Uncertainty propagation with dense Jacobians, and `BufferDict`."""

from ._uarray import (UArray, from_cov, normal, uconcatenate, next_block_id,
                      evalcov, corr, sample)
from ._bufferdict import (BufferDict, add_distribution, has_distribution,
                          bufferdict_from_numpy)
