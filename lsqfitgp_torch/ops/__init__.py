"""Hand-written CUDA kernels with their plain PyTorch versions."""

from ._gram import gram, gram_plain, PROFILES
from ._syrk import (schur_update, syrk_t_full, schur_update_plain,
                    syrk_t_full_plain)
from ._build import build_info
