"""Hand-written CUDA kernels with their plain PyTorch versions."""

from ._gram import gram, gram_plain, gram_sym, gram_sym_plain, PROFILES
from ._syrk import (schur_update, schur_update_gram, syrk_t_full,
                    syrk_t_full_, schur_update_plain, schur_update_gram_plain,
                    syrk_t_full_plain)
from ._build import build_info
