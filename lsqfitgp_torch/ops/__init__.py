"""Hand-written CUDA kernels with their plain PyTorch versions."""

from ._gram import (gram, gram_plain, gram_sym, gram_sym_plain,
                    gram_backward, gram_backward_plain, gram_sym_backward,
                    gram_sym_backward_plain, gram_jvp, gram_jvp_plain,
                    gram_sym_jvp, gram_sym_jvp_plain, gram_backward_jvp,
                    gram_backward_jvp_plain, gram_sym_backward_jvp,
                    gram_sym_backward_jvp_plain, PROFILES, Profile,
                    Term, Terms, MAXTERMS, MATERNP_MAX, k0, map_scalars,
                    sfb_table, sfb_coeffs_plain, sfb_parts_plain, sfb_terms)
from ._syrk import (schur_update, schur_update_gram, syrk_t_full,
                    syrk_t_full_, schur_update_plain, schur_update_gram_plain,
                    syrk_t_full_plain)
from ._mtable import (matern_table, matern_table_plain,
                      matern_table_eval_plain)
from ._build import build_info
