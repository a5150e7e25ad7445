// Kernels C and E and their derivative kernels on the ZooSpecial
// evaluator (profiles.cuh: term lists with the special-function cores):
// gram.cu compiled again, its entry points lsq_gram*_zs_f32/_zs_f64, so
// that nvcc builds them in a process of its own and the closed-form
// evaluators' kernels do not take the special cores' registers.

#define LSQ_GRAM_SPECIAL 1
#include "gram.cu"
