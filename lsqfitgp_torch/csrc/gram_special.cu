// Kernels C and E and their backwards on the ZooSpecial evaluator
// (profiles.cuh: term lists with the special-function cores), in
// float32 (the tangent kernels in gram_special_tangents.cu): gram.cu
// compiled again, its entry points lsq_gram*_zs_f32,
// so that nvcc builds them in a process of its own and the closed-form
// evaluators' kernels do not take the special cores' registers
// (gram_special_f64.cu: the same in float64, in another process).
//
// And the builder of the real-order Matern's tables,
// matern_table_kernel (special.cuh), entry point lsq_matern_table_f32
// (_f64 in gram_special_f64.cu): one launch per order, kind and dtype,
// whose table the kernels then read (ops/_mtable.py keeps it).  It
// replaces no TPU kernel: the JAX package evaluates the 100-node
// quadrature at every entry (lsqfitgp_tpu/special/_kv.py
// _kv_quad_scaled), which the table takes the place of in kernels C, D
// and E.  Its work is the quadrature at (E_HI - E_LO) MTAB_SUB NC nodes,
// about a thousand, in float64: the launch, not its bytes or operations,
// bounds it.
//
// And StationaryFracBrownian's coefficient builder, sfb_table_kernel
// (profiles.cuh), entry point lsq_sfb_table_f32 (_f64 in
// gram_special_f64.cu): one launch per launch of a kernel on a term list
// with an 'sfb' term, before it (ops/_gram.py sfb_table).

#define LSQ_GRAM_SPECIAL 32
#include "gram.cu"
