// gram_special.cu's kernels in float64: ZooSpecial's kernels C and E and
// their backwards, entry points lsq_gram*_zs_f64, and the table
// builders' lsq_matern_table_f64 and lsq_sfb_table_f64, in an nvcc
// process of their own (the two dtypes' special cores built apart halve
// the longest build; the tangent kernels in gram_special_f64_tangents.cu).

#define LSQ_GRAM_SPECIAL 64
#include "gram.cu"
