// gram_special_tangents.cu in float64: ZooSpecial's tangent kernels C',
// E', C'' and E'', entry points lsq_gram*jvp_zs_f64, in an nvcc process
// of their own beside gram_special_f64.cu's kernels C and E.

#define LSQ_GRAM_SPECIAL 64
#define LSQ_GRAM_TANGENTS 1
#include "gram.cu"
