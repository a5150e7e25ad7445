// gram_one.cu's kernels in float64: ZooOne's and ZooSum's kernel C and
// its backward, entry points lsq_gram_zo_f64 and lsq_gram_bwd_zo_f64, in
// an nvcc process of their own.

#define LSQ_GRAM_ONE 64
#include "gram.cu"
