// gram_special.cu's tangent kernels C', E', C'' and E'' on ZooSpecial in
// float32, entry points lsq_gram*jvp_zs_f32, in an nvcc process of their
// own: with them gram_special_f64.cu took 443 of a smoke's 1250 s to
// build on one machine (H100 80GB HBM3 host, 700.00 W), the longest
// process of the parallel build.

#define LSQ_GRAM_SPECIAL 32
#define LSQ_GRAM_TANGENTS 1
#include "gram.cu"
