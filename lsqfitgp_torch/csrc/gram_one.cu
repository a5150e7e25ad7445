// Kernel C and its fused backward on the ZooOne evaluator (profiles.cuh:
// one term of a closed-form profile, the profile a template parameter)
// and on the ZooSum evaluator (a sum of 2 to MAXTERMS closed-form terms,
// a group of entries at a time), in float32: gram.cu compiled again with
// LSQ_GRAM_ONE, its entry points lsq_gram_zo_f32 and lsq_gram_bwd_zo_f32
// (evaluator 3: one instantiation of each kernel per closed-form profile;
// evaluator 4: ZooSum's), in an nvcc process of its own (gram_one_f64.cu:
// the same in float64, in another).

#define LSQ_GRAM_ONE 32
#include "gram.cu"
