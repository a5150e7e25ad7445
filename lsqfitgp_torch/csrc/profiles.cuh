// The isotropic profiles the port's kernels evaluate in device code, and
// the post-chain epilogue they share (kernels C, D and E).
//
// A TPU kernel traces any profile callable; a CUDA kernel cannot, so a
// profile is an integer id into this registry (PROFILE_*), matching
// ops/_gram.py PROFILES, with its value g(r^2) and its r^2-derivative.
//
// The post chain is the kernel spec's ordered list of scalar 'mul' and
// 'add' steps (amp * k, k + c), read from a parameter vector in device
// memory: params[0..npost) are the chain's scalars, bit k of `postadd`
// says step k adds.  params[npost] is the diagonal term of the caller
// (kernel C's nugget, kernel D's eps).

#pragma once

#include <cuda_runtime.h>

namespace lsq {

constexpr int MAXPOST = 16;

enum { PROFILE_EXPQUAD = 0 };
enum { MODE_VALUE = 0, MODE_DERIV = 1, MODE_BARE = 2 };

__device__ __forceinline__ float dexp(float v) { return expf(v); }
__device__ __forceinline__ double dexp(double v) { return exp(v); }

template <typename T>
__device__ __forceinline__ T profile_value(int id, T r2)
{
    switch (id) {
    case PROFILE_EXPQUAD: return dexp(T(-0.5) * r2);
    }
    return T(0);
}

template <typename T>
__device__ __forceinline__ T profile_deriv(int id, T r2)
{
    switch (id) {
    case PROFILE_EXPQUAD: return T(-0.5) * dexp(T(-0.5) * r2);
    }
    return T(0);
}

// Squared distance of points x and y (p coordinates each), summed
// directly: at p = 1 the exact squared difference, at p > 1 a sum of
// p such terms (relative error ~p u whatever the coordinates' offset,
// so no centering is needed).
template <typename T>
__device__ __forceinline__ T sqdist(const T* __restrict__ x,
                                    const T* __restrict__ y, int p)
{
    T r2 = T(0);
    for (int d = 0; d < p; ++d) {
        const T dl = x[d] - y[d];
        r2 = fma(dl, dl, r2);
    }
    return r2;
}

// One entry in `mode` without the diagonal term: the post chain applied
// to g (VALUE); its r^2-derivative with the 'mul' steps, zeroed at
// r^2 <= 0 where the true tangent vanishes (DERIV); or bare g (BARE).
template <typename T>
__device__ __forceinline__ T entry(int profile, int mode, T r2, const T* pv,
                                   int npost, unsigned postadd)
{
    T v;
    if (mode == MODE_DERIV) {
        v = profile_deriv(profile, r2);
        for (int k = 0; k < npost; ++k)
            if (!((postadd >> k) & 1u)) v *= pv[k];
        if (r2 <= T(0)) v = T(0);
    } else {
        v = profile_value(profile, r2);
        if (mode == MODE_VALUE)
            for (int k = 0; k < npost; ++k)
                v = ((postadd >> k) & 1u) ? v + pv[k] : v * pv[k];
    }
    return v;
}

}  // namespace lsq
