// The isotropic profiles the port's kernels evaluate in device code, and
// the post-chain epilogue they share (kernels C, D and E).
//
// A TPU kernel traces any profile callable; a CUDA kernel cannot, so a
// profile is an integer id into this registry (PROFILE_*), matching
// ops/_gram.py PROFILES.  Each profile is a struct (Profile<id>) with
// its value g(r^2) and, from the same exponential, its first and second
// r^2-derivatives; kernels C and E and their tangent and backward
// kernels take it as a template parameter, kernel D dispatches on the
// id (`profile_value`).
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

__device__ __forceinline__ float dexp(float v) { return expf(v); }
__device__ __forceinline__ double dexp(double v) { return exp(v); }

template <int ID> struct Profile;

template <> struct Profile<PROFILE_EXPQUAD> {
    template <typename T>
    static __device__ __forceinline__ T value(T r2)
    {
        return dexp(T(-0.5) * r2);
    }
    // g and g'(r^2) from one exponential
    template <typename T>
    static __device__ __forceinline__ T both(T r2, T& deriv)
    {
        const T g = value(r2);
        deriv = T(-0.5) * g;
        return g;
    }
    // g, g' and g''(r^2) from one exponential
    template <typename T>
    static __device__ __forceinline__ T second(T r2, T& d1, T& d2)
    {
        const T g = value(r2);
        d1 = T(-0.5) * g;
        d2 = T(0.25) * g;
        return g;
    }
};

// r^2 = |x - y|^2 and its tangent dr^2 = 2 (x - y).(dx - dy), summed
// as `sqdist` sums r^2: symmetric in the two points to the bit.
template <typename T>
__device__ __forceinline__ T sqdist_tangent(const T* __restrict__ x,
                                            const T* __restrict__ y,
                                            const T* __restrict__ dx,
                                            const T* __restrict__ dy, int p,
                                            T& dr2)
{
    T r2 = T(0), t = T(0);
    for (int d = 0; d < p; ++d) {
        const T dl = x[d] - y[d];
        r2 = fma(dl, dl, r2);
        t = fma(dl, dx[d] - dy[d], t);
    }
    dr2 = T(2) * t;
    return r2;
}

template <typename T>
__device__ __forceinline__ T profile_value(int id, T r2)
{
    switch (id) {
    case PROFILE_EXPQUAD: return Profile<PROFILE_EXPQUAD>::value(r2);
    }
    return T(0);
}

// Squared distance of points x and y (p coordinates each), summed
// directly: at p = 1 the exact squared difference, at p > 1 a sum of
// p such terms (relative error ~p u whatever the coordinates' offset,
// so no centering is needed).  Symmetric in x and y to the bit.
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

// One entry without the diagonal term: the post chain applied to g step
// by step (kernel D's tile initializer).
template <typename T>
__device__ __forceinline__ T entry(int profile, T r2, const T* pv,
                                   int npost, unsigned postadd)
{
    T v = profile_value(profile, r2);
    for (int k = 0; k < npost; ++k)
        v = ((postadd >> k) & 1u) ? v + pv[k] : v * pv[k];
    return v;
}

// The post chain is affine in g: folded once per thread into
// post(g) = alpha g + beta, where alpha, the product of the 'mul'
// steps, is also the factor of the chain's derivative in g.
template <typename T>
struct Chain {
    T alpha, beta;
};

template <typename T>
__device__ __forceinline__ Chain<T> fold_chain(const T* __restrict__ pv,
                                               int npost, unsigned postadd)
{
    Chain<T> c{T(1), T(0)};
    for (int k = 0; k < npost; ++k) {
        const T v = pv[k];
        if ((postadd >> k) & 1u) {
            c.beta += v;
        } else {
            c.alpha *= v;
            c.beta *= v;
        }
    }
    return c;
}

}  // namespace lsq
