// What the Schur updates' kernels share (kernels A and D): the tile
// initializers and the work list of lower tiles.  The SIMT kernel
// (syrk.cu, float32 at precision='highest') calls an initializer over
// its 8 x 8 micro-tile, the tensor-core kernels (schur_tc.cu, float32 at
// 'high' and 'default'; dmma.cu, float64) over their accumulator
// fragments' coordinates: all call the same function of one (r, c), so
// all start from the same values.

#pragma once

#include "profiles.cuh"

namespace lsq {

// Kernel A: entry (r, c) of the view of the scaled B plus eps.  B is
// row-major with leading dimension ldb and holds the view at (offset,
// offset), never sliced; s has the global length of B's rows.  B, s and
// eps may be null.  eps lands only on diagonal entries whose global
// index is < nreal.
template <typename T>
struct InitScaled {
    const T* B;
    long long ldb, offset;
    const T* s;
    const T* eps;
    long long nreal;

    __device__ __forceinline__ T operator()(long long r, long long c) const
    {
        T v = T(0);
        if (B) {
            v = B[(offset + r) * ldb + offset + c];
            if (s) v = v * s[offset + r] * s[offset + c];
        }
        if (eps && r == c && offset + r < nreal) v += eps[0];
        return v;
    }
};

// Kernel D: entry (r, c) of the virtual matrix blockdiag(K, I) plus eps
// on the real diagonal, K[i, j] = the profile sum of |X_i - X_j|^2
// (profiles.cuh, the ZooSpecial evaluator: any registered profile and
// term sum) computed from the points X (npad x dim, row-major, global rows)
// with the parameter vector params, eps at params[1], and the terms'
// tables tb (the real-order Matern's and StationaryFracBrownian's, read
// through the cache).  By
// GLOBAL index, entries with a row or column >= nreal are 0 off the
// diagonal and exactly 1 on it.
template <typename T>
struct InitGram {
    const T* X;
    int dim;
    const T* params;
    int nterms;
    unsigned long long codes;
    int with_eps;
    long long nreal, offset;
    MTabs tb;

    __device__ __forceinline__ T operator()(long long r, long long c) const
    {
        const long long gr = offset + r, gc = offset + c;
        if (gr >= nreal || gc >= nreal) return gr == gc ? T(1) : T(0);
        T v = ZooSpecial<T>(params, nterms, codes, tb).value(
            sqdist(X + gr * dim, X + gc * dim, dim));
        if (with_eps && gr == gc) v += params[1];
        return v;
    }
};

// The work list: the (bm, bm) tiles of a (size, size) output whose row
// is at or below their column at the caller's granularity `tile` (a
// multiple of bm), so every i >= j tile of that granularity is written
// in full and no strict-upper one is launched.  Tiles are numbered
// coarse tile by coarse tile (row-major over the lower triangle), and
// inside each coarse tile row-major.
inline long long lower_tiles(long long size, long long tile, int bm)
{
    const long long nt = size / tile, t = tile / bm;
    return nt * (nt + 1) / 2 * t * t;
}

__device__ __forceinline__ void lower_tile(long long b, long long tile,
                                           int bm, long long& r0,
                                           long long& c0)
{
    const long long t = tile / bm, q = b / (t * t), w = b % (t * t);
    long long ci = (long long)((sqrt(8.0 * (double)q + 1.0) - 1.0) * 0.5);
    while (ci * (ci + 1) / 2 > q) --ci;
    while ((ci + 1) * (ci + 2) / 2 <= q) ++ci;
    const long long cj = q - ci * (ci + 1) / 2;
    r0 = (ci * t + w / t) * bm;
    c0 = (cj * t + w % t) * bm;
}

}  // namespace lsq
