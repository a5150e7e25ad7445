// Tiled Gram evaluator for isotropic kernels (sm_90a).
//
// K[i, j] = post(g(|x_i - y_j|^2)) (+ noise if i == j), replacing the
// TPU kernel lsqfitgp_tpu/ops/_gram.py::_gram_kernel.
//
// - r^2 is the sum over the p coordinates of the squared differences,
//   accumulated directly (at p = 1 it is the exact squared difference).
//   The TPU kernel used the norm expansion |x|^2 + |y|^2 - 2 x.y at
//   p > 1 only to put the cross term on its matrix unit; the direct sum
//   is at least as accurate.
// - The profile g comes from a registry in device code, selected by an
//   integer id (PROFILE_* below); `mode` picks the value, its
//   r^2-derivative g'(r^2) (zeroed at r^2 <= 0, where the true tangent
//   vanishes), or the bare core g without the post chain.
// - The post chain of scalar 'mul'/'add' steps and the nugget are read
//   from a parameter vector in device memory (no host round trip):
//   params[0..npost) are the chain's scalars, bit k of `postadd` says
//   step k adds, params[npost] is the nugget.  In derivative mode the
//   'add' steps drop out and the 'mul' steps scale.
// - The ragged edge is masked; no padding of the points.
//
// Bound on the H100: the output is n*m values written once and nothing
// is reused across tiles, so the kernel is bound by the write stream
// (plus one exp per entry).  Each block covers a 64 x 64 tile with
// 64 x 4 threads; a warp writes 32 consecutive columns of one row, so
// every store is coalesced, and a thread's row coordinates are the same
// for the whole warp (broadcast loads).  Nothing is allocated.

#include <cuda_runtime.h>

namespace {

constexpr int TILE = 64;
constexpr int TY = 4;
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

template <typename T>
__global__ void __launch_bounds__(TILE * TY)
gram_kernel(const T* __restrict__ x, const T* __restrict__ y, long long n,
            long long m, int p, const T* __restrict__ params, int npost,
            unsigned postadd, int with_noise, int profile, int mode,
            T* __restrict__ out)
{
    const long long c = (long long)blockIdx.x * TILE + threadIdx.x;
    if (c >= m) return;
    T pv[MAXPOST + 1];
    for (int k = 0; k <= npost; ++k) pv[k] = params[k];

    const long long rend = min((long long)(blockIdx.y + 1) * TILE, n);
    for (long long r = (long long)blockIdx.y * TILE + threadIdx.y; r < rend;
         r += TY) {
        T r2 = T(0);
        for (int d = 0; d < p; ++d) {
            const T dl = x[r * p + d] - y[c * p + d];
            r2 = fma(dl, dl, r2);
        }
        T v;
        if (mode == MODE_DERIV) {
            v = profile_deriv(profile, r2);
            for (int k = 0; k < npost; ++k)
                if (!((postadd >> k) & 1u)) v *= pv[k];
            if (r2 <= T(0)) v = T(0);
        } else {
            v = profile_value(profile, r2);
            if (mode == MODE_VALUE) {
                for (int k = 0; k < npost; ++k)
                    v = ((postadd >> k) & 1u) ? v + pv[k] : v * pv[k];
                if (with_noise && r == c) v += pv[npost];
            }
        }
        out[r * m + c] = v;
    }
}

template <typename T>
int launch_gram(const T* x, const T* y, long long n, long long m, int p,
                const T* params, int npost, unsigned postadd, int with_noise,
                int profile, int mode, T* out, void* stream)
{
    if (npost > MAXPOST) return (int)cudaErrorInvalidValue;
    if (n == 0 || m == 0) return 0;
    dim3 block(TILE, TY);
    dim3 grid((unsigned)((m + TILE - 1) / TILE),
              (unsigned)((n + TILE - 1) / TILE));
    gram_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
        x, y, n, m, p, params, npost, postadd, with_noise, profile, mode,
        out);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int lsq_gram_f32(const float* x, const float* y, long long n, long long m,
                 int p, const float* params, int npost, unsigned postadd,
                 int with_noise, int profile, int mode, float* out,
                 void* stream)
{
    return launch_gram(x, y, n, m, p, params, npost, postadd, with_noise,
                       profile, mode, out, stream);
}

int lsq_gram_f64(const double* x, const double* y, long long n, long long m,
                 int p, const double* params, int npost, unsigned postadd,
                 int with_noise, int profile, int mode, double* out,
                 void* stream)
{
    return launch_gram(x, y, n, m, p, params, npost, postadd, with_noise,
                       profile, mode, out, stream);
}

}  // extern "C"
