// Tiled Gram evaluators for isotropic kernels (sm_90a).
//
// Kernel C, gram: K[i, j] = post(g(|x_i - y_j|^2)) (+ noise if i == j),
// replacing the TPU kernel lsqfitgp_tpu/ops/_gram.py::_gram_kernel.
//
// Kernel E, gram_sym: the same for y = x, evaluated on the upper-triangle
// tile pairs only, each block writing its tile and the mirrored tile,
// replacing lsqfitgp_tpu/ops/_gram.py::_gram_sym_kernel.
//
// - r^2 is the sum over the p coordinates of the squared differences,
//   accumulated directly (at p = 1 it is the exact squared difference).
//   The TPU kernels used the norm expansion |x|^2 + |y|^2 - 2 x.y at
//   p > 1 only to put the cross term on the matrix unit; the direct sum
//   is at least as accurate.
// - The profile g, the post chain and the modes come from profiles.cuh:
//   `mode` picks the value, its r^2-derivative g'(r^2) (zeroed at
//   r^2 <= 0) with the chain's 'mul' steps, or the bare core g.  The
//   nugget params[npost] is added on the diagonal in the value mode.
// - The ragged edge is masked; no padding of the points.
//
// Bound on the H100: the output is n*m values written once and nothing
// is reused across tiles, so both kernels are bound by the write stream
// (plus one exp per entry).  C covers a 64 x 64 tile per block of
// 64 x 4 threads; a warp writes 32 consecutive columns of one row, so
// every store is coalesced, and a thread's row coordinates are the same
// for the whole warp (broadcast loads).  E halves the exps and keeps
// the writes: it computes a tile once, stores it row-wise, and writes
// its mirror from a shared-memory copy read column-wise (padded by one
// column against bank conflicts), so the mirror's stores are coalesced
// too and no second pass over the matrix follows.  Nothing is allocated.

#include "profiles.cuh"

namespace {

using namespace lsq;

constexpr int TILE = 64;
constexpr int TY = 4;

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
        const T r2 = sqdist(x + r * p, y + c * p, p);
        T v = entry(profile, mode, r2, pv, npost, postadd);
        if (mode == MODE_VALUE && with_noise && r == c) v += pv[npost];
        out[r * m + c] = v;
    }
}

template <typename T>
__global__ void __launch_bounds__(TILE * TY)
gram_sym_kernel(const T* __restrict__ x, long long n, int p,
                const T* __restrict__ params, int npost, unsigned postadd,
                int with_noise, int profile, int mode, T* __restrict__ out)
{
    const long long i0 = (long long)blockIdx.y * TILE;   // row tile
    const long long j0 = (long long)blockIdx.x * TILE;   // column tile
    if (i0 > j0) return;                                 // lower: mirrored

    __shared__ T sh[TILE][TILE + 1];
    T pv[MAXPOST + 1];
    for (int k = 0; k <= npost; ++k) pv[k] = params[k];

    const int tx = threadIdx.x;
    const long long c = j0 + tx;
    for (int rr = threadIdx.y; rr < TILE; rr += TY) {
        const long long r = i0 + rr;
        if (r < n && c < n) {
            const T r2 = sqdist(x + r * p, x + c * p, p);
            T v = entry(profile, mode, r2, pv, npost, postadd);
            if (mode == MODE_VALUE && with_noise && r == c) v += pv[npost];
            out[r * n + c] = v;
            sh[rr][tx] = v;
        }
    }
    if (i0 == j0) return;
    __syncthreads();
    // the mirror: rows j0.., columns i0.. take the tile transposed
    const long long cm = i0 + tx;
    for (int rr = threadIdx.y; rr < TILE; rr += TY) {
        const long long rm = j0 + rr;
        if (rm < n && cm < n) out[rm * n + cm] = sh[tx][rr];
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

template <typename T>
int launch_gram_sym(const T* x, long long n, int p, const T* params,
                    int npost, unsigned postadd, int with_noise, int profile,
                    int mode, T* out, void* stream)
{
    if (npost > MAXPOST) return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    const unsigned nt = (unsigned)((n + TILE - 1) / TILE);
    dim3 block(TILE, TY);
    dim3 grid(nt, nt);
    gram_sym_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
        x, n, p, params, npost, postadd, with_noise, profile, mode, out);
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

int lsq_gram_sym_f32(const float* x, long long n, int p, const float* params,
                     int npost, unsigned postadd, int with_noise, int profile,
                     int mode, float* out, void* stream)
{
    return launch_gram_sym(x, n, p, params, npost, postadd, with_noise,
                           profile, mode, out, stream);
}

int lsq_gram_sym_f64(const double* x, long long n, int p,
                     const double* params, int npost, unsigned postadd,
                     int with_noise, int profile, int mode, double* out,
                     void* stream)
{
    return launch_gram_sym(x, n, p, params, npost, postadd, with_noise,
                           profile, mode, out, stream);
}

}  // extern "C"
