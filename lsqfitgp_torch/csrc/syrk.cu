// Lower-trapezoid symmetric updates for the blocked Cholesky (sm_90a).
//
// Kernel A, schur_update: the lower tiles of
//     S = diag(s) B diag(s) + eps I - A A^T
// with B read as the (size, size) view at (offset, offset) of a larger
// row-major matrix, never copied.  It replaces the TPU kernel
// lsqfitgp_tpu/ops/_syrk.py::_schur_kernel.
//
// Kernel B, syrk_t_full: the full symmetric W^T W of a lower-triangular
// W, computed on the lower output tiles only, skipping the rows of W
// that are zero above its diagonal, and mirrored into the upper tiles by
// the kernel itself.  It replaces lsqfitgp_tpu/ops/_syrk.py::_syrk_t_kernel.
//
// Bound on the H100: both are matrix products with a deep k-loop, so the
// fp32 (or fp64) FMA rate bounds them, not memory.  The design is the
// classic register-blocked shared-memory product: a 128 x 128 output
// tile per block of 256 threads, each thread owning an 8 x 8 micro-tile
// strided by 16 (so shared-memory reads and global writes of a warp are
// contiguous), the k-loop inside the block in slabs of 8.  Accumulation
// is IEEE fp32 (or fp64) FMA: no tensor cores, no TF32.  Blocks that
// would compute a tile above the diagonal exit at once; the grid is the
// full square of tiles and every block computes its own (i, j) from
// blockIdx.  No library routine is called and nothing is allocated.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;             // output tile edge
constexpr int BK = 8;               // k-slab depth
constexpr int TM = 8;               // micro-tile edge per thread
constexpr int NTHREADS = 256;       // 16 x 16 threads
constexpr int PAD = 4;              // shared-memory row padding

// One slab step: acc[a][b] -= sum_kk As[kk][ty + 16a] * Bs[kk][tx + 16b]
template <typename T>
__device__ __forceinline__ void slab_update(
    T (&acc)[TM][TM], const T (*As)[BM + PAD], const T (*Bs)[BM + PAD],
    int tx, int ty, T sign)
{
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
        T a[TM], b[TM];
#pragma unroll
        for (int q = 0; q < TM; ++q) {
            a[q] = sign * As[kk][ty + 16 * q];
            b[q] = Bs[kk][tx + 16 * q];
        }
#pragma unroll
        for (int p = 0; p < TM; ++p)
#pragma unroll
            for (int q = 0; q < TM; ++q)
                acc[p][q] = fma(a[p], b[q], acc[p][q]);
    }
}

// Kernel A.  A is (size, h) row-major; B is row-major with leading
// dimension ldb and holds the view at (offset, offset); s has the
// global length of B's rows.  B, s and eps may be null.  Tiles are
// computed when their row is at or below their column at the
// granularity `tile` (a multiple of BM), so every i >= j tile of that
// granularity is written in full and no strict-upper one is touched.
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
schur_kernel(const T* __restrict__ B, long long ldb, long long offset,
             const T* __restrict__ s, const T* __restrict__ eps,
             long long nreal, const T* __restrict__ A, long long h,
             T* __restrict__ out, long long size, long long tile)
{
    const long long r0 = (long long)blockIdx.y * BM;
    const long long c0 = (long long)blockIdx.x * BM;
    if (r0 / tile < c0 / tile) return;

    __shared__ T As[BK][BM + PAD];
    __shared__ T Bs[BK][BM + PAD];
    const int t = threadIdx.x;
    const int tx = t % 16, ty = t / 16;

    // tile initialization: scale and eps fused into the accumulator
    T acc[TM][TM];
    const T e = eps ? eps[0] : T(0);
#pragma unroll
    for (int p = 0; p < TM; ++p) {
        const long long r = r0 + ty + 16 * p;
#pragma unroll
        for (int q = 0; q < TM; ++q) {
            const long long c = c0 + tx + 16 * q;
            T v = T(0);
            if (B) {
                v = B[(offset + r) * ldb + offset + c];
                if (s) v = v * s[offset + r] * s[offset + c];
            }
            if (eps && r == c && offset + r < nreal) v += e;
            acc[p][q] = v;
        }
    }

    for (long long k0 = 0; k0 < h; k0 += BK) {
#pragma unroll
        for (int l = 0; l < BM * BK / NTHREADS; ++l) {
            const int idx = t + NTHREADS * l;
            const int m = idx / BK, kk = idx % BK;
            const long long k = k0 + kk;
            As[kk][m] = k < h ? A[(r0 + m) * h + k] : T(0);
            Bs[kk][m] = k < h ? A[(c0 + m) * h + k] : T(0);
        }
        __syncthreads();
        slab_update(acc, As, Bs, tx, ty, T(-1));
        __syncthreads();
    }

#pragma unroll
    for (int p = 0; p < TM; ++p) {
        const long long r = r0 + ty + 16 * p;
#pragma unroll
        for (int q = 0; q < TM; ++q)
            out[r * size + c0 + tx + 16 * q] = acc[p][q];
    }
}

// Kernel B.  W is (h, m) row-major and lower triangular: W[k, c] = 0
// for k < c, so the tile whose rows start at r0 >= c0 needs only k >= r0.
template <typename T>
__global__ void __launch_bounds__(NTHREADS)
syrk_t_kernel(const T* __restrict__ W, long long h, long long m,
              T* __restrict__ out)
{
    const long long r0 = (long long)blockIdx.y * BM;
    const long long c0 = (long long)blockIdx.x * BM;
    if (r0 < c0) return;

    __shared__ T As[BK][BM + PAD];
    __shared__ T Bs[BK][BM + PAD];
    const int t = threadIdx.x;
    const int tx = t % 16, ty = t / 16;

    T acc[TM][TM];
#pragma unroll
    for (int p = 0; p < TM; ++p)
#pragma unroll
        for (int q = 0; q < TM; ++q)
            acc[p][q] = T(0);

    for (long long k0 = r0; k0 < h; k0 += BK) {
#pragma unroll
        for (int l = 0; l < BM * BK / NTHREADS; ++l) {
            const int idx = t + NTHREADS * l;
            const int kk = idx / BM, col = idx % BM;
            const long long k = k0 + kk;
            const bool kin = k < h;
            As[kk][col] = kin && r0 + col < m ? W[k * m + r0 + col] : T(0);
            Bs[kk][col] = kin && c0 + col < m ? W[k * m + c0 + col] : T(0);
        }
        __syncthreads();
        slab_update(acc, As, Bs, tx, ty, T(1));
        __syncthreads();
    }

#pragma unroll
    for (int p = 0; p < TM; ++p) {
        const long long r = r0 + ty + 16 * p;
        if (r >= m) continue;
#pragma unroll
        for (int q = 0; q < TM; ++q) {
            const long long c = c0 + tx + 16 * q;
            if (c >= m) continue;
            out[r * m + c] = acc[p][q];
            if (r0 != c0) out[c * m + r] = acc[p][q];   // the mirror
        }
    }
}

template <typename T>
int launch_schur(const T* B, long long ldb, long long offset, const T* s,
                 const T* eps, long long nreal, const T* A, long long h,
                 T* out, long long size, long long tile, void* stream)
{
    if (size == 0) return 0;
    const unsigned nt = (unsigned)(size / BM);
    dim3 grid(nt, nt);
    schur_kernel<T><<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(
        B, ldb, offset, s, eps, nreal, A, h, out, size, tile);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_syrk_t(const T* W, long long h, long long m, T* out, void* stream)
{
    if (m == 0) return 0;
    const unsigned nt = (unsigned)((m + BM - 1) / BM);
    dim3 grid(nt, nt);
    syrk_t_kernel<T><<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(
        W, h, m, out);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int lsq_schur_update_f32(const float* B, long long ldb, long long offset,
                         const float* s, const float* eps, long long nreal,
                         const float* A, long long h, float* out,
                         long long size, long long tile, void* stream)
{
    return launch_schur(B, ldb, offset, s, eps, nreal, A, h, out, size,
                        tile, stream);
}

int lsq_schur_update_f64(const double* B, long long ldb, long long offset,
                         const double* s, const double* eps,
                         long long nreal, const double* A, long long h,
                         double* out, long long size, long long tile,
                         void* stream)
{
    return launch_schur(B, ldb, offset, s, eps, nreal, A, h, out, size,
                        tile, stream);
}

int lsq_syrk_t_f32(const float* W, long long h, long long m, float* out,
                   void* stream)
{
    return launch_syrk_t(W, h, m, out, stream);
}

int lsq_syrk_t_f64(const double* W, long long h, long long m, double* out,
                   void* stream)
{
    return launch_syrk_t(W, h, m, out, stream);
}

}  // extern "C"
