// Lower-trapezoid symmetric updates for the blocked Cholesky (sm_90a),
// the SIMT kernels: IEEE FMA on the CUDA cores.
//
// Kernel A, schur_update: the lower tiles of
//     S = diag(s) B diag(s) + eps I - A A^T
// with B read as the (size, size) view at (offset, offset) of a larger
// row-major matrix, never copied.  It replaces the TPU kernel
// lsqfitgp_tpu/ops/_syrk.py::_schur_kernel.
//
// Kernel D, schur_update_gram: the lower tiles of
//     S = K[off:off+size, off:off+size] + eps I - A A^T
// where K[i, j] = post(g(|X_i - X_j|^2)) is computed in the tile from
// the points, so the Gram block never exists in device memory.  The
// virtual matrix is exactly blockdiag(K, I): by GLOBAL index, entries
// with a row or column >= nreal are 0 off the diagonal and 1 on it, and
// eps lands only on the real diagonal.  It replaces both TPU call sites
// lsqfitgp_tpu/ops/_syrk.py::_schur_gram_kernel and _schur_gram_kernel2
// (the second exists only because the TPU's 1 MB scalar memory cannot
// hold the flat work table at n = 65536; here each block finds its own
// tile from blockIdx, so one kernel serves both).  r^2 is the direct sum
// of squared differences (profiles.cuh), not the TPU kernels'
// per-tile-pair centered norm expansion: exact at p = 1, relative error
// ~p u at p > 1 whatever the coordinates' offset.
//
// A and D run here in float32 at precision='highest'; float32 at 'high'
// (3xTF32) and 'default' (1xTF32) runs the tensor-core kernel of
// schur_tc.cu, float64 the FP64 tensor-core kernel of dmma.cu, all from
// the same initializers (schur_init.cuh).
//
// Kernel B, syrk_t_full: the full symmetric W^T W of a lower-triangular
// W, computed on the lower output tiles only, skipping the rows of W
// that are zero above its diagonal, and mirrored into the upper tiles by
// the kernel itself.  It replaces lsqfitgp_tpu/ops/_syrk.py::_syrk_t_kernel
// in float32; float64 runs dmma.cu.
//
// Bound on the H100: all three are matrix products with a deep k-loop,
// so the fp32 FMA rate bounds them, not memory (D's tile
// initialization, one exp per entry, is negligible beside a k-loop of
// depth >= 512).  The design is the classic register-blocked
// shared-memory product: a 128 x 128 output tile per block of 256
// threads, each thread owning an 8 x 8 micro-tile strided by 16 (so
// shared-memory reads and global writes of a warp are contiguous), the
// k-loop inside the block in slabs of 8.  A and D are one kernel
// templated on the tile's initializer.  Accumulation is IEEE fp32 FMA:
// no tensor cores, no TF32.  A and D launch only the lower
// tiles, numbered by a 1-D work list (schur_init.cuh); B's grid is the
// full square, and its blocks above the diagonal exit at once.  No
// library routine is called and nothing is allocated.

#include "schur_init.cuh"

namespace {

using namespace lsq;

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

// Kernels A and D.  A is (size, h) row-major.  Block b computes the
// b-th tile of the lower work list at the granularity `tile` (a
// multiple of BM).
template <typename T, typename Init>
__global__ void __launch_bounds__(NTHREADS)
schur_kernel(Init init, const T* __restrict__ A, long long h,
             T* __restrict__ out, long long size, long long tile)
{
    long long r0, c0;
    lower_tile(blockIdx.x, tile, BM, r0, c0);

    __shared__ T As[BK][BM + PAD];
    __shared__ T Bs[BK][BM + PAD];
    const int t = threadIdx.x;
    const int tx = t % 16, ty = t / 16;

    T acc[TM][TM];
#pragma unroll
    for (int p = 0; p < TM; ++p)
#pragma unroll
        for (int q = 0; q < TM; ++q)
            acc[p][q] = init(r0 + ty + 16 * p, c0 + tx + 16 * q);

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

template <typename T, typename Init>
int launch_schur(Init init, const T* A, long long h, T* out, long long size,
                 long long tile, void* stream)
{
    if (size == 0) return 0;
    if (tile % BM) return (int)cudaErrorInvalidValue;
    const unsigned nb = (unsigned)lower_tiles(size, tile, BM);
    schur_kernel<T, Init><<<nb, NTHREADS, 0, (cudaStream_t)stream>>>(
        init, A, h, out, size, tile);
    return (int)cudaGetLastError();
}

template <typename T>
int launch_schur_scaled(const T* B, long long ldb, long long offset,
                        const T* s, const T* eps, long long nreal,
                        const T* A, long long h, T* out, long long size,
                        long long tile, void* stream)
{
    return launch_schur(InitScaled<T>{B, ldb, offset, s, eps, nreal}, A, h,
                        out, size, tile, stream);
}

template <typename T>
int launch_schur_gram(const T* X, int dim, const T* params, int npost,
                      unsigned postadd, int with_eps, int profile,
                      long long nreal, long long offset, const T* A,
                      long long h, T* out, long long size, long long tile,
                      void* stream)
{
    if (npost > MAXPOST) return (int)cudaErrorInvalidValue;
    return launch_schur(InitGram<T>{X, dim, params, npost, postadd,
                                    with_eps, profile, nreal, offset},
                        A, h, out, size, tile, stream);
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
    return launch_schur_scaled(B, ldb, offset, s, eps, nreal, A, h, out,
                               size, tile, stream);
}

int lsq_schur_gram_f32(const float* X, int dim, const float* params,
                       int npost, unsigned postadd, int with_eps,
                       int profile, long long nreal, long long offset,
                       const float* A, long long h, float* out,
                       long long size, long long tile, void* stream)
{
    return launch_schur_gram(X, dim, params, npost, postadd, with_eps,
                             profile, nreal, offset, A, h, out, size, tile,
                             stream);
}

int lsq_syrk_t_f32(const float* W, long long h, long long m, float* out,
                   void* stream)
{
    return launch_syrk_t(W, h, m, out, stream);
}

}  // extern "C"
