// Lower-trapezoid symmetric updates for the blocked Cholesky (sm_90a),
// the SIMT kernels: IEEE fp32 FMA on the CUDA cores.
//
// Kernel A, schur_update: the lower tiles of
//     S = diag(s) B diag(s) + eps I - A A^T
// with B read as the (size, size) view at (offset, offset) of a larger
// row-major matrix, never copied.  It replaces the TPU kernel
// lsqfitgp_tpu/ops/_syrk.py::_schur_kernel.
//
// Kernel D, schur_update_gram: the lower tiles of
//     S = K[off:off+size, off:off+size] + eps I - A A^T
// where K[i, j] = the profile of |X_i - X_j|^2 is computed in the tile from
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
// so the fp32 FMA rate (67 TFLOP/s) bounds them, not memory (D's tile
// initialization, one exp per entry, is negligible beside a k-loop of
// depth >= 512).  The design is the register-blocked SIMT product with
// the loads taken off the FMA's path:
// - a 128 x 128 output tile per block; each thread owns a 4 RS x 8
//   micro-tile made of RS x 2 sub-tiles of 4 x 4 (rows at a stride of
//   128 / RS, columns at 64), so its operands for one k are RS + 2
//   16-byte shared loads; a warp covers 4 x 8 threads, so each of its
//   shared loads touches at most 128 distinct bytes;
// - k-slabs of 16 in a k-major shared layout (As[k][m], rows padded by
//   4), double-buffered: slab k+1 is read from device memory into
//   registers (16-byte loads where the rows allow it) before slab k is
//   computed, and stored into the other buffer after it, so one barrier
//   per slab separates the two and the loads' latency hides under the
//   slab's FMAs;
// - A's and D's operand rows are k-contiguous, so each thread stores its
//   4-wide loads transposed into the k-major layout; B's operand is W's
//   rows, already k-major, stored as it came;
// - 34 KB of shared memory a block, two blocks an SM
//   (__launch_bounds__(512 / RS, 2)).  A and D take RS = 4 (4 warps of
//   16 x 8, 6 LDS.128 per 128 FFMA, up to 255 registers), which on the
//   H100 took less time than RS = 2 (8 warps of 8 x 8, 4 LDS.128 per 64
//   FFMA, 128 registers); B, whose tiles' k-ranges shrink down the
//   triangle, took less with RS = 2 and keeps it;
// - A and D launch only the lower tiles, B only the lower tiles of its
//   own 128-granular work list (largest k-range first), all numbered by
//   schur_init.cuh's lower_tile;
// - every product is summed in k order, one IEEE FMA at a time, into an
//   accumulator that starts at the tile's initial value.
// Rows of any length h (and B's any m) are taken: where they are not
// 16-byte aligned the loads are 4-byte ones with the same schedule.  No
// library routine is called and nothing is allocated.

#include "schur_init.cuh"

namespace {

using namespace lsq;

constexpr int BM = 128;             // output tile edge
constexpr int BK = 16;              // k-slab depth
constexpr int LDS = BM + 4;         // shared row length (16-byte rows)
constexpr int RS_AD = 4;            // kernels A and D: 4 warps of 16 x 8
constexpr int RS_B = 2;             // kernel B: 8 warps of 8 x 8

// threads a block and 4-wide loads a thread per operand slab
template <int RS> constexpr int NTHREADS = 512 / RS;
template <int RS> constexpr int SLOTS = BM * BK / 4 / NTHREADS<RS>;

struct Smem {
    float a[2][BK][LDS];
    float b[2][BK][LDS];
};

// The thread's micro-tile: rows row<RS>(ty, p), p < 4 RS, and columns
// col(tx, q), q < 8, of the block's tile; a warp is 4 x 8 threads.
__device__ __forceinline__ void coords(int t, int& tx, int& ty)
{
    const int warp = t / 32, lane = t % 32;
    tx = (warp % 2) * 8 + lane % 8;     // 0 .. 15
    ty = (warp / 2) * 4 + lane / 8;     // 0 .. 32 / RS - 1
}

template <int RS>
__device__ __forceinline__ int row(int ty, int p)
{
    return (p / 4) * (BM / RS) + ty * 4 + p % 4;
}

__device__ __forceinline__ int col(int tx, int q)
{
    return (q / 4) * 64 + tx * 4 + q % 4;
}

__device__ __forceinline__ float4 zero4()
{
    return make_float4(0.f, 0.f, 0.f, 0.f);
}

// 4 consecutive entries p[j..j+3] of a row of length len, zero past it
template <bool VEC>
__device__ __forceinline__ float4 load4(const float* __restrict__ p,
                                        long long j, long long len)
{
    if (VEC)
        return j < len ? *reinterpret_cast<const float4*>(p + j) : zero4();
    float4 v;
    v.x = j < len ? p[j] : 0.f;
    v.y = j + 1 < len ? p[j + 1] : 0.f;
    v.z = j + 2 < len ? p[j + 2] : 0.f;
    v.w = j + 3 < len ? p[j + 3] : 0.f;
    return v;
}

// One slab of one operand tile of A/D: rows row0 .. row0+127 of the
// (., h) row-major A, k = k0 .. k0+15; slot idx is row idx / 4, k's
// quarter idx % 4, so a warp reads 8 rows of 64 contiguous bytes
template <int RS, bool VEC>
__device__ __forceinline__ void fetch_rows(float4 (&r)[SLOTS<RS>],
                                           const float* __restrict__ A,
                                           long long h, long long row0,
                                           long long k0, int t)
{
#pragma unroll
    for (int l = 0; l < SLOTS<RS>; ++l) {
        const int idx = t + NTHREADS<RS> * l;
        r[l] = load4<VEC>(A + (row0 + idx / 4) * h, k0 + (idx % 4) * 4, h);
    }
}

// ... stored transposed into the k-major slab
template <int RS>
__device__ __forceinline__ void put_rows(float (*S)[LDS],
                                         const float4 (&r)[SLOTS<RS>],
                                         int t)
{
#pragma unroll
    for (int l = 0; l < SLOTS<RS>; ++l) {
        const int idx = t + NTHREADS<RS> * l;
        const int m = idx / 4, kk = (idx % 4) * 4;
        S[kk][m] = r[l].x;
        S[kk + 1][m] = r[l].y;
        S[kk + 2][m] = r[l].z;
        S[kk + 3][m] = r[l].w;
    }
}

// One slab of one operand tile of B: columns col0 .. col0+127 of rows
// k0 .. k0+15 of the (h, m) row-major W, zero past h and m; slot idx is
// row idx / 32, column quarter idx % 32 (a warp reads 512 contiguous
// bytes of one row)
template <int RS, bool VEC>
__device__ __forceinline__ void fetch_cols(float4 (&r)[SLOTS<RS>],
                                           const float* __restrict__ W,
                                           long long h, long long m,
                                           long long col0, long long k0,
                                           int t)
{
#pragma unroll
    for (int l = 0; l < SLOTS<RS>; ++l) {
        const int idx = t + NTHREADS<RS> * l;
        const long long k = k0 + idx / 32;
        r[l] = k < h ? load4<VEC>(W + k * m, col0 + (idx % 32) * 4, m)
                     : zero4();
    }
}

template <int RS>
__device__ __forceinline__ void put_cols(float (*S)[LDS],
                                         const float4 (&r)[SLOTS<RS>],
                                         int t)
{
#pragma unroll
    for (int l = 0; l < SLOTS<RS>; ++l) {
        const int idx = t + NTHREADS<RS> * l;
        *reinterpret_cast<float4*>(&S[idx / 32][(idx % 32) * 4]) = r[l];
    }
}

// One slab: acc[p][q] += (NEG ? -1 : 1) * sum_kk As[kk][row p] Bs[kk][col q],
// one FMA per product in kk order
template <int RS, bool NEG>
__device__ __forceinline__ void slab(float (&acc)[4 * RS][8],
                                     const float (*As)[LDS],
                                     const float (*Bs)[LDS], int tx, int ty)
{
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
        float a[4 * RS], b[8];
#pragma unroll
        for (int i = 0; i < RS; ++i) {
            const float4 v = *reinterpret_cast<const float4*>(
                &As[kk][(BM / RS) * i + ty * 4]);
            a[4 * i] = v.x;
            a[4 * i + 1] = v.y;
            a[4 * i + 2] = v.z;
            a[4 * i + 3] = v.w;
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
            const float4 v =
                *reinterpret_cast<const float4*>(&Bs[kk][64 * j + tx * 4]);
            b[4 * j] = v.x;
            b[4 * j + 1] = v.y;
            b[4 * j + 2] = v.z;
            b[4 * j + 3] = v.w;
        }
#pragma unroll
        for (int p = 0; p < 4 * RS; ++p)
#pragma unroll
            for (int q = 0; q < 8; ++q)
                acc[p][q] = fmaf(NEG ? -a[p] : a[p], b[q], acc[p][q]);
    }
}

// Kernels A and D.  A is (size, h) row-major.  Block b computes the
// b-th tile of the lower work list at the granularity `tile` (a
// multiple of BM).
template <typename Init, bool VEC>
__global__ void __launch_bounds__(NTHREADS<RS_AD>, 2)
schur_kernel(Init init, const float* __restrict__ A, long long h,
             float* __restrict__ out, long long size, long long tile)
{
    constexpr int RS = RS_AD;
    long long r0, c0;
    lower_tile(blockIdx.x, tile, BM, r0, c0);

    __shared__ __align__(16) Smem sm;
    const int t = threadIdx.x;
    int tx, ty;
    coords(t, tx, ty);

    float4 ra[SLOTS<RS>], rb[SLOTS<RS>];
    const long long nslab = (h + BK - 1) / BK;
    if (nslab > 0) {
        fetch_rows<RS, VEC>(ra, A, h, r0, 0, t);
        fetch_rows<RS, VEC>(rb, A, h, c0, 0, t);
    }

    float acc[4 * RS][8];
#pragma unroll
    for (int p = 0; p < 4 * RS; ++p)
#pragma unroll
        for (int q = 0; q < 8; ++q)
            acc[p][q] = init(r0 + row<RS>(ty, p), c0 + col(tx, q));

    if (nslab > 0) {
        put_rows<RS>(sm.a[0], ra, t);
        put_rows<RS>(sm.b[0], rb, t);
        __syncthreads();
    }
    for (long long s = 0; s < nslab; ++s) {
        const int cur = s & 1;
        const bool next = s + 1 < nslab;
        if (next) {
            fetch_rows<RS, VEC>(ra, A, h, r0, (s + 1) * BK, t);
            fetch_rows<RS, VEC>(rb, A, h, c0, (s + 1) * BK, t);
        }
        slab<RS, true>(acc, sm.a[cur], sm.b[cur], tx, ty);
        if (next) {
            put_rows<RS>(sm.a[cur ^ 1], ra, t);
            put_rows<RS>(sm.b[cur ^ 1], rb, t);
        }
        __syncthreads();
    }

#pragma unroll
    for (int p = 0; p < 4 * RS; ++p) {
        float* o = out + (r0 + row<RS>(ty, p)) * size + c0 + tx * 4;
        *reinterpret_cast<float4*>(o) =
            make_float4(acc[p][0], acc[p][1], acc[p][2], acc[p][3]);
        *reinterpret_cast<float4*>(o + 64) =
            make_float4(acc[p][4], acc[p][5], acc[p][6], acc[p][7]);
    }
}

// out[r, c..c+3] = v in an (m, m) row-major out, clipped to m (with
// VEC, m % 4 == 0 and c % 4 == 0, so the 4 are all in or all out)
template <bool VEC>
__device__ __forceinline__ void store4(float* __restrict__ out, long long m,
                                       long long r, long long c, float4 v)
{
    if (r >= m || c >= m) return;
    float* p = out + r * m + c;
    if (VEC) {
        *reinterpret_cast<float4*>(p) = v;
        return;
    }
    p[0] = v.x;
    if (c + 1 < m) p[1] = v.y;
    if (c + 2 < m) p[2] = v.z;
    if (c + 3 < m) p[3] = v.w;
}

// Kernel B.  W is (h, m) row-major and lower triangular: W[k, c] = 0
// for k < c, so the tile whose rows start at r0 >= c0 needs only k >= r0.
// Block b computes the b-th lower tile of edge BM; the tile's 4 x 4
// sub-tiles go to out[r, c] and, off the diagonal tiles, transposed to
// out[c, r], both as 16-byte rows where m allows.
template <bool VEC>
__global__ void __launch_bounds__(NTHREADS<RS_B>, 2)
syrk_t_kernel(const float* __restrict__ W, long long h, long long m,
              float* __restrict__ out)
{
    constexpr int RS = RS_B;
    long long r0, c0;
    lower_tile(blockIdx.x, BM, BM, r0, c0);

    __shared__ __align__(16) Smem sm;
    const int t = threadIdx.x;
    int tx, ty;
    coords(t, tx, ty);

    float4 ra[SLOTS<RS>], rb[SLOTS<RS>];
    const long long nslab = h > r0 ? (h - r0 + BK - 1) / BK : 0;
    if (nslab > 0) {
        fetch_cols<RS, VEC>(ra, W, h, m, r0, r0, t);
        fetch_cols<RS, VEC>(rb, W, h, m, c0, r0, t);
        put_cols<RS>(sm.a[0], ra, t);
        put_cols<RS>(sm.b[0], rb, t);
        __syncthreads();
    }

    float acc[4 * RS][8];
#pragma unroll
    for (int p = 0; p < 4 * RS; ++p)
#pragma unroll
        for (int q = 0; q < 8; ++q)
            acc[p][q] = 0.f;

    for (long long s = 0; s < nslab; ++s) {
        const int cur = s & 1;
        const bool next = s + 1 < nslab;
        const long long k1 = r0 + (s + 1) * BK;
        if (next) {
            fetch_cols<RS, VEC>(ra, W, h, m, r0, k1, t);
            fetch_cols<RS, VEC>(rb, W, h, m, c0, k1, t);
        }
        slab<RS, false>(acc, sm.a[cur], sm.b[cur], tx, ty);
        if (next) {
            put_cols<RS>(sm.a[cur ^ 1], ra, t);
            put_cols<RS>(sm.b[cur ^ 1], rb, t);
        }
        __syncthreads();
    }

    // the tile's 4 x 4 sub-tiles as rows of 4: the direct ones at
    // out[r, c..c+3], off the diagonal tiles the transposed ones at
    // out[c, r..r+3]
#pragma unroll
    for (int p = 0; p < 4 * RS; ++p)
#pragma unroll
        for (int j = 0; j < 2; ++j)
            store4<VEC>(out, m, r0 + row<RS>(ty, p), c0 + 64 * j + tx * 4,
                        make_float4(acc[p][4 * j], acc[p][4 * j + 1],
                                    acc[p][4 * j + 2], acc[p][4 * j + 3]));
    if (r0 == c0) return;
#pragma unroll
    for (int q = 0; q < 8; ++q)
#pragma unroll
        for (int i = 0; i < RS; ++i)
            store4<VEC>(out, m, c0 + col(tx, q), r0 + (BM / RS) * i + ty * 4,
                        make_float4(acc[4 * i][q], acc[4 * i + 1][q],
                                    acc[4 * i + 2][q], acc[4 * i + 3][q]));
}

bool aligned16(const void* p)
{
    return reinterpret_cast<unsigned long long>(p) % 16 == 0;
}

template <typename Init>
int launch_schur(Init init, const float* A, long long h, float* out,
                 long long size, long long tile, void* stream)
{
    if (size == 0) return 0;
    if (tile % BM) return (int)cudaErrorInvalidValue;
    const unsigned nb = (unsigned)lower_tiles(size, tile, BM);
    cudaStream_t st = (cudaStream_t)stream;
    if (h % 4 == 0 && aligned16(A))
        schur_kernel<Init, true><<<nb, NTHREADS<RS_AD>, 0, st>>>(
            init, A, h, out, size, tile);
    else
        schur_kernel<Init, false><<<nb, NTHREADS<RS_AD>, 0, st>>>(
            init, A, h, out, size, tile);
    return (int)cudaGetLastError();
}

int launch_syrk_t(const float* W, long long h, long long m, float* out,
                  void* stream)
{
    if (m == 0) return 0;
    const long long nt = (m + BM - 1) / BM;
    const unsigned nb = (unsigned)lower_tiles(nt * BM, BM, BM);
    cudaStream_t st = (cudaStream_t)stream;
    if (m % 4 == 0 && aligned16(W) && aligned16(out))
        syrk_t_kernel<true><<<nb, NTHREADS<RS_B>, 0, st>>>(W, h, m, out);
    else
        syrk_t_kernel<false><<<nb, NTHREADS<RS_B>, 0, st>>>(W, h, m, out);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int lsq_schur_update_f32(const float* B, long long ldb, long long offset,
                         const float* s, const float* eps, long long nreal,
                         const float* A, long long h, float* out,
                         long long size, long long tile, void* stream)
{
    return launch_schur(
        lsq::InitScaled<float>{B, ldb, offset, s, eps, nreal}, A, h, out,
        size, tile, stream);
}

int lsq_schur_gram_f32(const float* X, int dim, const float* params,
                       int nterms, unsigned long long codes,
                       int with_eps, long long nreal, long long offset,
                       const float* A, long long h, float* out,
                       long long size, long long tile, void* stream)
{
    if (nterms < 1 || nterms > lsq::MAXTERMS)
        return (int)cudaErrorInvalidValue;
    return launch_schur(
        lsq::InitGram<float>{X, dim, params, nterms, codes, with_eps,
                             nreal, offset},
        A, h, out, size, tile, stream);
}

int lsq_syrk_t_f32(const float* W, long long h, long long m, float* out,
                   void* stream)
{
    return launch_syrk_t(W, h, m, out, stream);
}

}  // extern "C"
