// Kernels A, B and D in float64 on Hopper's FP64 tensor cores (sm_90a):
// DMMA, mma.sync.aligned.m16n8k16.row.col.f64 (wgmma has no FP64 form).
//
// Kernel A, schur_update: the lower tiles of
//     S = init(r, c) - A A^T
// with init kernel A's scaled view of B plus eps (InitScaled) or kernel
// D's virtual Gram blockdiag(K, I) plus eps (InitGram), from
// schur_init.cuh.  It replaces the TPU kernels
// lsqfitgp_tpu/ops/_syrk.py::_schur_kernel (A) and _schur_gram_kernel /
// _schur_gram_kernel2 (D) in float64.
//
// Kernel B, syrk_t_full: the full, exactly symmetric W^T W of a
// lower-triangular W (h, m).  It replaces
// lsqfitgp_tpu/ops/_syrk.py::_syrk_t_kernel.  In place (out == W, square)
// it leaves W^T W in W's own buffer with m doubles of scratch:
// - one launch over the lower tile pairs (r0 >= c0) stores each tile of
//   W^T W transposed into W's strict upper triangle, which is zero in a
//   lower-triangular W (a diagonal tile stores its strict upper half,
//   and its diagonal into the scratch vector).  The loads read W[k, c]
//   with k < c as zero by index and never touch that memory, so the
//   stores race with no read: the strict upper triangle is never read,
//   and the lower one, which every tile reads, is never written;
// - a second, bandwidth-bound launch mirrors the strict upper triangle
//   into the strict lower one and writes the diagonal from the scratch.
//   It reads only the upper triangle and writes only the lower one.
// Out of place it writes each entry and its mirror from the same
// register in one launch.
//
// Bound on the H100: all three are matrix products with a deep k-loop,
// bound by the FP64 tensor-core rate (67 TFLOP/s), twice what the SIMT
// FMA path reaches.  The design:
// - a 128 x 128 output tile per block of 8 warps, each warp 64 x 32: 4 x 4
//   m16n8k16 products per 16-deep k-step, accumulated in fp64 registers
//   over the whole k-loop (no promotion: the FP64 tensor cores round as
//   IEEE fp64 FMA does);
// - a ring of 4 shared-memory stages of 16 k each, filled by cp.async
//   (three in flight while one is consumed);
// - A's operands are K-major (rows of A); B's are M-major (W[k, c0 + i]),
//   so its fragments are gathered with 64-bit shared loads by (k, m)
//   index (ldmatrix has no 64-bit form).  Either way each tile row is
//   padded by 4 doubles, so that the 16 threads of a half-warp read 16
//   distinct bank pairs;
// - ragged edges by predicated copies: cp.async with a source size of
//   0, 8 or 16 bytes zero-fills the rest, so a k tail past h, columns
//   past m and B's upper triangle never reach memory.  Rows whose start
//   is not 16-byte aligned (odd h or m) take 8-byte copies;
// - A and D launch only the lower tiles at the caller's granularity
//   (schur_init.cuh), B the lower 128-tiles, heaviest (smallest r0)
//   first; B's k-loop starts at the tile's row (rows of W above are zero
//   in its columns): about n^3/6 multiply-adds.
// Nothing is allocated and no library routine is called.

#include <cuda_runtime.h>
#include <stdint.h>

#include "schur_init.cuh"

namespace {

using namespace lsq;

constexpr int BM = 128;             // output tile edge
constexpr int BK = 16;              // k per stage
constexpr int STAGES = 4;
constexpr int NTHREADS = 256;       // 8 warps, 2 x 4
constexpr int WM = 64, WN = 32;     // warp tile
constexpr int MT = WM / 16;         // m16 tiles of a warp
constexpr int NT = WN / 8;          // n8 tiles of a warp
constexpr int MK = 16;              // k of one mma
constexpr int KS = BK + 4;          // K-major tile row stride (doubles)
constexpr int MS = BM + 4;          // M-major tile row stride (doubles)
constexpr int TT = 32;              // the mirror's tile edge

// elements of one operand tile, and the dynamic shared memory of a ring
template <bool KMAJOR>
__host__ __device__ constexpr int tile_elems()
{
    return KMAJOR ? BM * KS : BK * MS;
}
template <bool KMAJOR>
__host__ __device__ constexpr int smem_bytes()
{
    return STAGES * 2 * tile_elems<KMAJOR>() * 8;
}

// Where a stage's two operand tiles come from.  K-major (kernel A):
// rows p0 and p1 of X, whose leading dimension is ld, k in [kbeg, kend).
// M-major (kernel B): columns p0 and p1 of X, rows k in [kbeg, kend),
// X[k, x] read as 0 by index where k < x or x >= mcols.
struct Src {
    const double* X;
    long long ld, kbeg, kend, mcols, p0, p1;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p)
{
    return (uint32_t)__cvta_generic_to_shared(p);
}

// copy V doubles, of which the first `bytes` bytes from src and the rest
// zero-filled
template <int V>
__device__ __forceinline__ void cp_async(uint32_t dst, const double* src,
                                         int bytes)
{
    if constexpr (V == 2)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
                     "l"(src), "r"(bytes)
                     : "memory");
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;" ::"r"(dst),
                     "l"(src), "r"(bytes)
                     : "memory");
}

__device__ __forceinline__ void cp_async_commit()
{
    asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait()
{
    asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Issue the copies of one stage (k0 .. k0 + BK) of both operand tiles
// into the stage at shared address dst.
template <bool KMAJOR, int V>
__device__ __forceinline__ void load_stage(uint32_t dst, const Src& s,
                                           long long k0)
{
    constexpr int PER = BM * BK / V / NTHREADS;   // copies per operand
#pragma unroll
    for (int op = 0; op < 2; ++op) {
        const long long p = op ? s.p1 : s.p0;
#pragma unroll
        for (int l = 0; l < PER; ++l) {
            const int c = threadIdx.x + NTHREADS * l;
            int mi, ki;
            long long nv;
            const double* src;
            if constexpr (KMAJOR) {
                mi = c / (BK / V);
                ki = c % (BK / V) * V;
                nv = s.kend - (k0 + ki);
                src = s.X + (p + mi) * s.ld + k0 + ki;
            } else {
                ki = c / (BM / V);
                mi = c % (BM / V) * V;
                const long long k = k0 + ki, x = p + mi;
                nv = k < s.kend ? (s.mcols < k + 1 ? s.mcols : k + 1) - x : 0;
                src = s.X + k * s.ld + x;
            }
            nv = nv < 0 ? 0 : (nv > V ? V : nv);
            const int at = op * tile_elems<KMAJOR>() +
                           (KMAJOR ? mi * KS + ki : ki * MS + mi);
            cp_async<V>(dst + 8 * at, nv ? src : s.X, (int)nv * 8);
        }
    }
}

// entry (m, k) of an operand tile
template <bool KMAJOR>
__device__ __forceinline__ double frag_at(const double* T, int m, int k)
{
    return KMAJOR ? T[m * KS + k] : T[k * MS + m];
}

// d += a b for one m16n8k16 tile: a row-major 16 x 16 (a[q] at row
// g + 8 (q & 1), column t + 4 (q >> 1)), b column-major 16 x 8 (b[q] at
// row t + 4 q, column g), d 16 x 8 (d[e] at row g + 8 (e >> 1), column
// 2 t + (e & 1)), g = lane / 4, t = lane % 4; fp64 sums with IEEE
// rounding.
__device__ __forceinline__ void mma(double (&d)[4], const double (&a)[8],
                                    const double (&b)[4])
{
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7, %8, %9, %10, %11}, "
        "{%12, %13, %14, %15}, {%0, %1, %2, %3};"
        : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
        : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]),
          "d"(a[5]), "d"(a[6]), "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]),
          "d"(b[3]));
}

// A warp's products of one stage: acc[i][j] += rows (operand 0) times
// columns (operand 1)
template <bool KMAJOR>
__device__ __forceinline__ void compute_stage(double (&acc)[MT][NT][4],
                                              const double* st, int wm,
                                              int wn, int g, int t)
{
    const double* T0 = st;
    const double* T1 = st + tile_elems<KMAJOR>();
#pragma unroll
    for (int kb = 0; kb < BK; kb += MK) {
        double b[NT][MK / 4];
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int q = 0; q < MK / 4; ++q)
                b[j][q] = frag_at<KMAJOR>(T1, wn * WN + j * 8 + g,
                                          kb + t + 4 * q);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
            double a[MK / 2];
#pragma unroll
            for (int q = 0; q < MK / 2; ++q)
                a[q] = frag_at<KMAJOR>(T0, wm * WM + i * 16 + g + 8 * (q & 1),
                                       kb + t + 4 * (q >> 1));
#pragma unroll
            for (int j = 0; j < NT; ++j) mma(acc[i][j], a, b[j]);
        }
    }
}

// The k-loop of one output tile: the ring of STAGES stages, STAGES - 1
// in flight.
template <bool KMAJOR, int V>
__device__ __forceinline__ void mainloop(double (&acc)[MT][NT][4],
                                         unsigned char* smem, const Src& s)
{
    constexpr int STAGE = 2 * tile_elems<KMAJOR>() * 8;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int wm = warp / (BM / WN), wn = warp % (BM / WN);
    const long long depth = s.kend - s.kbeg;
    const int nk = depth > 0 ? (int)((depth + BK - 1) / BK) : 0;
    const uint32_t base = smem_u32(smem);
#pragma unroll
    for (int it = 0; it < STAGES - 1; ++it) {
        if (it < nk)
            load_stage<KMAJOR, V>(base + it * STAGE, s, s.kbeg + it * BK);
        cp_async_commit();
    }
    for (int it = 0; it < nk; ++it) {
        cp_async_wait<STAGES - 2>();
        // stage `it` has landed for every thread, and every warp is done
        // with stage it - 1, which the next copies overwrite
        __syncthreads();
        const int nx = it + STAGES - 1;
        if (nx < nk)
            load_stage<KMAJOR, V>(base + (nx % STAGES) * STAGE, s,
                                  s.kbeg + (long long)nx * BK);
        cp_async_commit();
        compute_stage<KMAJOR>(
            acc,
            reinterpret_cast<const double*>(smem + (it % STAGES) * STAGE),
            wm, wn, lane / 4, lane % 4);
    }
    cp_async_wait<0>();
}

// tile coordinates of entry e of accumulator (i, j) of this thread
__device__ __forceinline__ int acc_row(int i, int e)
{
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    return warp / (BM / WN) * WM + i * 16 + lane / 4 + 8 * (e >> 1);
}

__device__ __forceinline__ int acc_col(int j, int e)
{
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    return warp % (BM / WN) * WN + j * 8 + 2 * (lane % 4) + (e & 1);
}

// Kernels A and D.  A is (size, h) row-major; block b computes the b-th
// tile of the lower work list at the granularity `tile`.  The
// accumulator starts at -init and gathers +A A^T; the result is its
// negation, which is exactly init - A A^T rounded alike (negation is
// exact and the rounding symmetric).
template <typename Init, int V>
__global__ void __launch_bounds__(NTHREADS, 1)
schur_dmma_kernel(Init init, const double* __restrict__ A, long long h,
                  double* __restrict__ out, long long size, long long tile)
{
    extern __shared__ __align__(16) unsigned char smem[];
    long long r0, c0;
    lower_tile(blockIdx.x, tile, BM, r0, c0);
    double acc[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e)
                acc[i][j][e] = -init(r0 + acc_row(i, e), c0 + acc_col(j, e));
    mainloop<true, V>(acc, smem, Src{A, h, 0, h, 0, r0, c0});
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; e += 2) {
                const long long r = r0 + acc_row(i, e);
                const long long c = c0 + acc_col(j, e);
                *reinterpret_cast<double2*>(out + r * size + c) =
                    make_double2(-acc[i][j][e], -acc[i][j][e + 1]);
            }
}

// Kernel B.  W is (h, m) row-major and lower triangular.  Block b
// computes the b-th lower 128-tile (r0 >= c0) over k >= r0.  Each entry
// with r >= c is stored once: in place, at W[c, r] (r > c) or diag[r];
// out of place at out[r, c] and out[c, r].  (W and out alias in place.)
template <int V, bool INPLACE>
__global__ void __launch_bounds__(NTHREADS, 1)
syrk_t_dmma_kernel(const double* W, long long h, long long m, double* out,
                   double* diag)
{
    extern __shared__ __align__(16) unsigned char smem[];
    long long r0, c0;
    lower_tile(blockIdx.x, BM, BM, r0, c0);
    double acc[MT][NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0;
    mainloop<false, V>(acc, smem, Src{W, m, r0, h, m, r0, c0});
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
                const long long r = r0 + acc_row(i, e);
                const long long c = c0 + acc_col(j, e);
                // r < c only in a diagonal tile: its upper half is the
                // mirror of its lower half
                if (r >= m || c >= m || r < c) continue;
                const double v = acc[i][j][e];
                if constexpr (INPLACE) {
                    if (r == c)
                        diag[r] = v;
                    else
                        out[c * m + r] = v;
                } else {
                    out[r * m + c] = v;
                    if (r != c) out[c * m + r] = v;
                }
            }
}

// The in-place kernel B's second launch: W[r, c] = W[c, r] for r > c and
// W[r, r] = diag[r], by TT x TT tile pairs through shared memory.  Block
// b reads the b-th lower tile pair's upper tile (rows C0, columns R0)
// and writes its lower tile (rows R0, columns C0).
__global__ void __launch_bounds__(TT * 8)
mirror_kernel(double* W, long long m, const double* __restrict__ diag)
{
    __shared__ double s[TT][TT + 1];
    long long R0, C0;
    lower_tile(blockIdx.x, TT, TT, R0, C0);
    const int tx = threadIdx.x, ty = threadIdx.y;
    for (int i = ty; i < TT; i += 8) {
        const long long r = C0 + i, c = R0 + tx;
        if (c < m && r < c) s[i][tx] = W[r * m + c];
    }
    __syncthreads();
    for (int i = ty; i < TT; i += 8) {
        const long long r = R0 + i, c = C0 + tx;
        if (r >= m || c > r) continue;
        W[r * m + c] = r == c ? diag[r] : s[tx][i];
    }
}

template <typename Kernel, typename... Args>
int run(Kernel kernel, unsigned blocks, int smem, void* stream,
        Args... args)
{
    // above 48 KB a block's dynamic shared memory must be asked for
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    kernel<<<blocks, NTHREADS, smem, (cudaStream_t)stream>>>(args...);
    return (int)cudaGetLastError();
}

template <typename Init>
int launch_schur(Init init, const double* A, long long h, double* out,
                 long long size, long long tile, void* stream)
{
    if (size == 0) return 0;
    if (tile % BM || size % tile) return (int)cudaErrorInvalidValue;
    const unsigned nb = (unsigned)lower_tiles(size, tile, BM);
    constexpr int smem = smem_bytes<true>();
    if (h % 2 == 0 && (uintptr_t)A % 16 == 0)
        return run(schur_dmma_kernel<Init, 2>, nb, smem, stream, init, A, h,
                   out, size, tile);
    return run(schur_dmma_kernel<Init, 1>, nb, smem, stream, init, A, h,
               out, size, tile);
}

int launch_syrk_t(const double* W, long long h, long long m, double* out,
                  double* diag, void* stream)
{
    if (m == 0) return 0;
    const bool inplace = out == W;
    if (inplace && (h != m || !diag)) return (int)cudaErrorInvalidValue;
    const long long nt = (m + BM - 1) / BM;
    const unsigned nb = (unsigned)(nt * (nt + 1) / 2);
    constexpr int smem = smem_bytes<false>();
    const bool vec = m % 2 == 0 && (uintptr_t)W % 16 == 0;
    int err;
    if (inplace)
        err = vec ? run(syrk_t_dmma_kernel<2, true>, nb, smem, stream, W, h,
                        m, out, diag)
                  : run(syrk_t_dmma_kernel<1, true>, nb, smem, stream, W, h,
                        m, out, diag);
    else
        err = vec ? run(syrk_t_dmma_kernel<2, false>, nb, smem, stream, W, h,
                        m, out, diag)
                  : run(syrk_t_dmma_kernel<1, false>, nb, smem, stream, W, h,
                        m, out, diag);
    if (err || !inplace) return err;
    const long long nm = (m + TT - 1) / TT;
    mirror_kernel<<<(unsigned)(nm * (nm + 1) / 2), dim3(TT, 8), 0,
                    (cudaStream_t)stream>>>(out, m, diag);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int lsq_schur_update_dmma_f64(const double* B, long long ldb,
                              long long offset, const double* s,
                              const double* eps, long long nreal,
                              const double* A, long long h, double* out,
                              long long size, long long tile, void* stream)
{
    return launch_schur(InitScaled<double>{B, ldb, offset, s, eps, nreal}, A,
                        h, out, size, tile, stream);
}

int lsq_schur_gram_dmma_f64(const double* X, int dim, const double* params,
                            int nterms, unsigned long long codes,
                            int with_eps, long long nreal, long long offset,
                            const double* A, long long h, double* out,
                            long long size, long long tile, void* stream)
{
    if (nterms < 1 || nterms > MAXTERMS)
        return (int)cudaErrorInvalidValue;
    return launch_schur(InitGram<double>{X, dim, params, nterms, codes,
                                         with_eps, nreal, offset},
                        A, h, out, size, tile, stream);
}

// out == W: in place (W square), with diag m doubles of scratch
int lsq_syrk_t_dmma_f64(const double* W, long long h, long long m,
                        double* out, double* diag, void* stream)
{
    return launch_syrk_t(W, h, m, out, diag, stream);
}

}  // extern "C"
