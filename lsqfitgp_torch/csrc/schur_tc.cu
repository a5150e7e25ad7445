// Kernels A and D on the tensor cores (sm_90a), float32: the lower tiles
// of
//     S = init(r, c) - A A^T
// with init kernel A's scaled view of B plus eps (InitScaled) or kernel
// D's virtual Gram blockdiag(K, I) plus eps (InitGram), from
// schur_init.cuh, the same initializers the SIMT kernel of syrk.cu
// calls.  It replaces the TPU kernels lsqfitgp_tpu/ops/_syrk.py::
// _schur_kernel (A) and _schur_gram_kernel / _schur_gram_kernel2 (D) at
// their default precision, whose products are the bf16_3x split of
// _dot_prec:
//   PASSES = 3, precision='high': 3xTF32, a = hi + lo with hi = rna(a)
//     and lo = rna(a - hi) in TF32, products hi.hi + hi.lo + lo.hi
//     (the lo.lo term, < 2^-22 |a b|, is dropped): about 2^-21 relative
//     per product, finer than bf16_3x's 2^-16;
//   PASSES = 1, precision='default': 1xTF32, one pass of rna(a),
//     2^-10 relative per product (JAX's DEFAULT is one bf16 pass).
//
// Bound on the H100: the products, at 495 TFLOP/s of TF32 divided by the
// pass count (165 TFLOP/s of useful work for 3xTF32, 2.5x the 67 TFLOP/s
// that bounds the SIMT kernel).  The design:
// - wgmma.mma_async m64n128k8 .tf32.  out[r, c] = sum_k A[r, k] A[c, k]
//   reads the row tile and the column tile straight from the rows of the
//   row-major A (size, h): both are K-major, as wgmma's 32-bit operands
//   must be, and no transposed copy exists.
// - A 128 x 128 output tile per block of three warpgroups: one producer
//   thread keeps TMA loads (cp.async.bulk.tensor, mbarrier completion) of
//   the row and column tiles in flight in a ring of shared-memory stages
//   of 32 k-columns (one 128-byte swizzle row of float32); two consumer
//   warpgroups own 64 output rows each.  setmaxnreg moves registers from
//   the producer to the consumers.
// - The split happens after the load, with no device memory (a
//   pre-split copy of A would cost 2 size h 4 bytes, 8 GiB at kernel D's
//   largest update).  wgmma reads only the top 19 bits of each word, so
//   hi is rounded explicitly (cvt.rna) and lo taken from the rounded hi.
//   The row tile goes to registers (wgmma's A operand may live there):
//   each warpgroup loads its 64 rows from the swizzled stage and splits
//   them in registers.  The column tile, shared by both warpgroups, is
//   split in shared memory, each warpgroup rounding half of it in place
//   (hi) and writing lo beside it, then a named barrier joins the two.
//   With both operands and both splits in shared memory, a stage moves
//   about 1.4 times the bytes that shared memory's 128 bytes per clock
//   carry in the stage's tensor-core time; the row operand in registers
//   takes its reads and its split off that path (measured: 0-7 % faster,
//   PERF.md, so shared memory is not the main limit).
// - The next stage is split and loaded while a stage's products run;
//   two register sets of row fragments alternate.
// - The tensor cores sum in fp32 but not with IEEE round-to-nearest
//   (their sums lose low bits toward zero, as published measurements of
//   earlier NVIDIA tensor cores found).  One wgmma accumulator over the
//   whole k-loop biased the diagonal of A A^T, all of whose terms are
//   positive: at size = h = 8192 every diagonal entry was outside the
//   smoke's tolerance (PERF.md).  So each stage's products start from zero
//   in the wgmma accumulator and are then subtracted from a separate
//   register accumulator with IEEE rounding; that accumulator starts from
//   init(r, c), as the SIMT kernel's does.
// - The work list holds only the lower tiles (schur_init.cuh), one block
//   each.  The TMA descriptor comes from the driver's
//   cuTensorMapEncodeTiled, found with cudaGetDriverEntryPoint, so the
//   library needs no link to libcuda.  A's rows must be 16-byte aligned
//   (h % 4 == 0); the k tail past h is zero-filled by the TMA unit.
// Nothing is allocated and no library routine is called.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "schur_init.cuh"

namespace {

using namespace lsq;

constexpr int BM = 128;                  // output tile edge
constexpr int BK = 32;                   // k per stage
constexpr int WG = 128;                  // threads of a warpgroup
constexpr int NCONS = 2;                 // consumer warpgroups
constexpr int NTHREADS = (NCONS + 1) * WG;
constexpr int TILE = BM * BK * 4;        // one operand tile of a stage
constexpr int HALF4 = TILE / 2 / 16;     // float4s of a warpgroup's half

template <int PASSES>
struct Cfg {
    // a stage: the row tile as loaded, the column tile (hi after the
    // split) and, for 3 passes, the column tile's lo part
    static constexpr int STAGE = (PASSES == 3 ? 3 : 2) * TILE;
    static constexpr int STAGES = PASSES == 3 ? 4 : 6;
    static constexpr int SMEM = STAGES * STAGE + 2 * STAGES * 8 + 1024;
};

// A warpgroup's row-tile operand of one stage, in registers, in
// wgmma's A-fragment layout: for k-step kk, entry j of this thread is
// row 16 warp + lane / 4 + 8 (j & 1), column 8 kk + lane % 4 + 4 (j >> 1)
// of the warpgroup's 64 rows.  hi = rna(a); lo = rna(a - hi) for 3
// passes.
template <int PASSES>
struct Frags {
    uint32_t hi[BK / 8][4];
    uint32_t lo[PASSES == 3 ? BK / 8 : 1][4];
};

__device__ __forceinline__ uint32_t smem_u32(const void* p)
{
    return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count)
{
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
                 "r"(count)
                 : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity)
{
    uint32_t done;
    do {
        asm volatile(
            "{\n"
            ".reg .pred p;\n"
            "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            "selp.u32 %0, 1, 0, p;\n"
            "}\n"
            : "=r"(done)
            : "r"(bar), "r"(parity)
            : "memory");
    } while (!done);
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar)
{
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
                 : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes)
{
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
        "r"(bytes)
        : "memory");
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int k0, int row0, uint32_t bar)
{
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
        "l"((uint64_t)map), "r"(k0), "r"(row0), "r"(bar)
        : "memory");
}

// shared-memory matrix descriptor: K-major, 128-byte swizzle, 8-row
// groups 1024 bytes apart
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr)
{
    return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
           ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ float tf32_rna(float x)
{
    uint32_t u;
    asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(u) : "f"(x));
    return __uint_as_float(u);
}

__device__ __forceinline__ void fence_operand(float (&d)[64])
{
#pragma unroll
    for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= a b^T for a 64 x 8 tile a in registers (Frags layout) and a
// 128 x 8 tile b in shared memory; scale_d = 0 drops d's previous value
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d)
{
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "setp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63},"
        " {%64, %65, %66, %67}, %68, p, 1, 1;\n"
        "}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
          "r"(scale_d));
}

template <int PASSES>
__device__ __forceinline__ void fence_frags(Frags<PASSES>& f)
{
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            asm volatile("" : "+r"(f.hi[kk][j])::"memory");
            if constexpr (PASSES == 3)
                asm volatile("" : "+r"(f.lo[kk][j])::"memory");
        }
}

// Round this warpgroup's half of the stage's column tile to TF32 in
// place and, for 3 passes, write the rounded remainders into the
// stage's lo tile (the same swizzled layout); then make the tile
// visible to the tensor cores and join the other consumer warpgroup.
template <int PASSES>
__device__ __forceinline__ void split_cols(unsigned char* stage, int wg,
                                           int t)
{
    float4* hi = reinterpret_cast<float4*>(stage + TILE) + wg * HALF4;
#pragma unroll
    for (int j = 0; j < HALF4 / WG; ++j) {
        const int i = t + WG * j;
        const float4 v = hi[i];
        const float4 h = make_float4(tf32_rna(v.x), tf32_rna(v.y),
                                     tf32_rna(v.z), tf32_rna(v.w));
        hi[i] = h;
        if constexpr (PASSES == 3) {
            float4* lo = reinterpret_cast<float4*>(stage + 2 * TILE) +
                         wg * HALF4;
            lo[i] = make_float4(tf32_rna(v.x - h.x), tf32_rna(v.y - h.y),
                                tf32_rna(v.z - h.z), tf32_rna(v.w - h.w));
        }
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync 1, %0;" ::"n"(NCONS * WG) : "memory");
}

// Load this warpgroup's rows of the stage's row tile (as loaded, 128-byte
// swizzled: 16-byte chunk c of row r sits at chunk c ^ (r % 8)) into
// registers and split them.
template <int PASSES>
__device__ __forceinline__ void load_rows(Frags<PASSES>& f,
                                          const unsigned char* stage, int wg,
                                          int warp, int lane)
{
    const int g = lane / 4, tig = lane % 4;
    const int r0 = wg * 64 + warp * 16 + g;    // r0 % 8 == g
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int r = r0 + 8 * (j & 1);
            const int k = 8 * kk + tig + 4 * (j >> 1);
            const float a = *reinterpret_cast<const float*>(
                stage + r * 128 + (((k >> 2) ^ g) << 4) + ((k & 3) << 2));
            const float h = tf32_rna(a);
            f.hi[kk][j] = __float_as_uint(h);
            if constexpr (PASSES == 3)
                f.lo[kk][j] = __float_as_uint(tf32_rna(a - h));
        }
}

// Issue one stage's products into d (which starts from zero): for 3
// passes the small terms lo.hi and hi.lo first, then hi.hi.
template <int PASSES>
__device__ __forceinline__ void stage_products(float (&d)[64],
                                               const Frags<PASSES>& f,
                                               uint32_t stage)
{
    const uint32_t c = stage + TILE;
    if constexpr (PASSES == 3) {
#pragma unroll
        for (int kk = 0; kk < BK / 8; ++kk)
            wgmma_tf32_rs(d, f.lo[kk], sw128_desc(c + kk * 32), kk > 0);
#pragma unroll
        for (int kk = 0; kk < BK / 8; ++kk)
            wgmma_tf32_rs(d, f.hi[kk], sw128_desc(c + TILE + kk * 32), 1);
    }
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk)
        wgmma_tf32_rs(d, f.hi[kk], sw128_desc(c + kk * 32),
                      PASSES == 3 || kk > 0);
}

// One stage of a consumer warpgroup: issue its products from the
// fragments `cur`, split and load the next stage into `next` while they
// run, then add them into acc with IEEE rounding and release the stage.
template <int PASSES>
__device__ __forceinline__ void consume(int it, int nk, float (&acc)[64],
                                        float (&d)[64], Frags<PASSES>& cur,
                                        Frags<PASSES>& next,
                                        unsigned char* smem, uint32_t full,
                                        uint32_t empty, int wg, int t)
{
    using C = Cfg<PASSES>;
    const int s = it % C::STAGES;
    fence_operand(d);
    fence_frags(cur);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
    stage_products<PASSES>(d, cur, smem_u32(smem + s * C::STAGE));
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    if (it + 1 < nk) {
        const int s1 = (it + 1) % C::STAGES;
        mbar_wait(full + 8 * s1, ((it + 1) / C::STAGES) & 1);
        split_cols<PASSES>(smem + s1 * C::STAGE, wg, t);
        load_rows<PASSES>(next, smem + s1 * C::STAGE, wg, t / 32, t % 32);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
    fence_operand(d);
    fence_frags(cur);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] -= d[i];
    if (t == 0) mbar_arrive(empty + 8 * s);
}

template <int PASSES, typename Init>
__global__ void __launch_bounds__(NTHREADS, 1)
schur_tc_kernel(const __grid_constant__ CUtensorMap map, Init init,
                float* __restrict__ out, long long size, long long h,
                long long tile)
{
    using C = Cfg<PASSES>;
    extern __shared__ unsigned char smem_raw[];
    // the stages 1024-byte aligned, as the 128-byte swizzle needs
    const uint32_t raw = smem_u32(smem_raw);
    unsigned char* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
    const uint32_t base = smem_u32(smem);
    const uint32_t full = base + C::STAGES * C::STAGE;
    const uint32_t empty = full + 8 * C::STAGES;

    long long r0, c0;
    lower_tile(blockIdx.x, tile, BM, r0, c0);
    const int nk = (int)((h + BK - 1) / BK);
    const int wg = threadIdx.x / WG, t = threadIdx.x % WG;

    if (threadIdx.x == 0) {
        for (int s = 0; s < C::STAGES; ++s) {
            mbar_init(full + 8 * s, 1);
            mbar_init(empty + 8 * s, NCONS);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    if (wg == NCONS) {
        // the producer
        asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
        if (t == 0) {
            for (int it = 0; it < nk; ++it) {
                const int s = it % C::STAGES;
                mbar_wait(empty + 8 * s, ((it / C::STAGES) & 1) ^ 1);
                mbar_expect_tx(full + 8 * s, 2 * TILE);
                const uint32_t dst = base + s * C::STAGE;
                tma_load(dst, &map, it * BK, (int)r0, full + 8 * s);
                tma_load(dst + TILE, &map, it * BK, (int)c0, full + 8 * s);
            }
        }
    } else {
        // the consumers: warpgroup wg owns output rows [64 wg, 64 wg + 64)
        asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
        const int warp = t / 32, lane = t % 32;
        // accumulator i holds entry (row + 8 ((i >> 1) & 1),
        // col + 8 (i >> 2) + (i & 1)) of the wgmma fragment
        const long long row = r0 + wg * 64 + warp * 16 + lane / 4;
        const long long col = c0 + 2 * (lane % 4);
        float acc[64], d[64];
#pragma unroll
        for (int i = 0; i < 64; ++i) {
            acc[i] = init(row + 8 * ((i >> 1) & 1), col + 8 * (i >> 2) + (i & 1));
            d[i] = 0.f;
        }
        Frags<PASSES> f0, f1;
        if (nk > 0) {
            mbar_wait(full, 0);
            split_cols<PASSES>(smem, wg, t);
            load_rows<PASSES>(f0, smem, wg, warp, lane);
        }
        // two stages per trip, so that each fragment set keeps its
        // registers
        for (int it = 0; it < nk; it += 2) {
            consume<PASSES>(it, nk, acc, d, f0, f1, smem, full, empty, wg, t);
            if (it + 1 < nk)
                consume<PASSES>(it + 1, nk, acc, d, f1, f0, smem, full,
                                empty, wg, t);
        }
#pragma unroll
        for (int i = 0; i < 64; i += 2) {
            const long long rr = row + 8 * ((i >> 1) & 1);
            const long long cc = col + 8 * (i >> 2);
            *reinterpret_cast<float2*>(out + rr * size + cc) =
                make_float2(acc[i], acc[i + 1]);
        }
    }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder()
{
    static EncodeTiled fn = nullptr;
    if (!fn) {
        void* p = nullptr;
        cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q);
#else
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q);
#endif
        if (q == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
    }
    return fn;
}

template <int PASSES, typename Init>
int launch_tc(Init init, const float* A, long long h, float* out,
              long long size, long long tile, void* stream)
{
    if (size == 0) return 0;
    if (tile % BM || size % tile) return (int)cudaErrorInvalidValue;
    CUtensorMap map = {};
    if (h > 0) {
        if (h % 4 || (uintptr_t)A % 16) return (int)cudaErrorInvalidValue;
        const EncodeTiled encode = encoder();
        if (!encode) return (int)cudaErrorNotSupported;
        const cuuint64_t dims[2] = {(cuuint64_t)h, (cuuint64_t)size};
        const cuuint64_t strides[1] = {(cuuint64_t)h * 4};
        const cuuint32_t box[2] = {BK, BM}, estr[2] = {1, 1};
        if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, (void*)A, dims,
                   strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                   CU_TENSOR_MAP_SWIZZLE_128B,
                   CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                   CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
            return (int)cudaErrorInvalidValue;
    }
    auto kernel = schur_tc_kernel<PASSES, Init>;
    static bool sized = false;
    if (!sized) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            Cfg<PASSES>::SMEM);
        if (e != cudaSuccess) return (int)e;
        sized = true;
    }
    const unsigned nb = (unsigned)lower_tiles(size, tile, BM);
    kernel<<<nb, NTHREADS, Cfg<PASSES>::SMEM, (cudaStream_t)stream>>>(
        map, init, out, size, h, tile);
    return (int)cudaGetLastError();
}

template <typename Init>
int launch_passes(int passes, Init init, const float* A, long long h,
                  float* out, long long size, long long tile, void* stream)
{
    if (passes == 3)
        return launch_tc<3>(init, A, h, out, size, tile, stream);
    if (passes == 1)
        return launch_tc<1>(init, A, h, out, size, tile, stream);
    return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

int lsq_schur_update_tc_f32(const float* B, long long ldb, long long offset,
                            const float* s, const float* eps,
                            long long nreal, const float* A, long long h,
                            float* out, long long size, long long tile,
                            int passes, void* stream)
{
    return launch_passes(passes,
                         InitScaled<float>{B, ldb, offset, s, eps, nreal}, A,
                         h, out, size, tile, stream);
}

int lsq_schur_gram_tc_f32(const float* X, int dim, const float* params,
                          int nterms, unsigned long long codes,
                          int with_eps, long long nreal, long long offset,
                          const float* A, long long h, float* out,
                          long long size, long long tile,
                          const void* const* tabs, int passes, void* stream)
{
    if (nterms < 1 || nterms > MAXTERMS)
        return (int)cudaErrorInvalidValue;
    return launch_passes(passes,
                         InitGram<float>{X, dim, params, nterms, codes,
                                         with_eps, nreal, offset,
                                         host_tabs(tabs)},
                         A, h, out, size, tile, stream);
}

}  // extern "C"
