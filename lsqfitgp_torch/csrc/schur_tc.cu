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
//   precision='high': 3xTF32 (schur_tc3_kernel), a = hi + lo with
//     hi = rna(a) and lo = rna(a - hi) in TF32, products hi.hi + hi.lo +
//     lo.hi (the lo.lo term, < 2^-22 |a b|, is dropped): about 2^-21
//     relative per product, finer than bf16_3x's 2^-16;
//   precision='default': 1xTF32 (schur_tc1_kernel), one pass of rna(a),
//     2^-10 relative per product (JAX's DEFAULT is one bf16 pass).
//
// Bound on the H100: the products, at 495 TFLOP/s of TF32 divided by the
// pass count (165 TFLOP/s of useful work for 3xTF32, 2.5x the 67 TFLOP/s
// that bounds the SIMT kernel).  What both kernels share:
// - wgmma.mma_async m64n128k8 .tf32.  out[r, c] = sum_k A[r, k] A[c, k]
//   reads the row tile and the column tile straight from the rows of the
//   row-major A (size, h): both are K-major, as wgmma's 32-bit operands
//   must be, and no transposed copy exists.
// - Blocks of three warpgroups: the third loads, with TMA
//   (cp.async.bulk.tensor, mbarrier completion), the row and column tiles
//   into a ring of shared-memory stages of 32 k-columns (one 128-byte
//   swizzle row of float32); two consumer warpgroups issue the products.
//   setmaxnreg moves registers from the loading warpgroup to the
//   consumers.
// - The rounding to TF32 happens after the load, with no device memory
//   (a rounded copy of A would cost size h 4 bytes, 4 GiB at kernel D's
//   largest update).  wgmma reads only the top 19 bits of each word, so
//   each factor is rounded explicitly (cvt.rna).  The row tile goes to
//   registers (wgmma's A operand may live there): each warpgroup loads
//   its rows from the swizzled stage and rounds them in registers.  The
//   column tile, which wgmma reads from shared memory, is rounded there
//   in place.
// - A's rows must be 16-byte aligned (h % 4 == 0); the k tail past h and
//   the rows past size are zero-filled by the TMA unit.  The TMA
//   descriptor comes from the driver's cuTensorMapEncodeTiled, found with
//   cudaGetDriverEntryPoint, so the library needs no link to libcuda.
// Nothing is allocated and no library routine is called.
//
// schur_tc3_kernel (3xTF32): a 128 x 128 output tile per block, 64 rows
// a consumer warpgroup, 4 stages.
// - Each warpgroup splits its half of the stage's column tile in shared
//   memory (hi in place, lo beside it), then a named barrier joins the
//   two; the row fragments are split in registers.  The next stage is
//   split and loaded while a stage's products run; two register sets of
//   row fragments alternate.
// - The tensor cores sum in fp32 but not with IEEE round-to-nearest
//   (their sums lose low bits toward zero, as published measurements of
//   earlier NVIDIA tensor cores found).  One wgmma accumulator over the
//   whole k-loop biased the diagonal of A A^T, all of whose terms are
//   positive: at 3 passes and size = h = 8192 every diagonal entry was
//   outside the smoke's tolerance of about 2^-15.5 relative (PERF.md).
//   So each stage's products start from zero in the wgmma accumulator and
//   are then subtracted from a separate register accumulator with IEEE
//   rounding; that accumulator starts from init(r, c), as the SIMT
//   kernel's does.
// - The work list holds the 128 x 128 lower tiles (schur_init.cuh), one
//   block each.
//
// schur_tc1_kernel (1xTF32): the 3-pass design at one pass ran at 0.35 of
// its bound, slower than cuBLAS's TF32 product of the full square (H100
// 80GB HBM3, 700 W; PERF.md).  A stage of a 128 x 128 tile moves about
// 80 KiB through shared memory (the column tile read by both warpgroups'
// products, read and written by its rounding, the row fragments) in the
// 512 cycles of its products at one pass, where shared memory carries
// 128 bytes a cycle; and each stage drained its products (wait_group 0)
// and added them into the IEEE accumulator before the next could issue.
// So:
// - One wgmma accumulator over the whole k-loop, and init(r, c) - sum
//   formed once, with IEEE rounding, at the end.  At one pass the
//   tolerance is 2^-10 relative; the truncating sums' bias, about 2^-24
//   relative per k8 product, is h / 8 2^-24 at most: 2^-14 at kernel A's
//   h = 8192, 2^-12 at D's h = 32768 (the smoke prints the diagonal's
//   mean bias: +2^-14.3 and +2^-12.2 on an H100 80GB HBM3 at 700.00 W).
// - A 256 x 128 output tile per block: each consumer warpgroup owns 128
//   rows as two m64n128 accumulators (128 registers).  A stage is 48 KiB
//   from L2 for 2 MFLOP (3/4 of the 128 x 128 tile's bytes a flop) and
//   about 128 KiB through shared memory in its 1024 cycles of products.
// - The products pipelined: wait_group 1 keeps one stage's products in
//   flight while the next stage's fragments are loaded and its products
//   issued.  Two register sets of row fragments alternate.
// - The loading warpgroup's three other warps round the column tile in
//   shared memory and signal a barrier per slot (ready), so the
//   consumers neither split nor meet at a named barrier in the k-loop.
// - The card showed the loads' and the rounding's latency to bound it (H100
//   80GB HBM3, 700.00 W: 3 stages of 48 KiB ran 1.15-1.3 times slower than 4;
//   without the rounding it ran 1.15-1.2 times faster).  So the row tiles and
//   the column tiles have rings of their own: a row slot (32 KiB) is freed as
//   soon as the consumers hold its fragments, a column slot (16 KiB) when its
//   products are done, and 4 row slots beside 5 column slots keep more loads
//   in flight in the same shared memory than 4 stages of both.
// - The work list (band_tile): the 256 x 128 tiles that hold one of the
//   caller's lower 128 x 128 tiles, in bands of BAND row pairs numbered
//   column by column, so that the blocks in flight at once share rows and
//   columns within a few launches of each other: kernel D's update of a
//   32768-row A ran 1.3 times faster with bands of 2 row pairs than of 16 (L2
//   reuse; H100 80GB HBM3, 700.00 W).  A warpgroup whose 128 rows hold no
//   tile of the list (past size, or above the caller's tile diagonal where a
//   row pair crosses it) issues no products and stores nothing.
// - The epilogue stages the sums in the freed rings and writes init -
//   sum row by row with 16-byte stores, reading init (B, or the Gram's
//   points) along rows.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "schur_init.cuh"

namespace {

using namespace lsq;

constexpr int BM = 128;                  // tile edge (3 passes), columns
constexpr int BK = 32;                   // k per stage
constexpr int WG = 128;                  // threads of a warpgroup
constexpr int NCONS = 2;                 // consumer warpgroups
constexpr int NTHREADS = (NCONS + 1) * WG;
constexpr int TILE = BM * BK * 4;        // one 128-row operand tile of a stage

// 3 passes: a stage holds the row tile as loaded, the column tile (hi
// after the split) and the column tile's lo part
constexpr int STAGE3 = 3 * TILE;
constexpr int STAGES3 = 4;
constexpr int SMEM3 = STAGES3 * STAGE3 + 2 * STAGES3 * 8 + 1024;
constexpr int HALF4 = TILE / 2 / 16;     // float4s of a warpgroup's half

// 1 pass: a ring of 256-row tiles, each slot freed once the consumers
// hold its rows in registers, and a deeper ring of column tiles, each
// slot held until its products are done
constexpr int BR1 = 2 * BM;              // rows of the output tile
constexpr int RTILE = 2 * TILE;          // a stage's 256-row tile
constexpr int RSLOTS = 4;
constexpr int CSLOTS = 5;
constexpr int RING1 = RSLOTS * RTILE + CSLOTS * TILE;
constexpr int SMEM1 = RING1 + 8 * (2 * RSLOTS + 3 * CSLOTS) + 1024;
constexpr int NROUND = 3;                // warps rounding the column tile
constexpr int PITCH1 = BM + 8;           // epilogue staging row, in floats
constexpr int BAND = 2;                  // row pairs a band of the work list
static_assert(BR1 * PITCH1 * 4 <= RING1,
              "the epilogue's staging fits in the rings");

// A warpgroup's 64-row operand of one stage, in registers, in wgmma's
// A-fragment layout: for k-step kk, entry j of this thread is row
// 16 warp + lane / 4 + 8 (j & 1), column 8 kk + lane % 4 + 4 (j >> 1)
// of the 64 rows.  3 passes: hi = rna(a), lo = rna(a - hi).
struct Frags3 {
    uint32_t hi[BK / 8][4];
    uint32_t lo[BK / 8][4];
};

// 1 pass: rna(a) of the warpgroup's two 64-row blocks
struct Frags1 {
    uint32_t a[2][BK / 8][4];
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
                                         int k0, long long row0, uint32_t bar)
{
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::"
        "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];" ::"r"(dst),
        "l"((uint64_t)map), "r"(k0), "r"((int)row0), "r"(bar)
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

__device__ __forceinline__ float4 tf32_rna4(float4 v)
{
    return make_float4(tf32_rna(v.x), tf32_rna(v.y), tf32_rna(v.z),
                       tf32_rna(v.w));
}

__device__ __forceinline__ void fence_operand(float (&d)[64])
{
#pragma unroll
    for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void fence_regs(uint32_t (&r)[BK / 8][4])
{
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j)
            asm volatile("" : "+r"(r[kk][j])::"memory");
}

__device__ __forceinline__ void wgmma_fence()
{
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit()
{
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait()
{
    asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
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

// Entry (r, k) of a stage's row tile as loaded (128-byte swizzled: the
// 16-byte chunk c of row r sits at chunk c ^ (r % 8)), for r % 8 == g
__device__ __forceinline__ float swizzled(const unsigned char* tile, int r,
                                          int k, int g)
{
    return *reinterpret_cast<const float*>(
        tile + r * 128 + (((k >> 2) ^ g) << 4) + ((k & 3) << 2));
}

// -- 3 passes ----------------------------------------------------------------

__device__ __forceinline__ void fence_frags(Frags3& f)
{
    fence_regs(f.hi);
    fence_regs(f.lo);
}

// Round this warpgroup's half of the stage's column tile to TF32 in
// place and write the rounded remainders into the stage's lo tile (the
// same swizzled layout); then make the tile visible to the tensor cores
// and join the other consumer warpgroup.
__device__ __forceinline__ void split_cols(unsigned char* stage, int wg,
                                           int t)
{
    float4* hi = reinterpret_cast<float4*>(stage + TILE) + wg * HALF4;
    float4* lo = reinterpret_cast<float4*>(stage + 2 * TILE) + wg * HALF4;
#pragma unroll
    for (int j = 0; j < HALF4 / WG; ++j) {
        const int i = t + WG * j;
        const float4 v = hi[i];
        const float4 h = tf32_rna4(v);
        hi[i] = h;
        lo[i] = make_float4(tf32_rna(v.x - h.x), tf32_rna(v.y - h.y),
                            tf32_rna(v.z - h.z), tf32_rna(v.w - h.w));
    }
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync 1, %0;" ::"n"(NCONS * WG) : "memory");
}

// Load this warpgroup's 64 rows of the stage's row tile into registers
// and split them.
__device__ __forceinline__ void load_rows(Frags3& f,
                                          const unsigned char* stage, int wg,
                                          int warp, int lane)
{
    const int g = lane / 4, tig = lane % 4;
    const int r0 = wg * 64 + warp * 16 + g;    // r0 % 8 == g
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const float a = swizzled(stage, r0 + 8 * (j & 1),
                                     8 * kk + tig + 4 * (j >> 1), g);
            const float h = tf32_rna(a);
            f.hi[kk][j] = __float_as_uint(h);
            f.lo[kk][j] = __float_as_uint(tf32_rna(a - h));
        }
}

// Issue one stage's products into d (which starts from zero): the small
// terms lo.hi and hi.lo first, then hi.hi.
__device__ __forceinline__ void stage_products(float (&d)[64],
                                               const Frags3& f,
                                               uint32_t stage)
{
    const uint32_t c = stage + TILE;
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk)
        wgmma_tf32_rs(d, f.lo[kk], sw128_desc(c + kk * 32), kk > 0);
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk)
        wgmma_tf32_rs(d, f.hi[kk], sw128_desc(c + TILE + kk * 32), 1);
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk)
        wgmma_tf32_rs(d, f.hi[kk], sw128_desc(c + kk * 32), 1);
}

// One stage of a consumer warpgroup: issue its products from the
// fragments `cur`, split and load the next stage into `next` while they
// run, then add them into acc with IEEE rounding and release the stage.
__device__ __forceinline__ void consume(int it, int nk, float (&acc)[64],
                                        float (&d)[64], Frags3& cur,
                                        Frags3& next, unsigned char* smem,
                                        uint32_t full, uint32_t empty, int wg,
                                        int t)
{
    const int s = it % STAGES3;
    fence_operand(d);
    fence_frags(cur);
    wgmma_fence();
    stage_products(d, cur, smem_u32(smem + s * STAGE3));
    wgmma_commit();
    if (it + 1 < nk) {
        const int s1 = (it + 1) % STAGES3;
        mbar_wait(full + 8 * s1, ((it + 1) / STAGES3) & 1);
        split_cols(smem + s1 * STAGE3, wg, t);
        load_rows(next, smem + s1 * STAGE3, wg, t / 32, t % 32);
    }
    wgmma_wait<0>();
    fence_operand(d);
    fence_frags(cur);
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] -= d[i];
    if (t == 0) mbar_arrive(empty + 8 * s);
}

template <typename Init>
__global__ void __launch_bounds__(NTHREADS, 1)
schur_tc3_kernel(const __grid_constant__ CUtensorMap map, Init init,
                 float* __restrict__ out, long long size, long long h,
                 long long tile)
{
    extern __shared__ unsigned char smem_raw[];
    // the stages 1024-byte aligned, as the 128-byte swizzle needs
    const uint32_t raw = smem_u32(smem_raw);
    unsigned char* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
    const uint32_t base = smem_u32(smem);
    const uint32_t full = base + STAGES3 * STAGE3;
    const uint32_t empty = full + 8 * STAGES3;

    long long r0, c0;
    lower_tile(blockIdx.x, tile, BM, r0, c0);
    const int nk = (int)((h + BK - 1) / BK);
    const int wg = threadIdx.x / WG, t = threadIdx.x % WG;

    if (threadIdx.x == 0) {
        for (int s = 0; s < STAGES3; ++s) {
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
                const int s = it % STAGES3;
                mbar_wait(empty + 8 * s, ((it / STAGES3) & 1) ^ 1);
                mbar_expect_tx(full + 8 * s, 2 * TILE);
                const uint32_t dst = base + s * STAGE3;
                tma_load(dst, &map, it * BK, r0, full + 8 * s);
                tma_load(dst + TILE, &map, it * BK, c0, full + 8 * s);
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
            acc[i] = init(row + 8 * ((i >> 1) & 1),
                          col + 8 * (i >> 2) + (i & 1));
            d[i] = 0.f;
        }
        Frags3 f0, f1;
        if (nk > 0) {
            mbar_wait(full, 0);
            split_cols(smem, wg, t);
            load_rows(f0, smem, wg, warp, lane);
        }
        // two stages per trip, so that each fragment set keeps its
        // registers
        for (int it = 0; it < nk; it += 2) {
            consume(it, nk, acc, d, f0, f1, smem, full, empty, wg, t);
            if (it + 1 < nk)
                consume(it + 1, nk, acc, d, f1, f0, smem, full, empty, wg, t);
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

// -- 1 pass ------------------------------------------------------------------

// The columns of 128 that row pair R (rows [256 R, +256)) takes in the
// work list: the 128 x 128 tile (i, c) is the caller's (a lower tile of
// edge `tile` = 128 t) when i < n128 = size / 128 and i / t >= c / t, so
// the pair's lower row i = min(2 R + 1, n128 - 1) takes c < (i / t + 1) t
__host__ __device__ __forceinline__ int pair_cols(int R, int n128, int t)
{
    const int i = 2 * R + 1 < n128 ? 2 * R + 1 : n128 - 1;
    return (i / t + 1) * t;
}

// the work list's length: the 256 x 128 tiles over all row pairs
inline long long band_tiles(long long size, long long tile)
{
    const int n128 = (int)(size / BM), t = (int)(tile / BM);
    long long n = 0;
    for (int R = 0; R < (n128 + 1) / 2; ++R) n += pair_cols(R, n128, t);
    return n;
}

// Block b's tile (R, C) of the work list: the row pairs in bands of BAND,
// band by band; in a band, column by column, the pairs that take the
// column in order.  pair_cols grows with R, so the columns
// [pair_cols(j - 1), pair_cols(j)) are taken by the band's pairs from j
// on.
__device__ __forceinline__ void band_tile(int b, int n128, int t, int& R,
                                          int& C)
{
    const int npair = (n128 + 1) / 2;
    int r0 = 0, r1;
    for (;;) {
        r1 = min(r0 + BAND, npair);
        int n = 0;
        for (int r = r0; r < r1; ++r) n += pair_cols(r, n128, t);
        if (b < n) break;
        b -= n;
        r0 = r1;
    }
    int c = 0;
    for (int j = r0; j < r1; ++j) {
        const int ce = pair_cols(j, n128, t), k = r1 - j;
        if (b < (ce - c) * k) {
            C = c + b / k;
            R = j + b % k;
            return;
        }
        b -= (ce - c) * k;
        c = ce;
    }
    R = C = 0;    // not reached for b within the list
}

// Load and round this warpgroup's 128 rows of the stage's row tile.
__device__ __forceinline__ void load_rows1(Frags1& f,
                                           const unsigned char* stage, int wg,
                                           int warp, int lane)
{
    const int g = lane / 4, tig = lane % 4;
#pragma unroll
    for (int b = 0; b < 2; ++b) {
        const int r0 = wg * 128 + b * 64 + warp * 16 + g;   // r0 % 8 == g
#pragma unroll
        for (int kk = 0; kk < BK / 8; ++kk)
#pragma unroll
            for (int j = 0; j < 4; ++j)
                f.a[b][kk][j] = __float_as_uint(tf32_rna(swizzled(
                    stage, r0 + 8 * (j & 1), 8 * kk + tig + 4 * (j >> 1),
                    g)));
    }
}

// One stage of a consumer warpgroup: wait for the rows and the rounded
// column tile, load and round the rows into `cur` and free their slot
// (a warp's loads done, its lane 0 arrives), issue the products, then
// wait for the previous stage's products (whose fragments are `prev`)
// and free that stage's column slot.  An inactive warpgroup only keeps
// the barriers' counts.
__device__ __forceinline__ void mma_stage(int it, float (&d)[2][64],
                                          Frags1& cur, Frags1& prev,
                                          const unsigned char* rows,
                                          uint32_t cols, uint32_t bars,
                                          int wg, int t, bool active)
{
    const int sr = it % RSLOTS, sc = it % CSLOTS;
    // the kernel's barriers from bars: rfull, rempty, cfull, ready, cempty
    const uint32_t rfull = bars, rempty = rfull + 8 * RSLOTS,
                   ready = rempty + 8 * (RSLOTS + CSLOTS),
                   cempty = ready + 8 * CSLOTS;
    mbar_wait(rfull + 8 * sr, (it / RSLOTS) & 1);
    mbar_wait(ready + 8 * sc, (it / CSLOTS) & 1);
    if (active) load_rows1(cur, rows + sr * RTILE, wg, t / 32, t % 32);
    __syncwarp();
    if (t % 32 == 0) mbar_arrive(rempty + 8 * sr);
    if (active) {
        fence_operand(d[0]);
        fence_operand(d[1]);
        wgmma_fence();
        const uint32_t c = cols + sc * TILE;
#pragma unroll
        for (int kk = 0; kk < BK / 8; ++kk)
#pragma unroll
            for (int b = 0; b < 2; ++b)
                wgmma_tf32_rs(d[b], cur.a[b][kk], sw128_desc(c + kk * 32),
                              1);
        wgmma_commit();
        wgmma_wait<1>();
        fence_operand(d[0]);
        fence_operand(d[1]);
#pragma unroll
        for (int b = 0; b < 2; ++b) fence_regs(prev.a[b]);
    }
    if (it > 0 && t == 0)
        mbar_arrive(cempty + 8 * ((it - 1) % CSLOTS));
}

template <typename Init>
__global__ void __launch_bounds__(NTHREADS, 1)
schur_tc1_kernel(const __grid_constant__ CUtensorMap map, Init init,
                 float* __restrict__ out, long long size, long long h,
                 long long tile)
{
    extern __shared__ unsigned char smem_raw[];
    const uint32_t raw = smem_u32(smem_raw);
    unsigned char* smem = smem_raw + (((raw + 1023) & ~1023u) - raw);
    // the row ring, the column ring, then the barriers: a row slot's
    // full and empty, a column slot's full, ready (rounded) and empty
    const uint32_t rows = smem_u32(smem), cols = rows + RSLOTS * RTILE;
    const uint32_t rfull = rows + RING1, rempty = rfull + 8 * RSLOTS,
                   cfull = rempty + 8 * RSLOTS, ready = cfull + 8 * CSLOTS,
                   cempty = ready + 8 * CSLOTS;

    const int n128 = (int)(size / BM), tb = (int)(tile / BM);
    int R, C;
    band_tile((int)blockIdx.x, n128, tb, R, C);
    const long long r0 = (long long)R * BR1, c0 = (long long)C * BM;
    const int nk = (int)((h + BK - 1) / BK);
    const int wg = threadIdx.x / WG, t = threadIdx.x % WG;
    const int warp = t / 32, lane = t % 32;

    if (threadIdx.x == 0) {
        for (int s = 0; s < RSLOTS; ++s) {
            mbar_init(rfull + 8 * s, 1);
            mbar_init(rempty + 8 * s, NCONS * WG / 32);
        }
        for (int s = 0; s < CSLOTS; ++s) {
            mbar_init(cfull + 8 * s, 1);
            mbar_init(ready + 8 * s, 32 * NROUND);
            mbar_init(cempty + 8 * s, NCONS);
        }
        asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    __syncthreads();

    if (wg == NCONS) {
        asm volatile("setmaxnreg.dec.sync.aligned.u32 40;" ::: "memory");
        if (warp == 0) {
            // the producer: the row tile's two boxes, then the column tile
            if (lane == 0) {
                for (int it = 0; it < nk; ++it) {
                    const int sr = it % RSLOTS, sc = it % CSLOTS;
                    mbar_wait(rempty + 8 * sr, ((it / RSLOTS) & 1) ^ 1);
                    mbar_expect_tx(rfull + 8 * sr, RTILE);
                    tma_load(rows + sr * RTILE, &map, it * BK, r0,
                             rfull + 8 * sr);
                    tma_load(rows + sr * RTILE + TILE, &map, it * BK,
                             r0 + BM, rfull + 8 * sr);
                    mbar_wait(cempty + 8 * sc, ((it / CSLOTS) & 1) ^ 1);
                    mbar_expect_tx(cfull + 8 * sc, TILE);
                    tma_load(cols + sc * TILE, &map, it * BK, c0,
                             cfull + 8 * sc);
                }
            }
        } else {
            // the rounders: the column tile to TF32 in place, four 16-byte
            // loads in flight a thread, then made visible to the tensor
            // cores
            constexpr int STEP = 32 * NROUND, PER = TILE / 16;
            for (int it = 0; it < nk; ++it) {
                const int sc = it % CSLOTS;
                mbar_wait(cfull + 8 * sc, (it / CSLOTS) & 1);
                float4* col = reinterpret_cast<float4*>(
                    smem + RSLOTS * RTILE + sc * TILE);
                for (int i0 = t - 32; i0 < PER; i0 += 4 * STEP) {
                    float4 v[4];
#pragma unroll
                    for (int j = 0; j < 4; ++j)
                        if (i0 + j * STEP < PER) v[j] = col[i0 + j * STEP];
#pragma unroll
                    for (int j = 0; j < 4; ++j)
                        if (i0 + j * STEP < PER)
                            col[i0 + j * STEP] = tf32_rna4(v[j]);
                }
                asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
                mbar_arrive(ready + 8 * sc);
            }
        }
        return;
    }

    // the consumers: warpgroup wg owns output rows [128 wg, 128 wg + 128)
    // of the tile, the 128 x 128 tile (2 R + wg, C) of the caller's grid
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;" ::: "memory");
    const int i128 = 2 * R + wg;
    const bool active = i128 < n128 && i128 / tb >= C / tb;
    float d[2][64];
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
        for (int i = 0; i < 64; ++i) d[b][i] = 0.f;
    Frags1 f0, f1;
    // two stages per trip, so that each fragment set keeps its registers
    for (int it = 0; it < nk; it += 2) {
        mma_stage(it, d, f0, f1, smem, cols, rfull, wg, t, active);
        if (it + 1 < nk)
            mma_stage(it + 1, d, f1, f0, smem, cols, rfull, wg, t, active);
    }
    wgmma_wait<0>();
    fence_operand(d[0]);
    fence_operand(d[1]);
#pragma unroll
    for (int b = 0; b < 2; ++b) {
        fence_regs(f0.a[b]);
        fence_regs(f1.a[b]);
    }

    // the epilogue: both warpgroups are done with the rings, which now
    // stage each warpgroup's sums, accumulator entry i of block b at row
    // 64 b + 16 warp + lane / 4 + 8 ((i >> 1) & 1), column 8 (i >> 2) +
    // 2 (lane % 4) + (i & 1) of its rows
    asm volatile("bar.sync 1, %0;" ::"n"(NCONS * WG) : "memory");
    if (!active) return;
    float* sums = reinterpret_cast<float*>(smem) + wg * BM * PITCH1;
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
        for (int i = 0; i < 64; i += 2) {
            const int r = b * 64 + warp * 16 + lane / 4 + 8 * ((i >> 1) & 1);
            const int c = 8 * (i >> 2) + 2 * (lane % 4);
            *reinterpret_cast<float2*>(sums + r * PITCH1 + c) =
                make_float2(d[b][i], d[b][i + 1]);
        }
    asm volatile("bar.sync %0, %1;" ::"r"(2 + wg), "n"(WG) : "memory");
    // a warp's row at a time: 16 bytes a lane, init read along the row
    const long long rw = r0 + wg * BM, c = c0 + 4 * lane;
    for (int r = warp; r < BM; r += WG / 32) {
        const float4 s = *reinterpret_cast<const float4*>(
            sums + r * PITCH1 + 4 * lane);
        *reinterpret_cast<float4*>(out + (rw + r) * size + c) = make_float4(
            init(rw + r, c) - s.x, init(rw + r, c + 1) - s.y,
            init(rw + r, c + 2) - s.z, init(rw + r, c + 3) - s.w);
    }
}

// -- launch ------------------------------------------------------------------

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

// A's rows as a 2-D tensor of boxes of BK columns and BM rows
int encode_rows(CUtensorMap* map, const float* A, long long h,
                long long size)
{
    if (h % 4 || (uintptr_t)A % 16) return (int)cudaErrorInvalidValue;
    const EncodeTiled encode = encoder();
    if (!encode) return (int)cudaErrorNotSupported;
    const cuuint64_t dims[2] = {(cuuint64_t)h, (cuuint64_t)size};
    const cuuint64_t strides[1] = {(cuuint64_t)h * 4};
    const cuuint32_t box[2] = {BK, BM}, estr[2] = {1, 1};
    if (encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, (void*)A, dims,
               strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
               CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
        return (int)cudaErrorInvalidValue;
    return 0;
}

// the kernel's shared memory above 48 KiB, asked for at its first launch
template <typename Kernel>
int sized(Kernel kernel, int smem, bool& done)
{
    if (!done) {
        const cudaError_t e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return (int)e;
        done = true;
    }
    return 0;
}

template <typename Init>
int launch_passes(int passes, Init init, const float* A, long long h,
                  float* out, long long size, long long tile, void* stream)
{
    if (passes != 1 && passes != 3) return (int)cudaErrorInvalidValue;
    if (size == 0) return 0;
    if (tile % BM || size % tile) return (int)cudaErrorInvalidValue;
    CUtensorMap map = {};
    if (h > 0) {
        if (const int e = encode_rows(&map, A, h, size)) return e;
    }
    const auto s = (cudaStream_t)stream;
    if (passes == 3) {
        static bool done = false;
        auto kernel = schur_tc3_kernel<Init>;
        if (const int e = sized(kernel, SMEM3, done)) return e;
        kernel<<<(unsigned)lower_tiles(size, tile, BM), NTHREADS, SMEM3, s>>>(
            map, init, out, size, h, tile);
    } else {
        static bool done = false;
        auto kernel = schur_tc1_kernel<Init>;
        if (const int e = sized(kernel, SMEM1, done)) return e;
        kernel<<<(unsigned)band_tiles(size, tile), NTHREADS, SMEM1, s>>>(
            map, init, out, size, h, tile);
    }
    return (int)cudaGetLastError();
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
