// Tiled Gram evaluators for isotropic kernels, and their fused backward
// passes (sm_90a).
//
// Kernel C, gram: K[i, j] = post(g(|x_i - y_j|^2)) (+ noise if i == j),
// replacing the TPU kernel lsqfitgp_tpu/ops/_gram.py::_gram_kernel; its
// backward, gram_bwd, replaces the JVP rule _gram_d_jvp, which evaluates
// the derivative weights with more Pallas calls and contracts them with
// the tangents in XLA.
//
// Kernel E, gram_sym: the same for y = x, evaluated on the upper tile
// pairs only, each block writing its tile and the mirrored tile,
// replacing lsqfitgp_tpu/ops/_gram.py::_gram_sym_kernel; its backward,
// gram_sym_bwd, replaces _gram_sym_d_jvp.
//
// Their tangents, for forward-mode and second-order derivatives:
// kernel C' (gram_jvp), the tangent Gram dK along (dx, dy) and the post
// chain's and nugget's tangents, the forward direction of _gram_d_jvp;
// kernel C'' (gram_bwd_jvp), the tangent of C's backward at a fixed
// output gradient G, which replaces JAX's second differentiation of the
// _elemgrad_* Pallas calls under jacfwd(grad); E' and E'' the same for
// y = x on E's upper tile pairs.
//
// Bounds on the H100: a forward writes the n x m output once and reuses
// nothing across tiles, so the write stream bounds it (plus one exp per
// entry, half of them in E); a backward reads the output gradient G
// once, so the read stream bounds it.
//
// Design.
// - The evaluator of the profile (profiles.cuh: FixedExpQuad, the main
//   path's single ExpQuad term, Zoo, up to MAXTERMS terms of the
//   closed-form profiles read at run time, or ZooSpecial, of any
//   registered profile) and p = 1 are template parameters; the folded
//   parameter vector (profiles.cuh) stays in device memory (no host
//   read).  This file builds the kernels of the first two, with the
//   entry points lsq_gram*_f32/_f64; gram_special.cu compiles it again
//   with LSQ_GRAM_SPECIAL for ZooSpecial's, with the entry points
//   lsq_gram*_zs_f32/_zs_f64, in an nvcc process of its own (the special
//   cores' code takes most of the build).
// - A block of 256 threads covers 64 x 64 tiles.  Each thread owns 16
//   bytes of a tile row (4 floats or 2 doubles): 16-byte stores in the
//   forwards, 16-byte loads of G in the backwards, entry by entry at the
//   ragged edge and where rows are not 16-byte aligned.  A p = 1 thread
//   keeps its column coordinates in registers; a row's coordinate is one
//   load for its lanes.
// - The forwards' stores are streaming (st.global.cs, evict-first): the
//   kernel never reads its output.  In a one-off probe on the H100 the
//   same kernels with plain stores wrote well below the card's write
//   rate whatever the tile shape (8 x 1024 to 64 x 64), and with
//   streaming stores at the rate of torch's own fill_.
// - E writes the mirror of a tile from a shared-memory copy read down its
//   columns (rows padded by one against bank conflicts), with the same
//   wide stores.  C and E evaluate each entry by the same expression and
//   r^2 is symmetric to the bit, so they write identical matrices.
// - A backward recomputes r^2, g and g' (one exponential) per entry and,
//   in one read of G, accumulates what the gradient needs: per row i and
//   coordinate d the sum over j of G_ij Wr_ij (x_i - y_j)_d, with
//   Wr = dK/dr^2, zero at r^2 <= 0 where the true tangent vanishes
//   (the x gradient); the same per column j (the y gradient); and the
//   gradient of <G, K> with respect to the parameter vector: the sum of
//   G (for b), G's trace (the nugget's), and per term the sums of G
//   times dK/dc, dK/dw, dK/da and dK/db (FixedExpQuad: G g only).  No floating-point atomics: row sums go across a row's
//   lanes by warp shuffles, column sums across the block's rows through
//   shared memory, the scalars by shuffles and shared memory, and each
//   block writes its partial sums to slots of its own in a scratch
//   buffer that the wrapper sums over the slots in a fixed order, so the
//   gradient is the same to the bit from run to run.  E's backward and
//   the tangent kernels take the coordinates in chunks of up to PCHUNK
//   per launch at p > 1, each entry reading its coordinates from
//   device memory.
// - C's backward block covers CROWS tiles down a column of tiles, which
//   cuts its column partial sums to n / 256 slots.
// - C and its backward at p > 1 stage a tile's row and column
//   coordinates in shared memory, SLAB coordinates at a time (so any p
//   fits), with coalesced loads; each thread sums r^2 for its RPT x V
//   entries in registers from broadcast row reads and one 16-byte
//   column read per coordinate, in sqdist's order (fma(dl, dl, r2) for
//   d = 0 .. p - 1), so C still writes E's entries to the bit.  That is
//   2 instructions per entry and coordinate: at p = 10 in float32 the
//   tile's instructions, not the 0.32 ms write stream at 16384^2, bound
//   it.  The backward makes one launch for all p, so G is read once: per
//   64-row step of its block it sums r^2 over the slabs, turns the
//   thread's entries into weights G Wr in registers, then sweeps the
//   slabs again (the last one staged first) for the row and column sums
//   of w (x_i - y_j)_d, 3 instructions per entry and coordinate, DG
//   coordinates at a time: rows across a row's lanes by a reduce-scatter
//   (each lane ends with one row's sum, in RPT x DG - 1 shuffles where a
//   sum per row would take RPT x DG x 4), columns across the block's rows
//   through shared memory into the block's slot, added over the block's
//   steps by the thread that owns the slot entry.
// - E's backward walks the upper tile pairs (I, J): it loads the mirror
//   tile G[J, I] into shared memory with coalesced rows and forms
//   S = G[I, J] + G[J, I]^T in registers (both of K's arguments are x).
//   A tile's row sums go to rows I and its column sums, negated, to rows
//   J, each into the slot of the other tile, so all of G is read once
//   and half of C's exponentials are taken.  A diagonal tile (its own
//   mirror, read once) takes row sums only, over the whole tile.
// - The tangent kernels are the forwards and the backwards with more
//   per entry: C' and E' also read the points' tangents (registers at
//   p = 1) and write dK with the forwards' stores, mirror and ragged
//   edge; C'' and E'' take g, g' and g'' from one exponential and sum,
//   with the backwards' slots and no atomics (two calls give the same
//   bits), G (dalpha g' + alpha g'' dr^2)(x_i - y_j) + G alpha g'
//   (dx_i - dy_j), and G g' dr^2, G and G g for the chain's.  The weights
//   are zero at r^2 <= 0, as the first derivative's.  C'' and E'' take
//   one term, whose coefficient alpha and its tangent come in
//   coef = [alpha, dalpha]; C' and E' the parameter vector's tangent,
//   every parameter of every term.

#include "profiles.cuh"

#ifndef LSQ_GRAM_SPECIAL
#define LSQ_GRAM_SPECIAL 0
#endif

namespace {

using namespace lsq;

constexpr int TILE = 64;    // tile edge
constexpr int NT = 256;     // threads per block
constexpr int PCHUNK = 4;   // coordinates per backward launch at p > 1
                            // (E's backward, C'', E'')
constexpr int CROWS = 4;    // tiles per block of C's backward
constexpr int SLAB = 16;    // coordinates staged at once (C at p > 1)
constexpr int DG = 2;       // coordinates per reduction (C's backward)

template <typename T>
struct Geo {
    static constexpr int V = 16 / sizeof(T);   // entries per 16 bytes
    static constexpr int TX = TILE / V;        // lanes along a tile row
    static constexpr int TY = NT / TX;         // tile rows per step
    static constexpr int RPT = TILE / TY;      // tile rows per thread
    // a staged coordinate's row of TILE points, padded against bank
    // conflicts while staging and 16-byte aligned
    static constexpr int PITCH = TILE + V;
};

// streaming (evict-first) stores: the output is not read again here
__device__ __forceinline__ void st16(float* p, const float* v)
{
    __stcs(reinterpret_cast<float4*>(p), make_float4(v[0], v[1], v[2], v[3]));
}

__device__ __forceinline__ void st16(double* p, const double* v)
{
    __stcs(reinterpret_cast<double2*>(p), make_double2(v[0], v[1]));
}

__device__ __forceinline__ void ld16(const float* p, float* v)
{
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
}

__device__ __forceinline__ void ld16(const double* p, double* v)
{
    const double2 t = __ldg(reinterpret_cast<const double2*>(p));
    v[0] = t.x;
    v[1] = t.y;
}

// v[0, V) into dst[0, left): one 16-byte store where the row allows it
template <typename T>
__device__ __forceinline__ void store_row(T* dst, const T* v, long long left,
                                          bool wide)
{
    constexpr int V = Geo<T>::V;
    if (wide && left >= V) {
        st16(dst, v);
        return;
    }
#pragma unroll
    for (int k = 0; k < V; ++k)
        if (k < left) __stcs(dst + k, v[k]);
}

// src[0, left) into v, zeros beyond
template <typename T>
__device__ __forceinline__ void load_row(const T* src, T* v, long long left,
                                         bool wide)
{
    constexpr int V = Geo<T>::V;
    if (wide && left >= V) {
        ld16(src, v);
        return;
    }
#pragma unroll
    for (int k = 0; k < V; ++k) v[k] = k < left ? src[k] : T(0);
}

// the sum over groups of W consecutive lanes (every lane gets it)
template <int W, typename T>
__device__ __forceinline__ T lane_sum(T v)
{
#pragma unroll
    for (int o = W / 2; o > 0; o >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, o);
    return v;
}

// Reduce-scatter over each group of 2 O consecutive lanes: v[0, C) summed
// over the group in a fixed order, lane l of the group ending with the
// sum of v[l / (2 O / C)] in v[0] (C a power of 2, at most 2 O).  Each
// step sends half of the sums a lane still holds to its partner and
// keeps the other half, then the last steps add whole.
template <int O, int C, typename T>
__device__ __forceinline__ void scatter_sum(T* v, int l)
{
    if constexpr (O > 0) {
        if constexpr (C > 1) {
            constexpr int H = C / 2;
            const bool up = (l & O) != 0;
#pragma unroll
            for (int i = 0; i < H; ++i) {
                const T send = up ? v[i] : v[i + H];
                const T keep = up ? v[i + H] : v[i];
                v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
            }
            scatter_sum<O / 2, H>(v, l);
        } else {
            v[0] += __shfl_xor_sync(0xffffffffu, v[0], O);
            scatter_sum<O / 2, 1>(v, l);
        }
    }
}

__device__ __forceinline__ void lds16(const float* p, float* v)
{
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
}

__device__ __forceinline__ void lds16(const double* p, double* v)
{
    const double2 t = *reinterpret_cast<const double2*>(p);
    v[0] = t.x;
    v[1] = t.y;
}

// Coordinates [d0, d0 + pc) of the TILE points z0, z0 + 1, ... of z (nz
// points of p coordinates) into s[d][i], zeros past nz: consecutive
// threads read consecutive addresses of the points' rows.  The point of
// element e is e / pc in float, (e + 1/2) (1 / pc) truncated: exact for
// e < TILE * SLAB, whose quotients lie at least 1 / (2 SLAB) from an
// integer, where an integer division per element would cost about 20
// instructions, a large share of a tile's work at p >= 10.
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ z, long long z0,
                                      long long nz, int p, int d0, int pc,
                                      T (*s)[Geo<T>::PITCH])
{
    const float rcp = 1.0f / pc;
    for (int e = threadIdx.x; e < TILE * pc; e += NT) {
        const int i = (int)(((float)e + 0.5f) * rcp);
        const int d = e - i * pc;
        const long long r = z0 + i;
        s[d][i] = r < nz ? z[r * p + d0 + d] : T(0);
    }
}

// r2[a][k] += the squares of the pc staged coordinates' differences for
// the thread's entries (rows ty + a TY, columns tx V + k of the staged
// tile), each fma(dl, dl, r2) in the coordinates' order, as sqdist sums
template <typename T>
__device__ __forceinline__ void add_r2(T (*xs)[Geo<T>::PITCH],
                                       T (*ys)[Geo<T>::PITCH], int pc,
                                       T (&r2)[Geo<T>::RPT][Geo<T>::V])
{
    using Gm = Geo<T>;
    const int tx = threadIdx.x % Gm::TX, ty = threadIdx.x / Gm::TX;
#pragma unroll 2
    for (int d = 0; d < pc; ++d) {
        T yv[Gm::V];
        lds16(&ys[d][tx * Gm::V], yv);
#pragma unroll
        for (int a = 0; a < Gm::RPT; ++a) {
            const T xr = xs[d][ty + a * Gm::TY];
#pragma unroll
            for (int k = 0; k < Gm::V; ++k) {
                const T dl = xr - yv[k];
                r2[a][k] = fma(dl, dl, r2[a][k]);
            }
        }
    }
}

// r^2 of the thread's entries of the tile at rows i0, columns j0, all
// p coordinates staged SLAB at a time through xs, ys; returns the
// number of slabs (the last one is left staged)
template <typename T>
__device__ __forceinline__ int tile_r2(const T* __restrict__ x,
                                       const T* __restrict__ y, long long n,
                                       long long m, int p, long long i0,
                                       long long j0, T (*xs)[Geo<T>::PITCH],
                                       T (*ys)[Geo<T>::PITCH],
                                       T (&r2)[Geo<T>::RPT][Geo<T>::V])
{
#pragma unroll
    for (int a = 0; a < Geo<T>::RPT; ++a)
#pragma unroll
        for (int k = 0; k < Geo<T>::V; ++k) r2[a][k] = T(0);
    int l = 0;
    for (int d0 = 0; d0 < p; d0 += SLAB, ++l) {
        const int pc = min(SLAB, p - d0);
        __syncthreads();   // the previous slab is read
        stage(x, i0, n, p, d0, pc, xs);
        stage(y, j0, m, p, d0, pc, ys);
        __syncthreads();
        add_r2(xs, ys, pc, r2);
    }
    return l;
}

// r^2 of entry (r, c): from the coordinates in registers at p = 1
template <typename T, bool P1>
__device__ __forceinline__ T dist2(const T* __restrict__ x,
                                   const T* __restrict__ y, long long r,
                                   long long c, int p, T xr, T yc)
{
    if constexpr (P1) {
        const T dl = xr - yc;
        return dl * dl;
    } else {
        return sqdist(x + r * p, y + c * p, p);
    }
}

// One entry of the value, plus the nugget on the global diagonal (C and
// E share it, so their entries are identical).
template <typename T, class Ev>
__device__ __forceinline__ T entry_value(const Ev& ev, T r2, bool on_diag,
                                         T noise)
{
    T v = ev.value(r2);
    if (on_diag) v += noise;
    return v;
}

// Upper tile pair b (row-major over the lower triangle, transposed):
// the first row and column of the tile, i0 <= j0.
__device__ __forceinline__ void upper_pair(long long b, long long& i0,
                                           long long& j0)
{
    long long ci = (long long)((sqrt(8.0 * (double)b + 1.0) - 1.0) * 0.5);
    while (ci * (ci + 1) / 2 > b) --ci;
    while ((ci + 1) * (ci + 2) / 2 <= b) ++ci;
    i0 = (b - ci * (ci + 1) / 2) * TILE;
    j0 = ci * TILE;
}

// -- forwards ----------------------------------------------------------------

template <typename T, class Ev, bool P1>
__global__ void __launch_bounds__(NT)
gram_kernel(const T* __restrict__ x, const T* __restrict__ y, long long n,
            long long m, int p, const T* __restrict__ params, int nterms,
            unsigned long long codes, int with_noise, T* __restrict__ out)
{
    using Gm = Geo<T>;
    constexpr int V = Gm::V;
    const int tx = threadIdx.x % Gm::TX, ty = threadIdx.x / Gm::TX;
    const long long i0 = (long long)blockIdx.y * TILE;
    const long long j0 = (long long)blockIdx.x * TILE;
    const long long c0 = j0 + tx * V;
    const Ev ev(params, nterms, codes);
    const bool diag = with_noise && i0 < j0 + TILE && j0 < i0 + TILE;
    const T noise = diag ? params[1] : T(0);
    const bool wide = m % V == 0;
    if constexpr (P1) {
        T yc[V];
#pragma unroll
        for (int k = 0; k < V; ++k) yc[k] = c0 + k < m ? y[c0 + k] : T(0);
#pragma unroll
        for (int a = 0; a < Gm::RPT; ++a) {
            const long long r = i0 + ty + a * Gm::TY;
            if (r >= n) break;
            const T xr = x[r];
            T v[V];
#pragma unroll
            for (int k = 0; k < V; ++k) {
                const long long c = c0 + k < m ? c0 + k : m - 1;
                const T r2 = dist2<T, true>(x, y, r, c, p, xr, yc[k]);
                v[k] = entry_value(ev, r2, diag && r == c0 + k, noise);
            }
            store_row(out + r * m + c0, v, m - c0, wide);
        }
    } else {
        __shared__ __align__(16) T xs[SLAB][Gm::PITCH], ys[SLAB][Gm::PITCH];
        T r2[Gm::RPT][V];
        tile_r2(x, y, n, m, p, i0, j0, xs, ys, r2);
#pragma unroll
        for (int a = 0; a < Gm::RPT; ++a) {
            const long long r = i0 + ty + a * Gm::TY;
            if (r >= n) break;
            T v[V];
#pragma unroll
            for (int k = 0; k < V; ++k)
                v[k] = entry_value(ev, r2[a][k], diag && r == c0 + k, noise);
            store_row(out + r * m + c0, v, m - c0, wide);
        }
    }
}

// E's forwards: at least 3 blocks per SM (85 registers a thread).  Left
// to itself ptxas gave the float64 p = 1 forward 64 registers and 464
// bytes of spills on the H100 build (0.67 -> 1.07 ms); E's 33 KB of
// shared memory allows 6 blocks.
template <typename T, class Ev, bool P1>
__global__ void __launch_bounds__(NT, 3)
gram_sym_kernel(const T* __restrict__ x, long long n, int p,
                const T* __restrict__ params, int nterms,
                unsigned long long codes, int with_noise, T* __restrict__ out)
{
    using Gm = Geo<T>;
    constexpr int V = Gm::V;
    __shared__ T sh[TILE][TILE + 1];
    long long i0, j0;
    upper_pair(blockIdx.x, i0, j0);
    const int tx = threadIdx.x % Gm::TX, ty = threadIdx.x / Gm::TX;
    const long long c0 = j0 + tx * V;
    const Ev ev(params, nterms, codes);
    const bool diag = i0 == j0;
    const T noise = diag && with_noise ? params[1] : T(0);
    const bool wide = n % V == 0;
    T yc[V];
#pragma unroll
    for (int k = 0; k < V; ++k)
        yc[k] = P1 && c0 + k < n ? x[c0 + k] : T(0);
#pragma unroll
    for (int a = 0; a < Gm::RPT; ++a) {
        const int rr = ty + a * Gm::TY;
        const long long r = i0 + rr;
        if (r >= n) break;
        const T xr = P1 ? x[r] : T(0);
        T v[V];
#pragma unroll
        for (int k = 0; k < V; ++k) {
            const long long c = c0 + k < n ? c0 + k : n - 1;
            const T r2 = dist2<T, P1>(x, x, r, c, p, xr, yc[k]);
            v[k] = entry_value(ev, r2, diag && with_noise && r == c0 + k,
                               noise);
            sh[rr][tx * V + k] = v[k];
        }
        store_row(out + r * n + c0, v, n - c0, wide);
    }
    if (diag) return;
    __syncthreads();
    // the mirror: rows j0.., columns i0.. take the tile transposed
    const long long cm = i0 + tx * V;
#pragma unroll
    for (int a = 0; a < Gm::RPT; ++a) {
        const int rr = ty + a * Gm::TY;
        const long long rm = j0 + rr;
        if (rm >= n) break;
        T v[V];
#pragma unroll
        for (int k = 0; k < V; ++k) v[k] = sh[tx * V + k][rr];
        store_row(out + rm * n + cm, v, n - cm, wide);
    }
}

// -- backwards ---------------------------------------------------------------

// The coordinates d0 + q (q < pc) of point i of z, zeros beyond.
template <typename T, int PC>
__device__ __forceinline__ void coords(const T* __restrict__ z, long long i,
                                       bool valid, int p, int d0, int pc,
                                       T* out)
{
#pragma unroll
    for (int q = 0; q < PC; ++q)
        out[q] = valid && q < pc ? z[i * p + d0 + q] : T(0);
}

// The block's scalar sums v[0, S) into scal[0, S), over its threads in
// a fixed order.
template <int S, typename T>
__device__ __forceinline__ void block_scalars(T (&v)[S], T* scal)
{
    __shared__ T ws[NT / 32][S];
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
    for (int q = 0; q < S; ++q) {
        const T t = lane_sum<32>(v[q]);
        if (lane == 0) ws[warp][q] = t;
    }
    __syncthreads();
    if (threadIdx.x < S) {
        T s = T(0);
        for (int w = 0; w < NT / 32; ++w) s += ws[w][threadIdx.x];
        scal[threadIdx.x] = s;
    }
}

// The backwards' scalar sums: sum G, G's trace, then the evaluator's
// parameter sums (the gradient of <G, K> with respect to params)
template <typename T, class Ev>
struct ParSums {
    static constexpr int S = 2 + Ev::NS;
    T sg, tr, acc[Ev::NS];

    __device__ __forceinline__ ParSums() : sg(T(0)), tr(T(0))
    {
#pragma unroll
        for (int q = 0; q < Ev::NS; ++q) acc[q] = T(0);
    }
    // the block's sums into scal[0, S)
    __device__ __forceinline__ void store(T* scal) const
    {
        T v[S];
        v[0] = sg;
        v[1] = tr;
#pragma unroll
        for (int q = 0; q < Ev::NS; ++q) v[2 + q] = acc[q];
        block_scalars(v, scal);
    }
};

// The column sums acc[k][q] of the threads' tile columns, added over the
// block's rows in a fixed order through `red`, times `sign`, into
// dst[(c) * p + d0 + q] for the tile's columns c = j0 + tx V + k < nc.
template <typename T, int PC>
__device__ __forceinline__ void block_columns(T (&acc)[Geo<T>::V][PC],
                                              T (*red)[PC][TILE],
                                              long long j0, long long nc,
                                              int p, int d0, int pc, T sign,
                                              T* dst)
{
    using Gm = Geo<T>;
    const int tx = threadIdx.x % Gm::TX, ty = threadIdx.x / Gm::TX;
#pragma unroll
    for (int k = 0; k < Gm::V; ++k)
#pragma unroll
        for (int q = 0; q < PC; ++q) red[ty][q][tx * Gm::V + k] = acc[k][q];
    __syncthreads();
    for (int t = threadIdx.x; t < PC * TILE; t += NT) {
        const int q = t / TILE, cc = t % TILE;
        const long long c = j0 + cc;
        if (q < pc && c < nc) {
            T s = T(0);
            for (int w = 0; w < Gm::TY; ++w) s += red[w][q][cc];
            dst[c * p + d0 + q] = sign * s;
        }
    }
}

// Kernel C's backward at p > 1, the body of gram_bwd_kernel: the block's
// four 64-row steps one after another, each with the step's coordinates
// staged (tile_r2), the thread's entries' weights in registers, and the
// slabs swept again for the row and column sums, DG coordinates at a
// time.  A step's column sums go into the block's slot through `red`,
// each slot entry owned by one thread, which stores the first step's sum
// and adds the later ones in order.
template <typename T, class Ev, bool XY, bool PAR>
__device__ __forceinline__ void bwd_slabs(const T* __restrict__ G,
                                          const T* __restrict__ x,
                                          const T* __restrict__ y,
                                          long long n, long long m, int p,
                                          const Ev& ev, bool with_noise,
                                          int wide, T* __restrict__ rowpart,
                                          T* __restrict__ colpart, T* scal)
{
    using Gm = Geo<T>;
    constexpr int V = Gm::V, RPT = Gm::RPT, TY = Gm::TY, NV = RPT * DG;
    // each row's lanes share out its RPT x DG sums: NV lanes' worth
    static_assert(NV <= Gm::TX, "too many sums for a row's lanes");
    constexpr int SPREAD = Gm::TX / NV;
    __shared__ __align__(16) T xs[SLAB][Gm::PITCH], ys[SLAB][Gm::PITCH];
    __shared__ T red[TY][DG][TILE];
    const int tx = threadIdx.x % Gm::TX, ty = threadIdx.x / Gm::TX;
    const long long j0 = (long long)blockIdx.x * TILE;
    const long long c0 = j0 + tx * V;
    T* const rowblk = rowpart + (long long)blockIdx.x * n * p;
    T* const colblk = colpart + (long long)blockIdx.y * m * p;
    // the column-slot entry (column j0 + oc, coordinate oq of a group)
    // this thread owns
    const int oq = threadIdx.x / TILE, oc = threadIdx.x % TILE;
    ParSums<T, Ev> ps;
    for (int s = 0; s < CROWS; ++s) {
        const long long i0 = ((long long)blockIdx.y * CROWS + s) * TILE;
        if (i0 >= n) break;
        // G's entries, zeros past the edge: their weights are zero
        T w[RPT][V];
#pragma unroll
        for (int a = 0; a < RPT; ++a) {
            const long long r = i0 + ty + a * TY;
            const bool rv = r < n;
            load_row(G + (rv ? r : 0) * m + c0, w[a], rv ? m - c0 : 0, wide);
        }
        T r2[RPT][V];
        const int nslab = tile_r2(x, y, n, m, p, i0, j0, xs, ys, r2);
#pragma unroll
        for (int a = 0; a < RPT; ++a) {
#pragma unroll
            for (int k = 0; k < V; ++k) {
                const T gv = w[a][k];
                const T d1 = ev.template grad<PAR>(r2[a][k], gv, ps.acc);
                if constexpr (PAR) {
                    ps.sg += gv;
                    if (with_noise && i0 + ty + a * TY == c0 + k)
                        ps.tr += gv;
                }
                w[a][k] = r2[a][k] > T(0) ? gv * d1 : T(0);
            }
        }
        if constexpr (XY) {
            // the last slab is still staged: sweep the slabs backwards
            for (int l = nslab - 1; l >= 0; --l) {
                const int d0 = l * SLAB, pc = min(SLAB, p - d0);
                if (l != nslab - 1) {
                    __syncthreads();
                    stage(x, i0, n, p, d0, pc, xs);
                    stage(y, j0, m, p, d0, pc, ys);
                    __syncthreads();
                }
                for (int q0 = 0; q0 < pc; q0 += DG) {
                    // past pc the staged rows are stale: their sums are
                    // dropped below
                    T racc[NV], cacc[V][DG];
#pragma unroll
                    for (int q = 0; q < DG; ++q) {
#pragma unroll
                        for (int a = 0; a < RPT; ++a) racc[a * DG + q] = T(0);
#pragma unroll
                        for (int k = 0; k < V; ++k) cacc[k][q] = T(0);
                        T yv[V];
                        lds16(&ys[q0 + q][tx * V], yv);
#pragma unroll
                        for (int a = 0; a < RPT; ++a) {
                            const T xr = xs[q0 + q][ty + a * TY];
#pragma unroll
                            for (int k = 0; k < V; ++k) {
                                const T dl = xr - yv[k];
                                racc[a * DG + q] =
                                    fma(w[a][k], dl, racc[a * DG + q]);
                                cacc[k][q] = fma(w[a][k], dl, cacc[k][q]);
                            }
                        }
                    }
                    // rows: lane tx ends with sum idx = tx / SPREAD
                    scatter_sum<Gm::TX / 2, NV>(racc, tx);
                    const int idx = tx / SPREAD, ra = idx / DG;
                    const long long r = i0 + ty + ra * TY;
                    const int d = d0 + q0 + idx % DG;
                    if (tx % SPREAD == 0 && r < n && d < p)
                        rowblk[r * p + d] = racc[0];
                    // columns: over the block's rows through red
#pragma unroll
                    for (int k = 0; k < V; ++k)
#pragma unroll
                        for (int q = 0; q < DG; ++q)
                            red[ty][q][tx * V + k] = cacc[k][q];
                    __syncthreads();
                    const long long c = j0 + oc;
                    const int dc = d0 + q0 + oq;
                    if (oq < DG && c < m && dc < p) {
                        T sum = T(0);
#pragma unroll
                        for (int t = 0; t < TY; ++t) sum += red[t][oq][oc];
                        T& dst = colblk[c * p + dc];
                        dst = s == 0 ? sum : dst + sum;
                    }
                    __syncthreads();
                }
            }
        }
    }
    if constexpr (PAR)
        ps.store(scal + ps.S * ((long long)blockIdx.y * gridDim.x
                                           + blockIdx.x));
}

// Kernel C's backward at p = 1, the body of gram_bwd_kernel: the
// coordinates in registers, the row sums across a row's lanes.
template <typename T, class Ev, bool XY, bool PAR>
__device__ __forceinline__ void bwd_p1(const T* __restrict__ G,
                                       const T* __restrict__ x,
                                       const T* __restrict__ y, long long n,
                                       long long m, const Ev& ev,
                                       bool with_noise, int wide,
                                       T* __restrict__ rowpart,
                                       T* __restrict__ colpart, T* scal)
{
    using Gm = Geo<T>;
    constexpr int V = Gm::V;
    __shared__ T red[Gm::TY][1][TILE];
    const int tx = threadIdx.x % Gm::TX, ty = threadIdx.x / Gm::TX;
    const long long j0 = (long long)blockIdx.x * TILE;
    const long long c0 = j0 + tx * V;
    const long long i0 = (long long)blockIdx.y * (TILE * CROWS);
    const bool diag = PAR && with_noise && i0 < j0 + TILE
        && j0 < i0 + TILE * CROWS;
    T yc[V], cacc[V][1];
#pragma unroll
    for (int k = 0; k < V; ++k) {
        yc[k] = c0 + k < m ? y[c0 + k] : T(0);
        cacc[k][0] = T(0);
    }
    ParSums<T, Ev> ps;
    for (int a = 0; a < Gm::RPT * CROWS; ++a) {
        const long long r = i0 + ty + a * Gm::TY;
        const bool rv = r < n;
        T gv[V], racc = T(0);
        load_row(G + (rv ? r : 0) * m + c0, gv, rv ? m - c0 : 0, wide);
        const T xr = rv ? x[r] : T(0);
#pragma unroll
        for (int k = 0; k < V; ++k) {
            const long long c = c0 + k;
            if (!rv || c >= m) continue;
            const T r2 = dist2<T, true>(x, y, r, c, 1, xr, yc[k]);
            const T d1 = ev.template grad<PAR>(r2, gv[k], ps.acc);
            if constexpr (PAR) {
                ps.sg += gv[k];
                if (diag && r == c) ps.tr += gv[k];
            }
            if constexpr (XY) {
                const T w = r2 > T(0) ? gv[k] * d1 : T(0);
                const T t = w * (xr - yc[k]);
                racc += t;
                cacc[k][0] += t;
            }
        }
        if constexpr (XY) {
            racc = lane_sum<Gm::TX>(racc);
            if (tx == 0 && rv) rowpart[(long long)blockIdx.x * n + r] = racc;
        }
    }
    if constexpr (XY)
        block_columns<T, 1>(cacc, red, j0, m, 1, 0, 1, T(1),
                            colpart + (long long)blockIdx.y * m);
    if constexpr (PAR)
        ps.store(scal + ps.S * ((long long)blockIdx.y * gridDim.x
                                           + blockIdx.x));
}

// Kernel C's backward.  Block (bx, by) covers columns [64 bx, +64) and
// rows [256 by, +256).  Writes (when XY) rowpart[bx][i][d] and
// colpart[by][j][d], the sums over the block's columns and rows of
// G Wr (x_i - y_j)_d, and (when PAR) scal[by * gridDim.x + bx][0..S),
// the block's ParSums.  One launch for all p.
template <typename T, class Ev, bool P1, bool XY, bool PAR>
__global__ void __launch_bounds__(NT)
gram_bwd_kernel(const T* __restrict__ G, const T* __restrict__ x,
                const T* __restrict__ y, long long n, long long m, int p,
                const T* __restrict__ params, int nterms,
                unsigned long long codes, int with_noise, int wide,
                T* __restrict__ rowpart, T* __restrict__ colpart,
                T* __restrict__ scal)
{
    const Ev ev(params, nterms, codes);
    if constexpr (P1)
        bwd_p1<T, Ev, XY, PAR>(G, x, y, n, m, ev, with_noise, wide, rowpart,
                               colpart, scal);
    else
        bwd_slabs<T, Ev, XY, PAR>(G, x, y, n, m, p, ev, with_noise, wide,
                                  rowpart, colpart, scal);
}

// E's backward: the mirror tile, then (reused) the column sums
template <typename T, int PC>
union SymSmem {
    T sh[TILE][TILE + 1];
    T red[Geo<T>::TY][PC][TILE];
};

// Kernel E's backward.  Block b covers upper tile pair (I, J).  Writes
// (when XY) part[J][i][d] for the rows i of I and, off the diagonal,
// part[I][j][d] for the rows j of J: the sums of S Wr (x_i - x_j)_d over
// the tile's columns and, negated, over its rows; and (when PAR)
// scal[b][0..S), the pair's ParSums.
template <typename T, class Ev, bool P1, bool XY, bool PAR>
__global__ void __launch_bounds__(NT)
gram_sym_bwd_kernel(const T* __restrict__ G, const T* __restrict__ x,
                    long long n, int p, int d0, const T* __restrict__ params,
                    int nterms, unsigned long long codes, int with_noise,
                    int wide, T* __restrict__ part, T* __restrict__ scal)
{
    using Gm = Geo<T>;
    constexpr int V = Gm::V, PC = P1 ? 1 : PCHUNK;
    __shared__ SymSmem<T, PC> sm;
    long long i0, j0;
    upper_pair(blockIdx.x, i0, j0);
    const bool dt = i0 == j0;
    const int tx = threadIdx.x % Gm::TX, ty = threadIdx.x / Gm::TX;
    const int pc = P1 ? 1 : min(PC, p - d0);
    // G[J, I] into sm.sh, row by row
    const long long cI = i0 + tx * V;
#pragma unroll
    for (int a = 0; a < Gm::RPT; ++a) {
        const int rr = ty + a * Gm::TY;
        const long long rm = j0 + rr;
        const bool rv = rm < n;
        T gv[V];
        load_row(G + (rv ? rm : 0) * n + cI, gv, rv ? n - cI : 0, wide);
#pragma unroll
        for (int k = 0; k < V; ++k) sm.sh[rr][tx * V + k] = gv[k];
    }
    __syncthreads();
    const long long c0 = j0 + tx * V;
    const Ev ev(params, nterms, codes);
    T yc[V][PC], cacc[V][PC];
#pragma unroll
    for (int k = 0; k < V; ++k) {
        coords<T, PC>(x, c0 + k, c0 + k < n, p, d0, pc, yc[k]);
#pragma unroll
        for (int q = 0; q < PC; ++q) cacc[k][q] = T(0);
    }
    ParSums<T, Ev> ps;
#pragma unroll
    for (int a = 0; a < Gm::RPT; ++a) {
        const int rr = ty + a * Gm::TY;
        const long long r = i0 + rr;
        const bool rv = r < n;
        T gv[V], xr[PC], racc[PC];
        if (dt) {
            // a diagonal tile is its own mirror: read once, into sm.sh
#pragma unroll
            for (int k = 0; k < V; ++k) gv[k] = sm.sh[rr][tx * V + k];
        } else {
            load_row(G + (rv ? r : 0) * n + c0, gv, rv ? n - c0 : 0, wide);
        }
        coords<T, PC>(x, r, rv, p, d0, pc, xr);
#pragma unroll
        for (int q = 0; q < PC; ++q) racc[q] = T(0);
#pragma unroll
        for (int k = 0; k < V; ++k) {
            const long long c = c0 + k;
            if (!rv || c >= n) continue;
            const T s = gv[k] + sm.sh[tx * V + k][rr];
            const T r2 = dist2<T, P1>(x, x, r, c, p, xr[0], yc[k][0]);
            // the whole of G: on a diagonal tile G itself, off it both
            // G[I, J] and G[J, I]
            const T gs = dt ? gv[k] : s;
            const T d1 = ev.template grad<PAR>(r2, gs, ps.acc);
            if constexpr (PAR) {
                ps.sg += gs;
                if (dt && with_noise && r == c) ps.tr += gv[k];
            }
            if constexpr (XY) {
                const T w = r2 > T(0) ? s * d1 : T(0);
#pragma unroll
                for (int q = 0; q < PC; ++q) {
                    const T t = w * (xr[q] - yc[k][q]);
                    racc[q] += t;
                    cacc[k][q] += t;
                }
            }
        }
        if constexpr (XY) {
#pragma unroll
            for (int q = 0; q < PC; ++q) {
                racc[q] = lane_sum<Gm::TX>(racc[q]);
                if (tx == 0 && rv && q < pc)
                    part[((j0 / TILE) * n + r) * p + d0 + q] = racc[q];
            }
        }
    }
    if constexpr (XY) {
        if (!dt) {
            __syncthreads();   // sm.sh is read no more
            block_columns<T, PC>(cacc, sm.red, j0, n, p, d0, pc, T(-1),
                                 part + (i0 / TILE) * n * p);
        }
    }
    if constexpr (PAR)
        ps.store(scal + ps.S * (long long)blockIdx.x);
}

// -- tangents ----------------------------------------------------------------

// r^2 and its tangent dr^2 of entry (r, c): at p = 1 from the
// coordinates and their tangents in registers
template <typename T, bool P1>
__device__ __forceinline__ T dist2_tangent(const T* __restrict__ x,
                                           const T* __restrict__ y,
                                           const T* __restrict__ dx,
                                           const T* __restrict__ dy,
                                           long long r, long long c, int p,
                                           T xr, T yc, T dxr, T dyc, T& dr2)
{
    if constexpr (P1) {
        const T dl = xr - yc;
        dr2 = T(2) * (dl * (dxr - dyc));
        return dl * dl;
    } else {
        return sqdist_tangent(x + r * p, y + c * p, dx + r * p, dy + c * p, p,
                              dr2);
    }
}

// One entry of the tangent Gram: dK/dr^2 dr^2 (zero at r^2 <= 0, where
// the true tangent vanishes) + the parameters' part, plus the nugget's
// tangent dp[1] on the global diagonal.  C' and E' share it, so their
// entries are identical.
template <typename T, class Ev>
__device__ __forceinline__ T entry_tangent(const Ev& ev, T r2, T dr2,
                                           const T* __restrict__ dp,
                                           bool on_diag)
{
    T v = ev.tangent(r2, dr2, dp);
    if (on_diag) v += dp[1];
    return v;
}

// Kernel C': the tangent Gram, tiled and stored as kernel C.
template <typename T, class Ev, bool P1>
__global__ void __launch_bounds__(NT)
gram_jvp_kernel(const T* __restrict__ x, const T* __restrict__ y,
                const T* __restrict__ dx, const T* __restrict__ dy,
                long long n, long long m, int p, const T* __restrict__ params,
                const T* __restrict__ dp, int nterms, unsigned long long codes,
                int with_noise, T* __restrict__ out)
{
    using Gm = Geo<T>;
    constexpr int V = Gm::V;
    const int tx = threadIdx.x % Gm::TX, ty = threadIdx.x / Gm::TX;
    const long long i0 = (long long)blockIdx.y * TILE;
    const long long j0 = (long long)blockIdx.x * TILE;
    const long long c0 = j0 + tx * V;
    const Ev ev(params, nterms, codes);
    const bool diag = with_noise && i0 < j0 + TILE && j0 < i0 + TILE;
    const bool wide = m % V == 0;
    T yc[V], dyc[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
        const bool cv = P1 && c0 + k < m;
        yc[k] = cv ? y[c0 + k] : T(0);
        dyc[k] = cv ? dy[c0 + k] : T(0);
    }
#pragma unroll
    for (int a = 0; a < Gm::RPT; ++a) {
        const long long r = i0 + ty + a * Gm::TY;
        if (r >= n) break;
        const T xr = P1 ? x[r] : T(0), dxr = P1 ? dx[r] : T(0);
        T v[V];
#pragma unroll
        for (int k = 0; k < V; ++k) {
            const long long c = c0 + k < m ? c0 + k : m - 1;
            T dr2;
            const T r2 = dist2_tangent<T, P1>(x, y, dx, dy, r, c, p, xr,
                                              yc[k], dxr, dyc[k], dr2);
            v[k] = entry_tangent(ev, r2, dr2, dp, diag && r == c0 + k);
        }
        store_row(out + r * m + c0, v, m - c0, wide);
    }
}

// Kernel E': C' for y = x on the upper tile pairs, each tile and its
// mirror written, as kernel E; at least 2 blocks per SM (128 registers:
// ptxas spilled the float64 p = 1 kernel at 80 left to itself).
template <typename T, class Ev, bool P1>
__global__ void __launch_bounds__(NT, 2)
gram_sym_jvp_kernel(const T* __restrict__ x, const T* __restrict__ dx,
                    long long n, int p, const T* __restrict__ params,
                    const T* __restrict__ dp, int nterms,
                    unsigned long long codes, int with_noise,
                    T* __restrict__ out)
{
    using Gm = Geo<T>;
    constexpr int V = Gm::V;
    __shared__ T sh[TILE][TILE + 1];
    long long i0, j0;
    upper_pair(blockIdx.x, i0, j0);
    const int tx = threadIdx.x % Gm::TX, ty = threadIdx.x / Gm::TX;
    const long long c0 = j0 + tx * V;
    const Ev ev(params, nterms, codes);
    const bool diag = i0 == j0;
    const bool wide = n % V == 0;
    T yc[V], dyc[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
        const bool cv = P1 && c0 + k < n;
        yc[k] = cv ? x[c0 + k] : T(0);
        dyc[k] = cv ? dx[c0 + k] : T(0);
    }
#pragma unroll
    for (int a = 0; a < Gm::RPT; ++a) {
        const int rr = ty + a * Gm::TY;
        const long long r = i0 + rr;
        if (r >= n) break;
        const T xr = P1 ? x[r] : T(0), dxr = P1 ? dx[r] : T(0);
        T v[V];
#pragma unroll
        for (int k = 0; k < V; ++k) {
            const long long c = c0 + k < n ? c0 + k : n - 1;
            T dr2;
            const T r2 = dist2_tangent<T, P1>(x, x, dx, dx, r, c, p, xr,
                                              yc[k], dxr, dyc[k], dr2);
            v[k] = entry_tangent(ev, r2, dr2, dp,
                                 diag && with_noise && r == c0 + k);
            sh[rr][tx * V + k] = v[k];
        }
        store_row(out + r * n + c0, v, n - c0, wide);
    }
    if (diag) return;
    __syncthreads();
    const long long cm = i0 + tx * V;
#pragma unroll
    for (int a = 0; a < Gm::RPT; ++a) {
        const int rr = ty + a * Gm::TY;
        const long long rm = j0 + rr;
        if (rm >= n) break;
        T v[V];
#pragma unroll
        for (int k = 0; k < V; ++k) v[k] = sh[tx * V + k][rr];
        store_row(out + rm * n + cm, v, n - cm, wide);
    }
}

// The per-entry weights of the backward's tangent: w1 multiplies
// (x_i - y_j), w2 (dx_i - dy_j); both zero at r^2 <= 0
template <typename T>
__device__ __forceinline__ void tangent_weights(T gv, T r2, T dr2, T d1, T d2,
                                                T alpha, T dalpha, T& w1,
                                                T& w2)
{
    const bool pos = r2 > T(0);
    w1 = pos ? gv * fma(alpha * d2, dr2, dalpha * d1) : T(0);
    w2 = pos ? gv * (alpha * d1) : T(0);
}

// Kernel C'': the tangent of C's backward at fixed G along (dx, dy,
// dalpha), tiled as C's backward.  Writes (when XY) rowpart[bx][i][d]
// and colpart[by][j][d], the sums over the block's columns and rows of
// w1 (x_i - y_j)_d + w2 (dx_i - dy_j)_d, and (when SC)
// scal[by * gridDim.x + bx][0..3), the block's sums of G g' dr^2 (the
// tangent of sum G g), G and G g (the post chain's tangent needs them).
template <typename T, class Ev, bool P1, bool XY, bool SC>
__global__ void __launch_bounds__(NT)
gram_bwd_jvp_kernel(const T* __restrict__ G, const T* __restrict__ x,
                    const T* __restrict__ y, const T* __restrict__ dx,
                    const T* __restrict__ dy, long long n, long long m, int p,
                    int d0, const T* __restrict__ params,
                    const T* __restrict__ coef, unsigned long long codes,
                    int wide,
                    T* __restrict__ rowpart, T* __restrict__ colpart,
                    T* __restrict__ scal)
{
    using Gm = Geo<T>;
    constexpr int V = Gm::V, PC = P1 ? 1 : PCHUNK;
    __shared__ T red[Gm::TY][PC][TILE];
    const int tx = threadIdx.x % Gm::TX, ty = threadIdx.x / Gm::TX;
    const long long j0 = (long long)blockIdx.x * TILE;
    const long long c0 = j0 + tx * V;
    const long long i0 = (long long)blockIdx.y * (TILE * CROWS);
    const int pc = P1 ? 1 : min(PC, p - d0);
    const Ev ev(params, 1, codes);
    const T alpha = coef[0], dalpha = coef[1];
    T yc[V][PC], dyc[V][PC], cacc[V][PC];
#pragma unroll
    for (int k = 0; k < V; ++k) {
        coords<T, PC>(y, c0 + k, c0 + k < m, p, d0, pc, yc[k]);
        coords<T, PC>(dy, c0 + k, c0 + k < m, p, d0, pc, dyc[k]);
#pragma unroll
        for (int q = 0; q < PC; ++q) cacc[k][q] = T(0);
    }
    T s1 = T(0), sg = T(0), sgk = T(0);
    for (int a = 0; a < Gm::RPT * CROWS; ++a) {
        const long long r = i0 + ty + a * Gm::TY;
        const bool rv = r < n;
        T gv[V], xr[PC], dxr[PC], racc[PC];
        load_row(G + (rv ? r : 0) * m + c0, gv, rv ? m - c0 : 0, wide);
        coords<T, PC>(x, r, rv, p, d0, pc, xr);
        coords<T, PC>(dx, r, rv, p, d0, pc, dxr);
#pragma unroll
        for (int q = 0; q < PC; ++q) racc[q] = T(0);
#pragma unroll
        for (int k = 0; k < V; ++k) {
            const long long c = c0 + k;
            if (!rv || c >= m) continue;
            T dr2, d1, d2;
            const T r2 = dist2_tangent<T, P1>(x, y, dx, dy, r, c, p, xr[0],
                                              yc[k][0], dxr[0], dyc[k][0],
                                              dr2);
            const T g = ev.second(r2, d1, d2);
            if constexpr (SC) {
                s1 = fma(gv[k] * d1, dr2, s1);
                sg += gv[k];
                sgk = fma(gv[k], g, sgk);
            }
            if constexpr (XY) {
                T w1, w2;
                tangent_weights(gv[k], r2, dr2, d1, d2, alpha, dalpha, w1,
                                w2);
#pragma unroll
                for (int q = 0; q < PC; ++q) {
                    const T t = fma(w1, xr[q] - yc[k][q],
                                    w2 * (dxr[q] - dyc[k][q]));
                    racc[q] += t;
                    cacc[k][q] += t;
                }
            }
        }
        if constexpr (XY) {
#pragma unroll
            for (int q = 0; q < PC; ++q) {
                racc[q] = lane_sum<Gm::TX>(racc[q]);
                if (tx == 0 && rv && q < pc)
                    rowpart[((long long)blockIdx.x * n + r) * p + d0 + q] =
                        racc[q];
            }
        }
    }
    if constexpr (XY)
        block_columns<T, PC>(cacc, red, j0, m, p, d0, pc, T(1),
                             colpart + (long long)blockIdx.y * m * p);
    if constexpr (SC) {
        T sc[3] = {s1, sg, sgk};
        block_scalars(sc, scal + 3 * ((long long)blockIdx.y * gridDim.x
                                      + blockIdx.x));
    }
}

// Kernel E'': C'' for y = x on E's backward's upper tile pairs, with
// S = G[I, J] + G[J, I]^T; writes part[J][i][d], part[I][j][d] as E's
// backward and (when SC) scal[b][0..3), the pair's shares of the sums
// of G g' dr^2, G and G g.
template <typename T, class Ev, bool P1, bool XY, bool SC>
__global__ void __launch_bounds__(NT)
gram_sym_bwd_jvp_kernel(const T* __restrict__ G, const T* __restrict__ x,
                        const T* __restrict__ dx, long long n, int p, int d0,
                        const T* __restrict__ params,
                        const T* __restrict__ coef, unsigned long long codes,
                        int wide,
                        T* __restrict__ part, T* __restrict__ scal)
{
    using Gm = Geo<T>;
    constexpr int V = Gm::V, PC = P1 ? 1 : PCHUNK;
    __shared__ SymSmem<T, PC> sm;
    long long i0, j0;
    upper_pair(blockIdx.x, i0, j0);
    const bool dt = i0 == j0;
    const int tx = threadIdx.x % Gm::TX, ty = threadIdx.x / Gm::TX;
    const int pc = P1 ? 1 : min(PC, p - d0);
    const long long cI = i0 + tx * V;
#pragma unroll
    for (int a = 0; a < Gm::RPT; ++a) {
        const int rr = ty + a * Gm::TY;
        const long long rm = j0 + rr;
        const bool rv = rm < n;
        T gv[V];
        load_row(G + (rv ? rm : 0) * n + cI, gv, rv ? n - cI : 0, wide);
#pragma unroll
        for (int k = 0; k < V; ++k) sm.sh[rr][tx * V + k] = gv[k];
    }
    __syncthreads();
    const long long c0 = j0 + tx * V;
    const Ev ev(params, 1, codes);
    const T alpha = coef[0], dalpha = coef[1];
    T yc[V][PC], dyc[V][PC], cacc[V][PC];
#pragma unroll
    for (int k = 0; k < V; ++k) {
        coords<T, PC>(x, c0 + k, c0 + k < n, p, d0, pc, yc[k]);
        coords<T, PC>(dx, c0 + k, c0 + k < n, p, d0, pc, dyc[k]);
#pragma unroll
        for (int q = 0; q < PC; ++q) cacc[k][q] = T(0);
    }
    T s1 = T(0), sg = T(0), sgk = T(0);
#pragma unroll
    for (int a = 0; a < Gm::RPT; ++a) {
        const int rr = ty + a * Gm::TY;
        const long long r = i0 + rr;
        const bool rv = r < n;
        T gv[V], xr[PC], dxr[PC], racc[PC];
        if (dt) {
#pragma unroll
            for (int k = 0; k < V; ++k) gv[k] = sm.sh[rr][tx * V + k];
        } else {
            load_row(G + (rv ? r : 0) * n + c0, gv, rv ? n - c0 : 0, wide);
        }
        coords<T, PC>(x, r, rv, p, d0, pc, xr);
        coords<T, PC>(dx, r, rv, p, d0, pc, dxr);
#pragma unroll
        for (int q = 0; q < PC; ++q) racc[q] = T(0);
#pragma unroll
        for (int k = 0; k < V; ++k) {
            const long long c = c0 + k;
            if (!rv || c >= n) continue;
            const T s = gv[k] + sm.sh[tx * V + k][rr];
            T dr2, d1, d2;
            const T r2 = dist2_tangent<T, P1>(x, x, dx, dx, r, c, p, xr[0],
                                              yc[k][0], dxr[0], dyc[k][0],
                                              dr2);
            const T g = ev.second(r2, d1, d2);
            if constexpr (SC) {
                // the whole of G, as in E's backward
                const T gs = dt ? gv[k] : s;
                s1 = fma(gs * d1, dr2, s1);
                sg += gs;
                sgk = fma(gs, g, sgk);
            }
            if constexpr (XY) {
                T w1, w2;
                tangent_weights(s, r2, dr2, d1, d2, alpha, dalpha, w1, w2);
#pragma unroll
                for (int q = 0; q < PC; ++q) {
                    const T t = fma(w1, xr[q] - yc[k][q],
                                    w2 * (dxr[q] - dyc[k][q]));
                    racc[q] += t;
                    cacc[k][q] += t;
                }
            }
        }
        if constexpr (XY) {
#pragma unroll
            for (int q = 0; q < PC; ++q) {
                racc[q] = lane_sum<Gm::TX>(racc[q]);
                if (tx == 0 && rv && q < pc)
                    part[((j0 / TILE) * n + r) * p + d0 + q] = racc[q];
            }
        }
    }
    if constexpr (XY) {
        if (!dt) {
            __syncthreads();   // sm.sh is read no more
            block_columns<T, PC>(cacc, sm.red, j0, n, p, d0, pc, T(-1),
                                 part + (i0 / TILE) * n * p);
        }
    }
    if constexpr (SC) {
        T sc[3] = {s1, sg, sgk};
        block_scalars(sc, scal + 3 * (long long)blockIdx.x);
    }
}

// -- launchers ---------------------------------------------------------------

template <template <typename> class E>
struct EvTag {
    template <typename T>
    using type = E<T>;
};

// f(tag) for the evaluator the host chose: 0 FixedExpQuad, 1 Zoo (this
// file), 2 ZooSpecial (with LSQ_GRAM_SPECIAL); false for another value
// or a term count outside [1, MAXTERMS]
template <class F>
bool with_ev(int ev, int nterms, F&& f)
{
    if (nterms < 1 || nterms > MAXTERMS) return false;
    switch (ev) {
#if LSQ_GRAM_SPECIAL
    case 2: f(EvTag<ZooSpecial>{}); return true;
#else
    case 0: f(EvTag<FixedExpQuad>{}); return true;
    case 1: f(EvTag<Zoo>{}); return true;
#endif
    }
    return false;
}

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

int launched(bool ok)
{
    return ok ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_gram(const T* x, const T* y, long long n, long long m, int p,
                const T* params, int nterms, unsigned long long codes,
                int with_noise, int evk, T* out, void* stream)
{
    if (n == 0 || m == 0) return 0;
    const dim3 grid((unsigned)cdiv(m, TILE), (unsigned)cdiv(n, TILE));
    const auto s = (cudaStream_t)stream;
    return launched(with_ev(evk, nterms, [&](auto tag) {
        using Ev = typename decltype(tag)::template type<T>;
        auto kern = p == 1 ? gram_kernel<T, Ev, true>
                           : gram_kernel<T, Ev, false>;
        kern<<<grid, NT, 0, s>>>(x, y, n, m, p, params, nterms, codes,
                                 with_noise, out);
    }));
}

template <typename T>
int launch_gram_sym(const T* x, long long n, int p, const T* params,
                    int nterms, unsigned long long codes, int with_noise,
                    int evk, T* out, void* stream)
{
    if (n == 0) return 0;
    const long long nt = cdiv(n, TILE);
    const auto s = (cudaStream_t)stream;
    return launched(with_ev(evk, nterms, [&](auto tag) {
        using Ev = typename decltype(tag)::template type<T>;
        auto kern = p == 1 ? gram_sym_kernel<T, Ev, true>
                           : gram_sym_kernel<T, Ev, false>;
        kern<<<(unsigned)(nt * (nt + 1) / 2), NT, 0, s>>>(
            x, n, p, params, nterms, codes, with_noise, out);
    }));
}

// the instantiation for (p == 1, need_xy, need_p); need_xy or need_p
template <typename T, class Ev, bool P1>
auto bwd_kernel(bool xy, bool par)
{
    return xy ? (par ? gram_bwd_kernel<T, Ev, P1, true, true>
                     : gram_bwd_kernel<T, Ev, P1, true, false>)
              : gram_bwd_kernel<T, Ev, P1, false, true>;
}

template <typename T, class Ev, bool P1>
auto sym_bwd_kernel(bool xy, bool par)
{
    return xy ? (par ? gram_sym_bwd_kernel<T, Ev, P1, true, true>
                     : gram_sym_bwd_kernel<T, Ev, P1, true, false>)
              : gram_sym_bwd_kernel<T, Ev, P1, false, true>;
}

template <typename T>
int launch_gram_bwd(const T* G, const T* x, const T* y, long long n,
                    long long m, int p, const T* params, int nterms,
                    unsigned long long codes, int with_noise, int evk,
                    int need_xy, int need_p, int wide, T* rowpart,
                    T* colpart, T* scal, void* stream)
{
    if (!(need_xy || need_p) || p < 1) return (int)cudaErrorInvalidValue;
    if (n == 0 || m == 0) return 0;
    const dim3 grid((unsigned)cdiv(m, TILE),
                    (unsigned)cdiv(n, TILE * CROWS));
    const auto s = (cudaStream_t)stream;
    return launched(with_ev(evk, nterms, [&](auto tag) {
        using Ev = typename decltype(tag)::template type<T>;
        auto kern = p == 1 ? bwd_kernel<T, Ev, true>(need_xy, need_p)
                           : bwd_kernel<T, Ev, false>(need_xy, need_p);
        kern<<<grid, NT, 0, s>>>(G, x, y, n, m, p, params, nterms, codes,
                                 with_noise, wide, rowpart, colpart, scal);
    }));
}

template <typename T>
int launch_gram_sym_bwd(const T* G, const T* x, long long n, int p, int d0,
                        const T* params, int nterms, unsigned long long codes,
                        int with_noise, int evk, int need_x, int need_p,
                        int wide, T* part, T* scal, void* stream)
{
    if (!(need_x || need_p) || d0 < 0 || d0 >= p)
        return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    const long long nt = cdiv(n, TILE);
    const auto s = (cudaStream_t)stream;
    return launched(with_ev(evk, nterms, [&](auto tag) {
        using Ev = typename decltype(tag)::template type<T>;
        auto kern = p == 1 ? sym_bwd_kernel<T, Ev, true>(need_x, need_p)
                           : sym_bwd_kernel<T, Ev, false>(need_x, need_p);
        kern<<<(unsigned)(nt * (nt + 1) / 2), NT, 0, s>>>(
            G, x, n, p, d0, params, nterms, codes, with_noise, wide, part,
            scal);
    }));
}

template <typename T>
int launch_gram_jvp(const T* x, const T* y, const T* dx, const T* dy,
                    long long n, long long m, int p, const T* params,
                    const T* dparams, int nterms, unsigned long long codes,
                    int with_noise, int evk, T* out, void* stream)
{
    if (n == 0 || m == 0) return 0;
    const dim3 grid((unsigned)cdiv(m, TILE), (unsigned)cdiv(n, TILE));
    const auto s = (cudaStream_t)stream;
    return launched(with_ev(evk, nterms, [&](auto tag) {
        using Ev = typename decltype(tag)::template type<T>;
        auto kern = p == 1 ? gram_jvp_kernel<T, Ev, true>
                           : gram_jvp_kernel<T, Ev, false>;
        kern<<<grid, NT, 0, s>>>(x, y, dx, dy, n, m, p, params, dparams,
                                 nterms, codes, with_noise, out);
    }));
}

template <typename T>
int launch_gram_sym_jvp(const T* x, const T* dx, long long n, int p,
                        const T* params, const T* dparams, int nterms,
                        unsigned long long codes, int with_noise, int evk,
                        T* out, void* stream)
{
    if (n == 0) return 0;
    const long long nt = cdiv(n, TILE);
    const auto s = (cudaStream_t)stream;
    return launched(with_ev(evk, nterms, [&](auto tag) {
        using Ev = typename decltype(tag)::template type<T>;
        auto kern = p == 1 ? gram_sym_jvp_kernel<T, Ev, true>
                           : gram_sym_jvp_kernel<T, Ev, false>;
        kern<<<(unsigned)(nt * (nt + 1) / 2), NT, 0, s>>>(
            x, dx, n, p, params, dparams, nterms, codes, with_noise, out);
    }));
}

// the instantiations for (p == 1, need_xy, need_s); need_xy or need_s
template <typename T, class Ev, bool P1>
auto bwd_jvp_kernel(bool xy, bool sc)
{
    return xy ? (sc ? gram_bwd_jvp_kernel<T, Ev, P1, true, true>
                    : gram_bwd_jvp_kernel<T, Ev, P1, true, false>)
              : gram_bwd_jvp_kernel<T, Ev, P1, false, true>;
}

template <typename T, class Ev, bool P1>
auto sym_bwd_jvp_kernel(bool xy, bool sc)
{
    return xy ? (sc ? gram_sym_bwd_jvp_kernel<T, Ev, P1, true, true>
                    : gram_sym_bwd_jvp_kernel<T, Ev, P1, true, false>)
              : gram_sym_bwd_jvp_kernel<T, Ev, P1, false, true>;
}

// C'' and E'' take one term
template <typename T>
int launch_gram_bwd_jvp(const T* G, const T* x, const T* y, const T* dx,
                        const T* dy, long long n, long long m, int p, int d0,
                        const T* params, const T* coef,
                        unsigned long long codes, int evk, int need_xy,
                        int need_s, int wide, T* rowpart, T* colpart, T* scal,
                        void* stream)
{
    if (!(need_xy || need_s) || d0 < 0 || d0 >= p)
        return (int)cudaErrorInvalidValue;
    if (n == 0 || m == 0) return 0;
    const dim3 grid((unsigned)cdiv(m, TILE),
                    (unsigned)cdiv(n, TILE * CROWS));
    const auto s = (cudaStream_t)stream;
    return launched(with_ev(evk, 1, [&](auto tag) {
        using Ev = typename decltype(tag)::template type<T>;
        auto kern = p == 1 ? bwd_jvp_kernel<T, Ev, true>(need_xy, need_s)
                           : bwd_jvp_kernel<T, Ev, false>(need_xy, need_s);
        kern<<<grid, NT, 0, s>>>(G, x, y, dx, dy, n, m, p, d0, params, coef,
                                 codes, wide, rowpart, colpart, scal);
    }));
}

template <typename T>
int launch_gram_sym_bwd_jvp(const T* G, const T* x, const T* dx, long long n,
                            int p, int d0, const T* params, const T* coef,
                            unsigned long long codes, int evk, int need_x,
                            int need_s, int wide, T* part, T* scal,
                            void* stream)
{
    if (!(need_x || need_s) || d0 < 0 || d0 >= p)
        return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    const long long nt = cdiv(n, TILE);
    const auto s = (cudaStream_t)stream;
    return launched(with_ev(evk, 1, [&](auto tag) {
        using Ev = typename decltype(tag)::template type<T>;
        auto kern = p == 1
            ? sym_bwd_jvp_kernel<T, Ev, true>(need_x, need_s)
            : sym_bwd_jvp_kernel<T, Ev, false>(need_x, need_s);
        kern<<<(unsigned)(nt * (nt + 1) / 2), NT, 0, s>>>(
            G, x, dx, n, p, d0, params, coef, codes, wide, part, scal);
    }));
}

}  // namespace

extern "C" {

#define LSQ_GRAM(T, SUF)                                                     \
    int lsq_gram##SUF(const T* x, const T* y, long long n, long long m,       \
                      int p, const T* params, int nterms,                     \
                      unsigned long long codes, int with_noise, int ev,       \
                      T* out, void* stream)                                   \
    {                                                                         \
        return launch_gram(x, y, n, m, p, params, nterms, codes, with_noise,  \
                           ev, out, stream);                                  \
    }                                                                         \
    int lsq_gram_sym##SUF(const T* x, long long n, int p, const T* params,    \
                          int nterms, unsigned long long codes,               \
                          int with_noise, int ev, T* out, void* stream)       \
    {                                                                         \
        return launch_gram_sym(x, n, p, params, nterms, codes, with_noise,    \
                               ev, out, stream);                              \
    }                                                                         \
    int lsq_gram_bwd##SUF(const T* G, const T* x, const T* y, long long n,    \
                          long long m, int p, const T* params, int nterms,    \
                          unsigned long long codes, int with_noise, int ev,   \
                          int need_xy, int need_p, int wide, T* rowpart,      \
                          T* colpart, T* scal, void* stream)                  \
    {                                                                         \
        return launch_gram_bwd(G, x, y, n, m, p, params, nterms, codes,       \
                               with_noise, ev, need_xy, need_p, wide,         \
                               rowpart, colpart, scal, stream);               \
    }                                                                         \
    int lsq_gram_sym_bwd##SUF(const T* G, const T* x, long long n, int p,     \
                              int d0, const T* params, int nterms,            \
                              unsigned long long codes, int with_noise,       \
                              int ev, int need_x, int need_p, int wide,       \
                              T* part, T* scal, void* stream)                 \
    {                                                                         \
        return launch_gram_sym_bwd(G, x, n, p, d0, params, nterms, codes,     \
                                   with_noise, ev, need_x, need_p, wide,      \
                                   part, scal, stream);                       \
    }                                                                         \
    int lsq_gram_jvp##SUF(const T* x, const T* y, const T* dx, const T* dy,  \
                          long long n, long long m, int p, const T* params,  \
                          const T* dparams, int nterms,                       \
                          unsigned long long codes, int with_noise, int ev,   \
                          T* out, void* stream)                               \
    {                                                                         \
        return launch_gram_jvp(x, y, dx, dy, n, m, p, params, dparams,        \
                               nterms, codes, with_noise, ev, out, stream);   \
    }                                                                         \
    int lsq_gram_sym_jvp##SUF(const T* x, const T* dx, long long n, int p,    \
                              const T* params, const T* dparams, int nterms,  \
                              unsigned long long codes, int with_noise,       \
                              int ev, T* out, void* stream)                   \
    {                                                                         \
        return launch_gram_sym_jvp(x, dx, n, p, params, dparams, nterms,      \
                                   codes, with_noise, ev, out, stream);       \
    }                                                                         \
    int lsq_gram_bwd_jvp##SUF(const T* G, const T* x, const T* y,             \
                              const T* dx, const T* dy, long long n,          \
                              long long m, int p, int d0, const T* params,    \
                              const T* coef, unsigned long long codes,        \
                              int ev, int need_xy, int need_s, int wide,      \
                              T* rowpart, T* colpart, T* scal, void* stream)  \
    {                                                                         \
        return launch_gram_bwd_jvp(G, x, y, dx, dy, n, m, p, d0, params,      \
                                   coef, codes, ev, need_xy, need_s, wide,    \
                                   rowpart, colpart, scal, stream);           \
    }                                                                         \
    int lsq_gram_sym_bwd_jvp##SUF(const T* G, const T* x, const T* dx,        \
                                  long long n, int p, int d0,                 \
                                  const T* params, const T* coef,             \
                                  unsigned long long codes, int ev,           \
                                  int need_x, int need_s, int wide, T* part,  \
                                  T* scal, void* stream)                      \
    {                                                                         \
        return launch_gram_sym_bwd_jvp(G, x, dx, n, p, d0, params, coef,      \
                                       codes, ev, need_x, need_s, wide, part, \
                                       scal, stream);                         \
    }

#if LSQ_GRAM_SPECIAL
LSQ_GRAM(float, _zs_f32)
LSQ_GRAM(double, _zs_f64)
#else
LSQ_GRAM(float, _f32)
LSQ_GRAM(double, _f64)
#endif

#undef LSQ_GRAM

}  // extern "C"
