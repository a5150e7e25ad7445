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
// - The profile (profiles.cuh) and p = 1 are template parameters; the
//   post chain is folded once per thread into alpha g + beta, read from
//   the parameters in device memory (no host read).
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
//   Wr = alpha g'(r^2), zero at r^2 <= 0 where the true tangent vanishes
//   (the x gradient); the same per column j (the y gradient); the sums of
//   G g and of G (the post chain's gradient), and G's trace (the
//   nugget's).  No floating-point atomics: row sums go across a row's
//   lanes by warp shuffles, column sums across the block's rows through
//   shared memory, the scalars by shuffles and shared memory, and each
//   block writes its partial sums to slots of its own in a scratch
//   buffer that the wrapper sums over the slots in a fixed order, so the
//   gradient is the same to the bit from run to run.  The coordinates
//   go in chunks of up to PCHUNK per launch (one launch for p <= 4).
// - C's backward block covers CROWS tiles down a column of tiles, which
//   cuts its column partial sums to n / 256 slots.
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
//   are zero at r^2 <= 0, as the first derivative's.  The post chain
//   enters through coef = [alpha, dalpha, dbeta, dnoise] in device
//   memory, which the wrapper forms from the chain and its tangent.

#include "profiles.cuh"

namespace {

using namespace lsq;

constexpr int TILE = 64;    // tile edge
constexpr int NT = 256;     // threads per block
constexpr int PCHUNK = 4;   // coordinates per backward launch at p > 1
constexpr int CROWS = 4;    // tiles per block of C's backward

template <typename T>
struct Geo {
    static constexpr int V = 16 / sizeof(T);   // entries per 16 bytes
    static constexpr int TX = TILE / V;        // lanes along a tile row
    static constexpr int TY = NT / TX;         // tile rows per step
    static constexpr int RPT = TILE / TY;      // tile rows per thread
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

// One entry of the value: the folded chain, plus the nugget on the
// global diagonal (C and E share it, so their entries are identical).
template <typename T, class Prof>
__device__ __forceinline__ T entry_value(T r2, Chain<T> ch, bool on_diag,
                                         T noise)
{
    T v = fma(ch.alpha, Prof::value(r2), ch.beta);
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

template <typename T, class Prof, bool P1>
__global__ void __launch_bounds__(NT)
gram_kernel(const T* __restrict__ x, const T* __restrict__ y, long long n,
            long long m, int p, const T* __restrict__ params, int npost,
            unsigned postadd, int with_noise, T* __restrict__ out)
{
    using Gm = Geo<T>;
    constexpr int V = Gm::V;
    const int tx = threadIdx.x % Gm::TX, ty = threadIdx.x / Gm::TX;
    const long long i0 = (long long)blockIdx.y * TILE;
    const long long j0 = (long long)blockIdx.x * TILE;
    const long long c0 = j0 + tx * V;
    const Chain<T> ch = fold_chain(params, npost, postadd);
    const bool diag = with_noise && i0 < j0 + TILE && j0 < i0 + TILE;
    const T noise = diag ? params[npost] : T(0);
    const bool wide = m % V == 0;
    T yc[V];
#pragma unroll
    for (int k = 0; k < V; ++k)
        yc[k] = P1 && c0 + k < m ? y[c0 + k] : T(0);
#pragma unroll
    for (int a = 0; a < Gm::RPT; ++a) {
        const long long r = i0 + ty + a * Gm::TY;
        if (r >= n) break;
        const T xr = P1 ? x[r] : T(0);
        T v[V];
#pragma unroll
        for (int k = 0; k < V; ++k) {
            const long long c = c0 + k < m ? c0 + k : m - 1;
            const T r2 = dist2<T, P1>(x, y, r, c, p, xr, yc[k]);
            v[k] = entry_value<T, Prof>(r2, ch, diag && r == c0 + k, noise);
        }
        store_row(out + r * m + c0, v, m - c0, wide);
    }
}

template <typename T, class Prof, bool P1>
__global__ void __launch_bounds__(NT)
gram_sym_kernel(const T* __restrict__ x, long long n, int p,
                const T* __restrict__ params, int npost, unsigned postadd,
                int with_noise, T* __restrict__ out)
{
    using Gm = Geo<T>;
    constexpr int V = Gm::V;
    __shared__ T sh[TILE][TILE + 1];
    long long i0, j0;
    upper_pair(blockIdx.x, i0, j0);
    const int tx = threadIdx.x % Gm::TX, ty = threadIdx.x / Gm::TX;
    const long long c0 = j0 + tx * V;
    const Chain<T> ch = fold_chain(params, npost, postadd);
    const bool diag = i0 == j0;
    const T noise = diag && with_noise ? params[npost] : T(0);
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
            v[k] = entry_value<T, Prof>(r2, ch,
                                        diag && with_noise && r == c0 + k,
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

// The block's scalar sums (sum G, sum G g, trace) into scal[0, 3).
template <typename T>
__device__ __forceinline__ void block_scalars(T sg, T sgk, T tr, T* scal)
{
    __shared__ T ws[NT / 32][3];
    sg = lane_sum<32>(sg);
    sgk = lane_sum<32>(sgk);
    tr = lane_sum<32>(tr);
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    if (lane == 0) {
        ws[warp][0] = sg;
        ws[warp][1] = sgk;
        ws[warp][2] = tr;
    }
    __syncthreads();
    if (threadIdx.x < 3) {
        T s = T(0);
        for (int w = 0; w < NT / 32; ++w) s += ws[w][threadIdx.x];
        scal[threadIdx.x] = s;
    }
}

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

// Kernel C's backward.  Block (bx, by) covers columns [64 bx, +64) and
// rows [256 by, +256).  Writes (when XY) rowpart[bx][i][d] and
// colpart[by][j][d], the sums over the block's columns and rows of
// G Wr (x_i - y_j)_d, and (when PAR) scal[by * gridDim.x + bx][0..3).
template <typename T, class Prof, bool P1, bool XY, bool PAR>
__global__ void __launch_bounds__(NT)
gram_bwd_kernel(const T* __restrict__ G, const T* __restrict__ x,
                const T* __restrict__ y, long long n, long long m, int p,
                int d0, const T* __restrict__ params, int npost,
                unsigned postadd, int with_noise, int wide,
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
    const Chain<T> ch = fold_chain(params, npost, postadd);
    const bool diag = PAR && with_noise && i0 < j0 + TILE
        && j0 < i0 + TILE * CROWS;
    T yc[V][PC], cacc[V][PC];
#pragma unroll
    for (int k = 0; k < V; ++k) {
        coords<T, PC>(y, c0 + k, c0 + k < m, p, d0, pc, yc[k]);
#pragma unroll
        for (int q = 0; q < PC; ++q) cacc[k][q] = T(0);
    }
    T sg = T(0), sgk = T(0), tr = T(0);
    for (int a = 0; a < Gm::RPT * CROWS; ++a) {
        const long long r = i0 + ty + a * Gm::TY;
        const bool rv = r < n;
        T gv[V], xr[PC], racc[PC];
        load_row(G + (rv ? r : 0) * m + c0, gv, rv ? m - c0 : 0, wide);
        coords<T, PC>(x, r, rv, p, d0, pc, xr);
#pragma unroll
        for (int q = 0; q < PC; ++q) racc[q] = T(0);
#pragma unroll
        for (int k = 0; k < V; ++k) {
            const long long c = c0 + k;
            if (!rv || c >= m) continue;
            const T r2 = dist2<T, P1>(x, y, r, c, p, xr[0], yc[k][0]);
            T dg;
            const T g = Prof::both(r2, dg);
            if constexpr (PAR) {
                sg += gv[k];
                sgk = fma(gv[k], g, sgk);
                if (diag && r == c) tr += gv[k];
            }
            if constexpr (XY) {
                const T w = r2 > T(0) ? gv[k] * (ch.alpha * dg) : T(0);
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
                    rowpart[((long long)blockIdx.x * n + r) * p + d0 + q] =
                        racc[q];
            }
        }
    }
    if constexpr (XY)
        block_columns<T, PC>(cacc, red, j0, m, p, d0, pc, T(1),
                             colpart + (long long)blockIdx.y * m * p);
    if constexpr (PAR)
        block_scalars(sg, sgk, tr,
                      scal + 3 * ((long long)blockIdx.y * gridDim.x
                                  + blockIdx.x));
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
// scal[b][0..3).
template <typename T, class Prof, bool P1, bool XY, bool PAR>
__global__ void __launch_bounds__(NT)
gram_sym_bwd_kernel(const T* __restrict__ G, const T* __restrict__ x,
                    long long n, int p, int d0, const T* __restrict__ params,
                    int npost, unsigned postadd, int with_noise, int wide,
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
    const Chain<T> ch = fold_chain(params, npost, postadd);
    T yc[V][PC], cacc[V][PC];
#pragma unroll
    for (int k = 0; k < V; ++k) {
        coords<T, PC>(x, c0 + k, c0 + k < n, p, d0, pc, yc[k]);
#pragma unroll
        for (int q = 0; q < PC; ++q) cacc[k][q] = T(0);
    }
    T sg = T(0), sgk = T(0), tr = T(0);
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
            T dg;
            const T g = Prof::both(r2, dg);
            if constexpr (PAR) {
                // the whole of G: on a diagonal tile G itself, off it
                // both G[I, J] and G[J, I]
                const T gs = dt ? gv[k] : s;
                sg += gs;
                sgk = fma(gs, g, sgk);
                if (dt && with_noise && r == c) tr += gv[k];
            }
            if constexpr (XY) {
                const T w = r2 > T(0) ? s * (ch.alpha * dg) : T(0);
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
        block_scalars(sg, sgk, tr, scal + 3 * (long long)blockIdx.x);
}

// -- tangents ----------------------------------------------------------------

// alpha (the chain's 'mul' product), the tangents of the folded chain's
// alpha and beta, and the nugget's tangent: coef[0..4)
template <typename T>
struct Tangent {
    T alpha, dalpha, dbeta, dnoise;
};

template <typename T>
__device__ __forceinline__ Tangent<T> load_tangent(const T* __restrict__ coef)
{
    return Tangent<T>{coef[0], coef[1], coef[2], coef[3]};
}

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

// One entry of the tangent Gram: alpha g'(r^2) dr^2 (zero at r^2 <= 0,
// where the true tangent vanishes) + dalpha g + dbeta, plus dnoise on
// the global diagonal.  C' and E' share it, so their entries are
// identical.
template <typename T, class Prof>
__device__ __forceinline__ T entry_tangent(T r2, T dr2, const Tangent<T>& tc,
                                           bool on_diag)
{
    T d1;
    const T g = Prof::both(r2, d1);
    T v = fma(tc.dalpha, g, tc.dbeta);
    if (r2 > T(0)) v = fma(tc.alpha * d1, dr2, v);
    if (on_diag) v += tc.dnoise;
    return v;
}

// Kernel C': the tangent Gram, tiled and stored as kernel C.
template <typename T, class Prof, bool P1>
__global__ void __launch_bounds__(NT)
gram_jvp_kernel(const T* __restrict__ x, const T* __restrict__ y,
                const T* __restrict__ dx, const T* __restrict__ dy,
                long long n, long long m, int p, const T* __restrict__ coef,
                int with_noise, T* __restrict__ out)
{
    using Gm = Geo<T>;
    constexpr int V = Gm::V;
    const int tx = threadIdx.x % Gm::TX, ty = threadIdx.x / Gm::TX;
    const long long i0 = (long long)blockIdx.y * TILE;
    const long long j0 = (long long)blockIdx.x * TILE;
    const long long c0 = j0 + tx * V;
    const Tangent<T> tc = load_tangent(coef);
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
            v[k] = entry_tangent<T, Prof>(r2, dr2, tc, diag && r == c0 + k);
        }
        store_row(out + r * m + c0, v, m - c0, wide);
    }
}

// Kernel E': C' for y = x on the upper tile pairs, each tile and its
// mirror written, as kernel E.
template <typename T, class Prof, bool P1>
__global__ void __launch_bounds__(NT)
gram_sym_jvp_kernel(const T* __restrict__ x, const T* __restrict__ dx,
                    long long n, int p, const T* __restrict__ coef,
                    int with_noise, T* __restrict__ out)
{
    using Gm = Geo<T>;
    constexpr int V = Gm::V;
    __shared__ T sh[TILE][TILE + 1];
    long long i0, j0;
    upper_pair(blockIdx.x, i0, j0);
    const int tx = threadIdx.x % Gm::TX, ty = threadIdx.x / Gm::TX;
    const long long c0 = j0 + tx * V;
    const Tangent<T> tc = load_tangent(coef);
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
            v[k] = entry_tangent<T, Prof>(r2, dr2, tc,
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
template <typename T, class Prof, bool P1, bool XY, bool SC>
__global__ void __launch_bounds__(NT)
gram_bwd_jvp_kernel(const T* __restrict__ G, const T* __restrict__ x,
                    const T* __restrict__ y, const T* __restrict__ dx,
                    const T* __restrict__ dy, long long n, long long m, int p,
                    int d0, const T* __restrict__ coef, int wide,
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
            const T g = Prof::second(r2, d1, d2);
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
    if constexpr (SC)
        block_scalars(s1, sg, sgk,
                      scal + 3 * ((long long)blockIdx.y * gridDim.x
                                  + blockIdx.x));
}

// Kernel E'': C'' for y = x on E's backward's upper tile pairs, with
// S = G[I, J] + G[J, I]^T; writes part[J][i][d], part[I][j][d] as E's
// backward and (when SC) scal[b][0..3), the pair's shares of the sums
// of G g' dr^2, G and G g.
template <typename T, class Prof, bool P1, bool XY, bool SC>
__global__ void __launch_bounds__(NT)
gram_sym_bwd_jvp_kernel(const T* __restrict__ G, const T* __restrict__ x,
                        const T* __restrict__ dx, long long n, int p, int d0,
                        const T* __restrict__ coef, int wide,
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
            const T g = Prof::second(r2, d1, d2);
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
    if constexpr (SC)
        block_scalars(s1, sg, sgk, scal + 3 * (long long)blockIdx.x);
}

// -- launchers ---------------------------------------------------------------

// f(Profile<id>{}) for a registered profile id; false for another id
template <class F>
bool with_profile(int id, F&& f)
{
    switch (id) {
    case PROFILE_EXPQUAD: f(Profile<PROFILE_EXPQUAD>{}); return true;
    }
    return false;
}

long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

template <typename T>
int launch_gram(const T* x, const T* y, long long n, long long m, int p,
                const T* params, int npost, unsigned postadd, int with_noise,
                int profile, T* out, void* stream)
{
    if (npost > MAXPOST) return (int)cudaErrorInvalidValue;
    if (n == 0 || m == 0) return 0;
    const dim3 grid((unsigned)cdiv(m, TILE), (unsigned)cdiv(n, TILE));
    const auto s = (cudaStream_t)stream;
    const bool ok = with_profile(profile, [&](auto prof) {
        using Prof = decltype(prof);
        auto kern = p == 1 ? gram_kernel<T, Prof, true>
                           : gram_kernel<T, Prof, false>;
        kern<<<grid, NT, 0, s>>>(x, y, n, m, p, params, npost, postadd,
                                 with_noise, out);
    });
    return ok ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_gram_sym(const T* x, long long n, int p, const T* params,
                    int npost, unsigned postadd, int with_noise, int profile,
                    T* out, void* stream)
{
    if (npost > MAXPOST) return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    const long long nt = cdiv(n, TILE);
    const auto s = (cudaStream_t)stream;
    const bool ok = with_profile(profile, [&](auto prof) {
        using Prof = decltype(prof);
        auto kern = p == 1 ? gram_sym_kernel<T, Prof, true>
                           : gram_sym_kernel<T, Prof, false>;
        kern<<<(unsigned)(nt * (nt + 1) / 2), NT, 0, s>>>(
            x, n, p, params, npost, postadd, with_noise, out);
    });
    return ok ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}

// the instantiation for (p == 1, need_xy, need_p); need_xy or need_p
template <typename T, class Prof, bool P1>
auto bwd_kernel(bool xy, bool par)
{
    return xy ? (par ? gram_bwd_kernel<T, Prof, P1, true, true>
                     : gram_bwd_kernel<T, Prof, P1, true, false>)
              : gram_bwd_kernel<T, Prof, P1, false, true>;
}

template <typename T, class Prof, bool P1>
auto sym_bwd_kernel(bool xy, bool par)
{
    return xy ? (par ? gram_sym_bwd_kernel<T, Prof, P1, true, true>
                     : gram_sym_bwd_kernel<T, Prof, P1, true, false>)
              : gram_sym_bwd_kernel<T, Prof, P1, false, true>;
}

template <typename T>
int launch_gram_bwd(const T* G, const T* x, const T* y, long long n,
                    long long m, int p, int d0, const T* params, int npost,
                    unsigned postadd, int with_noise, int profile,
                    int need_xy, int need_p, int wide, T* rowpart,
                    T* colpart, T* scal, void* stream)
{
    if (npost > MAXPOST || !(need_xy || need_p) || d0 < 0 || d0 >= p)
        return (int)cudaErrorInvalidValue;
    if (n == 0 || m == 0) return 0;
    const dim3 grid((unsigned)cdiv(m, TILE),
                    (unsigned)cdiv(n, TILE * CROWS));
    const auto s = (cudaStream_t)stream;
    const bool ok = with_profile(profile, [&](auto prof) {
        using Prof = decltype(prof);
        auto kern = p == 1 ? bwd_kernel<T, Prof, true>(need_xy, need_p)
                           : bwd_kernel<T, Prof, false>(need_xy, need_p);
        kern<<<grid, NT, 0, s>>>(G, x, y, n, m, p, d0, params, npost,
                                 postadd, with_noise, wide, rowpart, colpart,
                                 scal);
    });
    return ok ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_gram_sym_bwd(const T* G, const T* x, long long n, int p, int d0,
                        const T* params, int npost, unsigned postadd,
                        int with_noise, int profile, int need_x, int need_p,
                        int wide, T* part, T* scal, void* stream)
{
    if (npost > MAXPOST || !(need_x || need_p) || d0 < 0 || d0 >= p)
        return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    const long long nt = cdiv(n, TILE);
    const auto s = (cudaStream_t)stream;
    const bool ok = with_profile(profile, [&](auto prof) {
        using Prof = decltype(prof);
        auto kern = p == 1 ? sym_bwd_kernel<T, Prof, true>(need_x, need_p)
                           : sym_bwd_kernel<T, Prof, false>(need_x, need_p);
        kern<<<(unsigned)(nt * (nt + 1) / 2), NT, 0, s>>>(
            G, x, n, p, d0, params, npost, postadd, with_noise, wide, part,
            scal);
    });
    return ok ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_gram_jvp(const T* x, const T* y, const T* dx, const T* dy,
                    long long n, long long m, int p, const T* coef,
                    int with_noise, int profile, T* out, void* stream)
{
    if (n == 0 || m == 0) return 0;
    const dim3 grid((unsigned)cdiv(m, TILE), (unsigned)cdiv(n, TILE));
    const auto s = (cudaStream_t)stream;
    const bool ok = with_profile(profile, [&](auto prof) {
        using Prof = decltype(prof);
        auto kern = p == 1 ? gram_jvp_kernel<T, Prof, true>
                           : gram_jvp_kernel<T, Prof, false>;
        kern<<<grid, NT, 0, s>>>(x, y, dx, dy, n, m, p, coef, with_noise,
                                 out);
    });
    return ok ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_gram_sym_jvp(const T* x, const T* dx, long long n, int p,
                        const T* coef, int with_noise, int profile, T* out,
                        void* stream)
{
    if (n == 0) return 0;
    const long long nt = cdiv(n, TILE);
    const auto s = (cudaStream_t)stream;
    const bool ok = with_profile(profile, [&](auto prof) {
        using Prof = decltype(prof);
        auto kern = p == 1 ? gram_sym_jvp_kernel<T, Prof, true>
                           : gram_sym_jvp_kernel<T, Prof, false>;
        kern<<<(unsigned)(nt * (nt + 1) / 2), NT, 0, s>>>(
            x, dx, n, p, coef, with_noise, out);
    });
    return ok ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}

// the instantiations for (p == 1, need_xy, need_s); need_xy or need_s
template <typename T, class Prof, bool P1>
auto bwd_jvp_kernel(bool xy, bool sc)
{
    return xy ? (sc ? gram_bwd_jvp_kernel<T, Prof, P1, true, true>
                    : gram_bwd_jvp_kernel<T, Prof, P1, true, false>)
              : gram_bwd_jvp_kernel<T, Prof, P1, false, true>;
}

template <typename T, class Prof, bool P1>
auto sym_bwd_jvp_kernel(bool xy, bool sc)
{
    return xy ? (sc ? gram_sym_bwd_jvp_kernel<T, Prof, P1, true, true>
                    : gram_sym_bwd_jvp_kernel<T, Prof, P1, true, false>)
              : gram_sym_bwd_jvp_kernel<T, Prof, P1, false, true>;
}

template <typename T>
int launch_gram_bwd_jvp(const T* G, const T* x, const T* y, const T* dx,
                        const T* dy, long long n, long long m, int p, int d0,
                        const T* coef, int profile, int need_xy, int need_s,
                        int wide, T* rowpart, T* colpart, T* scal,
                        void* stream)
{
    if (!(need_xy || need_s) || d0 < 0 || d0 >= p)
        return (int)cudaErrorInvalidValue;
    if (n == 0 || m == 0) return 0;
    const dim3 grid((unsigned)cdiv(m, TILE),
                    (unsigned)cdiv(n, TILE * CROWS));
    const auto s = (cudaStream_t)stream;
    const bool ok = with_profile(profile, [&](auto prof) {
        using Prof = decltype(prof);
        auto kern = p == 1 ? bwd_jvp_kernel<T, Prof, true>(need_xy, need_s)
                           : bwd_jvp_kernel<T, Prof, false>(need_xy, need_s);
        kern<<<grid, NT, 0, s>>>(G, x, y, dx, dy, n, m, p, d0, coef, wide,
                                 rowpart, colpart, scal);
    });
    return ok ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}

template <typename T>
int launch_gram_sym_bwd_jvp(const T* G, const T* x, const T* dx, long long n,
                            int p, int d0, const T* coef, int profile,
                            int need_x, int need_s, int wide, T* part,
                            T* scal, void* stream)
{
    if (!(need_x || need_s) || d0 < 0 || d0 >= p)
        return (int)cudaErrorInvalidValue;
    if (n == 0) return 0;
    const long long nt = cdiv(n, TILE);
    const auto s = (cudaStream_t)stream;
    const bool ok = with_profile(profile, [&](auto prof) {
        using Prof = decltype(prof);
        auto kern = p == 1
            ? sym_bwd_jvp_kernel<T, Prof, true>(need_x, need_s)
            : sym_bwd_jvp_kernel<T, Prof, false>(need_x, need_s);
        kern<<<(unsigned)(nt * (nt + 1) / 2), NT, 0, s>>>(
            G, x, dx, n, p, d0, coef, wide, part, scal);
    });
    return ok ? (int)cudaGetLastError() : (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

#define LSQ_GRAM(T, SUF)                                                     \
    int lsq_gram##SUF(const T* x, const T* y, long long n, long long m,       \
                      int p, const T* params, int npost, unsigned postadd,    \
                      int with_noise, int profile, T* out, void* stream)      \
    {                                                                         \
        return launch_gram(x, y, n, m, p, params, npost, postadd,             \
                           with_noise, profile, out, stream);                 \
    }                                                                         \
    int lsq_gram_sym##SUF(const T* x, long long n, int p, const T* params,    \
                          int npost, unsigned postadd, int with_noise,        \
                          int profile, T* out, void* stream)                  \
    {                                                                         \
        return launch_gram_sym(x, n, p, params, npost, postadd, with_noise,   \
                               profile, out, stream);                         \
    }                                                                         \
    int lsq_gram_bwd##SUF(const T* G, const T* x, const T* y, long long n,    \
                          long long m, int p, int d0, const T* params,        \
                          int npost, unsigned postadd, int with_noise,        \
                          int profile, int need_xy, int need_p, int wide,     \
                          T* rowpart, T* colpart, T* scal, void* stream)      \
    {                                                                         \
        return launch_gram_bwd(G, x, y, n, m, p, d0, params, npost, postadd,  \
                               with_noise, profile, need_xy, need_p, wide,    \
                               rowpart, colpart, scal, stream);               \
    }                                                                         \
    int lsq_gram_sym_bwd##SUF(const T* G, const T* x, long long n, int p,     \
                              int d0, const T* params, int npost,             \
                              unsigned postadd, int with_noise, int profile,  \
                              int need_x, int need_p, int wide, T* part,      \
                              T* scal, void* stream)                          \
    {                                                                         \
        return launch_gram_sym_bwd(G, x, n, p, d0, params, npost, postadd,    \
                                   with_noise, profile, need_x, need_p, wide, \
                                   part, scal, stream);                       \
    }                                                                         \
    int lsq_gram_jvp##SUF(const T* x, const T* y, const T* dx, const T* dy,  \
                          long long n, long long m, int p, const T* coef,    \
                          int with_noise, int profile, T* out, void* stream) \
    {                                                                         \
        return launch_gram_jvp(x, y, dx, dy, n, m, p, coef, with_noise,       \
                               profile, out, stream);                         \
    }                                                                         \
    int lsq_gram_sym_jvp##SUF(const T* x, const T* dx, long long n, int p,    \
                              const T* coef, int with_noise, int profile,     \
                              T* out, void* stream)                           \
    {                                                                         \
        return launch_gram_sym_jvp(x, dx, n, p, coef, with_noise, profile,    \
                                   out, stream);                              \
    }                                                                         \
    int lsq_gram_bwd_jvp##SUF(const T* G, const T* x, const T* y,             \
                              const T* dx, const T* dy, long long n,          \
                              long long m, int p, int d0, const T* coef,      \
                              int profile, int need_xy, int need_s, int wide, \
                              T* rowpart, T* colpart, T* scal, void* stream)  \
    {                                                                         \
        return launch_gram_bwd_jvp(G, x, y, dx, dy, n, m, p, d0, coef,        \
                                   profile, need_xy, need_s, wide, rowpart,   \
                                   colpart, scal, stream);                    \
    }                                                                         \
    int lsq_gram_sym_bwd_jvp##SUF(const T* G, const T* x, const T* dx,        \
                                  long long n, int p, int d0, const T* coef,  \
                                  int profile, int need_x, int need_s,        \
                                  int wide, T* part, T* scal, void* stream)   \
    {                                                                         \
        return launch_gram_sym_bwd_jvp(G, x, dx, n, p, d0, coef, profile,     \
                                       need_x, need_s, wide, part, scal,      \
                                       stream);                               \
    }

LSQ_GRAM(float, _f32)
LSQ_GRAM(double, _f64)

#undef LSQ_GRAM

}  // extern "C"
