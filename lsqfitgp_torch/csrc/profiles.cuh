// The isotropic profiles the port's kernels evaluate in device code
// (kernels C, D and E and the tangent and backward kernels of C and E).
//
// A TPU kernel traces any profile callable; a CUDA kernel cannot, so a
// profile is an integer id into this registry (PROFILE_*), matching
// ops/_gram.py PROFILES, evaluated by a switch that every thread of a
// launch takes the same way.  A Gram entry is a sum of up to MAXTERMS
// terms,
//
//     K(r2) = b + sum_t c_t g_t(t_t),  t_t = mode_t(w_t r2),
//
// where g_t is the core of term t in its own argument (r^2 for the
// 'squared' cores, the distance for the 'abs' and 'posabs' ones), mode_t
// the JAX package's distance transform of the scaled r^2 (squared:
// itself; abs: sqrt(max(u, tiny)); posabs: sqrt(u + eps^2)), w_t the
// term's r^2 factor (1 / scale^2) and c_t the product of the 'mul'
// steps of the term's and the sum's post chains.  A single kernel with
// its post chain is one term with w = 1.
//
// The parameter vector, in device memory, one layout for C, D, E and
// the tangent kernels (ops/_gram.py `_fold` forms it):
//     params[0]           b, every 'add' step of the chains folded
//     params[1]           the diagonal term of the caller (kernel C's
//                         nugget, kernel D's eps; 0 without one)
//     params[2 + 4 t + 0] c_t, the term's coefficient
//     params[2 + 4 t + 1] w_t, the term's r^2 factor
//     params[2 + 4 t + 2] a_t, the core's first argument
//     params[2 + 4 t + 3] b_t, the core's second argument
// (unused arguments 0).  The backwards return the gradient of <G, K>
// with respect to this vector; the tangent kernels take its tangent.
// Static numbers that choose code ride a launch argument instead: each
// term's code, 16 bits of `codes` (term t at bit 16 t), holds the
// profile id (bits 0-3), the mode (bits 4-5) and the static integer k
// (bits 6-15: Maternp's p).  The static gamma = 2 and alpha = 2 branches
// of GammaExp and Cauchy are ids of their own.
//
// Two evaluators take this vector.  FixedExpQuad is the single ExpQuad
// term with w = 1 (the main path's profile), compiled as before;
// Zoo reads the term list at run time.  Kernels C and E and their
// derivative kernels take the evaluator as a template parameter (the
// host picks it), kernel D's tile initializer always takes Zoo, which
// writes the same bits as FixedExpQuad for that term.

#pragma once

#include <cfloat>
#include <cuda_runtime.h>

namespace lsq {

constexpr int MAXTERMS = 4;      // terms of a sum the kernels evaluate
constexpr int TERMPAR = 4;       // parameters per term (c, w, a, b)
constexpr int MATERNP_MAX = 16;  // the largest Maternp order

enum {
    PROFILE_EXPQUAD = 0,    // exp(-t/2)
    PROFILE_MATERNP = 1,    // Matern (k + 1/2) of (2k + 1) t
    PROFILE_GAMMAEXP = 2,   // exp(-(t + tiny)^(a/2)), exp(-t) at a == 2
    PROFILE_GAMMAEXP2 = 3,  // exp(-t), GammaExp's static gamma = 2
    PROFILE_CAUCHY = 4,     // (1 + P / b)^(-b / a), P = (t + tiny)^(a/2)
    PROFILE_CAUCHY2 = 5,    // (1 + t / a)^(-a / 2), Cauchy's static alpha = 2
    PROFILE_EXPON = 6,      // exp(-t), t the distance
};

enum { MODE_SQUARED = 0, MODE_ABS = 1, MODE_POSABS = 2 };

__device__ __forceinline__ float dexp(float v) { return expf(v); }
__device__ __forceinline__ double dexp(double v) { return exp(v); }
__device__ __forceinline__ float dlog(float v) { return logf(v); }
__device__ __forceinline__ double dlog(double v) { return log(v); }
__device__ __forceinline__ float dlog1p(float v) { return log1pf(v); }
__device__ __forceinline__ double dlog1p(double v) { return log1p(v); }
__device__ __forceinline__ float dsqrt(float v) { return sqrtf(v); }
__device__ __forceinline__ double dsqrt(double v) { return sqrt(v); }

template <typename T> struct Lim;
template <> struct Lim<float> {
    static __device__ __forceinline__ float tiny() { return FLT_MIN; }
    static __device__ __forceinline__ float eps() { return FLT_EPSILON; }
};
template <> struct Lim<double> {
    static __device__ __forceinline__ double tiny() { return DBL_MIN; }
    static __device__ __forceinline__ double eps() { return DBL_EPSILON; }
};

// The half-integer Matern polynomials: f_p(x^2) = e^-x Q_p(x) with
// Q_p(x) = sum_k q[p][k] x^k, q[p][k] = p!/(2p)! (2p-k)!/((p-k)! k!) 2^k;
// and the factors of the derivatives in t (x^2 = (2p + 1) t) by the
// recurrence, (2p + 1) / (2 (2p - 1)) and (2p + 1)^2 / (4 (2p - 1)
// (2p - 3)), so that the device divides by no p-dependent number
struct MaternTable {
    double d[MATERNP_MAX + 1][MATERNP_MAX + 1];
    float f[MATERNP_MAX + 1][MATERNP_MAX + 1];
    double d1d[MATERNP_MAX + 1], d2d[MATERNP_MAX + 1];
    float d1f[MATERNP_MAX + 1], d2f[MATERNP_MAX + 1];
};

constexpr double cfact(int n)
{
    double r = 1;
    for (int i = 2; i <= n; ++i) r *= i;
    return r;
}

constexpr MaternTable make_matern()
{
    MaternTable t{};
    for (int p = 0; p <= MATERNP_MAX; ++p) {
        double two = 1;
        for (int k = 0; k <= p; ++k) {
            t.d[p][k] = cfact(p) / cfact(2 * p) * cfact(2 * p - k)
                / (cfact(p - k) * cfact(k)) * two;
            t.f[p][k] = (float)t.d[p][k];
            two *= 2;
        }
        const double s = 2 * p + 1;
        t.d1d[p] = p >= 1 ? s / (2 * (2 * p - 1)) : 0;
        t.d2d[p] = p >= 2 ? s * s / (4 * (2 * p - 1) * (2 * p - 3)) : 0;
        t.d1f[p] = (float)t.d1d[p];
        t.d2f[p] = (float)t.d2d[p];
    }
    return t;
}

static __constant__ MaternTable kMatern = make_matern();

__device__ __forceinline__ float mcoef(float, int p, int k)
{
    return kMatern.f[p][k];
}
__device__ __forceinline__ double mcoef(double, int p, int k)
{
    return kMatern.d[p][k];
}
__device__ __forceinline__ float mfac1(float, int p) { return kMatern.d1f[p]; }
__device__ __forceinline__ double mfac1(double, int p)
{
    return kMatern.d1d[p];
}
__device__ __forceinline__ float mfac2(float, int p) { return kMatern.d2f[p]; }
__device__ __forceinline__ double mfac2(double, int p)
{
    return kMatern.d2d[p];
}

// Q_p(x) by Horner
template <typename T>
__device__ __forceinline__ T maternq(int p, T x)
{
    T q = mcoef(T(0), p, p);
    for (int k = p - 1; k >= 0; --k) q = fma(q, x, mcoef(T(0), p, k));
    return q;
}

// The ExpQuad profile of the main path (FixedExpQuad), in r^2.
template <int ID> struct Profile;

template <> struct Profile<PROFILE_EXPQUAD> {
    template <typename T>
    static __device__ __forceinline__ T value(T r2)
    {
        return dexp(T(-0.5) * r2);
    }
    // g and g'(r^2) from one exponential
    template <typename T>
    static __device__ __forceinline__ T both(T r2, T& deriv)
    {
        const T g = value(r2);
        deriv = T(-0.5) * g;
        return g;
    }
    // g, g' and g''(r^2) from one exponential
    template <typename T>
    static __device__ __forceinline__ T second(T r2, T& d1, T& d2)
    {
        const T g = value(r2);
        d1 = T(-0.5) * g;
        d2 = T(0.25) * g;
        return g;
    }
};

// What a core gives at its argument t: the value, its first and second
// t-derivatives (when D1, D2) and its derivatives in the arguments a
// and b (when DA).
template <typename T>
struct Core {
    T g, g1, g2, ga, gb;
};

template <typename T, bool D1, bool D2, bool DA>
__device__ __forceinline__ Core<T> core_eval(int id, int k, T t, T a, T b)
{
    Core<T> o{T(0), T(0), T(0), T(0), T(0)};
    switch (id) {
    case PROFILE_EXPQUAD: {
        o.g = dexp(T(-0.5) * t);
        o.g1 = T(-0.5) * o.g;
        o.g2 = T(0.25) * o.g;
        break;
    }
    case PROFILE_GAMMAEXP2:
    case PROFILE_EXPON: {
        o.g = dexp(-t);
        o.g1 = -o.g;
        o.g2 = o.g;
        break;
    }
    case PROFILE_MATERNP: {
        // g(t) = f_k(x2), x2 = (2k + 1) t; d/dx2 f_k = -f_{k-1} / (2 (2k - 1))
        const T s = T(2 * k + 1), x2 = s * t, x = dsqrt(x2);
        const T e = dexp(-x);
        o.g = e * maternq(k, x);
        if (D1 && k >= 1) o.g1 = -mfac1(T(0), k) * e * maternq(k - 1, x);
        if (D2 && k >= 2) o.g2 = mfac2(T(0), k) * e * maternq(k - 2, x);
        if ((D1 && k == 0) || (D2 && k <= 1)) {
            // the singular derivatives take x clamped at sqrt(tiny)
            const T xc = dsqrt(fmax(x2, Lim<T>::tiny()));
            const T ec = dexp(-xc);
            if (k == 0) {
                o.g1 = -ec / (T(2) * xc);
                o.g2 = x2 > Lim<T>::tiny()
                    ? ec * (xc + T(1)) / (T(4) * xc * xc * xc)
                    : T(0);
            } else {
                o.g2 = s * s * ec / (T(4) * xc);
            }
        }
        break;
    }
    case PROFILE_GAMMAEXP: {
        if (a == T(2)) {
            o.g = dexp(-t);
            o.g1 = -o.g;
            o.g2 = o.g;
        } else {
            const T h = T(0.5) * a, tt = t + Lim<T>::tiny(), ls = dlog(tt);
            const T s = dexp(h * ls);
            o.g = dexp(-s);
            o.g1 = -o.g * h * s / tt;
            o.g2 = -o.g1 * (h * s - (h - T(1))) / tt;
            if (DA) o.ga = -o.g * s * ls * T(0.5);
        }
        break;
    }
    case PROFILE_CAUCHY: {
        T P = t, Pt = T(1), Ptt = T(0), Pa = T(0);
        if (a != T(2)) {
            const T h = T(0.5) * a, tt = t + Lim<T>::tiny(), ls = dlog(tt);
            P = dexp(h * ls);
            Pt = h * P / tt;
            Ptt = (h - T(1)) * Pt / tt;
            Pa = P * ls * T(0.5);
        }
        const T B = T(1) + P / b, lB = dlog1p(P / b);
        o.g = dexp(-(b / a) * lB);
        o.g1 = -o.g * Pt / (a * B);
        o.g2 = -(o.g1 * Pt / B + o.g * Ptt / B - o.g * Pt * Pt / (b * B * B))
            / a;
        if (DA) {
            o.ga = o.g * (b / (a * a) * lB - Pa / (a * B));
            o.gb = o.g * (P / (b * B) - lB) / a;
        }
        break;
    }
    case PROFILE_CAUCHY2: {
        const T B = T(1) + t / a, lB = dlog1p(t / a);
        o.g = dexp(T(-0.5) * a * lB);
        o.g1 = T(-0.5) * o.g / B;
        o.g2 = T(-0.5) * (o.g1 / B - o.g / (a * B * B));
        if (DA) o.ga = T(0.5) * o.g * (t / (a * B) - lB);
        break;
    }
    }
    return o;
}

// A term at r^2 = u / w: the core at mode(u) and its derivatives in u
// (the mode's chain rule applied): g, gu, guu, ga, gb.  Not inlined: the
// kernels evaluate entries in fully unrolled loops (a thread's 64 entries
// in C), and an inlined copy of every profile at each would make the
// Zoo kernels, and kernel D's tile initializers, take minutes to build;
// one call per term and entry instead.
template <typename T, bool D1, bool D2, bool DA>
__device__ __noinline__ Core<T> term_eval(unsigned code, T u, T a, T b)
{
    const int id = code & 15u, mode = (code >> 4) & 3u, k = code >> 6;
    if (mode == MODE_SQUARED) return core_eval<T, D1, D2, DA>(id, k, u, a, b);
    T v, tu;
    bool pos = true;
    if (mode == MODE_ABS) {
        // sqrt(max(u, tiny)): no derivative below tiny, as jnp.maximum's
        v = fmax(u, Lim<T>::tiny());
        pos = u > Lim<T>::tiny();
    } else {
        v = u + Lim<T>::eps() * Lim<T>::eps();
    }
    const T t = dsqrt(v);
    Core<T> o = core_eval<T, D1 || D2, D2, DA>(id, k, t, a, b);
    tu = pos ? T(0.5) / t : T(0);
    if (D2) o.g2 = pos ? o.g2 * tu * tu - o.g1 * tu / (T(2) * v) : T(0);
    if (D1) o.g1 = o.g1 * tu;
    return o;
}

__device__ __forceinline__ unsigned term_code(unsigned long long codes, int t)
{
    return (unsigned)(codes >> (16 * t)) & 0xffffu;
}

// The single ExpQuad term with w = 1: K = c g(r2) + b.
template <typename T>
struct FixedExpQuad {
    static constexpr int NS = 1;  // its parameter sums: sum G g (for c)
    using P = Profile<PROFILE_EXPQUAD>;
    T c, b;

    __device__ __forceinline__ FixedExpQuad(const T* __restrict__ params,
                                            int, unsigned long long)
        : c(params[2]), b(params[0])
    {
    }
    __device__ __forceinline__ T value(T r2) const
    {
        return fma(c, P::value(r2), b);
    }
    // dK/dr2; with PAR, acc[0] += gv g
    template <bool PAR>
    __device__ __forceinline__ T grad(T r2, T gv, T (&acc)[NS]) const
    {
        T dg;
        const T g = P::both(r2, dg);
        if (PAR) acc[0] = fma(gv, g, acc[0]);
        return c * dg;
    }
    // the tangent of K along dr2 and the parameters' tangent dp (the
    // weight of dr2 zero at r2 <= 0)
    __device__ __forceinline__ T tangent(T r2, T dr2,
                                         const T* __restrict__ dp) const
    {
        T d1;
        const T g = P::both(r2, d1);
        T v = fma(dp[2], g, dp[0]);
        if (r2 > T(0)) v = fma(c * d1, dr2, v);
        return v;
    }
    // the term's g, dg/dr2 and d2g/dr2^2 (kernels C'' and E'')
    __device__ __forceinline__ T second(T r2, T& d1, T& d2) const
    {
        return P::second(r2, d1, d2);
    }
};

// Up to MAXTERMS terms of any registered profile, read at run time.
template <typename T>
struct Zoo {
    static constexpr int NS = TERMPAR * MAXTERMS;
    const T* __restrict__ p;
    int n;
    unsigned long long codes;

    __device__ __forceinline__ Zoo(const T* __restrict__ params, int nterms,
                                   unsigned long long cd)
        : p(params), n(nterms), codes(cd)
    {
    }
    __device__ __forceinline__ T value(T r2) const
    {
        T v = p[0];
#pragma unroll
        for (int t = 0; t < MAXTERMS; ++t) {
            if (t >= n) break;
            const T* q = p + 2 + TERMPAR * t;
            const Core<T> o = term_eval<T, false, false, false>(
                term_code(codes, t), r2 * q[1], q[2], q[3]);
            v = fma(q[0], o.g, v);
        }
        return v;
    }
    // dK/dr2; with PAR, acc[4 t + (0, 1, 2, 3)] += gv dK/d(c, w, a, b)_t
    template <bool PAR>
    __device__ __forceinline__ T grad(T r2, T gv, T (&acc)[NS]) const
    {
        T d1 = T(0);
#pragma unroll
        for (int t = 0; t < MAXTERMS; ++t) {
            if (t >= n) break;
            const T* q = p + 2 + TERMPAR * t;
            const Core<T> o = term_eval<T, true, false, PAR>(
                term_code(codes, t), r2 * q[1], q[2], q[3]);
            const T cg = q[0] * o.g1;
            d1 = fma(cg, q[1], d1);
            if (PAR) {
                acc[TERMPAR * t] = fma(gv, o.g, acc[TERMPAR * t]);
                if (r2 > T(0))
                    acc[TERMPAR * t + 1] =
                        fma(gv, cg * r2, acc[TERMPAR * t + 1]);
                acc[TERMPAR * t + 2] =
                    fma(gv, q[0] * o.ga, acc[TERMPAR * t + 2]);
                acc[TERMPAR * t + 3] =
                    fma(gv, q[0] * o.gb, acc[TERMPAR * t + 3]);
            }
        }
        return d1;
    }
    __device__ __forceinline__ T tangent(T r2, T dr2,
                                         const T* __restrict__ dp) const
    {
        T v = dp[0];
#pragma unroll
        for (int t = 0; t < MAXTERMS; ++t) {
            if (t >= n) break;
            const T* q = p + 2 + TERMPAR * t;
            const T* dq = dp + 2 + TERMPAR * t;
            const Core<T> o = term_eval<T, true, false, true>(
                term_code(codes, t), r2 * q[1], q[2], q[3]);
            v = fma(dq[0], o.g, v);
            T s = fma(o.ga, dq[2], o.gb * dq[3]);
            if (r2 > T(0)) s = fma(o.g1, fma(q[1], dr2, r2 * dq[1]), s);
            v = fma(q[0], s, v);
        }
        return v;
    }
    __device__ __forceinline__ T second(T r2, T& d1, T& d2) const
    {
        const T w = p[3];
        const Core<T> o = term_eval<T, true, true, false>(
            term_code(codes, 0), r2 * w, p[4], p[5]);
        d1 = w * o.g1;
        d2 = w * w * o.g2;
        return o.g;
    }
};

// r^2 = |x - y|^2 and its tangent dr^2 = 2 (x - y).(dx - dy), summed
// as `sqdist` sums r^2: symmetric in the two points to the bit.
template <typename T>
__device__ __forceinline__ T sqdist_tangent(const T* __restrict__ x,
                                            const T* __restrict__ y,
                                            const T* __restrict__ dx,
                                            const T* __restrict__ dy, int p,
                                            T& dr2)
{
    T r2 = T(0), t = T(0);
    for (int d = 0; d < p; ++d) {
        const T dl = x[d] - y[d];
        r2 = fma(dl, dl, r2);
        t = fma(dl, dx[d] - dy[d], t);
    }
    dr2 = T(2) * t;
    return r2;
}

// Squared distance of points x and y (p coordinates each), summed
// directly: at p = 1 the exact squared difference, at p > 1 a sum of
// p such terms (relative error ~p u whatever the coordinates' offset,
// so no centering is needed).  Symmetric in x and y to the bit.
template <typename T>
__device__ __forceinline__ T sqdist(const T* __restrict__ x,
                                    const T* __restrict__ y, int p)
{
    T r2 = T(0);
    for (int d = 0; d < p; ++d) {
        const T dl = x[d] - y[d];
        r2 = fma(dl, dl, r2);
    }
    return r2;
}

}  // namespace lsq
