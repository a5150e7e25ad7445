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
// profile id (bits 0-4), the mode (bits 5-6) and the static integer k
// (bits 7-15: Maternp's p, Wendland's k).  The static gamma = 2 and
// alpha = 2 branches of GammaExp and Cauchy are ids of their own.
//
// The cores of the 1-D time-series kernels (Periodic, Celerite,
// Harmonic, Cos, Sinc) and the rest of the 'abs'/'posabs' zoo
// (HoleEffect, CausalExpQuad, Log, Wendland, Circular) are functions of
// the distance t.  Their trigonometric functions take full range
// reduction (sincos, sin; this code never takes the __sinf intrinsics
// and the build has no --use_fast_math): the time-series path reaches
// |t| ~ 1e4.  Log's and Sinc's closed forms cancel near t = 0, so below
// a threshold they take their power series (LOG_SERIES, SINC_SERIES in
// ops/_gram.py).
//
// The last five are the cores of StationaryFracBrownian, Matern of real
// order, Bessel, Pink and Color.  StationaryFracBrownian's three powers
// of about t^2H cancel to a value of about t^(2H-2) (an error of 0.1 in
// float32 at t = 16384, H = 0.75, against a value of 0.003): from
// SFB_SERIES on it sums the binomial series t^2H sum_j C(2H, 2j) t^-2j,
// SFB_TERMS terms, and its t- and H-derivatives from the same sums.
// Matern's and Bessel's static orders, Pink's delta-omega and
// StationaryFracBrownian's H ride the argument a (the orders without a
// gradient); Color's n is k.  Their special functions are in
// special.cuh; the five cores are functions of their own, not inlined,
// reached through a term function of their own (special_term) that only
// ZooSpecial calls: a kernel takes the registers of every function its
// code can call (one Zoo for all cores made the earlier profiles' kernels
// take 64 registers where they took 48, and their backwards 28-36 %
// longer).
//
// Three evaluators take this vector.  FixedExpQuad is the single ExpQuad
// term with w = 1 (the main path's profile), compiled as before; Zoo
// reads a term list of closed-form profiles at run time, ZooSpecial one
// of any profile.  Kernels C and E and their derivative kernels take the
// evaluator as a template parameter (the host picks it; gram_special.cu
// builds ZooSpecial's kernels in a process of its own), kernel D's tile
// initializer always takes ZooSpecial, which writes the same bits as
// FixedExpQuad for that term.

#pragma once

#include <cfloat>
#include <cuda_runtime.h>

#include "special.cuh"

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
    PROFILE_PERIODIC = 7,   // exp(-2 sin^2(t/2) / a^2)
    PROFILE_HOLEEFFECT = 8, // (1 - t) exp(-t)
    PROFILE_CAUSALEXPQUAD = 9,  // erfc(a t / 4) exp(-t^2 / 2)
    PROFILE_LOG = 10,       // log1p(t) / t
    PROFILE_WENDLAND = 11,  // (1 - t)_+^(nu + k) P_k(t), nu = k + a
    PROFILE_CIRCULAR = 12,  // (1 + a s / b)(1 - s / b)_+^a, s = dist(t, Z)
    PROFILE_CELERITE = 13,  // exp(-a t)(cos t + b sin t)
    PROFILE_HARMONIC = 14,  // the damped oscillator of quality factor a
    PROFILE_COS = 15,       // cos t
    PROFILE_SINC = 16,      // sin(pi t) / (pi t)
    PROFILE_SFB = 17,       // (|t+1|^2a + |t-1|^2a - 2 t^2a) / 2
    PROFILE_MATERN = 18,    // f_a(s t), s = 2a: Matern of real order a
    PROFILE_BESSEL = 19,    // Gamma(a+1) (2/x)^a J_a(x), x^2 = (2 + a/2)^2 t
    PROFILE_PINK = 20,      // (Ci(t (1 + a)) - Ci(t)) / log1p(a)
    PROFILE_COLOR = 21,     // (k - 1) Re E_k(-i t)
};

enum { MODE_SQUARED = 0, MODE_ABS = 1, MODE_POSABS = 2 };

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

// Wendland's polynomial P_k(t) = sum_j c_j(nu) t^(k - j): the
// coefficient c_j as a polynomial in nu = k + alpha, lowest power first
// (lsqfitgp_tpu/kernels/_wendland.py's table), and the series of Log's
// and Sinc's cores below their thresholds: log1p(t)/t = sum_j (-t)^j /
// (j + 1) for t < LOG_SERIES and sin(x)/x = sum_j (-1)^j x^(2j) /
// (2j + 1)! for x = pi t < SINC_SERIES (ops/_gram.py's constants)
constexpr int WENDLAND_KMAX = 3;
constexpr int LOG_TERMS = 20, SINC_TERMS = 10;
constexpr double LOG_SERIES = 0.1, SINC_SERIES = 1.0;

struct SeriesTable {
    double wd[WENDLAND_KMAX + 1][WENDLAND_KMAX + 1][4];
    float wf[WENDLAND_KMAX + 1][WENDLAND_KMAX + 1][4];
    double logd[LOG_TERMS + 1], sincd[SINC_TERMS + 1];
    float logf_[LOG_TERMS + 1], sinc_f[SINC_TERMS + 1];
};

constexpr SeriesTable make_series()
{
    SeriesTable t{};
    // wd[k][j] = c_j(nu), lowest power of nu first
    const double w[4][4][4] = {
        {{1, 0, 0, 0}},
        {{1, 1, 0, 0}, {1, 0, 0, 0}},
        {{1, 4. / 3, 1. / 3, 0}, {2, 1, 0, 0}, {1, 0, 0, 0}},
        {{1, 23. / 15, 3. / 5, 1. / 15}, {3, 12. / 5, 2. / 5, 0},
         {3, 1, 0, 0}, {1, 0, 0, 0}},
    };
    for (int k = 0; k <= WENDLAND_KMAX; ++k)
        for (int j = 0; j <= WENDLAND_KMAX; ++j)
            for (int m = 0; m < 4; ++m) {
                t.wd[k][j][m] = w[k][j][m];
                t.wf[k][j][m] = (float)w[k][j][m];
            }
    for (int j = 0; j <= LOG_TERMS; ++j) {
        t.logd[j] = (j % 2 ? -1.0 : 1.0) / (j + 1);
        t.logf_[j] = (float)t.logd[j];
    }
    double c = 1;
    for (int j = 0; j <= SINC_TERMS; ++j) {
        if (j > 0) c = -c / ((2 * j) * (2 * j + 1));
        t.sincd[j] = c;
        t.sinc_f[j] = (float)c;
    }
    return t;
}

static __constant__ SeriesTable kSeries = make_series();

__device__ __forceinline__ float wcoef(float, int k, int j, int m)
{
    return kSeries.wf[k][j][m];
}
__device__ __forceinline__ double wcoef(double, int k, int j, int m)
{
    return kSeries.wd[k][j][m];
}
__device__ __forceinline__ float logcoef(float, int j)
{
    return kSeries.logf_[j];
}
__device__ __forceinline__ double logcoef(double, int j)
{
    return kSeries.logd[j];
}
__device__ __forceinline__ float sinccoef(float, int j)
{
    return kSeries.sinc_f[j];
}
__device__ __forceinline__ double sinccoef(double, int j)
{
    return kSeries.sincd[j];
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

// StationaryFracBrownian's series: the number of terms per dtype
// (ops/_gram.py SFB_SERIES, SFB_TERMS)
constexpr double SFB_SERIES = 2.0;
template <typename T> struct SfbTerms;
template <> struct SfbTerms<float> { static constexpr int n = 14; };
template <> struct SfbTerms<double> { static constexpr int n = 30; };

// StationaryFracBrownian, alpha = 2 H, H = a (ops/_gram.py _sfb_parts)
template <typename T, bool D1, bool D2, bool DA>
__device__ __noinline__ Core<T> sfb_core(T t, T a)
{
    Core<T> o{T(0), T(0), T(0), T(0), T(0)};
    const T al = T(2) * a;
    if (t < T(SFB_SERIES)) {
        // the three powers; a zero base has no H-derivative
        const T bases[3] = {t + T(1), fabs(t - T(1)), t};
        const T wts[3] = {T(0.5), T(0.5), T(-1)};
        const T sg = t >= T(1) ? T(1) : T(-1);
#pragma unroll
        for (int i = 0; i < 3; ++i) {
            const T base = bases[i], w = wts[i];
            const T pw = ni_pow(base, al);
            o.g = fma(w, pw, o.g);
            if (D1)
                o.g1 = fma(w * (i == 1 ? sg : T(1)) * al,
                           ni_pow(base, al - T(1)), o.g1);
            if (D2)
                o.g2 = fma(w * al * (al - T(1)), ni_pow(base, al - T(2)), o.g2);
            if (DA && base > T(0))
                o.ga = fma(T(2) * w, dlog(base) * pw, o.ga);
        }
        return o;
    }
    // t^alpha sum_{j>=1} C(alpha, 2j) t^-2j; C and dC/dalpha by the
    // product recurrence C(alpha, i+1) = C(alpha, i) (alpha - i) / (i + 1)
    const T z = T(1) / (t * t), lt = dlog(t), P = dexp(al * lt);
    T c = T(1), dc = T(0), zj = T(1);
    T s0 = T(0), s1 = T(0), s2 = T(0), sh = T(0);
#pragma unroll 1
    for (int j = 1; j <= SfbTerms<T>::n; ++j) {
#pragma unroll
        for (int i = 2 * j - 2; i < 2 * j; ++i) {
            const T ai = al - T(i), inv = T(i + 1);
            const T cn = c * ai / inv;
            dc = (dc * ai + c) / inv;
            c = cn;
        }
        zj *= z;
        const T m = al - T(2 * j);
        s0 += c * zj;
        if (D1) s1 += c * m * zj;
        if (D2) s2 += c * m * (m - T(1)) * zj;
        if (DA) sh += dc * zj;
    }
    o.g = P * s0;
    o.g1 = P / t * s1;
    o.g2 = P / (t * t) * s2;
    o.ga = T(2) * P * (sh + lt * s0);
    return o;
}

// Pink, delta-omega = a (ops/_gram.py _pink): below t a < sqrt(eps),
// cos(t m), m = 1 + a/2; cos(t u) - cos t, u = 1 + a, as -2 sin(t m)
// sin(t a/2), which does not cancel
template <typename T, bool D1, bool D2, bool DA>
__device__ __noinline__ Core<T> pink_core(T t, T a)
{
    Core<T> o{T(0), T(0), T(0), T(0), T(0)};
    const T u = T(1) + a, m = T(1) + T(0.5) * a;
    T sm, cm;
    ni_sincos(t * m, &sm, &cm);
    if (t * a < dsqrt(Lim<T>::eps())) {
        o.g = cm;
        o.g1 = -m * sm;
        o.g2 = -m * m * cm;
        if (DA) o.ga = T(-0.5) * t * sm;
        return o;
    }
    const T L = dlog1p(a);
    o.g = (cosint(t * u) - cosint(t)) / L;
    if (D1 || D2 || DA) {
        T stu, ctu;
        ni_sincos(t * u, &stu, &ctu);
        const T A = T(-2) * sm * ni_sin(T(0.5) * a * t);
        o.g1 = A / (t * L);
        o.g2 = ((ni_sin(t) - u * stu) / t - A / (t * t)) / L;
        if (DA) o.ga = (ctu - o.g) / (u * L);
    }
    return o;
}

// Matern of real order nu = a, in t = r^2 (ops/_gram.py _matern): f_nu
// at x2 = s t, s = 2 nu; its derivatives by the recurrences regular at
// 0 (nu > 1, nu > 2), else by the quadrature's raw forms; nu = 0 is
// white noise
template <typename T, bool D1, bool D2>
__device__ __noinline__ Core<T> matern_core(T nu, T t)
{
    Core<T> o{T(0), T(0), T(0), T(0), T(0)};
    if (nu == T(0)) {
        o.g = T(2) * t <= Lim<T>::tiny() ? T(1) : T(0);
        return o;
    }
    const T s = T(2) * nu, x2 = s * t;
    o.g = kvmodx2(nu, x2);
    if (D1)
        o.g1 = s * (nu > T(1)
                    ? -kvmodx2(nu - T(1), x2) / (T(4) * (nu - T(1)))
                    : kvmodx2_raw(nu, x2, 1));
    if (D2)
        o.g2 = s * s * (nu > T(2)
                        ? kvmodx2(nu - T(2), x2)
                            / (T(16) * (nu - T(1)) * (nu - T(2)))
                        : kvmodx2_raw(nu, x2, 2));
    return o;
}

// Bessel of order nu = a, in t = r^2 (ops/_gram.py _bessel): f_nu at
// x2 = (2 + nu/2)^2 t, f_nu' = -f_{nu+1} / (4 (nu + 1))
template <typename T, bool D1, bool D2>
__device__ __noinline__ Core<T> bessel_core(T nu, T t)
{
    Core<T> o{T(0), T(0), T(0), T(0), T(0)};
    const T h = T(2) + nu / T(2), s = h * h, x2 = s * t;
    o.g = jvmodx2(nu, x2);
    if (D1)
        o.g1 = s * (-jvmodx2(nu + T(1), x2) / (T(4) * (nu + T(1))));
    if (D2)
        o.g2 = s * s * (jvmodx2(nu + T(2), x2)
                        / (T(16) * (nu + T(1)) * (nu + T(2))));
    return o;
}

// Color of order n = k (ops/_gram.py _color): (n - 1) Re E_n(-it), g' =
// -(n - 1) Im E_{n-1}(-it), g'' = -(n - 1) Re E_{n-2}(-it); below 1 each
// order's series, above one continued fraction and the recurrence
// E_{m-1} = (e^{it} - (m - 1) E_m) / (-it); below eps the limits
template <typename T, bool D1, bool D2>
__device__ __noinline__ Core<T> color_core(int n, T t)
{
    Core<T> o{T(0), T(0), T(0), T(0), T(0)};
    const T f = T(n - 1);
    if (t < Lim<T>::eps()) {
        o.g = f * T(1.0 / (n - 1));
        return o;
    }
    T re, im;
    if (t < T(1)) {
        expn_series(n, t, re, im);
        o.g = f * re;
        if (D1) {
            expn_series(n - 1, t, re, im);
            o.g1 = -f * im;
        }
        if (D2) {
            expn_series(n - 2, t, re, im);
            o.g2 = -f * re;
        }
        return o;
    }
    expn_cf(n, t, re, im);
    o.g = f * re;
    if (D1 || D2) {
        T sn, cs;
        ni_sincos(t, &sn, &cs);
        // E_{n-1} = (w_r + i w_i) / (-it) = (-w_i + i w_r) / t, w_r =
        // cos t - (n - 1) Re E_n: g' takes its imaginary part
        const T wr = cs - f * re;
        const T i1 = wr / t;
        o.g1 = -f * i1;
        if (D2) o.g2 = -f * (-(sn - T(n - 2) * i1) / t);
    }
    return o;
}

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
    case PROFILE_PERIODIC: {
        // a is the outer scale
        T s, c;
        dsincos(t, &s, &c);
        const T h = dsin(T(0.5) * t), ia2 = T(1) / (a * a);
        o.g = dexp(T(-2) * h * h * ia2);
        o.g1 = -o.g * s * ia2;
        o.g2 = o.g * (s * s * ia2 - c) * ia2;
        if (DA) o.ga = T(4) * o.g * h * h * ia2 / a;
        break;
    }
    case PROFILE_HOLEEFFECT: {
        const T e = dexp(-t);
        o.g = (T(1) - t) * e;
        o.g1 = (t - T(2)) * e;
        o.g2 = (T(3) - t) * e;
        break;
    }
    case PROFILE_CAUSALEXPQUAD: {
        // c = alpha / 4; d = 2/sqrt(pi) exp(-c^2 t^2) exp(-t^2/2)
        const T c = T(0.25) * a;
        const T E = dexp(T(-0.5) * t * t);
        o.g = derfc(c * t) * E;
        const T d = T(1.1283791670955126) * dexp(-(c * c + T(0.5)) * t * t);
        o.g1 = -c * d - t * o.g;
        o.g2 = c * d * t * (T(2) * c * c + T(1)) - o.g - t * o.g1;
        if (DA) o.ga = T(-0.25) * t * d;
        break;
    }
    case PROFILE_LOG: {
        if (t < T(LOG_SERIES)) {
            T s0 = T(0), s1 = T(0), s2 = T(0);
            for (int j = LOG_TERMS; j >= 0; --j) {
                const T c = logcoef(T(0), j);
                s0 = fma(s0, t, c);
                if (j >= 1) s1 = fma(s1, t, c * T(j));
                if (j >= 2) s2 = fma(s2, t, c * T(j * (j - 1)));
            }
            o.g = s0;
            o.g1 = s1;
            o.g2 = s2;
        } else {
            const T L = dlog1p(t), u = T(1) / (T(1) + t), it = T(1) / t;
            o.g = L * it;
            o.g1 = (t * u - L) * it * it;
            o.g2 = (T(2) * L * it - T(2) * u) * it * it - u * u * it;
        }
        break;
    }
    case PROFILE_WENDLAND: {
        // P, its t-derivatives and its nu-derivative by Horner; the
        // coefficients c_j(nu) and c_j'(nu) by Horner in nu
        const T nu = T(k) + a, e = nu + T(k);
        T P = T(0), P1 = T(0), P2 = T(0), Pa = T(0);
        for (int j = 0; j <= k; ++j) {
            T cj = T(0), dcj = T(0);
            for (int m = 3; m >= 0; --m) {
                dcj = fma(dcj, nu, cj);
                cj = fma(cj, nu, wcoef(T(0), k, j, m));
            }
            P2 = fma(P2, t, P1);
            P1 = fma(P1, t, P);
            P = fma(P, t, cj);
            Pa = fma(Pa, t, dcj);
        }
        if (t < T(1)) {
            const T w = T(1) - t, L = dlog(w);
            const T we1 = dexp((e - T(1)) * L), we = we1 * w;
            o.g = we * P;
            o.g1 = we1 * (w * P1 - e * P);
            o.g2 = e * (e - T(1)) * we1 / w * P - T(2) * e * we1 * P1
                + we * T(2) * P2;
            if (DA) o.ga = we * (L * P + Pa);
        }
        break;
    }
    case PROFILE_CIRCULAR: {
        // tau = a, c = b; s the distance of t to the nearest integer
        const T x = t - floor(t);
        const T s = fmin(x, T(1) - x), q = T(1) - s / b;
        if (q > T(0)) {
            const T lq = dlog(q), qt1 = dexp((a - T(1)) * lq), qt = qt1 * q;
            const T f = a * (a + T(1)) / (b * b), u = T(1) + a * s / b;
            o.g = u * qt;
            o.g1 = (x <= T(0.5) ? -f : f) * s * qt1;
            o.g2 = -f * (qt1 - (a - T(1)) * s / b * qt1 / q);
            if (DA) {
                o.ga = s / b * qt + u * qt * lq;
                o.gb = f * s * s / b * qt1;
            }
        }
        break;
    }
    case PROFILE_CELERITE: {
        // gamma = a, B = b
        T s, c;
        dsincos(t, &s, &c);
        const T E = dexp(-a * t);
        o.g = E * fma(b, s, c);
        o.g1 = E * ((b - a) * c - fma(a, b, T(1)) * s);
        o.g2 = E * ((a * a - T(2) * a * b - T(1)) * c
                    + (T(2) * a + a * a * b - b) * s);
        if (DA) {
            o.ga = -t * o.g;
            o.gb = E * s;
        }
        break;
    }
    case PROFILE_HARMONIC: {
        // Q = a: within sqrt(eps) of 1 the Matern-3/2 form; below,
        // e^-s (cosh(eta s) + sinh(eta s) / eta) by e^-(1-eta)s and
        // expm1(-2 eta s), which cannot overflow; above, e^-s (cos(eta s)
        // + sin(eta s) / eta); s = t / Q, eta = sqrt|1 - Q^2|
        const T Q = a;
        if (fabs(Q - T(1)) < dsqrt(Lim<T>::eps())) {
            const T x = t / Q, e = dexp(-x), iQ = T(1) / Q;
            const T T3 = t * t * (T(1) + t / T(3)), P = (T(1) - Q) * T3;
            const T P1 = (T(1) - Q) * (T(2) * t + t * t);
            const T P2 = (T(1) - Q) * (T(2) + T(2) * t);
            o.g = (T(1) + x) * e + e * P;
            o.g1 = -x * e * iQ + e * (P1 - P * iQ);
            o.g2 = (x - T(1)) * e * iQ * iQ
                + e * (P * iQ * iQ - T(2) * P1 * iQ + P2);
            if (DA)
                o.ga = x * e * t * iQ * iQ
                    + e * T3 * ((T(1) - Q) * t * iQ * iQ - T(1));
        } else {
            const T s = t / Q;
            T eta, C, S, Sp, deta;
            if (Q < T(1)) {
                eta = dsqrt((T(1) - Q) * (T(1) + Q));
                const T A = dexp(-Q * Q / (T(1) + eta) * s);
                const T m = dexpm1(T(-2) * eta * s);
                C = T(0.5) * A * (T(2) + m);
                S = T(-0.5) * A * m;
                Sp = S;
                deta = -Q / eta;
            } else {
                eta = dsqrt((Q - T(1)) * (Q + T(1)));
                T sn, cs;
                dsincos(eta * s, &sn, &cs);
                const T e = dexp(-s);
                C = e * cs;
                Sp = e * sn;
                S = -Sp;
                deta = Q / eta;
            }
            o.g = C + Sp / eta;
            const T gs = -o.g + C + eta * S;
            o.g1 = gs / Q;
            o.g2 = (-gs - Q * Q * C) / (Q * Q);
            if (DA)
                o.ga = gs * (-s / Q)
                    + (s * S + s * C / eta - Sp / (eta * eta)) * deta;
        }
        break;
    }
    case PROFILE_COS: {
        T s, c;
        dsincos(t, &s, &c);
        o.g = c;
        o.g1 = -s;
        o.g2 = -c;
        break;
    }
    case PROFILE_SINC: {
        // f(x) = sin(x)/x at x = pi t; g' = pi f', g'' = pi^2 f''
        const T pi = T(3.141592653589793), x = pi * t;
        T f, f1, f2;
        if (x < T(SINC_SERIES)) {
            const T z = x * x;
            T s0 = T(0), s1 = T(0), s2 = T(0);
            for (int j = SINC_TERMS; j >= 0; --j) {
                const T c = sinccoef(T(0), j);
                s0 = fma(s0, z, c);
                if (j >= 1) {
                    s1 = fma(s1, z, c * T(2 * j));
                    s2 = fma(s2, z, c * T(2 * j * (2 * j - 1)));
                }
            }
            f = s0;
            f1 = s1 * x;
            f2 = s2;
        } else {
            T sn, cs;
            dsincos(x, &sn, &cs);
            const T ix = T(1) / x;
            f = sn * ix;
            f1 = (x * cs - sn) * ix * ix;
            f2 = -f - T(2) * f1 * ix;
        }
        o.g = f;
        o.g1 = pi * f1;
        o.g2 = pi * pi * f2;
        break;
    }
    }
    return o;
}

// The special-function cores (ids from PROFILE_SFB on), each a call
template <typename T, bool D1, bool D2, bool DA>
__device__ __forceinline__ Core<T> special_eval(int id, int k, T t, T a,
                                                T b)
{
    switch (id) {
    case PROFILE_SFB:
        return sfb_core<T, D1, D2, DA>(t, a);
    case PROFILE_MATERN:
        return matern_core<T, D1, D2>(a, t);
    case PROFILE_BESSEL:
        return bessel_core<T, D1, D2>(a, t);
    case PROFILE_PINK:
        return pink_core<T, D1, D2, DA>(t, a);
    default:
        return color_core<T, D1, D2>(k, t);
    }
}

// A term at r^2 = u / w: the core at mode(u) and its derivatives in u
// (the mode's chain rule applied): g, gu, guu, ga, gb; SPECIAL takes the
// special-function cores' switch, else the closed forms'.
template <typename T, bool D1, bool D2, bool DA, bool SPECIAL>
__device__ __forceinline__ Core<T> term_modes(unsigned code, T u, T a, T b)
{
    const int id = code & 31u, mode = (code >> 5) & 3u, k = code >> 7;
    if (mode == MODE_SQUARED)
        return SPECIAL ? special_eval<T, D1, D2, DA>(id, k, u, a, b)
                       : core_eval<T, D1, D2, DA>(id, k, u, a, b);
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
    Core<T> o = SPECIAL
        ? special_eval<T, D1 || D2, D2, DA>(id, k, t, a, b)
        : core_eval<T, D1 || D2, D2, DA>(id, k, t, a, b);
    tu = pos ? T(0.5) / t : T(0);
    if (D2) o.g2 = pos ? o.g2 * tu * tu - o.g1 * tu / (T(2) * v) : T(0);
    if (D1) o.g1 = o.g1 * tu;
    return o;
}

// Not inlined: the kernels evaluate entries in fully unrolled loops (a
// thread's 64 entries in C), and an inlined copy of every profile at each
// would make the Zoo kernels, and kernel D's tile initializers, take
// minutes to build; one call per term and entry instead.  A kernel takes
// the registers of every function its code can call, so the closed
// forms' evaluator (Zoo) calls closed_term only, and the special cores'
// (ZooSpecial) picks it or special_term by the term's id.
template <typename T, bool D1, bool D2, bool DA>
__device__ __noinline__ Core<T> closed_term(unsigned code, T u, T a, T b)
{
    return term_modes<T, D1, D2, DA, false>(code, u, a, b);
}

template <typename T, bool D1, bool D2, bool DA>
__device__ __noinline__ Core<T> special_term(unsigned code, T u, T a, T b)
{
    return term_modes<T, D1, D2, DA, true>(code, u, a, b);
}

template <typename T, bool D1, bool D2, bool DA, bool SPECIAL = true>
__device__ __forceinline__ Core<T> term_eval(unsigned code, T u, T a, T b)
{
    if (SPECIAL && (code & 31u) >= PROFILE_SFB)
        return special_term<T, D1, D2, DA>(code, u, a, b);
    return closed_term<T, D1, D2, DA>(code, u, a, b);
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

// Up to MAXTERMS terms, read at run time: of the closed-form profiles
// (ids below PROFILE_SFB; Zoo) or of any registered profile (SPECIAL;
// ZooSpecial).
template <typename T, bool SPECIAL>
struct ZooT {
    static constexpr int NS = TERMPAR * MAXTERMS;
    const T* __restrict__ p;
    int n;
    unsigned long long codes;

    __device__ __forceinline__ ZooT(const T* __restrict__ params,
                                    int nterms, unsigned long long cd)
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
            const Core<T> o = term_eval<T, false, false, false, SPECIAL>(
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
            // the argument derivatives whatever PAR: one instance of
            // term_eval less to build (no path takes PAR false but a
            // backward without the profile's parameters)
            const Core<T> o = term_eval<T, true, false, true, SPECIAL>(
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
            const Core<T> o = term_eval<T, true, false, true, SPECIAL>(
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
        const Core<T> o = term_eval<T, true, true, false, SPECIAL>(
            term_code(codes, 0), r2 * w, p[4], p[5]);
        d1 = w * o.g1;
        d2 = w * w * o.g2;
        return o.g;
    }
};

template <typename T> using Zoo = ZooT<T, false>;
template <typename T> using ZooSpecial = ZooT<T, true>;

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
