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
// SFB_SERIES on it sums the binomial series t^2H sum_j C(2H, 2j) t^-2j
// and its t- and H-derivatives by Horner, J(t) terms, on coefficients
// that sfb_table_kernel forms once per launch (SfbTerms).
// Matern's and Bessel's static orders, Pink's delta-omega and
// StationaryFracBrownian's H ride the argument a (the orders without a
// gradient); Color's n is k.  Their special functions are in
// special.cuh; the cores are functions of their own, not inlined,
// reached through term functions of their own (special_term, and
// matern_term and sfb_term for the real-order Matern and for
// StationaryFracBrownian, which read their tables) that
// only ZooSpecial calls: a kernel takes the registers of every function
// its code can call (one Zoo for all cores made the earlier profiles'
// kernels take 64 registers where they took 48, and their backwards
// 28-36 % longer).
//
// Five evaluators take this vector.  FixedExpQuad is the single ExpQuad
// term with w = 1 (the main path's profile), compiled as before; ZooOne
// one term of a closed-form profile, its profile a template parameter
// (the core inlined into the kernel); ZooSum a sum of 2 to MAXTERMS
// closed-form terms read at run time, a group of entries at a time, one
// switch on each term's id with the cores inlined in its cases; Zoo
// reads a term list of closed-form profiles at run time, a call per
// term and entry, ZooSpecial one of any profile.  Kernels C and E and
// their derivative kernels take the evaluator as a template parameter
// (the host picks it; gram_one.cu and gram_one_f64.cu build ZooOne's
// and ZooSum's C and C's backward, gram_special.cu and
// gram_special_f64.cu ZooSpecial's kernels, each in an nvcc process of
// its own), kernel D's tile
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
};

// What a core gives at its argument t: the value, its first and second
// t-derivatives (when D1, D2) and its derivatives in the arguments a
// and b (when DA).
template <typename T>
struct Core {
    T g, g1, g2, ga, gb;
};

// StationaryFracBrownian's series from t = SFB_SERIES on (ops/_gram.py
// SFB_SERIES, SFB_TERMS, sfb_terms, sfb_parts_plain):
//
//     g = t^(alpha - 2) h0,  h0 = sum_{j >= 1} c_j z^(j - 1),  z = t^-2,
//
// c_j = C(alpha, 2j), alpha = 2H, and the sums of the derivatives with
// c_j m_j, c_j m_j (m_j - 1) (m_j = alpha - 2j) and dc_j = dC(alpha,
// 2j)/dalpha in place of c_j.  The coefficients are the same for every
// entry of a launch: sfb_table_kernel forms them once per launch, in
// float64 by the product recurrence C(alpha, i + 1) = C(alpha, i) (alpha -
// i) / (i + 1), and each entry sums by Horner, with no division, J(t)
// terms, at most SfbTerms<T>::n (14 in float32, 30 in float64).
//
// J(t) is the fewest terms whose tail stays below the unit roundoff u of
// the sums' leading terms.  For alpha in (0, 2] and m >= 2, |C(alpha,
// m + 1) / C(alpha, m)| = (m - alpha) / (m + 1) < m / (m + 1), so
// |C(alpha, m)| <= 2 |c_1| / m; with c_j m_j = (2j + 1) C(alpha, 2j + 1)
// and c_j m_j (m_j - 1) = (2j + 1)(2j + 2) C(alpha, 2j + 2):
//     |c_j| <= |c_1| / j,  |c_j m_j| <= 2 |c_1|,
//     |c_j m_j (m_j - 1)| <= 2 (2j + 1) |c_1|,
//     |dc_j| <= b_j = (1 + 2 H_{2j-1}) / (2j)  (H_n the harmonic number,
//         from |alpha| + |alpha - 1| <= 3 and |alpha (alpha - 1)| <= 2).
// After J terms the tails, relative to the leading term's bound, |c_1| z
// for g, g' and g'' and (|c_1| + |dc_1|) z >= z / 8 for dg/dH, are at most
// z^J G(J, z):
//     g:        G0 = 1 / ((J + 1)(1 - z))
//     g', dH:   G1 = max(G0, 2 / (1 - z), 8 b_{J+1} / (1 - z))
//     g'':      G2 = max(G1, 2 (2J + 3) / (1 - z) + 4 z / (1 - z)^2)
// J is the least with z^J G(J, z) <= u at the largest z of z's bucket:
// z's exponent and its top two mantissa bits, q = (bits(1/4) - bits(z))
// >> (mantissa bits - 2), where z <= 2^(-2 - q/4) (1 - (q % 4) / 8) (z <=
// 1/4 as t >= 2); no logarithm.  kSfbJ holds J per bucket and kind of
// sums, formed here at compile time; from bucket SfbTerms<T>::NQ on, J
// = 1.  The rule holds for H in (0, 1]; an H outside takes the ceiling.
// The ceiling misses it only for g'' (kernels C'' and E'') next to t = 2:
// float32 would take 16 terms at t = 2, and 14 leave a tail of 5.3 u
// (float64: 31 and 1.3 u).
constexpr double SFB_SERIES = 2.0;
constexpr int SFB_COLS = 4;  // per j: c, c m, c m (m - 1), dc
template <typename T> struct SfbTerms;
template <> struct SfbTerms<float> {
    static constexpr int n = 14;      // the ceiling
    static constexpr int NQ = 112;    // the buckets with a tabulated J
    static constexpr int SHIFT = 21;  // to z's exponent and 2 mantissa bits
    static constexpr double U = 5.9604644775390625e-08;  // 2^-24
};
template <> struct SfbTerms<double> {
    static constexpr int n = 30;
    static constexpr int NQ = 228;
    static constexpr int SHIFT = 50;
    static constexpr double U = 1.1102230246251565e-16;  // 2^-53
};

// the largest z of bucket q
constexpr double sfb_zmax(int q)
{
    double z = 0.25 * (1.0 - (q % 4) / 8.0);
    for (int i = 0; i < q / 4; ++i) z *= 0.5;
    return z;
}

// z^J G(J, z) for the sums of kind 0 (g), 1 (with g' and dg/dH) or 2
// (with g'')
constexpr double sfb_tail(int kind, int J, double z)
{
    const double r = 1.0 / (1.0 - z);
    double h = 0.0;  // H_{2J+1}, for b_{J+1}
    for (int i = 1; i <= 2 * J + 1; ++i) h += 1.0 / i;
    double g = r / (J + 1);
    if (kind >= 1) {
        const double b = (1.0 + 2.0 * h) / (2.0 * (J + 1));
        g = g > 2.0 * r ? g : 2.0 * r;
        g = g > 8.0 * b * r ? g : 8.0 * b * r;
    }
    if (kind >= 2) {
        const double g2 = 2.0 * (2 * J + 3) * r + 4.0 * z * r * r;
        g = g > g2 ? g : g2;
    }
    for (int i = 0; i < J; ++i) g *= z;
    return g;
}

constexpr int sfb_terms_at(int kind, int q, double u, int jmax)
{
    int J = 1;
    while (J < jmax && sfb_tail(kind, J, sfb_zmax(q)) > u) ++J;
    return J;
}

struct SfbJTable {
    unsigned char f[3][SfbTerms<float>::NQ];
    unsigned char d[3][SfbTerms<double>::NQ];
};

constexpr SfbJTable make_sfbj()
{
    SfbJTable t{};
    for (int k = 0; k < 3; ++k) {
        for (int q = 0; q < SfbTerms<float>::NQ; ++q)
            t.f[k][q] = (unsigned char)sfb_terms_at(
                k, q, SfbTerms<float>::U, SfbTerms<float>::n);
        for (int q = 0; q < SfbTerms<double>::NQ; ++q)
            t.d[k][q] = (unsigned char)sfb_terms_at(
                k, q, SfbTerms<double>::U, SfbTerms<double>::n);
    }
    return t;
}

// from bucket NQ on, one term holds every kind
static_assert(sfb_terms_at(2, SfbTerms<float>::NQ, SfbTerms<float>::U, 99)
                  == 1, "float32: one term from bucket NQ on");
static_assert(sfb_terms_at(2, SfbTerms<double>::NQ, SfbTerms<double>::U,
                           99) == 1, "float64: one term from bucket NQ on");

static __constant__ SfbJTable kSfbJ = make_sfbj();

// J(t) from z = t^-2 <= 1/4
template <int KIND>
__device__ __forceinline__ int sfb_terms(float z)
{
    const int q = (0x3e800000 - __float_as_int(z)) >> SfbTerms<float>::SHIFT;
    return q < SfbTerms<float>::NQ ? kSfbJ.f[KIND][q] : 1;
}
template <int KIND>
__device__ __forceinline__ int sfb_terms(double z)
{
    const long long q = (0x3fd0000000000000LL - __double_as_longlong(z))
        >> SfbTerms<double>::SHIFT;
    return q < SfbTerms<double>::NQ ? kSfbJ.d[KIND][q] : 1;
}

// StationaryFracBrownian, alpha = 2 H, H = a (ops/_gram.py _sfb_parts,
// sfb_parts_plain); tab: the term's coefficients, SFB_COLS per j from
// j = 1 (sfb_table_kernel)
template <typename T, bool D1, bool D2, bool DA>
__device__ __noinline__ Core<T> sfb_core(T t, T a, const T* __restrict__ tab)
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
    constexpr int KIND = D2 ? 2 : (D1 || DA) ? 1 : 0;
    const T z = T(1) / (t * t), lt = dlog(t);
    // t^(alpha - 2): g = t^alpha s0 with s0 = z h0, and the same for the
    // other sums; 1 / t = z t
    const T Pz = dexp((al - T(2)) * lt);
    const int J = a > T(0) && a <= T(1) ? sfb_terms<KIND>(z)
                                        : SfbTerms<T>::n;
    const T* r = tab + SFB_COLS * (J - 1);
    T h0 = r[0];
    T h1 = D1 ? r[1] : T(0), h2 = D2 ? r[2] : T(0), hh = DA ? r[3] : T(0);
#pragma unroll 1
    for (int j = J - 1; j >= 1; --j) {
        r -= SFB_COLS;
        h0 = fma(h0, z, r[0]);
        if (D1) h1 = fma(h1, z, r[1]);
        if (D2) h2 = fma(h2, z, r[2]);
        if (DA) hh = fma(hh, z, r[3]);
    }
    o.g = Pz * h0;
    if (D1) o.g1 = Pz * h1 * (z * t);
    if (D2) o.g2 = Pz * h2 * z;
    // dg/dH = 2 t^alpha (sh + s0 log t)
    if (DA) o.ga = T(2) * Pz * fma(lt, h0, hh);
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
// white noise.  From x = 2^E_LO on, f_nu and its first derivative come
// from the order's tables (special.cuh MTab; tf the value's, td the
// first derivative's: f_{nu-1}'s for nu > 1, else the raw form's), one
// exponential for both; below, for an order without tables (tf null:
// nu above ops/_mtable.py NU_MAX) and for the second derivative
// (kernels C'' and E'' only), the quadrature.  Inlined into matern_term, its only
// caller.
template <typename T, bool D1, bool D2>
__device__ __forceinline__ Core<T> matern_core(T nu, T t, const T* tf,
                                               const T* td)
{
    Core<T> o{T(0), T(0), T(0), T(0), T(0)};
    if (nu == T(0)) {
        o.g = T(2) * t <= Lim<T>::tiny() ? T(1) : T(0);
        return o;
    }
    const T s = T(2) * nu, x2 = s * t;
    const T x = dsqrt(x2);
    if (tf && x >= T(1.0 / (1 << -MTab<T>::E_LO))) {
        if (x < T(1 << MTab<T>::E_HI)) {
            const MTabAt<T> at(x, x2);
            o.g = at.value(tf);
            if (D1) {
                const T f1 = at.value(td);
                o.g1 = s * (nu > T(1) ? -f1 / (T(4) * (nu - T(1))) : f1);
            }
        }
        if (D2)
            o.g2 = s * s * (nu > T(2)
                            ? kvmodx2(nu - T(2), x2)
                                / (T(16) * (nu - T(1)) * (nu - T(2)))
                            : kvmodx2_raw(nu, x2, 2));
        return o;
    }
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

// The special-function cores (ids above PROFILE_SFB, but the real-order
// Matern's, which matern_term takes), each a call
template <typename T, bool D1, bool D2, bool DA>
__device__ __forceinline__ Core<T> special_eval(int id, int k, T t, T a,
                                                T b)
{
    switch (id) {
    case PROFILE_BESSEL:
        return bessel_core<T, D1, D2>(a, t);
    case PROFILE_PINK:
        return pink_core<T, D1, D2, DA>(t, a);
    default:
        return color_core<T, D1, D2>(k, t);
    }
}

// the cores a term function evaluates: the closed forms' switch, the
// special-function cores' switch, the real-order Matern with its tables
// or StationaryFracBrownian with its coefficients (tf)
enum { CORES_CLOSED = 0, CORES_SPECIAL = 1, CORES_MATERN = 2, CORES_SFB = 3 };

template <typename T, bool D1, bool D2, bool DA, int CORES>
__device__ __forceinline__ Core<T> cores_eval(int id, int k, T t, T a, T b,
                                              const T* tf, const T* td)
{
    if constexpr (CORES == CORES_MATERN)
        return matern_core<T, D1, D2>(a, t, tf, td);
    else if constexpr (CORES == CORES_SFB)
        return sfb_core<T, D1, D2, DA>(t, a, tf);
    else if constexpr (CORES == CORES_SPECIAL)
        return special_eval<T, D1, D2, DA>(id, k, t, a, b);
    else
        return core_eval<T, D1, D2, DA>(id, k, t, a, b);
}

// The distance modes' argument of the core at u: t = sqrt(v), v =
// max(u, tiny) ('abs': no derivative below tiny, as jnp.maximum's; pos
// false there) or u + eps^2 ('posabs')
template <typename T>
__device__ __forceinline__ T mode_arg(int mode, T u, T& v, bool& pos)
{
    pos = true;
    if (mode == MODE_ABS) {
        v = fmax(u, Lim<T>::tiny());
        pos = u > Lim<T>::tiny();
    } else {
        v = u + Lim<T>::eps() * Lim<T>::eps();
    }
    return dsqrt(v);
}

// The chain rule of the mode's square root: the core's t-derivatives in
// o to u-derivatives
template <typename T, bool D1, bool D2>
__device__ __forceinline__ void mode_chain(Core<T>& o, T t, T v, bool pos)
{
    const T tu = pos ? T(0.5) / t : T(0);
    if (D2) o.g2 = pos ? o.g2 * tu * tu - o.g1 * tu / (T(2) * v) : T(0);
    if (D1) o.g1 = o.g1 * tu;
}

// A term at r^2 = u / w: the core at mode(u) and its derivatives in u
// (the mode's chain rule applied): g, gu, guu, ga, gb.
template <typename T, bool D1, bool D2, bool DA, int CORES>
__device__ __forceinline__ Core<T> term_modes(unsigned code, T u, T a, T b,
                                              const T* tf, const T* td)
{
    const int id = code & 31u, mode = (code >> 5) & 3u, k = code >> 7;
    if (mode == MODE_SQUARED)
        return cores_eval<T, D1, D2, DA, CORES>(id, k, u, a, b, tf, td);
    T v;
    bool pos;
    const T t = mode_arg(mode, u, v, pos);
    Core<T> o = cores_eval<T, D1 || D2, D2, DA, CORES>(id, k, t, a, b, tf,
                                                       td);
    mode_chain<T, D1, D2>(o, t, v, pos);
    return o;
}

// Not inlined: the kernels evaluate entries in fully unrolled loops (a
// thread's 64 entries in C), and an inlined copy of every profile at each
// would make the Zoo kernels, and kernel D's tile initializers, take
// minutes to build; one call per term and entry instead.  A kernel takes
// the registers of every function its code can call, so the closed
// forms' evaluator (Zoo) calls closed_term only, and the special cores'
// (ZooSpecial) picks it, special_term, matern_term or sfb_term by the
// term's id: only the real-order Matern's and StationaryFracBrownian's
// calls take table pointers, so the other special cores' calls pass what
// they passed before the tables.
template <typename T, bool D1, bool D2, bool DA>
__device__ __noinline__ Core<T> closed_term(unsigned code, T u, T a, T b)
{
    return term_modes<T, D1, D2, DA, CORES_CLOSED>(code, u, a, b, nullptr,
                                                   nullptr);
}

template <typename T, bool D1, bool D2, bool DA>
__device__ __noinline__ Core<T> special_term(unsigned code, T u, T a, T b)
{
    return term_modes<T, D1, D2, DA, CORES_SPECIAL>(code, u, a, b, nullptr,
                                                    nullptr);
}

template <typename T, bool D1, bool D2, bool DA>
__device__ __noinline__ Core<T> matern_term(unsigned code, T u, T a, T b,
                                            const T* tf, const T* td)
{
    return term_modes<T, D1, D2, DA, CORES_MATERN>(code, u, a, b, tf, td);
}

template <typename T, bool D1, bool D2, bool DA>
__device__ __noinline__ Core<T> sfb_term(unsigned code, T u, T a,
                                         const T* tab)
{
    return term_modes<T, D1, D2, DA, CORES_SFB>(code, u, a, T(0), tab,
                                                nullptr);
}

// tf, td: the term's tables (matern_term's two; sfb_term's coefficients
// in tf)
template <typename T, bool D1, bool D2, bool DA, bool SPECIAL = true>
__device__ __forceinline__ Core<T> term_eval(unsigned code, T u, T a, T b,
                                             const T* tf = nullptr,
                                             const T* td = nullptr)
{
    if (SPECIAL && (code & 31u) == PROFILE_MATERN)
        return matern_term<T, D1, D2, DA>(code, u, a, b, tf, td);
    if (SPECIAL && (code & 31u) == PROFILE_SFB)
        return sfb_term<T, D1, D2, DA>(code, u, a, tf);
    if (SPECIAL && (code & 31u) > PROFILE_SFB)
        return special_term<T, D1, D2, DA>(code, u, a, b);
    return closed_term<T, D1, D2, DA>(code, u, a, b);
}

__device__ __forceinline__ unsigned term_code(unsigned long long codes, int t)
{
    return (unsigned)(codes >> (16 * t)) & 0xffffu;
}

// The terms' tables: per term t of a real-order Matern core (special.cuh
// MTab) the device pointer of its value table, f[t], and of its first
// derivative's, d[t]; of a StationaryFracBrownian core its coefficients
// (sfb_table_kernel's), f[t]; null for a term without.  A launch argument
// of every kernel (only ZooSpecial reads it), read through the cache.
struct MTabs {
    const void* f[MAXTERMS];
    const void* d[MAXTERMS];
};

// MTabs from the host's array of 2 MAXTERMS pointers (all f, then all d;
// null for no table at all)
inline MTabs host_tabs(const void* const* p)
{
    MTabs m{};
    for (int t = 0; t < MAXTERMS; ++t) {
        m.f[t] = p ? p[t] : nullptr;
        m.d[t] = p ? p[MAXTERMS + t] : nullptr;
    }
    return m;
}

// StationaryFracBrownian's coefficients for the launch that follows
// (sfb_core; ops/_gram.py sfb_table): for each 'sfb' term t of the list,
// SfbTerms<T>::n rows of SFB_COLS at out + t SFB_COLS SfbTerms<T>::n,
// from the device value of alpha = 2 params[2 + 4 t + 2] (H carries a
// gradient: no host read), by the product recurrence in float64, rounded
// to T.  One warp, a thread per term.  It replaces no TPU kernel: the JAX
// package evaluates the three powers at every lag (which cancel at large
// lags), and kernel C took the recurrence at every entry, four divisions
// a term; the table leaves each entry a Horner sum.  Its work is 2
// SfbTerms<T>::n dependent steps of two float64 divisions in one thread:
// latency, not bytes or operations, bounds it.
template <typename T>
__global__ void __launch_bounds__(32)
sfb_table_kernel(const T* __restrict__ params, int nterms,
                 unsigned long long codes, T* __restrict__ out)
{
    constexpr int J = SfbTerms<T>::n;
    const int t = threadIdx.x;
    if (t >= nterms || (term_code(codes, t) & 31u) != PROFILE_SFB) return;
    const double al = 2.0 * (double)params[2 + TERMPAR * t + 2];
    T* o = out + t * SFB_COLS * J;
    double c = 1.0, dc = 0.0;
    for (int j = 1; j <= J; ++j) {
        for (int i = 2 * j - 2; i < 2 * j; ++i) {
            const double ai = al - i, inv = i + 1;
            const double cn = c * ai / inv;
            dc = (dc * ai + c) / inv;
            c = cn;
        }
        const double m = al - 2 * j;
        o[SFB_COLS * (j - 1) + 0] = (T)c;
        o[SFB_COLS * (j - 1) + 1] = (T)(c * m);
        o[SFB_COLS * (j - 1) + 2] = (T)(c * m * (m - 1.0));
        o[SFB_COLS * (j - 1) + 3] = (T)dc;
    }
}

// The single ExpQuad term with w = 1: K = c g(r2) + b.
template <typename T>
struct FixedExpQuad {
    static constexpr int NS = 1;  // its parameter sums: sum G g (for c)
    static constexpr int SLOTS = NS;  // the sums the backwards store
    using P = Profile<PROFILE_EXPQUAD>;
    T c, b;

    __device__ __forceinline__ FixedExpQuad(const T* __restrict__ params,
                                            int, unsigned long long,
                                            const MTabs&)
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
    // the term's g, dg/dr2 and d2g/dr2^2 (kernels C'' and E''), g by
    // dexp_nonpos (in float64 exp without its slow path's branch)
    __device__ __forceinline__ T second(T r2, T& d1, T& d2) const
    {
        const T g = dexp_nonpos(T(-0.5) * r2);
        d1 = T(-0.5) * g;
        d2 = T(0.25) * g;
        return g;
    }
};

// Up to MAXTERMS terms, read at run time: of the closed-form profiles
// (ids below PROFILE_SFB; Zoo) or of any registered profile (SPECIAL;
// ZooSpecial).
template <typename T, bool SPECIAL>
struct ZooT {
    static constexpr int NS = TERMPAR * MAXTERMS;
    static constexpr int SLOTS = NS;
    const T* __restrict__ p;
    int n;
    unsigned long long codes;
    MTabs tb;

    __device__ __forceinline__ ZooT(const T* __restrict__ params,
                                    int nterms, unsigned long long cd,
                                    const MTabs& tabs)
        : p(params), n(nterms), codes(cd), tb(tabs)
    {
    }
    // term t's tables (null for a term without)
    __device__ __forceinline__ const T* tf(int t) const
    {
        return static_cast<const T*>(tb.f[t]);
    }
    __device__ __forceinline__ const T* td(int t) const
    {
        return static_cast<const T*>(tb.d[t]);
    }
    __device__ __forceinline__ T value(T r2) const
    {
        T v = p[0];
#pragma unroll
        for (int t = 0; t < MAXTERMS; ++t) {
            if (t >= n) break;
            const T* q = p + 2 + TERMPAR * t;
            const Core<T> o = term_eval<T, false, false, false, SPECIAL>(
                term_code(codes, t), r2 * q[1], q[2], q[3], tf(t), td(t));
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
                term_code(codes, t), r2 * q[1], q[2], q[3], tf(t), td(t));
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
                term_code(codes, t), r2 * q[1], q[2], q[3], tf(t), td(t));
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
            term_code(codes, 0), r2 * w, p[4], p[5], tf(0), td(0));
        d1 = w * o.g1;
        d2 = w * w * o.g2;
        return o.g;
    }
};

template <typename T> using Zoo = ZooT<T, false>;
template <typename T> using ZooSpecial = ZooT<T, true>;

// the core arguments whose derivatives the closed-form profile id takes
// (ops/_gram.py PROFILES' dargs): a for GammaExp, Cauchy2, Periodic,
// CausalExpQuad, Wendland and Harmonic, a and b for Cauchy, Circular
// and Celerite
__host__ __device__ constexpr int profile_nargs(int id)
{
    switch (id) {
    case PROFILE_GAMMAEXP:
    case PROFILE_CAUCHY2:
    case PROFILE_PERIODIC:
    case PROFILE_CAUSALEXPQUAD:
    case PROFILE_WENDLAND:
    case PROFILE_HARMONIC:
        return 1;
    case PROFILE_CAUCHY:
    case PROFILE_CIRCULAR:
    case PROFILE_CELERITE:
        return 2;
    default:
        return 0;
    }
}

// u = r^2 w rounded once, never contracted into a later add, as Zoo
// forms it before its call: C on ZooOne and ZooSum writes E's (Zoo's)
// bits
__device__ __forceinline__ float mul_rn(float a, float b)
{
    return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b)
{
    return __dmul_rn(a, b);
}

// The term of the closed-form profile ID (below PROFILE_SFB) at u = r^2 w
// (mul_rn): core_eval at the constant id, inlined (no call, no switch over
// the profiles), one evaluation of the core whatever the mode, with its
// u-derivative (D1) and its argument derivatives (DA)
template <typename T, int ID, bool D1, bool DA>
__device__ __forceinline__ Core<T> closed_core(int mode, int k, T u, T a,
                                               T b)
{
    static_assert(ID >= 0 && ID < PROFILE_SFB, "a closed-form profile");
    T t = u, v = u;
    bool pos = true;
    if (mode != MODE_SQUARED) t = mode_arg(mode, u, v, pos);
    Core<T> o = core_eval<T, D1, false, DA>(ID, k, t, a, b);
    if (D1 && mode != MODE_SQUARED) mode_chain<T, true, false>(o, t, v, pos);
    return o;
}

// One term of the closed-form profile ID, compiled in: closed_core in the
// kernel's entry loop, its mode read once per launch (one branch every
// thread takes the same way).  Its parameter sums are c's, w's and those
// of the arguments the core takes (NS of them, acc[0, NS) in the slots of
// Zoo's first term; the backwards store SLOTS = TERMPAR of them, zeros
// past NS); the argument derivatives only with PAR.  Kernel C and its
// backward take it for a one-term list at p = 1 (gram_one.cu,
// gram_one_f64.cu); E, the tangent kernels and C at p > 1 take Zoo.
template <typename T, int ID>
struct ZooOne {
    static constexpr int NS = 2 + profile_nargs(ID);
    static constexpr int SLOTS = TERMPAR;
    T b0, c, w, a, b;
    int mode, k;

    __device__ __forceinline__ ZooOne(const T* __restrict__ params, int,
                                      unsigned long long codes, const MTabs&)
        : b0(params[0]), c(params[2]), w(params[3]), a(params[4]),
          b(params[5]), mode((int)(codes >> 5) & 3),
          k((int)(codes >> 7) & 511)
    {
    }
    // the core at mode(r2 w) with its u-derivative (D1)
    template <bool D1, bool DA>
    __device__ __forceinline__ Core<T> term(T r2) const
    {
        return closed_core<T, ID, D1, DA>(mode, k, mul_rn(r2, w), a, b);
    }
    __device__ __forceinline__ T value(T r2) const
    {
        return fma(c, term<false, false>(r2).g, b0);
    }
    // dK/dr2; with PAR, acc[0, NS) += gv dK/d(c, w, a, b)
    template <bool PAR>
    __device__ __forceinline__ T grad(T r2, T gv, T (&acc)[NS]) const
    {
        const Core<T> o = term<true, PAR && (NS > 2)>(r2);
        const T cg = c * o.g1;
        if (PAR) {
            acc[0] = fma(gv, o.g, acc[0]);
            if (r2 > T(0)) acc[1] = fma(gv, cg * r2, acc[1]);
            if constexpr (NS > 2) acc[2] = fma(gv, c * o.ga, acc[2]);
            if constexpr (NS > 3) acc[3] = fma(gv, c * o.gb, acc[3]);
        }
        return cg * w;
    }
};

template <int ID>
struct ProfileId {
    static constexpr int value = ID;
};

// f(ProfileId<id>{}) for the closed-form profile id, by one switch
// (GammaExp's gamma = 2 takes Expon's case: the same core); nothing for
// another id
template <class F>
__device__ __forceinline__ void closed_switch(int id, F&& f)
{
    switch (id) {
    case PROFILE_EXPQUAD: f(ProfileId<PROFILE_EXPQUAD>{}); break;
    case PROFILE_MATERNP: f(ProfileId<PROFILE_MATERNP>{}); break;
    case PROFILE_GAMMAEXP: f(ProfileId<PROFILE_GAMMAEXP>{}); break;
    case PROFILE_GAMMAEXP2:
    case PROFILE_EXPON: f(ProfileId<PROFILE_EXPON>{}); break;
    case PROFILE_CAUCHY: f(ProfileId<PROFILE_CAUCHY>{}); break;
    case PROFILE_CAUCHY2: f(ProfileId<PROFILE_CAUCHY2>{}); break;
    case PROFILE_PERIODIC: f(ProfileId<PROFILE_PERIODIC>{}); break;
    case PROFILE_HOLEEFFECT: f(ProfileId<PROFILE_HOLEEFFECT>{}); break;
    case PROFILE_CAUSALEXPQUAD: f(ProfileId<PROFILE_CAUSALEXPQUAD>{}); break;
    case PROFILE_LOG: f(ProfileId<PROFILE_LOG>{}); break;
    case PROFILE_WENDLAND: f(ProfileId<PROFILE_WENDLAND>{}); break;
    case PROFILE_CIRCULAR: f(ProfileId<PROFILE_CIRCULAR>{}); break;
    case PROFILE_CELERITE: f(ProfileId<PROFILE_CELERITE>{}); break;
    case PROFILE_HARMONIC: f(ProfileId<PROFILE_HARMONIC>{}); break;
    case PROFILE_COS: f(ProfileId<PROFILE_COS>{}); break;
    case PROFILE_SINC: f(ProfileId<PROFILE_SINC>{}); break;
    }
}

// Parameter sums kept in memory, slot q at p[q * stride]: ZooSum's (a
// column of shared memory per thread), which it indexes by the run-time
// term: an array of registers so indexed would go to local memory.
template <typename T>
struct SlotSums {
    T* p;
    int stride;
    __device__ __forceinline__ T& operator[](int q) const
    {
        return p[q * stride];
    }
};

// A sum of 2 to MAXTERMS terms of the closed-form profiles, read at run
// time as Zoo reads them, but evaluated a group of G entries at a time,
// term by term: per term its parameters and code read once, one switch
// on its id (every thread of the launch takes the same case), whose case
// runs closed_core at that constant id over the G entries.  No call: the
// switch is paid once per term and group, not per term and entry, and a
// kernel takes the registers of its largest case.  The term loop stays
// rolled (one copy of the cases); a term's parameter sums are summed over
// the group in locals, then added into its slots (Zoo's: 4 t + q) in
// shared memory (SlotSums), only those the profile takes: the sixteen
// sums in registers, added by an unrolled compare-and-select, took the
// float32 backward from 64 to 80 registers and spilled in float64, 1.88
// against 1.68 ms in float32 on the multiscale sum (PERF.md).  Kernel C
// and its backward take it at p = 1 (gram_one.cu, gram_one_f64.cu); E,
// the tangent kernels and C at p > 1 take Zoo, whose bits C on ZooSum
// writes: the same cores, r^2 w rounded as Zoo rounds it, v = fma(c_t,
// g_t, v) from params[0] in term order.
template <typename T>
struct ZooSum {
    static constexpr int NS = TERMPAR * MAXTERMS;
    static constexpr int SLOTS = NS;
    const T* __restrict__ p;
    int n;
    unsigned long long codes;

    __device__ __forceinline__ ZooSum(const T* __restrict__ params,
                                      int nterms, unsigned long long cd,
                                      const MTabs&)
        : p(params), n(nterms), codes(cd)
    {
    }
    // v = K at r2 without the diagonal term
    template <int G>
    __device__ __forceinline__ void values(const T (&r2)[G], T (&v)[G]) const
    {
#pragma unroll
        for (int e = 0; e < G; ++e) v[e] = p[0];
#pragma unroll 1
        for (int t = 0; t < n; ++t) {
            const T* q = p + 2 + TERMPAR * t;
            const T c = q[0], w = q[1], a = q[2], b = q[3];
            const unsigned code = term_code(codes, t);
            const int mode = (code >> 5) & 3u, k = code >> 7;
            closed_switch(code & 31u, [&](auto id) {
                constexpr int ID = decltype(id)::value;
#pragma unroll
                for (int e = 0; e < G; ++e)
                    v[e] = fma(c, closed_core<T, ID, false, false>(
                                      mode, k, mul_rn(r2[e], w), a, b).g,
                               v[e]);
            });
        }
    }
    // d1 = dK/dr2; with PAR, acc[4 t + (0, 1, 2, 3)] += the sums over the
    // group of gv dK/d(c, w, a, b)_t
    template <bool PAR, int G>
    __device__ __forceinline__ void grads(const T (&r2)[G], const T (&gv)[G],
                                          T (&d1)[G],
                                          const SlotSums<T>& acc) const
    {
#pragma unroll
        for (int e = 0; e < G; ++e) d1[e] = T(0);
#pragma unroll 1
        for (int t = 0; t < n; ++t) {
            const T* q = p + 2 + TERMPAR * t;
            const T c = q[0], w = q[1], a = q[2], b = q[3];
            const unsigned code = term_code(codes, t);
            const int mode = (code >> 5) & 3u, k = code >> 7;
            T s[TERMPAR] = {T(0), T(0), T(0), T(0)};
            closed_switch(code & 31u, [&](auto id) {
                constexpr int ID = decltype(id)::value;
                constexpr int NA = profile_nargs(ID);
#pragma unroll
                for (int e = 0; e < G; ++e) {
                    const Core<T> o =
                        closed_core<T, ID, true, PAR && (NA > 0)>(
                            mode, k, mul_rn(r2[e], w), a, b);
                    const T cg = c * o.g1;
                    d1[e] = fma(cg, w, d1[e]);
                    if (PAR) {
                        s[0] = fma(gv[e], o.g, s[0]);
                        if (r2[e] > T(0)) s[1] = fma(gv[e], cg * r2[e], s[1]);
                        if constexpr (NA > 0)
                            s[2] = fma(gv[e], c * o.ga, s[2]);
                        if constexpr (NA > 1)
                            s[3] = fma(gv[e], c * o.gb, s[3]);
                    }
                }
                if (PAR) {
#pragma unroll
                    for (int j = 0; j < 2 + NA; ++j)
                        acc[TERMPAR * t + j] += s[j];
                }
            });
        }
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
