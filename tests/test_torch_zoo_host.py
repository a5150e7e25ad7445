"""The ZooOne and ZooSum evaluators' device code
(``lsqfitgp_torch/csrc/profiles.cuh``) compiled for the host with g++ and
held to the plain profiles.

Kernel C and its backward take ``ZooOne<T, ID>`` for one term of a
closed-form profile: the profile a template parameter, the core inlined,
the mode read once per launch, ``NS`` parameter sums (c, w and the
arguments the core takes) and the argument derivatives only under
``PAR``; and ``ZooSum<T>`` for a sum of 2 to 4 closed-form terms, a group
of G entries at a time: per term one switch on its id whose case runs
the inlined core over the group, the term's sums summed over the group
and added into its four slots.  A wrong sum slot or a derivative missing
under ``PAR`` shows in no other test on the CPU (the CPU route takes the
plain versions), so this file compiles ZooOne's ``value``, ``grad<true>``
and ``grad<false>`` of each instantiation, and ZooSum's ``values``,
``grads<true>`` and ``grads<false>`` for several G, behind a shim
``cuda_runtime.h`` that defines the CUDA keywords away, loads them with
ctypes, and compares, entry by entry on a seeded grid of r² (ZooSum's
sums group by group, weighted by seeded numbers), with ``ops/_gram.py``'s
``_value_r2`` (K), ``_dr2`` (dK/dr²) and ``_partials`` (per slot of each
term t: g, c r² g_u, c ∂g/∂a, c ∂g/∂b, the folded vector's slots 2 + 4 t
to 5 + 4 t): ZooOne for every closed-form id in each mode, ZooSum on
2-term sums with each closed-form id first and last and on 3- and 4-term
sums of mixed modes, and ZooSum's values equal to ``Zoo::value``'s to the
bit; in float64 and float32.  Skips where there is no g++.
"""

import ctypes
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

import lsqfitgp_torch as lt
from lsqfitgp_torch import ops
from lsqfitgp_torch.ops import _gram

CSRC = pathlib.Path(_gram.__file__).resolve().parent.parent / 'csrc'

SHIM = r'''
#pragma once
#include <cfloat>
#include <cmath>
#include <cstring>
#define __device__
#define __host__
#define __global__
#define __forceinline__ inline
#define __noinline__
#define __constant__
#define __shared__ static
#define __launch_bounds__(...)
using std::fabs;
using std::floor;
using std::fma;
using std::fmax;
using std::fmin;
struct Idx3 { unsigned x, y, z; };
static Idx3 threadIdx, blockIdx;
inline void __syncthreads() {}
template <typename A, typename B> inline A bits_as(B b)
{
    A a;
    std::memcpy(&a, &b, sizeof a);
    return a;
}
inline int __float_as_int(float f) { return bits_as<int>(f); }
inline unsigned __float_as_uint(float f) { return bits_as<unsigned>(f); }
inline float __uint_as_float(unsigned u) { return bits_as<float>(u); }
inline long long __double_as_longlong(double d)
{
    return bits_as<long long>(d);
}
inline double __longlong_as_double(long long b) { return bits_as<double>(b); }
inline float __fdividef(float a, float b) { return a / b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline double __dmul_rn(double a, double b) { return a * b; }
'''

HARNESS = r'''
#include "profiles.cuh"

using namespace lsq;

// value, grad<true> (dK/dr2 and the NS sums at G = 1, zeros past NS) and
// grad<false> (dK/dr2) of ZooOne<T, ID> at n values of r2
template <typename T, int ID>
int one(unsigned long long codes, const T* params, const T* r2, int n,
        T* val, T* d1, T* sums, T* d1_nopar)
{
    const ZooOne<T, ID> ev(params, 1, codes, MTabs{});
    constexpr int NS = ZooOne<T, ID>::NS;
    for (int i = 0; i < n; ++i) {
        val[i] = ev.value(r2[i]);
        T acc[NS] = {};
        d1[i] = ev.template grad<true>(r2[i], T(1), acc);
        for (int q = 0; q < TERMPAR; ++q)
            sums[TERMPAR * i + q] = q < NS ? acc[q] : T(0);
        T none[NS] = {};
        d1_nopar[i] = ev.template grad<false>(r2[i], T(1), none);
        for (int q = 0; q < NS; ++q)
            if (none[q] != T(0)) return -1;   // grad<false> summed
    }
    return NS;
}

template <typename T, int ID = 0>
int dispatch(int id, unsigned long long codes, const T* params, const T* r2,
             int n, T* val, T* d1, T* sums, T* d1_nopar)
{
    if constexpr (ID >= PROFILE_SFB) {
        return -2;
    } else {
        if (id == ID)
            return one<T, ID>(codes, params, r2, n, val, d1, sums, d1_nopar);
        return dispatch<T, ID + 1>(id, codes, params, r2, n, val, d1, sums,
                                   d1_nopar);
    }
}

// ZooSum<T>'s values, grads<true> and grads<false> on the n entries of r2
// in groups of G (n a multiple of G), and Zoo<T>::value at each entry:
// val, zval, d1 and d1_nopar per entry; sums[NS g + q] group g's
// parameter sums, gv-weighted; NS, or -1 where grads<false> summed
template <typename T, int G>
int sum(int nterms, unsigned long long codes, const T* params, const T* r2,
        const T* gv, int n, T* val, T* zval, T* d1, T* sums, T* d1_nopar)
{
    const ZooSum<T> ev(params, nterms, codes, MTabs{});
    const Zoo<T> zoo(params, nterms, codes, MTabs{});
    constexpr int NS = ZooSum<T>::NS;
    for (int i = 0; i + G <= n; i += G) {
        T r[G], w[G], v[G];
        for (int e = 0; e < G; ++e) {
            r[e] = r2[i + e];
            w[e] = gv[i + e];
        }
        ev.values(r, v);
        T acc[NS] = {}, d[G], dn[G];
        ev.template grads<true>(r, w, d, SlotSums<T>{acc, 1});
        T none[NS] = {};
        ev.template grads<false>(r, w, dn, SlotSums<T>{none, 1});
        for (int q = 0; q < NS; ++q) {
            if (none[q] != T(0)) return -1;
            sums[NS * (i / G) + q] = acc[q];
        }
        for (int e = 0; e < G; ++e) {
            val[i + e] = v[e];
            zval[i + e] = zoo.value(r[e]);
            d1[i + e] = d[e];
            d1_nopar[i + e] = dn[e];
        }
    }
    return NS;
}

template <typename T>
int sum_groups(int g, int nterms, unsigned long long codes, const T* params,
               const T* r2, const T* gv, int n, T* val, T* zval, T* d1,
               T* sums, T* d1_nopar)
{
    switch (g) {
    case 2:
        return sum<T, 2>(nterms, codes, params, r2, gv, n, val, zval, d1,
                         sums, d1_nopar);
    case 4:
        return sum<T, 4>(nterms, codes, params, r2, gv, n, val, zval, d1,
                         sums, d1_nopar);
    case 8:
        return sum<T, 8>(nterms, codes, params, r2, gv, n, val, zval, d1,
                         sums, d1_nopar);
    case 16:
        return sum<T, 16>(nterms, codes, params, r2, gv, n, val, zval, d1,
                          sums, d1_nopar);
    }
    return -2;
}

extern "C" {
int one_f64(int id, unsigned long long codes, const double* params,
            const double* r2, int n, double* val, double* d1, double* sums,
            double* d1_nopar)
{
    return dispatch<double>(id, codes, params, r2, n, val, d1, sums,
                            d1_nopar);
}
int one_f32(int id, unsigned long long codes, const float* params,
            const float* r2, int n, float* val, float* d1, float* sums,
            float* d1_nopar)
{
    return dispatch<float>(id, codes, params, r2, n, val, d1, sums, d1_nopar);
}
int sum_f64(int g, int nterms, unsigned long long codes,
            const double* params, const double* r2, const double* gv, int n,
            double* val, double* zval, double* d1, double* sums,
            double* d1_nopar)
{
    return sum_groups<double>(g, nterms, codes, params, r2, gv, n, val, zval,
                              d1, sums, d1_nopar);
}
int sum_f32(int g, int nterms, unsigned long long codes, const float* params,
            const float* r2, const float* gv, int n, float* val, float* zval,
            float* d1, float* sums, float* d1_nopar)
{
    return sum_groups<float>(g, nterms, codes, params, r2, gv, n, val, zval,
                             d1, sums, d1_nopar);
}
}
'''


@pytest.fixture(scope='module', autouse=True)
def cpu_device():
    with lt.using_device('cpu'):
        yield


@pytest.fixture(scope='module')
def harness(tmp_path_factory):
    gxx = shutil.which('g++')
    if gxx is None:
        pytest.skip('needs g++')
    d = tmp_path_factory.mktemp('zoo_host')
    (d / 'shim').mkdir()
    (d / 'shim' / 'cuda_runtime.h').write_text(SHIM)
    (d / 'harness.cpp').write_text(HARNESS)
    so = d / 'harness.so'
    # no contraction: the host's roundings are the plain ones, operation
    # by operation
    proc = subprocess.run(
        [gxx, '-std=c++17', '-O1', '-ffp-contract=off', '-fPIC', '-shared',
         '-w', '-I', str(d / 'shim'), '-I', str(CSRC), str(d / 'harness.cpp'),
         '-o', str(so)], capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr[-4000:]
    lib = ctypes.CDLL(str(so))
    P, I, U = ctypes.c_void_p, ctypes.c_int, ctypes.c_ulonglong
    for name in ('one_f64', 'one_f32'):
        getattr(lib, name).restype = I
        getattr(lib, name).argtypes = [I, U, P, P, I, P, P, P, P]
    for name in ('sum_f64', 'sum_f32'):
        getattr(lib, name).restype = I
        getattr(lib, name).argtypes = [I, I, U, P, P, P, I, P, P, P, P, P]
    return lib


def _cases():
    """(name, Term without its mode): every closed-form profile, with
    its arguments, and Maternp's orders and Harmonic's regimes."""
    P, T = ops.PROFILES, ops.Term
    return {
        'expquad': T(P['expquad']),
        'maternp0': T(P['maternp'], k=0),
        'maternp1': T(P['maternp'], k=1),
        'maternp2': T(P['maternp'], k=2),
        'maternp5': T(P['maternp'], k=5),
        'gammaexp': T(P['gammaexp'], args=(1.3,)),
        'gammaexp2': T(P['gammaexp2']),
        'cauchy': T(P['cauchy'], args=(1.4, 0.8)),
        'cauchy2': T(P['cauchy2'], args=(0.8,)),
        'expon': T(P['expon']),
        'periodic': T(P['periodic'], args=(1.4,)),
        'holeeffect': T(P['holeeffect']),
        'causalexpquad': T(P['causalexpquad'], args=(1.7,)),
        'log': T(P['log']),
        'wendland2': T(P['wendland'], k=2, args=(1.6,)),
        'circular': T(P['circular'], args=(4.5, 0.4)),
        'celerite': T(P['celerite'], args=(0.3, 0.1)),
        'harmonic-hi': T(P['harmonic'], args=(2.0,)),
        'harmonic-lo': T(P['harmonic'], args=(0.4,)),
        'harmonic-1': T(P['harmonic'], args=(1.0,)),
        'cos': T(P['cos']),
        'sinc': T(P['sinc']),
    }


CASES = _cases()


def test_cases_cover_every_closed_form_profile():
    ids = {t.profile.id for t in CASES.values()}
    assert ids == set(range(_gram._FIRST_SPECIAL))


def _r2_grid(dtype):
    """r² at zero, below and around tiny, and over (0, 9²] (scale 1.3:
    t up to about 7 in 'abs' mode, 48 in 'squared'), seeded."""
    rng = np.random.default_rng(20261018)
    tiny = torch.finfo(dtype).tiny
    r = np.concatenate([[0.0, tiny / 2, tiny, 4 * tiny, 1e-20, 1e-12, 1e-6,
                         1e-3], rng.uniform(0, 9, 150) ** 2,
                        rng.uniform(0, 0.3, 40) ** 2])
    return torch.tensor(r, dtype=dtype)


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
@pytest.mark.parametrize('mode', ['squared', 'abs', 'posabs'])
@pytest.mark.parametrize('name', sorted(CASES))
def test_zoo_one_matches_the_plain_profile(harness, name, mode, dtype):
    term = CASES[name]._replace(mode=mode, scale=1.3,
                                post=(('mul', 1.1), ('add', 0.2)))
    st = _gram._struct(term)
    nterms, codes, ev = _gram._codes(st)
    assert (nterms, ev) == (1, _gram._ONE)
    fv = _gram._fold(st, _gram._paramvec(_gram._flat(term) + [0.0],
                                         torch.zeros((), dtype=dtype)))
    r2 = _r2_grid(dtype)
    n = r2.shape[0]
    out = {k: torch.zeros(n, dtype=dtype) for k in ('val', 'd1', 'd1_nopar')}
    sums = torch.zeros(n, 4, dtype=dtype)
    P = ctypes.c_void_p
    fn = harness.one_f64 if dtype == torch.float64 else harness.one_f32
    ns = fn(term.profile.id, codes, P(fv.data_ptr()), P(r2.data_ptr()), n,
            P(out['val'].data_ptr()), P(out['d1'].data_ptr()),
            P(sums.data_ptr()), P(out['d1_nopar'].data_ptr()))
    assert ns >= 2, 'grad<false> summed the parameters' if ns == -1 else ns

    # the plain profile on the same inputs in the same dtype (the
    # singular derivatives at r² = 0 take the dtype's tiny)
    val = _gram._value_r2(st, fv, r2)
    d1 = _gram._dr2(st, fv, r2)
    parts = _gram._partials(st, fv, r2)
    # the slots the core's arguments take: those with a derivative
    assert ns == 2 + sum(m is not None for m in parts[2:]), (ns, parts[2:])

    u = torch.finfo(dtype).eps / 2
    k = 512
    regular = r2 >= 1e-3
    # the mode's distance t: in 'abs' and 'posabs' mode the chain rule
    # divides g' by 2 t, and a g' that is a difference of terms of size
    # ~max|g| (Wendland's, Harmonic's) keeps their rounding: both sides'
    # derivatives are noise of size u max|g| / t near t = 0
    c, w = float(fv[2]), float(fv[3])
    if mode == 'squared':
        chain = torch.zeros_like(r2, dtype=torch.float64)
    else:
        t = torch.sqrt(torch.clamp(r2.double() * w + (
            torch.finfo(dtype).eps ** 2 if mode == 'posabs' else 0),
            min=torch.finfo(dtype).tiny))
        chain = k * u * abs(c * w) * float(val[regular].abs().max()) / t

    def close(what, got, ref, extra=0):
        """Each entry within a rounding tolerance of its own size and of
        the largest size at r² >= 1e-3 (the formulas differ: Horner
        against torch's pow, sincos against sin and cos; both sides
        round), far below the error of a wrong slot or a missing
        derivative."""
        ref = torch.broadcast_to(ref, got.shape).double()
        tol = k * u * (ref.abs() + ref[regular].abs().max()) + extra
        err = (got.double() - ref).abs()
        assert bool((err <= tol).all()), (
            what, float(err.max()), float((err - tol).max()))

    close('K', out['val'], val)
    close('dK/dr2', out['d1'], d1, chain)
    assert torch.equal(out['d1'], out['d1_nopar'])
    for q in range(ns):
        close(f'slot {2 + q}', sums[:, q], parts[q], chain * r2 if q == 1 else 0)
    assert bool((sums[:, ns:] == 0).all())


# -- ZooSum: sums of closed-form terms, a group of entries at a time ------------

MODES = ('squared', 'abs', 'posabs')
# the groups the kernels hand ZooSum (the 16-byte entry group of each
# dtype, two rows of it, a thread's whole tile) and the grid's length, a
# multiple of each
GROUPS = (2, 4, 8, 16)


def _sum_grid(dtype):
    """`_r2_grid` and 10 more seeded points (a multiple of every group),
    and the entries' seeded weights gv of both signs, every seventh zero
    (as the kernels weight the entries past the matrix's edge)."""
    rng = np.random.default_rng(20261019)
    r2 = torch.cat([_r2_grid(dtype),
                    torch.tensor(rng.uniform(0, 9, 10) ** 2, dtype=dtype)])
    assert r2.shape[0] % max(GROUPS) == 0
    gv = torch.tensor(rng.standard_normal(r2.shape[0]), dtype=dtype)
    return r2, torch.where(torch.arange(r2.shape[0]) % 7 == 5, 0.0, gv)


def _partner():
    """The other term of the 2-term sums: Cauchy, two arguments, scaled,
    its own chain (so both terms' slots hold argument sums where the
    first has arguments)."""
    P = ops.PROFILES
    return ops.Term(P['cauchy'], args=(1.2, 0.7), scale=0.8,
                    post=(('mul', 0.6),))


def _pair(name, first):
    """CASES[name] in the mode its place in the sorted names gives it,
    scaled, with a chain, first or last beside `_partner`, under an
    outer chain."""
    mode = MODES[sorted(CASES).index(name) % len(MODES)]
    term = CASES[name]._replace(mode=mode, scale=1.3,
                                post=(('mul', 1.1), ('add', 0.2)))
    terms = (term, _partner()) if first else (_partner(), term)
    return ops.Terms(terms, (('mul', 0.9), ('add', 0.05)))


def _multi():
    """The 3- and 4-term sums of mixed modes; 'args-last' takes core
    arguments in its last term only, so that term 3's argument sums land
    in slots 14 and 15 and nowhere else."""
    P, T, S = ops.PROFILES, ops.Term, ops.Terms
    return {
        'terms3': S((T(P['maternp'], k=1, scale=0.5),
                     T(P['gammaexp'], 'abs', args=(1.6,), scale=2.0,
                       post=(('mul', 0.4),)),
                     T(P['celerite'], 'posabs', args=(0.3, 0.1), scale=1.5)),
                    (('mul', 0.9), ('add', 0.05))),
        'terms4': S((T(P['periodic'], 'abs', args=(1.4,), scale=1.2),
                     T(P['wendland'], 'posabs', k=2, args=(1.6,), scale=20.0,
                       post=(('mul', 0.7),)),
                     T(P['harmonic'], 'abs', args=(0.4,), scale=0.9),
                     T(P['circular'], 'posabs', args=(4.5, 0.4),
                       scale=3.0, post=(('mul', 0.3),)))),
        'args-last': S((T(P['expquad'], scale=2.0),
                        T(P['cos'], 'abs', scale=1.7, post=(('mul', 0.5),)),
                        T(P['holeeffect'], 'posabs', scale=0.6),
                        T(P['cauchy'], args=(1.4, 0.8), scale=1.1,
                          post=(('mul', 1.2),))),
                       (('add', 0.1),)),
    }


MULTI = _multi()


def _check_sum(harness, desc, dtype):
    st = _gram._struct(desc)
    nterms, codes, ev = _gram._codes(st)
    assert ev == _gram._SUM
    fv = _gram._fold(st, _gram._paramvec(_gram._flat(desc) + [0.0],
                                         torch.zeros((), dtype=dtype)))
    r2, gv = _sum_grid(dtype)
    n = r2.shape[0]
    P = ctypes.c_void_p
    fn = harness.sum_f64 if dtype == torch.float64 else harness.sum_f32

    # the plain terms on the same inputs in the same dtype
    val = _gram._value_r2(st, fv, r2)
    d1 = _gram._dr2(st, fv, r2)
    parts = _gram._partials(st, fv, r2)
    u = torch.finfo(dtype).eps / 2
    k = 512
    regular = r2 >= 1e-3
    # per term in 'abs' or 'posabs' mode the chain rule's noise near t = 0
    # (`test_zoo_one_matches_the_plain_profile`): of size u max|g| |c w| / t
    chain = torch.zeros_like(r2, dtype=torch.float64)
    for t, s in enumerate(_gram._leaves(st)):
        if s.mode == 'squared':
            continue
        c, w = float(fv[2 + 4 * t]), float(fv[3 + 4 * t])
        tt = torch.sqrt(torch.clamp(r2.double() * w + (
            torch.finfo(dtype).eps ** 2 if s.mode == 'posabs' else 0),
            min=torch.finfo(dtype).tiny))
        chain = chain + k * u * abs(c * w) * float(
            parts[4 * t][regular].abs().max()) / tt

    def tol(ref, extra=0):
        """Each entry's rounding tolerance, of its own size and of the
        largest size at r² >= 1e-3 (as ZooOne's test)."""
        ref = ref.double()
        return k * u * (ref.abs() + ref[regular].abs().max()) + extra

    for g in GROUPS:
        out = {key: torch.zeros(n, dtype=dtype)
               for key in ('val', 'zval', 'd1', 'd1_nopar')}
        sums = torch.zeros(n // g, 4 * _gram.MAXTERMS, dtype=dtype)
        ns = fn(g, nterms, codes, P(fv.data_ptr()), P(r2.data_ptr()),
                P(gv.data_ptr()), n,
                P(out['val'].data_ptr()), P(out['zval'].data_ptr()),
                P(out['d1'].data_ptr()), P(sums.data_ptr()),
                P(out['d1_nopar'].data_ptr()))
        assert ns == 4 * _gram.MAXTERMS, \
            'grads<false> summed the parameters' if ns == -1 else ns
        # ZooSum's values are Zoo's, to the bit
        assert torch.equal(out['val'], out['zval']), g
        assert bool(((out['val'].double() - val.double()).abs()
                     <= tol(val)).all()), ('K', g)
        assert bool(((out['d1'].double() - d1.double()).abs()
                     <= tol(d1, chain)).all()), ('dK/dr2', g)
        assert torch.equal(out['d1'], out['d1_nopar']), g
        wgv = gv.double()
        w = wgv.abs().reshape(-1, g)
        for q in range(4 * _gram.MAXTERMS):
            got = sums[:, q]
            m = parts[q] if q < len(parts) else None
            if m is None:
                # no sum lands in a slot of a term past the list or of an
                # argument the core does not take
                assert bool((got == 0).all()), (f'slot {2 + q}', g)
                continue
            ref = (wgv * m.double()).reshape(-1, g).sum(1)
            bound = (w * tol(m, chain * r2.double() if q % 4 == 1 else 0)
                     .reshape(-1, g)).sum(1)
            err = (got.double() - ref).abs()
            assert bool((err <= bound).all()), (
                f'slot {2 + q}', g, float(err.max()), float((err - bound)
                                                            .max()))


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
@pytest.mark.parametrize('first', [True, False], ids=['first', 'last'])
@pytest.mark.parametrize('name', sorted(CASES))
def test_zoo_sum_pairs_match_the_plain_profiles(harness, name, first, dtype):
    _check_sum(harness, _pair(name, first), dtype)


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
@pytest.mark.parametrize('name', sorted(MULTI))
def test_zoo_sum_matches_the_plain_profiles(harness, name, dtype):
    _check_sum(harness, MULTI[name], dtype)


def test_args_last_fills_only_its_slots():
    """'args-last': the argument slots of terms 0 to 2 take no sum, term
    3's both (checked against the plain partials by the test above)."""
    desc = MULTI['args-last']
    st = _gram._struct(desc)
    fv = _gram._fold(st, _gram._paramvec(_gram._flat(desc) + [0.0],
                                         torch.zeros((), dtype=torch.float64)))
    parts = _gram._partials(st, fv, torch.tensor([0.5, 2.0],
                                                 dtype=torch.float64))
    assert [m is None for m in parts] == [False, False, True, True] * 3 + [
        False] * 4
