"""Tiled-Gram dispatch specs for isotropic kernels.

Counterpart of ``lsqfitgp_tpu/kernelalg/_fastgram.py`` without the
double-float parts.  A freshly constructed isotropic kernel knows its
scalar profile g(r², **initkw) and distance mode; the spec records them
so the GP can assemble point blocks with kernel C (`ops.gram`) instead
of broadcasting the core.  Every transformation that changes the
kernel's values drops the spec, except the scalar ``mul``/``add``
algops, which extend its ``post`` chain, a sum with a constant or
white-noise kernel, and a sum of two profiled kernels, which becomes a
``terms`` sum (each term with its own scale, applied to r² inside the
profile, and its own chain).  Constructor ``scale``/``loc`` of a single
kernel are folded into the points (`transform_points`).  Constructor
arguments that are tensors are dynamic (they ride the kernels'
parameter vector and are differentiable), as traced values are in the
JAX package; Python numbers are static.

A CUDA kernel cannot trace an arbitrary profile, so `build_profile`
maps each core of the spec to a profile of `ops.PROFILES` through
`GRAM_PROFILES`, which the kernels register next to their definitions,
and returns an `ops.Terms` description.  A spec with a core outside
that registry, or with more than `ops.MAXTERMS` terms (the device
code's term sum is unrolled to that count; a wider sum would need the
profile list read from memory, which no model of the port needs yet),
takes the broadcast path; `why_not` says which.
"""

from __future__ import annotations

import collections

import numpy
import torch

from .._array import StructuredArray

__all__ = ['FastGramSpec', 'make_spec', 'make_noise_spec', 'post_spec',
           'add_specs', 'leaf_columns', 'build_profile', 'why_not',
           'transform_points', 'NOISE_CORES', 'GRAM_PROFILES']

FastGramSpec = collections.namedtuple(
    'FastGramSpec',
    ['core', 'mode', 'static_kw', 'dyn_names', 'dyn_values', 'scale',
     'loc', 'maxdim', 'post', 'noise', 'terms'],
    defaults=(None,),
)
# post: ordered chain of ('mul'|'add', scalar) applied outside the
# profile, accumulated by the scalar algops.
# noise: coefficient of an additive White component, or None; the
# profile and post chain never include it.  ``core=None`` is a zero
# base profile (a pure-noise or constant spec) when terms is None.
# terms: the sub-specs whose profiles sum (``a1*k1(scale=s1) +
# a2*k2(scale=s2)``, the multi-scale model); a term-sum spec has
# core=None, scale=None, loc=None, each term its own core, mode, scale
# and post chain, and the spec's own chain applies to the sum.

# constructor arguments consumed by CrossKernel.__new__ itself
_RESERVED = {'scale', 'loc', 'derivable', 'maxdim', 'dim', 'dynkw'}

# identity cores of δ-noise kernels (White registers its core here)
NOISE_CORES = []

# core function -> the name of its profile in ops.PROFILES (a core
# without arguments), or a resolver ``f(**kwargs) -> (name, k, args)``
# or None, with the core's arguments (static numbers and dynamic
# tensors) as keywords: the profile, its static integer and its
# arguments, None where no CUDA profile takes them
GRAM_PROFILES = {}


def _is_scalar_value(v):
    return numpy.ndim(v) == 0 if not isinstance(v, torch.Tensor) \
        else v.numel() == 1


def _scalar(v):
    return v.reshape(()) if isinstance(v, torch.Tensor) \
        else torch.as_tensor(v).reshape(())


def make_spec(core, mode, kw):
    """A FastGramSpec for an isotropic core, or None if the construction
    arguments put it outside the fast path's semantics."""
    if mode not in ('squared', 'abs', 'posabs'):
        return None
    if kw.get('dim') is not None or kw.get('dynkw'):
        return None
    initkw = {k: v for k, v in kw.items() if k not in _RESERVED}

    def resolve(name):
        v = kw.get(name)
        return v(**initkw) if callable(v) else v

    scale = resolve('scale')
    loc = resolve('loc')
    maxdim = resolve('maxdim')
    if isinstance(maxdim, tuple):
        return None
    for v in (scale, loc):
        if v is not None and not _is_scalar_value(v):
            return None
    static_kw, dyn_names, dyn_values = {}, [], []
    for k in sorted(initkw):
        v = initkw[k]
        if isinstance(v, torch.Tensor):
            if v.numel() != 1:
                return None
            dyn_names.append(k)
            dyn_values.append(v.reshape(()))
        else:
            if not isinstance(v, (str, bytes, type(None))) \
                    and numpy.ndim(v) > 0:
                return None
            static_kw[k] = v
    return FastGramSpec(
        core=core, mode=mode, static_kw=static_kw,
        dyn_names=tuple(dyn_names), dyn_values=tuple(dyn_values),
        scale=scale, loc=loc, maxdim=maxdim, post=(), noise=None)


def make_noise_spec(kw):
    """Spec of a bare White kernel (pure δ-noise), or None.  Scalar
    ``scale``/``loc`` do not change discrete equality and are dropped."""
    if kw.get('dim') is not None or kw.get('dynkw'):
        return None
    maxdim = kw.get('maxdim')
    if isinstance(maxdim, tuple):
        return None
    return FastGramSpec(
        core=None, mode='squared', static_kw={}, dyn_names=(),
        dyn_values=(), scale=None, loc=None, maxdim=maxdim, post=(),
        noise=torch.ones(()))


def post_spec(spec, op, value):
    """Spec of ``op(kernel, scalar)`` for op in 'mul'/'add', or None.  A
    scalar 'mul' scales the noise component too."""
    if spec is None or not _is_scalar_value(value):
        return None
    v = _scalar(value)
    noise = spec.noise
    if op == 'mul' and noise is not None:
        noise = noise * v
    return spec._replace(post=spec.post + ((op, v),), noise=noise)


def _chain_const(spec):
    """The constant profile of a core-less spec: its post chain applied
    to a zero base."""
    out = torch.zeros(())
    for op, v in spec.post:
        out = out * v if op == 'mul' else out + v
    return out


def _is_flat(s):
    """Profile-less spec: pure noise and/or a constant post chain."""
    return s.core is None and s.terms is None


def add_specs(sa, sb):
    """Spec of the sum of two kernels, or None.  A core-less side (pure
    noise, a constant chain) joins the other side's post chain as one
    'add' and the noises add.  Two profiled kernels become a ``terms``
    sum: each keeps its core, mode, scale and chain (loc cancels in the
    distance and is dropped); a term sum without a chain of its own
    contributes its terms, one with a chain nests."""
    if sa is None or sb is None:
        return None
    if _is_flat(sa) or _is_flat(sb):
        base, flat = (sa, sb) if _is_flat(sb) else (sb, sa)
        noise = base.noise
        if flat.noise is not None:
            noise = flat.noise if noise is None else noise + flat.noise
        post = base.post
        if flat.post:
            post = post + (('add', _chain_const(flat)),)
        return base._replace(post=post, noise=noise)

    def terms_of(s):
        if s.terms is not None and not s.post:
            return s.terms
        return (s._replace(loc=None, noise=None),)

    noise = sa.noise
    if sb.noise is not None:
        noise = sb.noise if noise is None else noise + sb.noise
    md = None
    for m in (sa.maxdim, sb.maxdim):
        if m is not None:
            md = m if md is None else min(md, m)
    return FastGramSpec(
        core=None, mode='squared', static_kw={}, dyn_names=(),
        dyn_values=(), scale=None, loc=None, maxdim=md, post=(),
        noise=noise, terms=terms_of(sa) + terms_of(sb))


def leaf_columns(x):
    """The coordinates of the points ``x`` as a list of 1-D columns, or
    None outside the fast path (a boolean, complex or non-tensor leaf).
    A plain tensor is one column; a `StructuredArray` gives its fields'
    columns in field order, recursing into nested fields, with a field's
    tail flattened into one column per component, the order of the JAX
    package's ``leaf_columns`` and of the isotropic cores' sum over
    fields."""
    def numeric(v):
        return isinstance(v, torch.Tensor) and v.dtype != torch.bool \
            and not v.is_complex()

    if not isinstance(x, StructuredArray):
        return [x.reshape(-1)] if numeric(x) else None
    cols = []

    def visit(v):
        if isinstance(v, StructuredArray):
            return all(visit(v[name]) for name in v.fields)
        if not numeric(v):
            return False
        cols.extend(v.reshape(x.size, -1).unbind(1))
        return True

    return cols if visit(x) else None


def _resolve(spec):
    """(name, k, args) of the spec's core in `GRAM_PROFILES`, or None."""
    entry = GRAM_PROFILES.get(spec.core)
    kwargs = dict(spec.static_kw)
    kwargs.update(zip(spec.dyn_names, spec.dyn_values))
    if entry is None:
        return None
    if isinstance(entry, str):
        return None if kwargs else (entry, 0, ())
    try:
        return entry(**kwargs)
    except TypeError:  # an argument the core does not take
        return None


def _describe(spec, with_scale):
    """The `ops.Term` or `ops.Terms` of a spec, or None; a sum term's
    scale goes inside the profile (``with_scale``)."""
    from .. import ops
    if spec.terms is not None:
        subs = [_describe(t, True) for t in spec.terms]
        if any(t is None for t in subs):
            return None
        return ops.Terms(tuple(subs), tuple(spec.post))
    if spec.core is None:
        return None
    r = _resolve(spec)
    if r is None:
        return None
    name, k, args = r
    return ops.Term(ops.PROFILES[name], spec.mode, k, tuple(args),
                    spec.scale if with_scale else None, tuple(spec.post))


def _cores(spec):
    if spec.terms is not None:
        return [c for t in spec.terms for c in _cores(t)]
    return [spec]


def why_not(spec):
    """Why kernel C cannot evaluate a profiled spec (naming the core),
    or None when it can."""
    from .. import ops
    for s in _cores(spec):
        if s.core is not None and _resolve(s) is None:
            name = getattr(s.core, '__name__', repr(s.core))
            return (f'the core {name} (arguments '
                    f'{sorted(s.static_kw) + list(s.dyn_names)}) has no '
                    f'CUDA profile')
    n = len(_cores(spec))
    if n > ops.MAXTERMS:
        return (f'a sum of {n} profiled kernels: the kernels take at most '
                f'{ops.MAXTERMS}')
    return None


def build_profile(spec):
    """The `ops.Terms` description of a profiled spec for `ops.gram` (a
    single core with its chain, or a term sum with each term's scale
    applied to r² inside the profile), or None when kernel C cannot
    evaluate it (`why_not`).  A single core's scale and loc are the
    caller's job (`transform_points`)."""
    from .. import ops
    if spec.core is None and spec.terms is None:
        return None
    if why_not(spec) is not None:
        return None
    desc = _describe(spec, False)
    return desc if isinstance(desc, ops.Terms) else ops.Terms((desc,))


def transform_points(spec, cols):
    """Stack columns to (n, p) and fold the constructor-level loc/scale
    (x → (x − loc)/scale) into the coordinates."""
    X = torch.stack([
        c if c.is_floating_point() else c.to(torch.get_default_dtype())
        for c in cols], -1)
    if spec.loc is not None:
        X = X - spec.loc
    if spec.scale is not None:
        X = X / spec.scale
    return X
