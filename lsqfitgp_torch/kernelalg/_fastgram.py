"""Tiled-Gram dispatch specs for isotropic kernels.

Counterpart of ``lsqfitgp_tpu/kernelalg/_fastgram.py`` without term
sums (two profiled kernels added) and the double-float parts.  A freshly constructed isotropic
kernel knows its scalar profile g(r², **initkw) and distance mode; the
spec records them so the GP can assemble point blocks with kernel C
(`ops.gram`) instead of broadcasting the core.  Every transformation
that changes the kernel's values drops the spec, except the scalar
``mul``/``add`` algops, which extend its ``post`` chain, and a sum with
a constant or white-noise kernel.  Constructor ``scale``/``loc`` are
folded into the points (`transform_points`).

A CUDA kernel cannot trace an arbitrary profile, so `build_profile`
maps the spec's core to a profile of `ops.PROFILES` through
`GRAM_PROFILES`, which the kernels register next to their definitions.
A spec outside that registry takes the broadcast path.
"""

from __future__ import annotations

import collections

import numpy
import torch

from .._array import StructuredArray

__all__ = ['FastGramSpec', 'make_spec', 'make_noise_spec', 'post_spec',
           'add_specs', 'leaf_columns', 'build_profile', 'transform_points',
           'NOISE_CORES', 'GRAM_PROFILES']

FastGramSpec = collections.namedtuple(
    'FastGramSpec',
    ['core', 'mode', 'static_kw', 'dyn_names', 'dyn_values', 'scale',
     'loc', 'maxdim', 'post', 'noise'],
)
# post: ordered chain of ('mul'|'add', scalar) applied outside the
# profile, accumulated by the scalar algops.
# noise: coefficient of an additive White component, or None; the
# profile and post chain never include it.  ``core=None`` is a zero
# base profile (a pure-noise or constant spec).

# constructor arguments consumed by CrossKernel.__new__ itself
_RESERVED = {'scale', 'loc', 'derivable', 'maxdim', 'dim', 'dynkw'}

# identity cores of δ-noise kernels (White registers its core here)
NOISE_CORES = []

# core function -> name of its profile in ops.PROFILES
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


def add_specs(sa, sb):
    """Spec of the sum of two kernels when one side is core-less (pure
    noise or a constant chain): its constant joins the other side's post
    chain as one 'add' and the noises add.  Sums of two profiled
    kernels (term sums) are not in this version: None."""
    if sa is None or sb is None:
        return None
    if sb.core is not None and sa.core is not None:
        return None
    base, flat = (sa, sb) if sb.core is None else (sb, sa)
    noise = base.noise
    if flat.noise is not None:
        noise = flat.noise if noise is None else noise + flat.noise
    post = base.post
    if flat.post:
        post = post + (('add', _chain_const(flat)),)
    return base._replace(post=post, noise=noise)


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


def build_profile(spec):
    """``(profile, post)`` for `ops.gram`: the registered profile name of
    the spec's core and its post chain, or None when kernel C cannot
    evaluate the spec (core outside `GRAM_PROFILES`, a distance mode
    other than r², or constructor arguments reaching the core).  The
    spec's scale and loc are the caller's job (`transform_points`)."""
    if spec.core is None or spec.mode != 'squared' or spec.static_kw \
            or spec.dyn_names:
        return None
    name = GRAM_PROFILES.get(spec.core)
    if name is None:
        return None
    return name, spec.post


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
