"""PyTorch utility layer.

Counterpart of the parts of ``lsqfitgp_tpu/_jaxutil.py`` that the port
uses (``elementwise_grad``, ``limit_derivatives``), plus the tensor
conversion every entry point shares and `recompute`, which forms a
block (a derivative block, the AR basis) without its graph and builds
it again in the backward.

JAX's ``skipifabstract`` runs a sanity check only when the values are
concrete, so checks vanish under ``jit``.  PyTorch has no abstract
values; `check` runs a check unless checks are disabled, which
`empbayes_fit` does inside its objective.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import sys
import threading

import numpy
import torch
import torch.autograd.forward_ad as fwAD
import torch.utils._pytree as pytree

from . import _config

__all__ = ['check', 'asarray', 'elementwise_grad', 'limit_derivatives',
           'recompute', 'TooManyDerivativesError']


def check(fn):
    """Run the sanity check ``fn()`` unless checks are disabled."""
    if _config.checks_enabled():
        fn()


def asarray(x, dtype=None, device=None):
    """A tensor from ``x``: tensors keep their dtype and device (unless
    given); numpy arrays and scalars become tensors of the default
    float dtype (integers and booleans keep their kind) on the default
    device, as ``jnp.asarray`` follows JAX's x64 switch."""
    if isinstance(x, torch.Tensor):
        if dtype is None and device is None:
            return x
        return x.to(dtype=dtype, device=device)
    # a copy in C order: torch takes no negative strides
    a = numpy.array(x, order='C')
    if dtype is None and a.dtype.kind in 'fc':
        dtype = _config.default_float()
    if device is None:
        device = _config.default_device()
    return torch.tensor(a, dtype=dtype, device=device)



# -- elementwise derivatives ---------------------------------------------------

# the differentiations in progress on this thread: a stack of the tokens
# of the tensors `elementwise_grad` differentiates with respect to, and
# the leaves it made, for the outermost call to tell whether its result
# depends on anything else
_state = threading.local()
_tokens = itertools.count(1)


def _stack():
    if not hasattr(_state, 'targets'):
        _state.targets = []
        _state.leaves = []
    return _state


def _depends_on_other_leaves(t, ours):
    """Whether ``t``'s graph reaches a leaf that requires grad besides
    ``ours`` (a hyperparameter, under a fit)."""
    seen = set()
    stack = [t.grad_fn]
    while stack:
        fn = stack.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        var = getattr(fn, 'variable', None)
        if var is not None:
            if not any(var is o for o in ours):
                return True
            continue
        stack.extend(f for f, _ in fn.next_functions)
    return False


def elementwise_grad(fun, argnum=0):
    """Elementwise derivative of ``fun`` with respect to its ``argnum``-th
    argument, for ``fun`` applied elementwise: one reverse pass with a
    ones cotangent, the counterpart of the JAX package's jvp with a ones
    tangent.  The argument must have the result's full shape (broadcast
    it first), so that each entry of the result depends on one entry of
    it.  Composable to any order: the pass keeps its graph
    (``create_graph``), so the result is differentiable again, with
    respect to the argument (a higher derivative) and to whatever
    ``fun`` closes over (the hyperparameters under a fit, to any order).
    Under ``torch.no_grad()``, or when the result depends on no tensor
    that requires grad but the argument, the outermost call returns it
    detached, so that no graph is left behind; a forward-mode tangent
    (the fit's Fisher information and ``forward=True``, whose
    hyperparameters are dual tensors) is kept, detached likewise."""

    @functools.wraps(fun)
    def grad_fun(*args, **kw):
        args = list(args)
        x = args[argnum]
        st = _stack()
        outermost = not st.targets
        outer_grad = torch.is_grad_enabled()
        with torch.enable_grad():
            if x.requires_grad:
                xg = x
            else:
                xg = x.detach().requires_grad_()
                st.leaves.append(xg)
            token = getattr(xg, '_lsqfitgp_token', None)
            if token is None:
                token = next(_tokens)
                xg._lsqfitgp_token = token
            args[argnum] = xg
            st.targets.append(token)
            try:
                out = fun(*args, **kw)
                if out.requires_grad:
                    d, = torch.autograd.grad(out, xg, torch.ones_like(out),
                                             create_graph=True,
                                             allow_unused=True)
                else:
                    d = None
            finally:
                st.targets.pop()
                if outermost:
                    leaves, st.leaves = st.leaves, []
        if d is None:
            d = torch.zeros_like(out)
        if outermost and d.requires_grad and (
                not outer_grad or not _depends_on_other_leaves(d, leaves)):
            primal, tangent = fwAD.unpack_dual(d)
            d = primal.detach() if tangent is None \
                else fwAD.make_dual(primal.detach(), tangent.detach())
        return d

    return grad_fun


class TooManyDerivativesError(Exception):
    pass


class _Limit(torch.autograd.Function):
    """The identity, counting the derivatives `elementwise_grad` takes
    through it: the counterpart of the JAX package's chain of custom-JVP
    identities.  Under a differentiation by `elementwise_grad` its
    backward raises past the bound, else passes the cotangent through a
    limiter one level up, owned by the tensor being differentiated, so
    that a further derivative with respect to the same tensor counts
    one more and one with respect to another tensor (a mixed
    derivative) does not.  Outside `elementwise_grad` (the
    hyperparameters' gradient) it is the identity.  With a bound of 0,
    the limiter on the input raises already where `elementwise_grad`
    evaluates the kernel on an input it differentiates, as the JAX
    package's raises where a tangent enters, even when the kernel's
    output does not depend on the input differentiably (White)."""

    @staticmethod
    def forward(ctx, x, level, n, token, name):
        if n == 0 and token is None and x.requires_grad and _stack().targets:
            raise TooManyDerivativesError(
                f'kernel{" " + name if name else ""} is derivable only '
                f'0 times')
        ctx.args = level, n, token, name
        return x.view_as(x)

    @staticmethod
    def jvp(ctx, t, *_):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        level, n, token, name = ctx.args
        targets = _stack().targets
        if targets and torch.is_grad_enabled():
            target = targets[-1]
            if token is not None and token != target:
                g = _Limit.apply(g, level, n, token, name)
            elif level >= n:
                raise TooManyDerivativesError(
                    f'kernel{" " + name if name else ""} is derivable only '
                    f'{n} times')
            else:
                g = _Limit.apply(g, level + 1, n, target, name)
        return g, None, None, None, None


def limit_derivatives(x, n, *, name=None):
    """``x``, but raising if `elementwise_grad` differentiates with respect
    to it more than ``n`` times; ``n`` None or ``sys.maxsize`` (True) is
    no limit."""
    if n is None or n >= sys.maxsize:
        return x
    return _Limit.apply(x, 0, n, None, name)


# -- recomputation ----------------------------------------------------------------

class _OuterInputs(torch.overrides.TorchFunctionMode):
    """Records the tensors requiring grad that a computation reads from
    outside itself: each tensor argument of a torch function (methods,
    operators and ``torch.autograd.grad`` included) that requires grad
    and is no result of an earlier call under the mode.  A tensor made
    before the mode is entered cannot share the ``id`` of one made
    under it, as both are alive at once."""

    def __init__(self):
        super().__init__()
        self.made = set()
        self.found = {}

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        for t in pytree.tree_leaves((args, kwargs)):
            if isinstance(t, torch.Tensor) and t.requires_grad \
                    and id(t) not in self.made:
                self.found.setdefault(id(t), t)
        out = func(*args, **kwargs)
        for t in pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.made.add(id(t))
        return out


class _Substitute(torch.overrides.TorchFunctionMode):
    """Passes ``subs[id(t)]`` wherever a torch function gets the tensor
    ``t``."""

    def __init__(self, subs):
        super().__init__()
        self.subs = subs

    def __torch_function__(self, func, types, args=(), kwargs=None):
        args, kwargs = pytree.tree_map(
            lambda t: self.subs.get(id(t), t) if isinstance(t, torch.Tensor)
            else t, (args, kwargs or {}))
        return func(*args, **kwargs)


class _Recompute(torch.autograd.Function):
    """``value`` = ``fn()``, computed without a graph kept, as a function
    of the outer tensors ``inputs`` that ``fn`` reads: the backward
    computes ``fn()`` again with its graph and differentiates that,
    keeping the graph only under ``create_graph`` (a second derivative).
    In the recomputation ``fn`` reads each input through an alias of its
    own, so that the derivative with respect to one input does not run
    on through another that it is computed from (the outer graph counts
    that path)."""

    @staticmethod
    def forward(ctx, fn, value, *inputs):
        ctx.fn = fn
        ctx.ids = [id(t) for t in inputs]
        ctx.save_for_backward(*inputs)
        return value

    @staticmethod
    def backward(ctx, g):
        with torch.enable_grad():
            aliases = [t.view_as(t) for t in ctx.saved_tensors]
            with _recomputing(), _Substitute(dict(zip(ctx.ids, aliases))):
                out = ctx.fn()
        grads = torch.autograd.grad(out, aliases, g, allow_unused=True,
                                    create_graph=torch.is_grad_enabled())
        return (None, None) + grads


@contextlib.contextmanager
def _recomputing():
    st = _stack()
    st.recomputing = getattr(st, 'recomputing', 0) + 1
    try:
        yield
    finally:
        st.recomputing -= 1


def recompute(fn):
    """``fn()``, a tensor, computed without an autograd graph and built
    again in the backward: a derivative block's graph holds many tensors
    of the block's size (`elementwise_grad` keeps each order's), the
    recomputation one block's at a time, and the forward none.  ``fn()``
    is returned as it is where nothing would be saved or the graph is
    needed: without grad mode, inside a differentiation by
    `elementwise_grad` or another recomputation, under forward-mode AD
    (dual tensors, which a recomputation would drop) or a functorch
    transform, or when it reads no tensor that requires grad."""
    st = _stack()
    if not torch.is_grad_enabled() or st.targets \
            or getattr(st, 'recomputing', 0) \
            or torch._C._are_functorch_transforms_active():
        return fn()
    mode = _OuterInputs()
    with _recomputing(), mode, torch.no_grad():
        out = fn()
    inputs = list(mode.found.values())
    if not inputs:
        return out
    if any(fwAD.unpack_dual(t).tangent is not None for t in inputs):
        return fn()
    return _Recompute.apply(fn, out, *inputs)
