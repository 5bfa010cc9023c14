"""The dynamic bicycles' discrete step with its derivatives: a CUDA kernel, its plain
version, and the autograd functions through which ``torch.func`` differentiates it.

A rollout of the dynamic bicycle calls ``fc`` 4 M times a step (rk4, M = 10 in the
dynamic studies), each a few dozen tensor operations, and ``torch.func`` repeats each of
them for every derivative it takes: about a million operations for one game Hessian of
the dynamic duel (N = 15), each one a kernel launch on the card.  Here the step is one
operation instead.  ``fd_step`` is an ``autograd.Function`` whose value, Jacobian and
second derivatives come from :func:`dyn_step`:

* ``dyn_step(model, q, u, order)`` gives f = fd(q, u) (order 0), with the Jacobian
  J = d f / d[q, u] (order 1), and with the second derivatives H (order 2) at a batch
  of points.  A CUDA tensor launches ``csrc/dyn_step.cu`` (hyper-dual arithmetic, one
  thread per point and pair of inputs), and raises for a model or track the kernel does
  not have; a CPU tensor takes the plain version, the model's own ``fd_plain`` run on
  second-order numbers (``_T2``), so that the model is written once in Python and once
  in CUDA.  No fallback.
* ``fd_step``'s backward and forward rules multiply by J from ``_FdJac``, whose own
  rules use H from ``_FdHess``, so that a forward-over-reverse Hessian (the game's
  ``evaluate``, ``evaluate_dp``) sees the step's exact second derivatives; no rule goes
  beyond second order.  PyTorch runs an ``autograd.Function``'s forward rule with
  forward gradients off, so a forward-over-forward Hessian would see none: take second
  derivatives forward-over-reverse (the models' ``fEd``/``fFd``/``fGd`` do).

Launches are counted in ``dyn_step.launches``, by order in
``dyn_step.launches_by_order`` and by order and point count in
``dyn_step.launches_by_shape`` (keys ``'order{k}_P{P}'``).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch
from torch.func import jacfwd, vmap

from dgsqp_torch.ops.linalg import _check_cuda, _load, _raise_on

# model kinds of csrc/dyn_step.cu
MODEL_KINDS = {'DynamicBicycle': 0, 'DynamicCLBicycle': 1, 'DynamicBicycleCombined': 2,
               'DynamicBicycleProgressAugmented': 3}
METHODS = {'euler': 0, 'rk2': 1, 'rk3': 2, 'rk4': 3}
_TRACK_KINDS = (1, 2)


def kernel_kind(model) -> int:
    """The kernel's model kind for ``model``, or -1 where it has none: a frame that reads
    the track needs a ``RadiusArclengthTrack`` (piecewise arcs)."""
    from dgsqp_torch.tracks.base import RadiusArclengthTrack
    kind = MODEL_KINDS.get(type(model).__name__, -1)
    if kind in _TRACK_KINDS and not isinstance(model.track, RadiusArclengthTrack):
        return -1
    return kind


def _linear_gains(model):
    """The linear tires' lateral gains (front, rear): the gain times the axle's load."""
    return (model.linear_Bf * model.m * model.g * model.L_r / (model.L_f + model.L_r),
            model.linear_Br * model.m * model.g * model.L_f / (model.L_f + model.L_r))


def _params(model):
    prm = (model.L_f, model.L_r, model.m, model.I_z, model.c_da, model.c_dr, model.c_r,
           model.p_r, model.pacejka_Df, model.pacejka_Dr, model.pacejka_Bf,
           model.pacejka_Br, model.pacejka_Cf, model.pacejka_Cr, *_linear_gains(model))
    flags = (int(model.tire_model == 'linear'), int(model.drive_wheels == 'rear'),
             int(model.simple_slip))
    return (ctypes.c_double * 16)(*[float(v) for v in prm]), (ctypes.c_int * 3)(*flags)


def _col(c):
    """A constant that scales a gradient (..., L): a float, or a tensor per point."""
    return c[..., None] if isinstance(c, torch.Tensor) and c.dim() else c


def _mat(c):
    return c[..., None, None] if isinstance(c, torch.Tensor) and c.dim() else c


def _outer(a, b):
    return a[..., :, None] * b[..., None, :]


class _T2:
    """Numbers with their gradients ``g`` (..., L) and second derivatives ``h``
    (..., L, L) over the step's L inputs (``h`` None at first order), all seed pairs at
    once: the plain version runs the models' own ``fd_plain`` and ``fc`` on them.  They
    take Python arithmetic, comparisons, ``unbind(-1)`` and the torch functions in
    ``_RULES``, which are those of the dynamic bicycles and their tracks."""

    __slots__ = ('v', 'g', 'h')

    def __init__(self, v, g, h=None):
        self.v, self.g, self.h = v, g, h

    dtype = property(lambda self: self.v.dtype)
    device = property(lambda self: self.v.device)

    def _lift(self, c):
        """A constant as a ``_T2`` shaped like this one, with zero derivatives."""
        if isinstance(c, _T2):
            return c
        v = torch.as_tensor(c, dtype=self.v.dtype, device=self.v.device).expand_as(self.v)
        return _T2(v, torch.zeros_like(self.g),
                   None if self.h is None else torch.zeros_like(self.h))

    def _chain(self, f0, f1, f2):
        """f(self) from f's value f0 and its first and second derivatives f1, f2."""
        h = None
        if self.h is not None:
            h = _mat(f1) * self.h + _mat(f2) * _outer(self.g, self.g)
        return _T2(f0, _col(f1) * self.g, h)

    def __add__(self, o):
        if isinstance(o, _T2):
            return _T2(self.v + o.v, self.g + o.g, None if self.h is None else self.h + o.h)
        return _T2(self.v + o, self.g, self.h)

    __radd__ = __add__

    def __neg__(self):
        return _T2(-self.v, -self.g, None if self.h is None else -self.h)

    def __sub__(self, o):
        return self + (-o)

    def __rsub__(self, c):
        return (-self) + c

    def __mul__(self, o):
        if isinstance(o, _T2):
            h = None
            if self.h is not None:
                gg = _outer(self.g, o.g)
                h = _mat(self.v) * o.h + _mat(o.v) * self.h + gg + gg.transpose(-1, -2)
            return _T2(self.v * o.v, _col(self.v) * o.g + _col(o.v) * self.g, h)
        return _T2(self.v * o, self.g * _col(o), None if self.h is None else self.h * _mat(o))

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, _T2):
            inv = 1.0 / o.v
            out = self * o._chain(inv, -inv * inv, 2.0 * inv * inv * inv)
            out.v = self.v / o.v
            return out
        return _T2(self.v / o, self.g / _col(o), None if self.h is None else self.h / _mat(o))

    def __pow__(self, p: float):
        if p == 0:      # x ** 0 is the constant 1, with zero derivatives at x = 0 too
            return self._lift(1.0)
        return self._chain(self.v ** p, p * self.v ** (p - 1), p * (p - 1) * self.v ** (p - 2))

    def __lt__(self, o):
        return self.v < (o.v if isinstance(o, _T2) else o)

    def __gt__(self, o):
        return self.v > (o.v if isinstance(o, _T2) else o)

    def unbind(self, dim: int = -1):
        if dim != -1:
            raise ValueError('_T2.unbind splits the last value dimension only')
        hs = self.h.unbind(-3) if self.h is not None else [None] * self.v.shape[-1]
        return [_T2(v, g, h) for v, g, h in zip(self.v.unbind(-1), self.g.unbind(-2), hs)]

    @classmethod
    def __torch_function__(cls, func, types, args=(), kwargs=None):
        rule = _RULES.get(func)
        if rule is None:
            return NotImplemented
        return rule(*args, **(kwargs or {}))


def _stack(parts, dim: int = -1):
    if dim != -1:
        raise ValueError('_T2 stacks along a new last value dimension only')
    like = next(p for p in parts if isinstance(p, _T2))
    parts = [like._lift(p) for p in parts]
    h = None if like.h is None else torch.stack([p.h for p in parts], dim=-3)
    return _T2(torch.stack([p.v for p in parts], dim=-1),
               torch.stack([p.g for p in parts], dim=-2), h)


def _where(cond, a, b):
    like = a if isinstance(a, _T2) else b
    a, b = like._lift(a), like._lift(b)
    h = None if like.h is None else torch.where(cond[..., None, None], a.h, b.h)
    return _T2(torch.where(cond, a.v, b.v), torch.where(cond[..., None], a.g, b.g), h)


def _atan2(y, x):
    y, x = (y if isinstance(y, _T2) else x._lift(y)), (x if isinstance(x, _T2) else y._lift(x))
    r2 = x.v * x.v + y.v * y.v
    fy, fx = x.v / r2, -y.v / r2
    g = _col(fy) * y.g + _col(fx) * x.g
    h = None
    if x.h is not None:
        r4 = r2 * r2
        fyy, fxx, fxy = -2.0 * x.v * y.v / r4, 2.0 * x.v * y.v / r4, (y.v * y.v - x.v * x.v) / r4
        h = _mat(fy) * y.h + _mat(fx) * x.h + _mat(fyy) * _outer(y.g, y.g) \
            + _mat(fxx) * _outer(x.g, x.g) + _mat(fxy) * (_outer(x.g, y.g) + _outer(y.g, x.g))
    return _T2(torch.atan2(y.v, x.v), g, h)


def _sin(x):
    s, c = torch.sin(x.v), torch.cos(x.v)
    return x._chain(s, c, -s)


def _cos(x):
    s, c = torch.sin(x.v), torch.cos(x.v)
    return x._chain(c, -s, -c)


def _atan(x):
    d = 1.0 / (1.0 + x.v * x.v)
    return x._chain(torch.atan(x.v), d, -2.0 * x.v * d * d)


def _sqrt(x):
    r = torch.sqrt(x.v)
    return x._chain(r, 0.5 / r, -0.25 / (r * x.v))


# the torch functions ``_T2`` takes: elementwise rules, and the track's piecewise
# helpers (``fmod`` has slope 1; ``searchsorted`` reads the values only)
_RULES = {
    torch.sin: _sin,
    torch.cos: _cos,
    torch.atan: _atan,
    torch.atan2: _atan2,
    torch.sqrt: _sqrt,
    torch.abs: lambda x: x._chain(torch.abs(x.v), torch.sign(x.v), torch.zeros_like(x.v)),
    torch.fmod: lambda x, L: _T2(torch.fmod(x.v, L), x.g, x.h),
    torch.where: _where,
    torch.stack: _stack,
    torch.searchsorted: lambda seq, x, **kw: torch.searchsorted(seq, x.v, **kw),
}


def _func_step(model, q, u, order: int):
    """(f, J, H) of ``fd_plain`` by ``torch.func``: for a model or track beyond
    ``_RULES`` (a Frenet frame on a spline track), which the kernel has not either."""
    nq = q.shape[-1]
    step = lambda z: model.fd_plain(z[:nq], z[nq:])
    z = torch.cat([q, u], dim=-1)
    J = vmap(jacfwd(step))(z)
    H = vmap(jacfwd(jacfwd(step)))(z) if order == 2 else None
    return model.fd_plain(q, u), J, H


def dyn_step_plain(model, q, u, order: int, dt=None, M=None, method=None):
    """(f, J, H) in tensor operations (J and H None below their order): the model's own
    ``fd_plain``, on ``_T2`` numbers seeded with the inputs for J and H; q (P, n_q),
    u (P, n_u).  ``dt``, ``M`` and ``method`` override the model's step (order 0
    only: the derivatives are the model's own step's)."""
    if order == 0:
        return model.fd_plain(q, u, dt, M, method), None, None
    if (dt, M, method) != (None, None, None):
        raise ValueError('dyn_step: step overrides are for order 0 only')
    if kernel_kind(model) < 0:
        return _func_step(model, q, u, order)
    P, nq = q.shape
    L = nq + u.shape[-1]
    seed = torch.eye(L, dtype=q.dtype, device=q.device).expand(P, L, L)

    def num(x, rows):
        h = torch.zeros(*x.shape, L, L, dtype=q.dtype, device=q.device) if order == 2 else None
        return _T2(x, seed[:, rows], h)
    f = model.fd_plain(num(q, slice(0, nq)), num(u, slice(nq, L)))
    return f.v, f.g, f.h


def dyn_step(model, q, u, order: int, dt=None, M=None, method=None):
    """fd(q, u) and, by ``order``, its Jacobian (P, n_q, L) and second derivatives
    (P, n_q, L, L) at the points q (P, n_q), u (P, n_u).  ``dt``, the sub-step count
    ``M`` and ``method`` default to the model's own; at order 0 they may differ (the
    plant's host step integrates at the simulation's step).  A CPU tensor takes
    :func:`dyn_step_plain`; a CUDA tensor launches ``csrc/dyn_step.cu``."""
    if q.device.type == 'cpu':
        return dyn_step_plain(model, q, u, order, dt, M, method)
    if order and (dt, M, method) != (None, None, None):
        raise ValueError('dyn_step: step overrides are for order 0 only')
    kind = kernel_kind(model)
    if kind < 0:
        raise ValueError(f'dyn_step: no kernel for {type(model).__name__} with '
                         f'{type(model.track).__name__}')
    if q.device.type != 'cuda':
        raise ValueError(f'dyn_step: unsupported device {q.device}')
    q, u = q.contiguous(), u.contiguous()
    _check_cuda('dyn_step', q, u)
    P, nq = q.shape
    nu = u.shape[-1]
    L = nq + nu
    f = torch.empty_like(q)
    J = torch.empty(P, nq, L, dtype=q.dtype, device=q.device) if order >= 1 else None
    H = torch.empty(P, nq, L, L, dtype=q.dtype, device=q.device) if order == 2 else None
    if P == 0:
        return f, J, H
    if kind in _TRACK_KINDS:
        kp, cum = model.track._tables_for(q)
        n_kp, length = kp.shape[0], float(model.track.track_length)
        kp_ptr, cum_ptr = kp.data_ptr(), cum.data_ptr()
    else:
        kp_ptr = cum_ptr = None
        n_kp, length = 0, 0.0
    method = method or model.model_config.discretization_method
    dt = float(model.dt if dt is None else dt)
    M = int(M or model.M)
    prm, flags = _params(model)
    eps = float(np.spacing(torch.finfo(q.dtype).eps))
    lib = _load('dyn_step')
    fn = lib.dgsqp_dyn_step_f32 if q.dtype == torch.float32 else lib.dgsqp_dyn_step_f64
    index = q.device.index or 0
    rc = fn(q.data_ptr(), u.data_ptr(), P, kind, nq, nu, METHODS[method], M, dt, dt / M,
            prm, flags, kp_ptr, cum_ptr, n_kp, length, eps, order, f.data_ptr(), J.data_ptr() if J is not None else None,
            H.data_ptr() if H is not None else None, index,
            torch.cuda.current_stream(q.device).cuda_stream)
    _raise_on(rc, 'dyn_step')
    dyn_step.launches += 1
    dyn_step.launches_by_order[order] = dyn_step.launches_by_order.get(order, 0) + 1
    key = f'order{order}_P{P}'
    dyn_step.launches_by_shape[key] = dyn_step.launches_by_shape.get(key, 0) + 1
    return f, J, H


dyn_step.launches = 0
dyn_step.launches_by_order = {}
dyn_step.launches_by_shape = {}


def _points(q, u):
    """q (..., n_q), u (..., n_u) broadcast to one leading shape and flattened."""
    lead = torch.broadcast_shapes(q.shape[:-1], u.shape[:-1])
    q = q.expand(*lead, q.shape[-1]).reshape(-1, q.shape[-1])
    u = u.expand(*lead, u.shape[-1]).reshape(-1, u.shape[-1])
    return lead, q, u


def _fold(info, in_dims, q, u):
    """vmap rule helper: the mapped dimension moved in front of both operands."""
    dq, du = in_dims[1], in_dims[2]
    q = q.movedim(dq, 0) if dq is not None else q.expand(info.batch_size, *q.shape)
    u = u.movedim(du, 0) if du is not None else u.expand(info.batch_size, *u.shape)
    return q, u


def _cat_tangents(tq, tu, q, u):
    """The tangent [tq, tu] of a point (zero where an operand has none)."""
    lead = torch.broadcast_shapes(q.shape[:-1], u.shape[:-1])
    tq = tq if tq is not None else torch.zeros_like(q)
    tu = tu if tu is not None else torch.zeros_like(u)
    return torch.cat([tq.expand(*lead, q.shape[-1]), tu.expand(*lead, u.shape[-1])], dim=-1)


class _FdHess(torch.autograd.Function):
    """Second derivatives (..., n_q, L, L) of the step; not differentiable further."""

    @staticmethod
    def forward(model, q, u):
        lead, qq, uu = _points(q, u)
        H = dyn_step(model, qq, uu, 2)[2]
        return H.reshape(*lead, *H.shape[1:])

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def vmap(info, in_dims, model, q, u):
        q, u = _fold(info, in_dims, q, u)
        return _FdHess.apply(model, q, u), 0


class _FdJac(torch.autograd.Function):
    """Jacobian (..., n_q, L) of the step, L = n_q + n_u."""

    @staticmethod
    def forward(model, q, u):
        lead, qq, uu = _points(q, u)
        J = dyn_step(model, qq, uu, 1)[1]
        return J.reshape(*lead, *J.shape[1:])

    @staticmethod
    def setup_context(ctx, inputs, output):
        model, q, u = inputs
        ctx.model = model
        ctx.save_for_backward(q, u)
        ctx.save_for_forward(q, u)

    @staticmethod
    def backward(ctx, gJ):
        q, u = ctx.saved_tensors
        H = _FdHess.apply(ctx.model, q, u)
        gz = torch.einsum('...il,...ilm->...m', gJ, H)
        nq = q.shape[-1]
        return None, gz[..., :nq].sum_to_size(q.shape), gz[..., nq:].sum_to_size(u.shape)

    @staticmethod
    def jvp(ctx, _, tq, tu):
        q, u = ctx.saved_tensors
        H = _FdHess.apply(ctx.model, q, u)
        t = _cat_tangents(tq, tu, q, u)
        return (H @ t[..., None, :, None])[..., 0]

    @staticmethod
    def vmap(info, in_dims, model, q, u):
        q, u = _fold(info, in_dims, q, u)
        return _FdJac.apply(model, q, u), 0


class _FdStep(torch.autograd.Function):
    """The step fd(q, u) (..., n_q)."""

    @staticmethod
    def forward(model, q, u):
        lead, qq, uu = _points(q, u)
        return dyn_step(model, qq, uu, 0)[0].reshape(*lead, q.shape[-1])

    @staticmethod
    def setup_context(ctx, inputs, output):
        model, q, u = inputs
        ctx.model = model
        ctx.save_for_backward(q, u)
        ctx.save_for_forward(q, u)

    @staticmethod
    def backward(ctx, g):
        q, u = ctx.saved_tensors
        J = _FdJac.apply(ctx.model, q, u)
        gz = (g[..., None, :] @ J)[..., 0, :]
        nq = q.shape[-1]
        return None, gz[..., :nq].sum_to_size(q.shape), gz[..., nq:].sum_to_size(u.shape)

    @staticmethod
    def jvp(ctx, _, tq, tu):
        q, u = ctx.saved_tensors
        J = _FdJac.apply(ctx.model, q, u)
        t = _cat_tangents(tq, tu, q, u)
        return (J @ t[..., None])[..., 0]

    @staticmethod
    def vmap(info, in_dims, model, q, u):
        q, u = _fold(info, in_dims, q, u)
        return _FdStep.apply(model, q, u), 0


def fd_step(model, q, u):
    """The model's discrete step as one differentiable operation (see the module)."""
    return _FdStep.apply(model, q, u)
