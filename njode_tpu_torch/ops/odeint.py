"""ODE solvers in PyTorch, the port's copy of ``njode_tpu/ops/odeint.py``.

The solver registry of the reference's vendored torchdiffeq: fixed-grid
euler, midpoint, heun, rk4 and single Dormand-Prince / Tsitouras steps;
adaptive dopri5 and tsit5 (embedded pairs with PI step-size control), the
Adams-Bashforth(-Moulton) methods, and :func:`odeint_adjoint`, whose
gradients come from the continuous adjoint method as a
``torch.autograd.Function``. :func:`dopri5_step` and
:func:`integrate_segment_adaptive` back GRU-ODE-Bayes ``solver='dopri5'``
(one step per grid interval in training, the adaptive integrator in eval).

Times and step sizes are float32 tensors, as in the JAX package, so both
take the same steps. The adaptive loops are Python loops that read the
step-size controller on the host (one synchronisation per attempted step):
use them for evaluation and simulation; training takes the fixed-grid
methods or the adjoint. No kernel runs here.
"""

from __future__ import annotations

import torch

# Dormand-Prince 5(4) Butcher tableau
_DP_C = (0.0, 1 / 5, 3 / 10, 4 / 5, 8 / 9, 1.0, 1.0)
_DP_A = (
    (),
    (1 / 5,),
    (3 / 40, 9 / 40),
    (44 / 45, -56 / 15, 32 / 9),
    (19372 / 6561, -25360 / 2187, 64448 / 6561, -212 / 729),
    (9017 / 3168, -355 / 33, 46732 / 5247, 49 / 176, -5103 / 18656),
    (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84),
)
_DP_B5 = (35 / 384, 0.0, 500 / 1113, 125 / 192, -2187 / 6784, 11 / 84, 0.0)
_DP_B4 = (5179 / 57600, 0.0, 7571 / 16695, 393 / 640, -92097 / 339200,
          187 / 2100, 1 / 40)

# Tsitouras 5(4)
_TS_C = (0.0, 0.161, 0.327, 0.9, 0.9800255409045097, 1.0, 1.0)
_TS_A = (
    (),
    (0.161,),
    (-0.008480655492356989, 0.335480655492357),
    (2.8971530571054935, -6.359448489975075, 4.3622954328695815),
    (5.325864828439257, -11.748883564062828, 7.4955393428898365,
     -0.09249506636175525),
    (5.86145544294642, -12.92096931784711, 8.159367898576159,
     -0.071584973281401, -0.028269050394068383),
    (0.09646076681806523, 0.01, 0.4798896504144996, 1.379008574103742,
     -3.290069515436081, 2.324710524099774),
)
_TS_B5 = (0.09646076681806523, 0.01, 0.4798896504144996, 1.379008574103742,
          -3.290069515436081, 2.324710524099774, 0.0)
# b - b_hat (Tsitouras 2011): the embedded 4th-order error weights
_TS_E = (-0.00178001105222577714, -0.0008164344596567469,
         0.007880878010261995, -0.1447110071732629, 0.5823571654525552,
         -0.45808210592918697, 0.015151515151515152)

_AB4 = (55.0 / 24.0, -59.0 / 24.0, 37.0 / 24.0, -9.0 / 24.0)
_AM4 = (9.0 / 24.0, 19.0 / 24.0, -5.0 / 24.0, 1.0 / 24.0)


def _f32(x, like=None):
    dev = like.device if isinstance(like, torch.Tensor) else None
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


def euler_step(func, t, y, dt):
    return y + dt * func(t, y)


def midpoint_step(func, t, y, dt):
    k = func(t, y)
    return y + dt * func(t + dt / 2.0, y + dt / 2.0 * k)


def heun_step(func, t, y, dt):
    k1 = func(t, y)
    k2 = func(t + dt, y + dt * k1)
    return y + dt / 2.0 * (k1 + k2)


def rk4_step(func, t, y, dt):
    k1 = func(t, y)
    k2 = func(t + dt / 2.0, y + dt / 2.0 * k1)
    k3 = func(t + dt / 2.0, y + dt / 2.0 * k2)
    k4 = func(t + dt, y + dt * k3)
    return y + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)


def _stages(func, t, y, dt, C, A):
    ks = []
    for i in range(len(C)):
        yi = y
        for a, k in zip(A[i], ks):
            yi = yi + dt * a * k
        ks.append(func(t + C[i] * dt, yi))
    return ks


def dopri5_step(func, t, y, dt):
    """One Dormand-Prince 5(4) step; returns (y5, error_estimate)."""
    ks = _stages(func, t, y, dt, _DP_C, _DP_A)
    y5 = y
    y4 = y
    for b5, b4, k in zip(_DP_B5, _DP_B4, ks):
        y5 = y5 + dt * b5 * k
        y4 = y4 + dt * b4 * k
    return y5, y5 - y4


def tsit5_step(func, t, y, dt):
    """One Tsitouras 5(4) step; returns (y5, error_estimate)."""
    ks = _stages(func, t, y, dt, _TS_C, _TS_A)
    y5 = y
    err = torch.zeros_like(y)
    for b5, e, k in zip(_TS_B5, _TS_E, ks):
        y5 = y5 + dt * b5 * k
        err = err + dt * e * k
    return y5, err


FIXED_STEPPERS = {
    "euler": euler_step,
    "midpoint": midpoint_step,
    "heun": heun_step,
    "rk4": rk4_step,
    "dopri5_fixed": lambda f, t, y, dt: dopri5_step(f, t, y, dt)[0],
    "tsit5_fixed": lambda f, t, y, dt: tsit5_step(f, t, y, dt)[0],
}

# torchdiffeq's registry: adaptive dopri5/tsit5/adams plus the fixed-grid
# methods and explicit_adams (Adams-Bashforth) / fixed_adams (ABM)
SOLVERS = tuple(FIXED_STEPPERS) + ("dopri5", "tsit5", "adams",
                                   "explicit_adams", "fixed_adams")


def _error_ratio(err, y0, y1, rtol, atol):
    tol = atol + rtol * torch.maximum(torch.abs(y0), torch.abs(y1))
    r = err / tol
    return torch.sqrt(torch.mean(r * r))


def _adaptive_loop(attempt, y0, t0, t1, dt0, rtol, atol, max_steps, order):
    """The PI-controlled loop of the adaptive integrators over [t0, t1]:
    ``attempt(t, y, dt) -> (y_new, err)``; returns (y(t1), last dt)."""
    safety, min_fac, max_fac = 0.9, 0.2, 5.0
    t0 = _f32(t0, y0)
    t1 = _f32(t1, y0)
    dt0 = _f32(dt0, y0)
    # a zero/negative carried dt (after a duplicate time point) would stall
    # the loop: re-seed it from the segment length
    dt = torch.where(dt0 > 0.0, dt0,
                     torch.maximum(t1 - t0, _f32(1e-6, y0)))
    # below this floor steps are force-accepted, so an unattainable
    # tolerance degrades gracefully instead of running to max_steps
    min_dt = 1e-6 * torch.maximum(t1 - t0, _f32(1e-30, y0))
    t, y, n = t0, y0, 0
    end = t1 - 1e-12
    while n < max_steps and bool(t < end):
        dt_c = torch.minimum(dt, t1 - t)
        y_new, err = attempt(t, y, dt_c)
        ratio = _error_ratio(err, y, y_new, rtol, atol)
        if bool(ratio <= 1.0) or bool(dt_c <= min_dt):
            t = t + dt_c
            y = y_new
        fac = safety * torch.pow(torch.clamp(ratio, min=1e-10), -1.0 / order)
        dt = dt_c * torch.clamp(fac, min_fac, max_fac)
        n += 1
    return y, dt


def integrate_segment_adaptive(func, y0, t0, t1, dt0, rtol, atol,
                               max_steps, step_fn=None, order=5.0):
    """Adaptive embedded Runge-Kutta over one segment [t0, t1] (dopri5 by
    default, tsit5 via ``step_fn=tsit5_step``), at most ``max_steps``
    attempts; returns (y(t1), last accepted dt)."""
    step_fn = step_fn or dopri5_step
    return _adaptive_loop(lambda t, y, h: step_fn(func, t, y, h), y0, t0,
                          t1, dt0, rtol, atol, max_steps, order)


def _abm_adaptive_segment(func, y0, t0, t1, dt0, rtol, atol, max_steps):
    """Adaptive Adams-Bashforth-Moulton over one segment: an order-4
    predictor-corrector built on 4 RK4 quarter steps, with the Milne-device
    error estimate and the same PI controller as dopri5."""

    def attempt(t, y, dt_c):
        h = dt_c / 4.0
        ys = [y]
        fs = [func(t, y)]
        for i in range(3):
            ys.append(rk4_step(func, t + i * h, ys[-1], h))
            fs.append(func(t + (i + 1) * h, ys[-1]))
        y_pred = ys[3] + h * (_AB4[0] * fs[3] + _AB4[1] * fs[2]
                              + _AB4[2] * fs[1] + _AB4[3] * fs[0])
        f_pred = func(t + dt_c, y_pred)
        y_corr = ys[3] + h * (_AM4[0] * f_pred + _AM4[1] * fs[3]
                              + _AM4[2] * fs[2] + _AM4[3] * fs[1])
        return y_corr, (y_corr - y_pred) * (19.0 / 270.0)

    return _adaptive_loop(attempt, y0, t0, t1, dt0, rtol, atol, max_steps,
                          4.0)


def _adams_scan(func, y0, ts, substeps, corrector: bool):
    """Fixed-grid order-4 Adams-Bashforth (``explicit_adams``) or
    Adams-Bashforth-Moulton (``fixed_adams``) with an RK4 warm-up for the
    first 3 substeps."""
    fhist = [torch.zeros_like(y0)] * 4          # newest first
    warm = 0
    y = y0
    ys = [y0]
    for i in range(ts.shape[0] - 1):
        t0 = ts[i]
        h = (ts[i + 1] - ts[i]) / substeps
        for j in range(substeps):
            t = t0 + j * h
            f0 = func(t, y)
            fhist = [f0] + fhist[:-1]
            if warm >= 3:
                y_ab = y + h * (_AB4[0] * fhist[0] + _AB4[1] * fhist[1]
                                + _AB4[2] * fhist[2] + _AB4[3] * fhist[3])
                if corrector:
                    f_pred = func(t + h, y_ab)
                    y_ab = y + h * (_AM4[0] * f_pred + _AM4[1] * fhist[0]
                                    + _AM4[2] * fhist[1]
                                    + _AM4[3] * fhist[2])
                y = y_ab
            else:
                y = rk4_step(func, t, y, h)
            warm += 1
        ys.append(y)
    return torch.stack(ys)


def odeint(func, y0, ts, method: str = "dopri5", rtol=1e-6, atol=1e-8,
           substeps: int = 1):
    """Integrate ``dy/dt = func(t, y)`` through the time points ``ts``
    (torchdiffeq's API): returns ``ys`` with ``ys[i] = y(ts[i])``.

    :param method: one of :data:`SOLVERS`; fixed-grid methods take
        ``substeps`` equal steps per ``ts`` interval, the adaptive ones at
        most 1000 attempts per interval.
    """
    ts = _f32(ts, y0)
    if method in ("explicit_adams", "fixed_adams"):
        return _adams_scan(func, y0, ts, substeps,
                           corrector=(method == "fixed_adams"))
    if method not in SOLVERS:
        raise ValueError(f"unknown method '{method}' (one of {SOLVERS})")
    ys = [y0]
    y = y0
    if method in ("dopri5", "tsit5", "adams"):
        dt = (ts[1] - ts[0]) if ts.shape[0] > 1 else _f32(1.0, y0)
        for i in range(ts.shape[0] - 1):
            if method == "adams":
                y, dt = _abm_adaptive_segment(func, y, ts[i], ts[i + 1], dt,
                                              rtol, atol, 1000)
            else:
                y, dt = integrate_segment_adaptive(
                    func, y, ts[i], ts[i + 1], dt, rtol, atol, 1000,
                    step_fn=tsit5_step if method == "tsit5"
                    else dopri5_step)
            ys.append(y)
    else:
        stepper = FIXED_STEPPERS[method]
        for i in range(ts.shape[0] - 1):
            h = (ts[i + 1] - ts[i]) / substeps
            for j in range(substeps):
                y = stepper(func, ts[i] + j * h, y, h)
            ys.append(y)
    return torch.stack(ys)


# ---------------------------------------------------------------------------
# continuous adjoint method (torchdiffeq's odeint_adjoint)
# ---------------------------------------------------------------------------

_RK_TABLEAUX = {
    # (c, A, b) explicit tableaux mirroring FIXED_STEPPERS, for the
    # augmented adjoint state
    "euler": ((0.0,), ((),), (1.0,)),
    "midpoint": ((0.0, 0.5), ((), (0.5,)), (0.0, 1.0)),
    "heun": ((0.0, 1.0), ((), (1.0,)), (0.5, 0.5)),
    "rk4": ((0.0, 0.5, 0.5, 1.0),
            ((), (0.5,), (0.0, 0.5), (0.0, 0.0, 1.0)),
            (1 / 6, 1 / 3, 1 / 3, 1 / 6)),
    "dopri5_fixed": (_DP_C, _DP_A, _DP_B5),
    "tsit5_fixed": (_TS_C, _TS_A, _TS_B5),
}


def _axpy(x, h, a, k):
    """x + h * a * k over a tuple state (tensor, tensor, [tensors])."""
    y, adj, g = x
    ky, ka, kg = k
    return (y + h * a * ky, adj + h * a * ka,
            [u + h * a * v for u, v in zip(g, kg)])


def _tree_rk_step(tableau, f, t, state, h):
    c, A, b = tableau
    ks = []
    for i in range(len(c)):
        si = state
        for a, k in zip(A[i], ks):
            if a != 0.0:
                si = _axpy(si, h, a, k)
        ks.append(f(t + c[i] * h, si))
    out = state
    for bi, k in zip(b, ks):
        if bi != 0.0:
            out = _axpy(out, h, bi, k)
    return out


class _OdeintAdjoint(torch.autograd.Function):
    """ys of the fixed-grid integration; the backward integrates
    ``d[y, a, g]/ds = [-f, a^T df/dy, a^T df/dparams]`` in reverse between
    the time points (one vector-Jacobian product per stage)."""

    @staticmethod
    def forward(ctx, func, method, substeps, y0, ts, *params):
        stepper = FIXED_STEPPERS[method]
        ys = [y0.detach()]
        y = y0.detach()
        with torch.no_grad():
            for i in range(ts.shape[0] - 1):
                h = (ts[i + 1] - ts[i]) / substeps
                for j in range(substeps):
                    y = stepper(lambda t, yy: func(t, yy, params),
                                ts[i] + j * h, y, h)
                ys.append(y)
        ys = torch.stack(ys)
        ctx.func, ctx.method, ctx.substeps = func, method, substeps
        ctx.save_for_backward(ys, ts, *params)
        return ys

    @staticmethod
    def backward(ctx, ct_ys):
        ys, ts = ctx.saved_tensors[:2]
        params = list(ctx.saved_tensors[2:])
        func, substeps = ctx.func, ctx.substeps
        tableau = _RK_TABLEAUX[ctx.method]

        def aug_field(t, state):
            y, a, _ = state
            with torch.enable_grad():
                yy = y.detach().requires_grad_(True)
                pp = [p.detach().requires_grad_(True) for p in params]
                fy = func(-t, yy, pp)
                vjp = torch.autograd.grad(fy, [yy] + pp, grad_outputs=a,
                                          allow_unused=True)
            ay = torch.zeros_like(y) if vjp[0] is None else vjp[0]
            ap = [torch.zeros_like(p) if v is None else v
                  for p, v in zip(params, vjp[1:])]
            # reverse time: dy/ds = -f, da/ds = +a^T df/dy, dg/ds = +a^T df/dp
            return (-fy.detach(), ay, ap)

        a = torch.zeros_like(ys[0])
        g = [torch.zeros_like(p) for p in params]
        for i in range(ts.shape[0] - 1, 0, -1):
            a = a + ct_ys[i]              # the cotangent lands at ts[i]
            t0, t1 = ts[i - 1], ts[i]
            h = (t1 - t0) / substeps
            state = (ys[i], a, g)
            for j in range(substeps):
                state = _tree_rk_step(tableau, aug_field, -(t1 - j * h),
                                      state, h)
            _, a, g = state
        return (None, None, None, a + ct_ys[0], None) + tuple(g)


def odeint_adjoint(func, y0, ts, params, method: str = "dopri5_fixed",
                   substeps: int = 1):
    """Integrate ``dy/dt = func(t, y, params)`` with gradients from the
    continuous adjoint method (O(1) memory in the number of steps).

    :param params: the differentiable parameters of ``func``, a sequence
        of tensors passed to it as a list
    :param method: a fixed-grid method (:data:`FIXED_STEPPERS`); the
        adjoint exists so that the integrator itself is not differentiated
    :return: ``ys`` with ``ys[i] = y(ts[i])``, differentiable in ``y0`` and
        ``params``
    """
    if method not in FIXED_STEPPERS:
        raise ValueError(
            f"odeint_adjoint needs a fixed-grid method, got '{method}' "
            f"(one of {tuple(FIXED_STEPPERS)})")
    ts = _f32(ts, y0)
    return _OdeintAdjoint.apply(func, method, substeps, y0, ts, *params)
