"""The port's ODE solvers (ops/odeint.py) against the JAX package's
``njode_tpu/ops/odeint.py``: every method of the registry on the same
problems, the adaptive controllers, and the adjoint gradients."""

import numpy as np
import pytest

import conftest  # noqa: F401

import jax
import jax.numpy as jnp
import torch

from njode_tpu.ops import odeint as jode
from njode_tpu_torch.ops import odeint as tode

TS = np.array([0.0, 0.3, 0.7, 1.0, 1.6], np.float32)
Y0 = np.array([1.0, -0.5, 0.25], np.float32)
A = np.array([[-0.5, 1.0, 0.0], [-1.0, -0.2, 0.3], [0.1, 0.0, -1.5]],
             np.float32)


def _jf(t, y):
    return jnp.tanh(y @ A.T) + 0.1 * jnp.sin(3.0 * t) * y


def _tf(t, y):
    return torch.tanh(y @ torch.as_tensor(A).T) \
        + 0.1 * torch.sin(3.0 * torch.as_tensor(t)) * y


@pytest.mark.parametrize("method", list(tode.SOLVERS))
def test_every_method_matches_jax(method):
    """Each method of the registry gives JAX's trajectory (adaptive ones
    take the same accepted steps: times and step sizes are float32 on both
    sides)."""
    kw = dict(substeps=3) if method in tode.FIXED_STEPPERS or "adams" in \
        method else {}
    if method in ("dopri5", "tsit5", "adams"):
        kw = dict(rtol=1e-4, atol=1e-6)
    ref = jode.odeint(_jf, jnp.asarray(Y0), jnp.asarray(TS), method, **kw)
    got = tode.odeint(_tf, torch.as_tensor(Y0), torch.as_tensor(TS), method,
                      **kw)
    assert got.shape == (len(TS), 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


def test_adaptive_segment_matches_jax_and_is_accurate():
    """One adaptive dopri5 segment against JAX's and against the exact
    solution of dy/dt = -2y. At rtol 1e-6 the embedded error estimate
    (the difference of two nearly equal float32 sums) is rounding noise,
    so the two controllers may choose different steps: the solutions
    agree, the last step sizes need not."""
    y0 = np.array([1.0, 2.0], np.float32)
    yj, dtj = jode._integrate_segment_adaptive(
        lambda t, y: -2.0 * y, jnp.asarray(y0), 0.0, 1.5, 0.1, 1e-6, 1e-8,
        64)
    yt, dtt = tode.integrate_segment_adaptive(
        lambda t, y: -2.0 * y, torch.as_tensor(y0), 0.0, 1.5, 0.1, 1e-6,
        1e-8, 64)
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), rtol=1e-6)
    assert 0.0 < float(dtt) <= 5 * 1.5 and 0.0 < float(dtj)
    np.testing.assert_allclose(yt.numpy(), y0 * np.exp(-3.0), rtol=1e-5)
    # a zero-length segment (a dt==0 padding step) is a no-op
    y_same, _ = tode.integrate_segment_adaptive(
        lambda t, y: -2.0 * y, torch.as_tensor(y0), 0.0, 0.0, 0.0, 1e-6,
        1e-8, 64)
    np.testing.assert_array_equal(y_same.numpy(), y0)


def test_fixed_grid_convergence_order():
    """rk4 beats euler by orders of magnitude on a smooth problem."""
    y0 = torch.ones(())
    ts = torch.tensor([0.0, 1.0])
    errs = {m: abs(float(tode.odeint(lambda t, y: -y, y0, ts, m,
                                     substeps=20)[-1]) - np.exp(-1.0))
            for m in ("euler", "midpoint", "rk4")}
    assert errs["rk4"] < errs["midpoint"] < errs["euler"]
    assert errs["rk4"] < 1e-6


@pytest.mark.parametrize("method", ["euler", "rk4", "dopri5_fixed"])
def test_adjoint_gradients_match_jax(method):
    """``odeint_adjoint`` gradients in y0 and the parameters, with
    cotangents at every time point, against JAX's adjoint."""
    W = np.array([[0.3, -0.7], [0.5, 0.1]], np.float32)
    b = np.array([0.05, -0.1], np.float32)
    y0 = np.array([0.4, -0.2], np.float32)
    ts = np.array([0.0, 0.4, 1.0], np.float32)
    ct = np.array([[0.1, 0.2], [0.3, -0.4], [1.0, 0.5]], np.float32)

    def jfunc(t, y, p):
        return jnp.tanh(y @ p["W"] + p["b"])

    def jloss(y0_, p):
        ys = jode.odeint_adjoint(jfunc, y0_, jnp.asarray(ts), p,
                                 method=method, substeps=4)
        return jnp.sum(ys * ct)

    gy, gp = jax.grad(jloss, argnums=(0, 1))(
        jnp.asarray(y0), {"W": jnp.asarray(W), "b": jnp.asarray(b)})
    Wt = torch.tensor(W, requires_grad=True)
    bt = torch.tensor(b, requires_grad=True)
    y0t = torch.tensor(y0, requires_grad=True)

    def tfunc(t, y, p):
        return torch.tanh(y @ p[0] + p[1])

    ys = tode.odeint_adjoint(tfunc, y0t, torch.as_tensor(ts), [Wt, bt],
                             method=method, substeps=4)
    (ys * torch.as_tensor(ct)).sum().backward()
    np.testing.assert_allclose(y0t.grad.numpy(), np.asarray(gy), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(Wt.grad.numpy(), np.asarray(gp["W"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bt.grad.numpy(), np.asarray(gp["b"]),
                               rtol=1e-5, atol=1e-6)
    if method == "euler":
        return
    # at high order the adjoint's gradient agrees with differentiating the
    # integrator (at euler's order the two differ by the discretisation)
    y0d = torch.tensor(y0, requires_grad=True)
    Wd = torch.tensor(W, requires_grad=True)
    bd = torch.tensor(b, requires_grad=True)
    yd = tode.odeint(lambda t, y: tfunc(t, y, [Wd, bd]), y0d,
                     torch.as_tensor(ts), method, substeps=4)
    (yd * torch.as_tensor(ct)).sum().backward()
    np.testing.assert_allclose(Wt.grad.numpy(), Wd.grad.numpy(), rtol=1e-3,
                               atol=1e-5)


def test_unknown_and_adaptive_methods_raise():
    with pytest.raises(ValueError, match="unknown method"):
        tode.odeint(lambda t, y: -y, torch.ones(2), torch.tensor([0., 1.]),
                    "bogus")
    with pytest.raises(ValueError, match="fixed-grid"):
        tode.odeint_adjoint(lambda t, y, p: -y, torch.ones(2),
                            torch.tensor([0., 1.]), [], method="dopri5")
