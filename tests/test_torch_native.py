"""The port's C++ collation (``njode_tpu_torch/native``), called directly,
against the numpy paths of the port's ``data/grid.py`` (its plain
versions) and against the JAX package's ``grid`` outputs: the union grid,
the event scatter, the path scatter, the overflow case and the t = 0
observation; and ``data/grid.py`` never builds it. Tolerance: bit for bit
(``np.array_equal``) throughout."""

import os
import subprocess
import sys

import numpy as np
import pytest

import conftest  # noqa: F401

from njode_tpu.data import grid as jgrid
from njode_tpu_torch import native
from njode_tpu_torch.data import grid as tgrid

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _same(x, y, name):
    x, y = np.asarray(x), np.asarray(y)
    assert x.dtype == y.dtype and x.shape == y.shape, name
    assert np.array_equal(x, y), name


def _equal(a, b):
    for name in tgrid.GridBatch._fields:
        _same(getattr(a, name), getattr(b, name), name)


def _native_events(times, time_ptr, X, obs_idx, dt, T, start_X, M=None,
                   max_steps=None):
    """The dense arrays of ``batch_from_events`` from the C++ grid and
    scatter: ``(times, dt, obs, X, M)``."""
    g_times, g_dts, obs_step, _ = native.build_union_grid(times, dt, T,
                                                          max_steps)
    obs, Xd, Md = native.densify_events(obs_step, time_ptr, obs_idx, X, M,
                                        len(g_times), len(start_X))
    return (g_times.astype(np.float32), g_dts.astype(np.float32), obs, Xd,
            Md)


def _check_events(nat, b):
    for name, x in zip(("times", "dt", "obs", "X", "M"), nat):
        _same(x, getattr(b, name), name)


GRID_CASES = [
    dict(times=[0.1, 0.3, 0.5, 1.0], dt=0.1, T=1.0, ms=10),
    dict(times=[0.013, 0.25, 0.254, 0.777, 1.0], dt=0.1, T=1.0, ms=30),
    dict(times=[0.2, 0.9, 1.5], dt=0.25, T=1.0, ms=20),
    dict(times=[0.0, 0.3, 1.0], dt=0.1, T=1.0, ms=20),
]


@pytest.mark.parametrize("case", GRID_CASES,
                         ids=["aligned", "offgrid", "beyond_T", "t0"])
def test_union_grid_native_numpy_and_jax_agree(case):
    args = (case["times"], case["dt"], case["T"], case["ms"])
    nat = native.build_union_grid(*args)[:3]
    py = tgrid.build_union_grid(*args)
    ref = jgrid.build_union_grid(*args)
    for a, b, c in zip(nat, py, ref):
        assert a.dtype == b.dtype == np.asarray(c).dtype
        assert np.array_equal(a, b) and np.array_equal(a, c)
    leading = int(case["times"][0] == 0.0)     # the t = 0 step, dt = 0
    assert native.build_union_grid(*args)[3] == int((py[1] > 0).sum()) \
        + leading


def test_t0_observation_leading_zero_step():
    times, dts, obs_step, k = native.build_union_grid([0.0, 0.3, 1.0], 0.1,
                                                      1.0, 20)
    assert times[0] == 0.0 and dts[0] == 0.0 and obs_step[0] == 0
    assert dts[1] > 0 and k == 11
    ev = dict(times=np.array([0.0, 0.5]), time_ptr=np.array([0, 1, 2]),
              X=np.array([[1.0], [2.0]], np.float32),
              obs_idx=np.array([0, 0]))
    args = (ev["times"], ev["time_ptr"], ev["X"], ev["obs_idx"], 0.5, 1.0,
            np.zeros((1, 1), np.float32))
    b = tgrid.recompute_n_obs(tgrid.batch_from_events(*args, max_steps=4))
    assert b.n_obs_ot[0] == 2
    assert b.obs[0, 0] == 1 and float(b.X[0, 0, 0]) == 1.0
    assert tgrid.validate_batch(b) == []
    _check_events(_native_events(*args, max_steps=4), b)


def test_union_grid_overflow_raises_the_numpy_error():
    for build in (native.build_union_grid, tgrid.build_union_grid):
        with pytest.raises(ValueError, match=r"grid needs 11 steps > "
                                             r"max_steps=3"):
            build([0.013, 0.5], 0.1, 1.0, 3)


@pytest.mark.parametrize("with_M", [False, True])
@pytest.mark.parametrize("offgrid", [False, True])
def test_batch_from_events_native_numpy_and_jax_agree(with_M, offgrid):
    rs = np.random.RandomState(0)
    B, D, steps = 7, 3, 25
    dt = 1.0 / steps
    paths = rs.lognormal(0, 0.3, (B, D, steps + 1))
    observed = (rs.random((B, steps + 1)) < 0.3).astype(np.int64)
    observed[0, steps] = 1
    ev = jgrid.events_from_paths(paths, observed, dt)
    times = ev["times"] + (0.013 if offgrid else 0.0) * (ev["times"] < 0.9)
    M = (rs.randint(0, 2, ev["X"].shape).astype(np.float32)
         if with_M else None)
    args = (times, ev["time_ptr"], ev["X"], ev["obs_idx"], dt, 1.0,
            ev["start_X"])
    kw = dict(M=M, max_steps=steps + 30)
    b_py = tgrid.batch_from_events(*args, **kw)
    _check_events(_native_events(*args, **kw), b_py)
    _equal(b_py, jgrid.batch_from_events(*args, **kw))


@pytest.mark.parametrize("D,funcs", [(2, None), (1, "square")])
def test_batch_from_paths_native_numpy_and_jax_agree(D, funcs):
    rs = np.random.RandomState(3)
    B, steps = 9, 30
    paths = rs.lognormal(0, 0.3, (B, D, steps + 1)).astype(np.float32)
    observed = (rs.random((B, steps + 1)) < 0.25).astype(np.int64)
    fns = None if funcs is None else [lambda x: x ** 2]
    b_py = tgrid.batch_from_paths(paths, observed, 1.0 / steps, fns)
    full = paths if fns is None else np.concatenate(
        [paths] + [f(paths) for f in fns], axis=1)
    nat = native.densify_paths(full.astype(np.float64), observed)
    for name, x in zip(("obs", "X", "M", "n_obs_ot"), nat):
        _same(x, getattr(b_py, name), name)
    _equal(b_py, jgrid.batch_from_paths(paths, observed, 1.0 / steps, fns))


def test_grid_never_builds_the_native_library(tmp_path, monkeypatch):
    """``data/grid.py`` stays on numpy: with a source that cannot build,
    its three collation functions still run and nothing is loaded."""
    bad = tmp_path / "collate.cc"
    bad.write_text("not C++\n")
    monkeypatch.setattr(native, "_SRC", str(bad))
    monkeypatch.setattr(native, "_lib", None)
    b = tgrid.batch_from_paths(np.ones((2, 1, 5)), np.ones((2, 5), np.int64),
                               0.25)
    assert float(b.n_obs_ot.sum()) == 8.0
    tgrid.build_union_grid([0.5], 0.1, 1.0, 20)
    tgrid.batch_from_events([0.5], [0, 1], [[1.0]], [0], 0.1, 1.0,
                            np.zeros((1, 1), np.float32), max_steps=20)
    assert native._lib is None


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "collate.cc"
    bad.write_text('extern "C" { int njode_build_union_grid( }\n')
    monkeypatch.setattr(native, "_SRC", str(bad))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as err:
        native.build_union_grid([0.5], 0.1, 1.0, 20)
    assert "error" in str(err.value)


_BUILD_ONLY = r"""
import sys
from njode_tpu_torch import native
native.get_lib()
_, X, _, _ = native.densify_paths([[[1.0, 2.0, 3.0]]], [[1, 1, 0]])
banned = ("jax", "optax", "njode_tpu", "pandas", "sklearn", "matplotlib")
print(",".join(sorted(m for m in sys.modules if m.split(".")[0] in banned)),
      float(X.sum()))
"""


def test_native_build_imports_no_banned_package():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _BUILD_ONLY], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["2.0"], out.stdout
