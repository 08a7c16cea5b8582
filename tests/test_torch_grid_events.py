"""The port's event-format grid functions (njode_tpu_torch/data/grid.py)
against ``njode_tpu.data.grid``: the union grid, the dense and sparse
event batches, the on-device densification, the event encoding of grid
paths and the nearest-step lookup. Off-grid times, a t=0 observation,
events beyond T, duplicate events and ``max_steps`` padding; compared
exactly."""

import numpy as np
import pytest

import conftest  # noqa: F401

import jax.numpy as jnp
import torch

from njode_tpu.data import grid as jgrid
from njode_tpu_torch.data import grid as tgrid


def _events(seed=0, B=6, D=3, n_times=9, T=2.0, t0=True, beyond=True,
            dups=True):
    """An event dict with off-grid times (optionally one at t=0 and one
    beyond T) and, optionally, a row observed twice at one time."""
    rs = np.random.RandomState(seed)
    times = np.sort(rs.uniform(0.01, T, n_times))
    if t0:
        times = np.concatenate([[0.0], times])
    if beyond:
        times = np.concatenate([times, [T + 0.5]])
    rows, ptr = [], [0]
    for _ in times:
        r = rs.choice(B, size=rs.randint(1, 4), replace=False)
        if dups and len(rows) == 2:
            r = np.concatenate([r, r[:1]])        # a duplicate event
        rows.append(r)
        ptr.append(ptr[-1] + len(r))
    obs_idx = np.concatenate(rows).astype(np.int64)
    E = len(obs_idx)
    X = rs.normal(size=(E, D)).astype(np.float32)
    M = (rs.random((E, D)) < 0.7).astype(np.float32)
    return {"times": times, "time_ptr": np.asarray(ptr, np.int64), "X": X,
            "M": M, "obs_idx": obs_idx, "batch_size": B,
            "cov": rs.normal(size=(B, 2)).astype(np.float32)}


@pytest.mark.parametrize("max_steps", [None, 40])
@pytest.mark.parametrize("kw", [dict(), dict(t0=False, beyond=False)],
                         ids=["t0_beyond", "plain"])
def test_build_union_grid(kw, max_steps):
    ev = _events(**kw)
    for dt in (0.1, 0.25):
        ref = jgrid.build_union_grid(ev["times"], dt, 2.0, max_steps)
        got = tgrid.build_union_grid(ev["times"], dt, 2.0, max_steps)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, np.asarray(b))
    if max_steps is not None:
        with pytest.raises(ValueError, match="max_steps"):
            tgrid.build_union_grid(ev["times"], 0.01, 2.0, max_steps)


@pytest.mark.parametrize("use_m", [True, False])
def test_batch_from_events(use_m):
    ev = _events(seed=1)
    args = (ev["times"], ev["time_ptr"], ev["X"], ev["obs_idx"], 0.1, 2.0,
            np.zeros((6, 3), np.float32))
    kw = dict(M=ev["M"] if use_m else None, max_steps=40)
    ref = jgrid.batch_from_events(*args, **kw)
    got = tgrid.batch_from_events(*args, **kw)
    for name, a, b in zip(ref._fields, got, ref):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)


@pytest.mark.parametrize("cov", [False, True])
def test_sparse_from_events_and_densify(cov):
    """The SparseBatch (duplicates retired on the host) and its dense
    scatter on the device equal the JAX ones, and the dense scatter equals
    the host-side dense bridge."""
    ev = _events(seed=2)
    kw = dict(max_events=len(ev["obs_idx"]) + 5, pad_batch_to=8,
              cov=ev["cov"] if cov else None)
    ref = jgrid.sparse_from_events(ev, 0.1, 2.0, 40, **kw)
    got = tgrid.sparse_from_events(ev, 0.1, 2.0, 40, **kw)
    for name, a, b in zip(ref._fields, got, ref):
        np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)
    dref = jgrid.densify_sparse(jnp_tree(ref))
    dgot = tgrid.densify_sparse(tgrid.sparse_to_torch(got, "cpu"))
    for name, a, b in zip(dref._fields, dgot, dref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)
    dense = tgrid.batch_from_events(
        ev["times"], ev["time_ptr"], ev["X"], ev["obs_idx"], 0.1, 2.0,
        np.zeros((6, 3), np.float32), M=ev["M"], max_steps=40)
    for name in ("obs", "X", "M"):
        np.testing.assert_array_equal(
            getattr(dgot, name).numpy()[:, :6], getattr(dense, name),
            err_msg=name)
    with pytest.raises(ValueError, match="max_events"):
        tgrid.sparse_from_events(ev, 0.1, 2.0, 40, max_events=3)


def jnp_tree(sb):
    return type(sb)(*(jnp.asarray(a) for a in sb))


def test_events_from_paths_and_nearest_steps():
    rs = np.random.RandomState(3)
    paths = rs.normal(size=(5, 2, 11))
    observed = (rs.random((5, 11)) < 0.4).astype(np.int64)
    ref = jgrid.events_from_paths(paths, observed, 0.1)
    got = tgrid.events_from_paths(paths, observed, 0.1)
    assert set(ref) == set(got)
    for k in ref:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    g_times = np.arange(1, 21) * 0.1
    ev_t = rs.uniform(0, 2.1, 30)
    np.testing.assert_array_equal(tgrid.nearest_grid_steps(g_times, ev_t),
                                  jgrid.nearest_grid_steps(g_times, ev_t))


def test_scatter_events_keeps_padding_out():
    """Padding events (step K) never reach the grid; ``obs`` is 1 exactly
    where a live event landed."""
    step = torch.tensor([0, 2, 3, 3, 3])
    row = torch.tensor([1, 0, 1, 1, 0])
    Xe = torch.arange(10, dtype=torch.float32).view(5, 2)
    obs, X, M = tgrid.scatter_events(step, row, Xe, torch.ones(5, 2), 3, 2)
    assert obs.tolist() == [[0, 1], [0, 0], [1, 0]]
    assert X[2, 0].tolist() == [2.0, 3.0] and float(X.abs().sum()) == 6.0
    assert float(M.sum()) == 4.0
