"""Dense union-time-grid batching (the port's copy of ``njode_tpu/data/grid.py``).

A batch on the dense grid is consumed step by step by the NJODE scan:

- ``dt[k]``      step size of Euler step k (0.0 marks padding steps),
- ``times[k]``   absolute time at the END of step k,
- ``obs[k, b]``  1.0 iff batch row b has an observation (jump) at ``times[k]``,
- ``X[k, b, d]`` observed value (0 where unobserved),
- ``M[k, b, d]`` per-coordinate observation mask.

Grid-aligned synthetic data goes through ``batch_from_paths``; real data
(climate) arrives in the reference's ragged event format and goes through
``build_union_grid`` (the reference's clipped Euler stepping on the host),
``batch_from_events`` or the compact :class:`SparseBatch` that
``densify_sparse`` scatters on the batch's device. Every function is the
numpy branch of the JAX function: the JAX package's C++ collation
(``njode_tpu/native``) is not ported (ROADMAP.md Queue 1 item 9).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


class GridBatch(NamedTuple):
    """A dense batch on the union time grid; time-major ``[K, ...]``. The
    fields hold numpy arrays on the host or tensors on a device
    (:func:`to_torch`)."""

    times: np.ndarray     # [K] float32, absolute time at end of each step
    dt: np.ndarray        # [K] float32, Euler step sizes (0 => padding)
    obs: np.ndarray       # [K, B] float32, observation indicator
    X: np.ndarray         # [K, B, D] float32, observed values
    M: np.ndarray         # [K, B, D] float32, coordinate mask
    start_X: np.ndarray   # [B, D] float32
    n_obs_ot: np.ndarray  # [B] float32, total #observations per row

    @property
    def num_steps(self):
        return self.times.shape[0]

    @property
    def batch_size(self):
        return self.start_X.shape[0]


def to_torch(batch: GridBatch, device="cuda") -> GridBatch:
    """Move every field to ``device`` as a contiguous float32 tensor."""
    return GridBatch(*(torch.as_tensor(np.asarray(a) if not
                                       isinstance(a, torch.Tensor) else a)
                       .to(device=device, dtype=torch.float32)
                       .contiguous() for a in batch))


def batch_from_paths(paths, observed_dates, delta_t: float,
                     functions=None) -> GridBatch:
    """Build a GridBatch from grid-sampled synthetic data.

    Inputs follow the reference dataset layout: ``paths [B, D, T+1]``,
    ``observed_dates [B, T+1]`` 0/1 (column 0 is ignored for jumps;
    ``start_X`` is always ``paths[:,:,0]``).

    :param functions: optional list of callables applied to X and appended as
        extra dims (the ``func_appl_X`` feature).
    """
    paths = np.asarray(paths)
    observed_dates = np.asarray(observed_dates)
    B, D, T1 = paths.shape
    K = T1 - 1
    if functions:
        paths = np.concatenate([paths] + [f(paths) for f in functions], axis=1)

    times = (np.arange(1, K + 1) * delta_t).astype(np.float64)
    dts = np.full(K, delta_t, dtype=np.float64)
    obs = observed_dates[:, 1:].T.astype(np.float32)        # [K, B]
    X = np.transpose(paths[:, :, 1:], (2, 0, 1)).astype(np.float32)
    X = X * obs[:, :, None]
    M = np.broadcast_to(obs[:, :, None], X.shape).astype(np.float32)
    n_obs = obs.sum(axis=0).astype(np.float32)
    start_X = paths[:, :, 0].astype(np.float32)
    return GridBatch(times=times.astype(np.float32),
                     dt=dts.astype(np.float32),
                     obs=obs, X=X, M=M, start_X=start_X, n_obs_ot=n_obs)


def build_union_grid(obs_times, delta_t: float, T: float,
                     max_steps: Optional[int] = None):
    """The reference's Euler stepping on the host in float64: full
    ``delta_t`` steps, a fractional step landing exactly on each
    observation time, then on to T.

    :param obs_times: sorted distinct observation times (the batch union)
    :param max_steps: pad the grid with dt=0 steps at time T to this length
    :return: (times [K], dt [K], obs_step_index [len(obs_times)]):
        ``obs_step_index[i]`` is the step whose end time is
        ``obs_times[i]``, -1 for an observation beyond T. An observation
        at t=0 becomes a leading dt==0 step, so the jump fires before any
        propagation.
    """
    obs_times = np.asarray(obs_times, dtype=np.float64)
    tol = 1e-10 * delta_t
    times, dts = [], []
    obs_idx = np.full(len(obs_times), -1, dtype=np.int64)
    current = 0.0
    for i, ot in enumerate(obs_times):
        if ot > T + 1e-10:
            break
        if ot <= tol:
            if not times:
                times.append(0.0)
                dts.append(0.0)
            obs_idx[i] = 0
            continue
        while current < ot - tol:
            d = delta_t if current < ot - delta_t else ot - current
            current = current + d
            times.append(current)
            dts.append(d)
        obs_idx[i] = len(times) - 1
    while current < T - tol:
        d = delta_t if current < T - delta_t else T - current
        current = current + d
        times.append(current)
        dts.append(d)
    times = np.asarray(times, dtype=np.float64)
    dts = np.asarray(dts, dtype=np.float64)
    if max_steps is not None:
        if len(times) > max_steps:
            raise ValueError(
                f"grid needs {len(times)} steps > max_steps={max_steps}")
        pad = max_steps - len(times)
        times = np.concatenate([times, np.full(pad, T, dtype=np.float64)])
        dts = np.concatenate([dts, np.zeros(pad, dtype=np.float64)])
    return times, dts, obs_idx


def batch_from_events(times, time_ptr, X, obs_idx, delta_t, T, start_X,
                      n_obs_ot=None, M=None,
                      max_steps: Optional[int] = None) -> GridBatch:
    """A GridBatch (numpy) from the reference's ragged event encoding
    ``(times, time_ptr, X, obs_idx[, M])`` densified onto the union grid.
    A later event of the same (step, row) overwrites an earlier one. X
    stays raw: the loss and the masked encoder apply M themselves."""
    times = np.asarray(times, dtype=np.float64)
    time_ptr = np.asarray(time_ptr, dtype=np.int64)
    if len(times) + 1 != len(time_ptr):
        raise ValueError(f"event encoding broken: {len(times)} times vs "
                         f"{len(time_ptr)} pointers")
    X = np.asarray(X, dtype=np.float32)
    obs_idx = np.asarray(obs_idx, dtype=np.int64)
    start_X = np.asarray(start_X, dtype=np.float32)
    B, D = start_X.shape
    g_times, g_dts, obs_step = build_union_grid(times, delta_t, T, max_steps)
    K = len(g_times)
    obs = np.zeros((K, B), dtype=np.float32)
    Xd = np.zeros((K, B, D), dtype=np.float32)
    Md = np.zeros((K, B, D), dtype=np.float32)
    for i in range(len(times)):
        k = obs_step[i]
        if k < 0:
            continue
        s, e = time_ptr[i], time_ptr[i + 1]
        rows = obs_idx[s:e]
        obs[k, rows] = 1.0
        Xd[k, rows] = X[s:e]
        Md[k, rows] = (1.0 if M is None
                       else np.asarray(M[s:e], dtype=np.float32))
    if n_obs_ot is None:
        n_obs = obs.sum(axis=0).astype(np.float32)
    else:
        n_obs = np.asarray(n_obs_ot, dtype=np.float32)
    return GridBatch(times=g_times.astype(np.float32),
                     dt=g_dts.astype(np.float32),
                     obs=obs, X=Xd, M=Md, start_X=start_X, n_obs_ot=n_obs)


class SparseBatch(NamedTuple):
    """A batch's events on the union grid, to be densified on the device
    by :func:`densify_sparse` (the dense [K, B, D] tensors are about 100
    times larger than the events). Padding events carry ``step == K``."""

    times: np.ndarray     # [K] float32
    dt: np.ndarray        # [K] float32
    step: np.ndarray      # [E] int32, grid step per event (K = padding)
    row: np.ndarray       # [E] int32, batch row per event
    X: np.ndarray         # [E, D] float32
    M: np.ndarray         # [E, D] float32
    start_X: np.ndarray   # [B, D] float32


def sparse_from_events(ev, delta_t: float, T: float, max_steps: int,
                       max_events: int, pad_batch_to=None,
                       cov=None) -> SparseBatch:
    """Pack an event dict (times/time_ptr/X/M/obs_idx/batch_size) into a
    :class:`SparseBatch` on the union grid.

    Of several events of one (step, row) only the last is kept, as
    :func:`batch_from_events` keeps it: the earlier ones go to the padding
    step here, on the host, since a scatter with repeated indices has no
    defined order on the device. ``cov``: per-row covariates ``[batch_size,
    C]`` shipped as ``start_X`` (GRU-ODE-Bayes); without them ``start_X``
    is zero, the real-data trainers' convention."""
    times = np.asarray(ev["times"], np.float64)
    time_ptr = np.asarray(ev["time_ptr"], np.int64)
    if len(times) + 1 != len(time_ptr):
        raise ValueError("event encoding broken: len(times) + 1 != "
                         "len(time_ptr)")
    g_times, g_dts, obs_step = build_union_grid(times, delta_t, T, max_steps)
    K = len(g_times)
    E = len(ev["obs_idx"])
    if E > max_events:
        raise ValueError(f"batch has {E} events > max_events={max_events}")
    step = np.repeat(obs_step, np.diff(time_ptr)).astype(np.int64)
    step = np.where(step < 0, K, step)
    rows = np.asarray(ev["obs_idx"], np.int64)
    key = step * (int(rows.max(initial=0)) + 1) + rows
    _, last_rev = np.unique(key[::-1], return_index=True)
    keep = np.zeros(E, bool)
    keep[E - 1 - last_rev] = True
    step = np.where(keep, step, K)
    D = ev["X"].shape[1]
    pad = max_events - E
    B = ev["batch_size"] if pad_batch_to is None else pad_batch_to
    M = (np.asarray(ev["M"], np.float32) if ev.get("M") is not None
         else np.ones_like(ev["X"], np.float32))
    if cov is not None:
        cov = np.asarray(cov, np.float32)
        start_X = np.zeros((B, cov.shape[1]), np.float32)
        start_X[:cov.shape[0]] = cov
    else:
        start_X = np.zeros((B, D), np.float32)
    return SparseBatch(
        times=g_times.astype(np.float32), dt=g_dts.astype(np.float32),
        step=np.concatenate([step, np.full(pad, K)]).astype(np.int32),
        row=np.concatenate([rows, np.zeros(pad)]).astype(np.int32),
        X=np.concatenate([np.asarray(ev["X"], np.float32),
                          np.zeros((pad, D), np.float32)]),
        M=np.concatenate([M, np.zeros((pad, D), np.float32)]),
        start_X=start_X)


def sparse_to_torch(sb: SparseBatch, device="cuda") -> SparseBatch:
    """Move a SparseBatch to ``device`` (indices int64, values float32)."""
    def put(a, dtype):
        return torch.as_tensor(np.asarray(a)).to(device=device, dtype=dtype)

    return SparseBatch(times=put(sb.times, torch.float32),
                       dt=put(sb.dt, torch.float32),
                       step=put(sb.step, torch.int64),
                       row=put(sb.row, torch.int64),
                       X=put(sb.X, torch.float32), M=put(sb.M, torch.float32),
                       start_X=put(sb.start_X, torch.float32))


def scatter_events(step, row, Xe, Me, K: int, B: int):
    """Dense ``(obs [K,B], X [K,B,D], M [K,B,D])`` from events at grid steps
    ``step`` (K = padding) of rows ``row``, on their device. ``obs`` is an
    amax reduce. ``X`` and ``M`` are plain writes: each (step < K, row)
    must hold one event (duplicates retired to step K beforehand), so the
    only repeated indices are in the padding step K, which is dropped."""
    step = step.reshape(-1).long()
    row = row.reshape(-1).long()
    D = Xe.shape[-1]
    dev = Xe.device
    flat = step * B + row
    obs = torch.zeros(((K + 1) * B,), dtype=torch.float32, device=dev)
    obs = obs.scatter_reduce(0, flat, (step < K).to(torch.float32),
                             reduce="amax").view(K + 1, B)
    X = torch.zeros(((K + 1) * B, D), dtype=torch.float32, device=dev)
    M = torch.zeros(((K + 1) * B, D), dtype=torch.float32, device=dev)
    X.index_put_((flat,), Xe.reshape(-1, D).to(torch.float32))
    M.index_put_((flat,), Me.reshape(-1, D).to(torch.float32))
    return (obs[:K].contiguous(), X.view(K + 1, B, D)[:K].contiguous(),
            M.view(K + 1, B, D)[:K].contiguous())


def densify_sparse(sb: SparseBatch, B=None) -> GridBatch:
    """Scatter a SparseBatch of tensors into a dense GridBatch on its
    device; ``n_obs_ot`` is recomputed from the scattered mask."""
    if B is None:
        B = sb.start_X.shape[0]
    K = sb.times.shape[0]
    obs, X, M = scatter_events(sb.step, sb.row, sb.X, sb.M, K, B)
    return GridBatch(times=sb.times, dt=sb.dt, obs=obs, X=X, M=M,
                     start_X=sb.start_X, n_obs_ot=obs.sum(dim=0))


def events_from_paths(paths, observed_dates, delta_t: float):
    """Grid-sampled data in the reference's ragged event format: walk grid
    steps t=1..T, collect the times with >=1 observation, and flatten the
    observations (time-major, then path order) into ``X`` with ``obs_idx``
    and CSR-style ``time_ptr``."""
    paths = np.asarray(paths)
    observed_dates = np.asarray(observed_dates)
    B, D, T1 = paths.shape
    times, time_ptr, X, obs_idx = [], [0], [], []
    current_time, counter = 0.0, 0
    for t in range(1, T1):
        current_time += delta_t
        if observed_dates[:, t].sum() > 0:
            times.append(current_time)
            for i in range(B):
                if observed_dates[i, t] == 1:
                    counter += 1
                    X.append(paths[i, :, t])
                    obs_idx.append(i)
            time_ptr.append(counter)
    return {
        "times": np.array(times),
        "time_ptr": np.array(time_ptr),
        "X": np.array(X, dtype=np.float32).reshape(len(X), D),
        "obs_idx": np.array(obs_idx, dtype=np.int64),
        "start_X": paths[:, :, 0].astype(np.float32),
        "n_obs_ot": observed_dates[:, 1:].sum(axis=1).astype(np.float32),
    }


def nearest_grid_steps(grid_times, eval_times):
    """Index of the nearest entry of ``[0.0] + grid_times`` per eval time
    (the pre-jump extraction convention of the real-data trainers)."""
    pred_t = np.concatenate([[0.0], np.asarray(grid_times, np.float64)])
    ev = np.asarray(eval_times, np.float64)
    return np.abs(pred_t[None, :] - ev[:, None]).argmin(axis=1).astype(
        np.int32)


def validate_batch(batch: GridBatch, strict: bool = True):
    """Data-invariant checks for a GridBatch: monotone live times, padding
    only as a suffix, 0/1 indicators, consistent counts, finite values.

    :returns: list of violation strings (empty when valid); raises
        ``ValueError`` with all of them when ``strict``.
    """
    def host(a):
        return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
            else np.asarray(a)

    problems = []
    t = host(batch.times).astype(np.float64)
    dt = host(batch.dt).astype(np.float64)
    obs = host(batch.obs)
    live = dt > 0
    # a leading dt==0 step at time 0 carries t=0 observations (jump before
    # any propagation) and counts as live for structural purposes
    zero_step = np.zeros_like(live)
    if len(t) and dt[0] == 0 and abs(t[0]) < 1e-12:
        zero_step[0] = True
    if np.any(dt < 0):
        problems.append("negative dt steps")
    if live.any():
        tl = t[live]
        if np.any(np.diff(tl) <= 0):
            problems.append("times not strictly increasing on live steps")
        # padding must be a suffix: no live step after the first dt==0
        body = live | zero_step
        if live[np.argmin(body):].any() and not body.all():
            problems.append("dt==0 padding step before a live step")
    if np.any((obs != 0) & (obs != 1)):
        problems.append("obs indicators not in {0, 1}")
    if np.any(obs[~(live | zero_step)] != 0):
        problems.append("observations on padding steps")
    if not np.allclose(obs.sum(axis=0), host(batch.n_obs_ot)):
        problems.append("n_obs_ot inconsistent with obs mask "
                        "(run recompute_n_obs)")
    M = host(batch.M)
    if np.any((host(batch.X) != 0) & (M == 0) & (obs[:, :, None] == 0)):
        problems.append("nonzero X at fully unobserved entries")
    for name in ("X", "M", "start_X"):
        if not np.isfinite(host(getattr(batch, name))).all():
            problems.append(f"non-finite values in {name}")
    if strict and problems:
        raise ValueError("invalid GridBatch: " + "; ".join(problems))
    return problems


def recompute_n_obs(batch: GridBatch) -> GridBatch:
    """Recompute per-row observation counts from the mask (the reference
    train loop distrusts the dataset's ``n_obs_ot``)."""
    if isinstance(batch.obs, torch.Tensor):
        return batch._replace(n_obs_ot=batch.obs.sum(dim=0))
    return batch._replace(n_obs_ot=batch.obs.sum(axis=0).astype(np.float32))
