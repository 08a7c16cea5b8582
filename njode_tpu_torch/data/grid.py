"""Dense union-time-grid batching (the port's copy of ``njode_tpu/data/grid.py``).

A batch on the dense grid is consumed step by step by the NJODE scan:

- ``dt[k]``      step size of Euler step k (0.0 marks padding steps),
- ``times[k]``   absolute time at the END of step k,
- ``obs[k, b]``  1.0 iff batch row b has an observation (jump) at ``times[k]``,
- ``X[k, b, d]`` observed value (0 where unobserved),
- ``M[k, b, d]`` per-coordinate observation mask.

This slice covers grid-aligned synthetic data: ``batch_from_paths`` (the
numpy branch of the JAX function; the JAX package's C++ collation stays on
its side), ``validate_batch`` and ``recompute_n_obs``. The union-grid and
event-format builders for real data come with the real-data slice
(ROADMAP Queue 1 item 4).
"""

from __future__ import annotations

from typing import NamedTuple

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
