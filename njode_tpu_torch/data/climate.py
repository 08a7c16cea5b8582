"""Climate (USHCN) sporadic time series, the port's copy of
``njode_tpu/data/climate.py`` without pandas.

- :class:`ClimateDataset` reads a long-format sporadic CSV with columns
  ``ID, Time, Value_*, Mask_*`` (the schema of the reference's
  ``small_chunked_sporadic.csv``), optional per-series covariate and label
  files, applies the validation filters and collates batches in the
  reference's event format;
- :func:`make_synthetic_climate_csv` writes the schema-true stand-in at the
  published scale (the real file is not in the repository), with the same
  random draws as the JAX function, so both packages read the same numbers;
- :func:`make_fold_indices` writes the 5-fold index files;
- :func:`prestack_series` builds a split's device-ready event bank once.

The pandas semantics kept: series ids keep the order of first appearance
when they are remapped, rows sort by time with numpy's quicksort as
``DataFrame.sort_values`` does, held-out rows are cut per series after the
sort by time, times stay float64 while values are cast to float32.

A table handed to :func:`seq_collate` and :func:`add_jitter`, or returned
by :func:`preprocess_ushcn_daily`, is a *frame*: a dict of column name to
a 1-D numpy array, in column order (what the JAX module takes as a pandas
``DataFrame``); :func:`read_frame` reads one from a CSV.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from njode_tpu_torch.data import grid
from njode_tpu_torch.utils.paths import makedirs


def read_table(path):
    """``(columns, values [rows, columns] float64)`` of a numeric CSV with
    a header line."""
    with open(path) as f:
        columns = f.readline().strip().split(",")
    values = np.loadtxt(path, delimiter=",", skiprows=1, dtype=np.float64,
                        ndmin=2)
    if values.size == 0:
        values = np.zeros((0, len(columns)), np.float64)
    return columns, values


def unique_in_order(a):
    """Distinct values of ``a`` in the order of first appearance (pandas'
    ``Series.unique``)."""
    a = np.asarray(a)
    _, first = np.unique(a, return_index=True)
    return a[np.sort(first)]


def _rows_by_key(keys, ids):
    """``{id: positions of keys == id}`` (ascending positions)."""
    order = np.argsort(keys, kind="stable")
    sk = keys[order]
    out = {}
    for i in ids:
        lo, hi = np.searchsorted(sk, i, "left"), np.searchsorted(sk, i,
                                                                  "right")
        out[int(i)] = order[lo:hi]
    return out


class ClimateDataset:
    """Long-format sporadic dataset (the reference's ``ODE_Dataset``).

    ``validation=True`` keeps only series with >=1 observation at or
    before ``T_val`` and after it (or from ``T_val_from``), truncates the
    inputs at ``T_val`` and holds out at most ``max_val_samples`` rows per
    series (or the one nearest ``T_closest``). ``idx`` filters series and
    remaps their ids to ``0..n-1`` in order of first appearance.
    ``cov_file`` (``ID, <covariates...>``) and ``label_file`` (``ID,
    label``) give per-series covariates and labels; without them a single
    zero covariate and zero labels stand in. ``collate`` emits them as
    ``cov [B, cov_dim]`` and ``y [B]``.
    """

    def __init__(self, csv_file, idx=None, t_mult: float = 1.0,
                 validation: bool = False, val_options: Optional[dict] = None,
                 cov_file=None, label_file=None):
        cols, data = read_table(csv_file)
        if cols[0] != "ID":
            raise ValueError("the first column must be ID")
        ids = data[:, 0]
        time = data[:, cols.index("Time")]
        if label_file is not None:
            lcols, ldata = read_table(label_file)
            if lcols[:2] != ["ID", "label"]:
                raise ValueError("label file columns must be ID, label")
            lab_ids, lab = ldata[:, 0], ldata[:, 1]
        else:
            lab_ids = unique_in_order(ids)
            lab = np.zeros(len(lab_ids))
        if cov_file is not None:
            ccols, cdata = read_table(cov_file)
            if ccols[0] != "ID":
                raise ValueError("the first column of the covariates must "
                                 "be ID")
            cov_ids, cov = cdata[:, 0], cdata[:, 1:]
        else:
            cov_ids = unique_in_order(ids)
            cov = np.zeros((len(cov_ids), 1))

        if validation:
            if val_options is None:
                raise ValueError("Validation set options should be fed")
            t_val = val_options["T_val"]
            before = np.unique(ids[time <= t_val])
            if val_options.get("T_val_from"):
                after = np.unique(ids[time >= val_options["T_val_from"]])
            else:
                after = np.unique(ids[time > t_val])
            valid = np.intersect1d(before, after)
            keep = np.isin(ids, valid)
            data, ids, time = data[keep], ids[keep], time[keep]
            ck, lk = np.isin(cov_ids, valid), np.isin(lab_ids, valid)
            cov_ids, cov = cov_ids[ck], cov[ck]
            lab_ids, lab = lab_ids[lk], lab[lk]

        if idx is not None:
            keep = np.isin(ids, idx)
            data, ids, time = data[keep], ids[keep], time[keep]
            order = unique_in_order(ids)
            mapping = {float(v): float(i) for i, v in enumerate(order)}

            def remap(a):
                return np.array([mapping.get(float(v), np.nan) for v in a])

            ck, lk = np.isin(cov_ids, idx), np.isin(lab_ids, idx)
            ids = remap(ids)
            cov_ids, cov = remap(cov_ids[ck]), cov[ck]
            lab_ids, lab = remap(lab_ids[lk]), lab[lk]
        if len(cov_ids) != len(np.unique(ids)):
            raise ValueError("covariates must have one row per series")

        self.value_cols = [c for c in cols if c.startswith("Value")]
        self.mask_cols = [c for c in cols if c.startswith("Mask")]
        self.variable_num = len(self.value_cols)
        vals = data[:, [cols.index(c) for c in self.value_cols]].astype(
            np.float32)
        masks = data[:, [cols.index(c) for c in self.mask_cols]].astype(
            np.float32)
        # times stay float64: float32 times beyond ~100 drift off the 0.1
        # grid by more than 1e-6
        time = time.astype(np.float64) * t_mult
        ids = ids.astype(np.float32).astype(np.int64)

        self.validation = validation
        if validation:
            t_val = val_options["T_val"]
            if val_options.get("T_val_from"):
                after = time >= val_options["T_val_from"]
            else:
                after = time > t_val
            a_pos = np.nonzero(after)[0]
            a_pos = a_pos[np.argsort(time[a_pos], kind="quicksort")]
            a_ids = ids[a_pos]
            if val_options.get("T_closest") is not None:
                # one held-out row per series: the nearest to T_closest,
                # ties broken on Value_0, then on time
                tc = val_options["T_closest"]
                dist = np.abs(time[a_pos] - tc)
                v0 = vals[a_pos, 0]
                o = np.lexsort((np.arange(len(a_pos)), v0, dist))
                _, first = np.unique(a_ids[o], return_index=True)
                a_pos = a_pos[o[first]]
            else:
                n_max = val_options["max_val_samples"]
                rank = np.zeros(len(a_pos), np.int64)
                seen = {}
                for j, i in enumerate(a_ids):
                    rank[j] = seen.get(int(i), 0)
                    seen[int(i)] = rank[j] + 1
                a_pos = a_pos[rank < n_max]
            # held-out rows in (ID, Time) order
            a_pos = a_pos[np.lexsort((time[a_pos], ids[a_pos]))]
            self._a_times = time[a_pos]
            self._a_vals = vals[a_pos]
            self._a_masks = masks[a_pos]
            a_ids = ids[a_pos]
            b = time <= t_val
            time, vals, masks, ids = time[b], vals[b], masks[b], ids[b]

        order = np.argsort(time, kind="quicksort")
        self._times = time[order]
        self._vals = vals[order]
        self._masks = masks[order]
        self._ids_col = ids[order]
        self.ids = np.unique(self._ids_col)
        self.length = len(self.ids)

        # per-series covariates / labels in ``self.ids`` order
        self.cov_dim = cov.shape[1]
        pos = {int(v): i for i, v in enumerate(cov_ids)}
        self._cov_by_pos = np.stack(
            [cov[pos[int(i)]] for i in self.ids]).astype(np.float32) \
            if self.length else np.zeros((0, self.cov_dim), np.float32)
        lpos = {int(v): i for i, v in enumerate(lab_ids)}
        self._label_by_pos = np.asarray([lab[lpos[int(i)]] for i in self.ids])

        self._rows_by_id = _rows_by_key(self._ids_col, self.ids)
        if validation:
            self._a_rows_by_id = _rows_by_key(a_ids, self.ids)

    def __len__(self):
        return self.length

    def max_batch_events(self, batch_size: int) -> int:
        """Event-count bound for any ``batch_size``-series batch: the sum
        of the ``batch_size`` largest per-series row counts."""
        per_series = np.sort([len(r) for r in
                              self._rows_by_id.values()])[::-1]
        return int(per_series[:batch_size].sum())

    def collate(self, batch_ids):
        """Event-format batch of the series at positions ``batch_ids`` of
        ``self.ids`` (the reference's ``custom_collate_fn``).

        :return: dict with ``times [L]``, ``time_ptr [L+1]``, ``X/M
            [total_obs, D]``, ``obs_idx [total_obs]`` (positions within the
            batch), ``batch_size``, ``cov``, ``y`` and, for validation sets,
            the held-out ``X_val/M_val/times_val/index_val``.
        """
        batch_ids = np.asarray(batch_ids)
        sel_ids = self.ids[batch_ids]
        rows = [self._rows_by_id[int(i)] for i in sel_ids]
        pos = np.concatenate([np.full(len(r), k, np.int64)
                              for k, r in enumerate(rows)])
        rows = np.concatenate(rows)
        order = np.argsort(self._times[rows], kind="stable")
        rows, pos = rows[order], pos[order]
        times, counts = np.unique(self._times[rows], return_counts=True)
        res = {
            "times": times,
            "time_ptr": np.concatenate([[0], np.cumsum(counts)]).astype(
                np.int64),
            "X": self._vals[rows],
            "M": self._masks[rows],
            "obs_idx": pos,
            "batch_size": len(batch_ids),
            "cov": self._cov_by_pos[batch_ids],
            "y": self._label_by_pos[batch_ids],
        }
        if self.validation:
            a_rows = [self._a_rows_by_id[int(i)] for i in sel_ids]
            a_pos = np.concatenate([np.full(len(r), k, np.int64)
                                    for k, r in enumerate(a_rows)])
            a_rows = np.concatenate(a_rows)
            res["X_val"] = self._a_vals[a_rows]
            res["M_val"] = self._a_masks[a_rows]
            res["times_val"] = self._a_times[a_rows]
            res["index_val"] = a_pos
        return res

    def max_grid_steps(self, delta_t: float, T: float) -> int:
        """Scan length that holds any batch of this split: the plain Euler
        grid (+4 slack for float drift of the step accumulator) when every
        time lies on the ``delta_t`` grid, else ``floor(T/dt) +
        n_distinct_times + 1``."""
        times = np.unique(self._times)
        times = times[times <= T + 1e-10]
        frac = times / delta_t
        n_grid = int(np.ceil(T / delta_t - 1e-9))
        if np.all(np.abs(frac - np.round(frac)) <= 1e-6):
            return n_grid + 4
        return n_grid + len(times) + 1


def dense_batch_from_events(ev, delta_t: float, T: float, max_steps: int,
                            pad_batch_to: Optional[int] = None):
    """An event-format batch as a numpy :class:`grid.GridBatch` with
    ``start_X = 0`` and ``n_obs_ot`` recomputed from the observations.
    Rows padded up to ``pad_batch_to`` have no observations; the caller
    rescales the loss by ``padded_B / real_B``."""
    b = grid.batch_from_events(
        ev["times"], ev["time_ptr"], ev["X"], ev["obs_idx"], delta_t, T,
        start_X=np.zeros((ev["batch_size"], ev["X"].shape[1]), np.float32),
        M=ev["M"], max_steps=max_steps)
    b = grid.recompute_n_obs(b)
    if pad_batch_to is not None and pad_batch_to > b.batch_size:
        pad = pad_batch_to - b.batch_size
        b = b._replace(
            obs=np.pad(b.obs, ((0, 0), (0, pad))),
            X=np.pad(b.X, ((0, 0), (0, pad), (0, 0))),
            M=np.pad(b.M, ((0, 0), (0, pad), (0, 0))),
            start_X=np.pad(b.start_X, ((0, pad), (0, 0))),
            n_obs_ot=np.pad(b.n_obs_ot, (0, pad)))
    return b


def extract_at_times(pred_t, pred_path, eval_times, eval_idx):
    """Pre-jump predictions at held-out times: for each (eval_time, row)
    the prediction at the nearest grid time.

    :param pred_t: [K+1] grid times incl. t=0
    :param pred_path: [K+1, B, D] pre-jump predictions
    :return: [L, D]
    """
    pred_t = np.asarray(pred_t)
    pred_path = np.asarray(pred_path)
    eval_times = np.asarray(eval_times)
    k = np.abs(pred_t[None, :] - eval_times[:, None]).argmin(axis=1)
    return pred_path[k, np.asarray(eval_idx)]


def masked_mse_parts(pred_at_val, X_val, M_val):
    """(masked squared error summed over held-out points, mask count): the
    numerator and denominator of the climate eval metric."""
    se = float((((X_val - pred_at_val) ** 2) * M_val).sum())
    return se, float(M_val.sum())


def make_synthetic_climate_csv(path: str, n_series: int = 1114,
                               n_vars: int = 5, T: float = 200.0,
                               obs_perc: float = 0.02, seed: int = 0):
    """Write a synthetic sporadic CSV with the schema and scale of the
    reference's ``small_chunked_sporadic.csv``: one row per (ID, Time)
    with >=1 observed variable, times on the 0.1 grid in (0, T], values
    from OU paths. A stand-in for tests and smoke runs, not climate data.

    The random draws are the JAX function's, in its order (per series: the
    Gaussian increments, then the mask uniforms), so both write the same
    numbers; floats are written at full precision (``repr``).
    :return: (columns, rows [n_rows, columns] float64)
    """
    rs = np.random.RandomState(seed)
    grid_times = np.round(np.arange(0.1, T + 1e-9, 0.1), 1)
    n_t = len(grid_times)
    z = np.empty((n_series, n_t, n_vars))
    mask = np.empty((n_series, n_t, n_vars), bool)
    for sid in range(n_series):
        # RandomState's Gaussian stream continues across calls, so one
        # draw of n_t rows equals the n_t draws of one row each
        z[sid] = rs.normal(0, 1, (n_t, n_vars))
        mask[sid] = rs.random((n_t, n_vars)) < obs_perc
    x = np.empty_like(z)
    x[:, 0] = z[:, 0]
    for k in range(1, n_t):
        x[:, k] = x[:, k - 1] - 0.05 * x[:, k - 1] + 0.3 * z[:, k]
    cols = (["ID", "Time"] + [f"Value_{i}" for i in range(n_vars)]
            + [f"Mask_{i}" for i in range(n_vars)])
    sid, k = np.nonzero(mask.any(axis=2))
    vals = np.where(mask[sid, k], x[sid, k], 0.0)
    rows = np.concatenate([sid[:, None].astype(np.float64),
                           grid_times[k][:, None], vals,
                           mask[sid, k].astype(np.float64)], axis=1)
    makedirs(os.path.dirname(path) or ".")
    with open(path, "w") as f:
        f.write(",".join(cols) + "\n")
        for r in rows:
            f.write(",".join([str(int(r[0]))] + [repr(float(v))
                                                  for v in r[1:]]) + "\n")
    return cols, rows


def make_fold_indices(out_dir: str, n_series: int, n_folds: int = 5,
                      val_frac: float = 0.18, test_frac: float = 0.1,
                      seed: int = 0):
    """Write ``small_chunk_fold_idx_<i>/{train,val,test}_idx.npy`` fold
    files in the reference layout."""
    rs = np.random.RandomState(seed)
    for i in range(n_folds):
        perm = rs.permutation(n_series)
        n_test = int(round(test_frac * n_series))
        n_val = int(round(val_frac * n_series))
        d = os.path.join(out_dir, f"small_chunk_fold_idx_{i}")
        makedirs(d)
        np.save(os.path.join(d, "test_idx.npy"), np.sort(perm[:n_test]))
        np.save(os.path.join(d, "val_idx.npy"),
                np.sort(perm[n_test:n_test + n_val]))
        np.save(os.path.join(d, "train_idx.npy"),
                np.sort(perm[n_test + n_val:]))


def prestack_series(ds: ClimateDataset, delta_t: float, T: float,
                    max_steps: int):
    """The events of a (non-validation) split stacked once per series,
    each mapped to its step on the union grid of the split's observed
    times, so batches build on the device (``training/steps.
    prestacked_batch``) with no host collation.

    With grid-aligned times this grid is every batch's union grid, so the
    batches equal the collated ones; off-grid times return ``None`` (the
    caller collates per batch). If any series observes at t=0, the grid
    gains a leading dt==0 step that the per-batch grids of batches without
    a t=0 observation lack: dynamics identical, dropout streams shifted by
    one step (as in the JAX package).

    :return: dict with 'times'/'dt' [K] float32, 'k' [N, Emax] int32 (K =
        padding), 'X'/'M' [N, Emax, D] float32, 'n_ev' [N], 'cov' [N, C]
        in ``ds.ids`` order, or None when off-grid.
    """
    if ds.validation:
        raise ValueError("prestack applies to training splits")
    all_tt = np.unique(ds._times)
    frac = all_tt / delta_t
    if not np.all(np.abs(frac - np.round(frac)) <= 1e-6):
        return None
    g_times, g_dts, obs_step = grid.build_union_grid(all_tt, delta_t, T,
                                                     max_steps)
    K = len(g_times)
    D = ds.variable_num
    rows_by_pos = [ds._rows_by_id[int(i)] for i in ds.ids]
    n_ev = np.array([len(r) for r in rows_by_pos])
    Emax = int(n_ev.max())
    N = len(ds.ids)
    k_all = np.full((N, Emax), K, np.int32)
    X_all = np.zeros((N, Emax, D), np.float32)
    M_all = np.zeros((N, Emax, D), np.float32)
    for i, rows in enumerate(rows_by_pos):
        steps = obs_step[np.searchsorted(all_tt, ds._times[rows])]
        e = len(rows)
        k_all[i, :e] = np.where(steps >= 0, steps, K)
        X_all[i, :e] = ds._vals[rows]
        M_all[i, :e] = ds._masks[rows]
    return {"times": g_times.astype(np.float32),
            "dt": g_dts.astype(np.float32), "k": k_all, "X": X_all,
            "M": M_all, "n_ev": n_ev, "cov": ds._cov_by_pos.copy()}


# ---------------------------------------------------------------------------
# frames, the sequential collate and the reference's misc helpers
# ---------------------------------------------------------------------------

def read_frame(path):
    """A numeric CSV as a frame (columns in file order, float64)."""
    columns, values = read_table(path)
    return {c: values[:, j].copy() for j, c in enumerate(columns)}


def _frame_rows(frame, keep):
    return {c: np.asarray(v)[keep] for c, v in frame.items()}


def seq_collate(frame, n_vars: int):
    """Padded-sequence collate of the sequential-update model
    (``seq_collate_fn``): rows sorted by (Time, -number of observed
    features, ID), stably; per row the observed values and feature ids in
    ascending feature order, padded to the batch's longest row.

    :return: dict of numpy arrays: 'times' [T] (distinct, float64),
        'time_ptr' [T+1], 'Xpadded'/'Fpadded' [n, l_max], 'X'/'M' [n, D]
        float32 (values times mask), 'lengths' [n], 'obs_idx' [n]
    """
    t = np.asarray(frame["Time"], np.float64)
    ids = np.asarray(frame["ID"]).astype(np.int64)
    vals = np.stack([np.asarray(frame[f"Value_{j}"])
                     for j in range(n_vars)], axis=1)
    mask = np.stack([np.asarray(frame[f"Mask_{j}"])
                     for j in range(n_vars)], axis=1)
    observed = mask > 0
    lengths = observed.sum(axis=1).astype(np.int64)
    order = np.lexsort((ids, -lengths, t))
    t, ids, vals, mask, observed, lengths = (
        a[order] for a in (t, ids, vals, mask, observed, lengths))
    times, counts = np.unique(t, return_counts=True)
    time_ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
    n = len(t)
    l_max = int(lengths.max()) if n else 1
    # observed features first, each group in ascending feature order
    feat = np.argsort(~observed, axis=1, kind="stable")[:, :l_max]
    real = np.arange(l_max)[None, :] < lengths[:, None]
    Fp = np.where(real, feat, 0).astype(np.int64)
    Xp = np.where(real, np.take_along_axis(vals, feat, axis=1),
                  0).astype(np.float32)
    return {"times": times, "time_ptr": time_ptr, "Xpadded": Xp,
            "Fpadded": Fp, "X": (vals * mask).astype(np.float32),
            "M": mask.astype(np.float32), "lengths": lengths,
            "obs_idx": ids}


def add_jitter(frame, jitter_time: float = 1e-3, seed=None):
    """Split the rows where both of 2 variables are observed into one row
    per variable, moving one of the two ``jitter_time`` earlier (chosen by
    ``RandomState(seed).randint(2)`` a row); times clip at 0. Rows come
    out as the unsplit rows, then the variable-1 halves, then the
    variable-2 halves (the reference's concat order).

    :param frame: 6 columns: ID, Time, Value_1, Value_2, Mask_1, Mask_2
    """
    if len(frame) != 6:
        raise ValueError(
            "Only df with 6 columns: supports 2 value and 2 mask columns.")
    rs = np.random.RandomState(seed)
    m1, m2 = np.asarray(frame["Mask_1"]), np.asarray(frame["Mask_2"])
    both = (m1 == 1.0) & (m2 == 1.0)
    single = _frame_rows(frame, ~both)
    b1, b2 = _frame_rows(frame, both), _frame_rows(frame, both)
    b1["Mask_2"] = np.zeros_like(b1["Mask_2"])
    b2["Mask_1"] = np.zeros_like(b2["Mask_1"])
    jitter = rs.randint(2, size=int(both.sum()))
    b1["Time"] = b1["Time"] - jitter_time * jitter
    b2["Time"] = b2["Time"] - jitter_time * (1 - jitter)
    out = {c: np.concatenate([single[c], b1[c], b2[c]]) for c in frame}
    out["Time"] = np.maximum(out["Time"], 0.0)
    return out


def map_to_closest(values, reference):
    """Per element, the closest entry of ``reference`` (the first on a
    tie)."""
    values = np.asarray(values)
    reference = np.asarray(reference)
    idx = np.abs(reference[None, :] - values[:, None]).argmin(axis=1)
    return reference[idx]


def adjust_learning_rate(epoch: int, init_lr: float) -> float:
    """The reference's schedule, lr/3 after epoch 20 (returned, not set on
    an optimizer)."""
    return init_lr / 3.0 if epoch > 20 else init_lr


def compute_corr(X_true, X_hat, mask):
    """Masked per-feature Pearson correlation (float64)."""
    X_true = np.asarray(X_true, np.float64)
    X_hat = np.asarray(X_hat, np.float64)
    mask = np.asarray(mask, np.float64)
    means_true = X_true.sum(0) / mask.sum(0)
    means_hat = X_hat.sum(0) / mask.sum(0)
    num = ((X_true - means_true) * (X_hat - means_hat) * mask).sum(0)
    d1 = np.sqrt((((X_true - means_true) ** 2) * mask).sum(0))
    d2 = np.sqrt((((X_hat - means_hat) ** 2) * mask).sum(0))
    return num / (d1 * d2)


def sort_array_on_other(x1, x2):
    """The permutation ``perm`` with ``x2[perm] == x1``."""
    index = {v: i for i, v in enumerate(x1)}
    perm = np.argsort([index[v] for v in x2])
    if not (np.asarray(x2)[perm] == np.asarray(x1)).all():
        raise ValueError("x2 is not a permutation of x1")
    return perm


def log_lik_gaussian(x, mu, logvar):
    """Gaussian negative log-likelihood per element."""
    x, mu, logvar = map(np.asarray, (x, mu, logvar))
    return (np.log(np.sqrt(2 * np.pi)) + logvar / 2
            + (x - mu) ** 2 / (2 * np.exp(logvar)))


def tail_fun_gaussian(x, mu, logvar):
    """P(N(mu, exp(logvar)) > x), in float64."""
    import torch

    x, mu, logvar = map(np.asarray, (x, mu, logvar))
    z = (x - mu) / (np.exp(0.5 * logvar) * np.sqrt(2))
    erf = torch.special.erf(torch.as_tensor(z, dtype=torch.float64))
    return 0.5 - 0.5 * erf.numpy()


def _dense_ids(*keys):
    """Group numbers of the rows' keys in sorted key order (pandas'
    ``groupby(keys).ngroup()``)."""
    _, inv = np.unique(np.stack(keys, axis=1), axis=0, return_inverse=True)
    return inv.reshape(-1).astype(np.int64)


def preprocess_ushcn_daily(raw_csv: str, out_csv: str,
                           chunk_days: int = 200, t_scale: float = 1.0,
                           min_obs_per_chunk: int = 10):
    """Write ``small_chunked_sporadic.csv`` from raw USHCN daily data (the
    GRU-ODE-Bayes preprocessing recipe): each variable is centred and
    scaled over its observed entries (sample standard deviation, ddof 1)
    and zeroed elsewhere; the timeline is cut into ``chunk_days``-day
    chunks, each (station, chunk) a new series numbered in sorted
    (station, chunk) order; series with fewer than ``min_obs_per_chunk``
    rows are dropped and the rest renumbered from 0; rows sort by (ID,
    Time), stably.

    :param raw_csv: the long-format raw file, columns ``ID, day,
        Value_*, Mask_*``; it is never fetched (FileNotFoundError when
        absent)
    :return: the written frame
    """
    if not os.path.exists(raw_csv):
        raise FileNotFoundError(
            f"raw USHCN file {raw_csv} not found; download it with the "
            "GRU-ODE-Bayes preprocessing scripts, or use "
            "make_synthetic_climate_csv as a stand-in")
    df = read_frame(raw_csv)
    value_cols = [c for c in df if c.startswith("Value")]
    mask_cols = [c for c in df if c.startswith("Mask")]
    for v, m in zip(value_cols, mask_cols):
        obs = df[m] > 0
        x = df[v][obs]
        mu, sd = x.mean(), x.std(ddof=1)
        df[v] = np.where(obs, (df[v] - mu) / (sd + 1e-12), 0.0)
    day = df["day"].astype(np.int64)
    chunk = day // chunk_days
    time = (day % chunk_days).astype(np.float64) * t_scale
    sid = _dense_ids(df["ID"].astype(np.int64), chunk)
    counts = np.bincount(sid)[sid]
    keep = counts >= min_obs_per_chunk
    sid = _dense_ids(sid[keep])
    time = time[keep]
    order = np.lexsort((time, sid))
    out = {"ID": sid[order], "Time": time[order]}
    for c in value_cols + mask_cols:
        out[c] = df[c][keep][order]
    makedirs(os.path.dirname(out_csv) or ".")
    integral = {c for c in mask_cols if np.all(out[c] == np.round(out[c]))}
    with open(out_csv, "w") as f:
        f.write(",".join(out) + "\n")
        for i in range(len(sid)):
            cells = [str(int(out["ID"][i]))]
            for c in list(out)[1:]:
                v = out[c][i]
                cells.append(str(int(v)) if c in integral
                             else repr(float(v)))
            f.write(",".join(cells) + "\n")
    return out
