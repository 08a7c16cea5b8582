"""PhysioNet-2012 irregular clinical series, the port's copy of
``njode_tpu/data/physionet.py`` (numpy only: no sklearn, no network).

- :func:`parse_record_lines`: one raw record file, times quantized, repeated
  observations of a bin averaged;
- :class:`PhysioNetData`: parses the set-a / set-b tarballs, or loads its
  ``.npz`` cache; it never fetches: with ``download=True`` and no tarball
  it raises and names the missing file;
- :func:`make_synthetic_records`: the schema-true stand-in (41 variables,
  sparse masks, quantized times in [0, 48] h), the JAX module's numpy draws,
  so the same records from a seed;
- :func:`get_data_min_max`, :func:`normalize_masked_data` (the reference
  divides by ``att_max``, not the range; kept);
- :func:`collate_records`: the latent-ODE collate (train, and test with
  the second half of the timeline held out and ``eval_input_prob``);
- :func:`parse_datasets`: set-a + set-b, the 80/20 split of sklearn's
  ``train_test_split(train_size=0.8, random_state=42)`` without sklearn
  (:func:`train_test_split_indices`);
- :func:`compute_masked_likelihood_mse`, :func:`max_batch_events`,
  :func:`max_union_grid_steps`, :func:`prestack_train_records`.

A record is a tuple ``(record_id, tt [T], vals [T, D], mask [T, D],
label)``.
"""

from __future__ import annotations

import math
import os
import tarfile
from typing import List, Optional, Sequence, Tuple

import numpy as np

from njode_tpu_torch.data.grid import build_union_grid
from njode_tpu_torch.utils.paths import makedirs

# where the tarballs come from (physionet.org, challenge-2012 v1.0.0); the
# port reads them from <root>/PhysioNet/raw/ and fetches nothing
URLS = [
    "https://physionet.org/files/challenge-2012/1.0.0/set-a.tar.gz?download",
    "https://physionet.org/files/challenge-2012/1.0.0/set-b.tar.gz?download",
]

# the 41 parameters, the 4 static ones included (physionet_LODE.py:107-117)
PARAMS = [
    "Age", "Gender", "Height", "ICUType",
    "Weight", "Albumin", "ALP", "ALT",
    "AST", "Bilirubin", "BUN",
    "Cholesterol", "Creatinine", "DiasABP", "FiO2", "GCS", "Glucose",
    "HCO3", "HCT", "HR", "K", "Lactate", "Mg",
    "MAP", "MechVent", "Na", "NIDiasABP", "NIMAP", "NISysABP", "PaCO2",
    "PaO2", "pH", "Platelets", "RespRate",
    "SaO2", "SysABP", "Temp", "TroponinI", "TroponinT", "Urine", "WBC",
]
PARAMS_DICT = {k: i for i, k in enumerate(PARAMS)}


def parse_record_lines(record_id: str, lines: Sequence[str],
                       quantization: float = 0.1, reduce: str = "average"):
    """Parse one raw record file into ``(record_id, tt, vals, mask)``:
    times ``HH:MM`` in hours rounded to the quantization bin; repeated
    observations of a parameter in one bin averaged (``reduce='average'``)
    or overwritten; a parameter other than the 41 and 'RecordID' is an
    error."""
    D = len(PARAMS)
    prev_time = 0.0
    tt = [0.0]
    vals = [np.zeros(D)]
    mask = [np.zeros(D)]
    nobs = [np.zeros(D)]
    for line in lines[1:]:
        time_s, param, val = line.strip().split(",")
        hh, mm = time_s.split(":")
        time = float(hh) + float(mm) / 60.0
        time = round(time / quantization) * quantization
        if time != prev_time:
            tt.append(time)
            vals.append(np.zeros(D))
            mask.append(np.zeros(D))
            nobs.append(np.zeros(D))
            prev_time = time
        if param in PARAMS_DICT:
            j = PARAMS_DICT[param]
            n = nobs[-1][j]
            if reduce == "average" and n > 0:
                vals[-1][j] = (vals[-1][j] * n + float(val)) / (n + 1)
            else:
                vals[-1][j] = float(val)
            mask[-1][j] = 1
            nobs[-1][j] += 1
        elif param != "RecordID":
            raise ValueError(f"Read unexpected param {param}")
    return (record_id, np.asarray(tt, np.float64),
            np.stack(vals).astype(np.float32),
            np.stack(mask).astype(np.float32))


class PhysioNetData:
    """One parsed split (set-a for ``train``, else set-b), cached as
    ``<root>/PhysioNet/processed/<split>_<quantization>.npz`` (the JAX
    module's cache format, so either package reads the other's).

    Without the cache: ``download=False`` raises; ``download=True`` parses
    ``<root>/PhysioNet/raw/<split>.tar.gz`` (or its unpacked directory) and
    raises, naming the missing file, when neither is there. ``records`` is
    a list of ``(record_id, tt, vals, mask, label)``."""

    def __init__(self, root: str, train: bool = True,
                 quantization: float = 0.1, download: bool = False,
                 n_samples: Optional[int] = None):
        self.root = root
        self.train = train
        self.quantization = quantization
        split = "set-a" if train else "set-b"
        cache = os.path.join(self.processed_folder,
                             f"{split}_{quantization}.npz")
        if not os.path.exists(cache):
            if not download:
                raise RuntimeError(
                    "Dataset not found. You can use download=True to "
                    "parse the raw tarballs")
            self._process(split, cache)
        self.records = self._load_cache(cache)
        if n_samples is not None:
            self.records = self.records[:n_samples]

    @property
    def raw_folder(self):
        return os.path.join(self.root, "PhysioNet", "raw")

    @property
    def processed_folder(self):
        return os.path.join(self.root, "PhysioNet", "processed")

    def _process(self, split, cache):
        makedirs(self.raw_folder)
        makedirs(self.processed_folder)
        tar_path = os.path.join(self.raw_folder, f"{split}.tar.gz")
        dirname = os.path.join(self.raw_folder, split)
        if not os.path.isdir(dirname):
            if not os.path.exists(tar_path):
                url = [u for u in URLS if split in u][0]
                raise RuntimeError(
                    f"missing {tar_path} (and no directory {dirname}): this "
                    f"package fetches nothing; place {split}.tar.gz from "
                    f"{url.split('?')[0]} there, or use "
                    "make_synthetic_records() for a stand-in")
            with tarfile.open(tar_path, "r:gz") as tar:
                tar.extractall(self.raw_folder)
        outcomes = self._load_outcomes()
        records = []
        for txtfile in sorted(os.listdir(dirname)):
            rid = txtfile.split(".")[0]
            with open(os.path.join(dirname, txtfile)) as f:
                lines = f.readlines()
            rid, tt, vals, mask = parse_record_lines(
                rid, lines, self.quantization)
            records.append((rid, tt, vals, mask, outcomes.get(rid, np.nan)))
        self._save_cache(cache, records)

    def _load_outcomes(self):
        """Mortality label: the last of the 5 outcome columns."""
        path = os.path.join(self.raw_folder, "Outcomes-a.txt")
        if not os.path.exists(path):
            return {}
        out = {}
        with open(path) as f:
            for line in f.readlines()[1:]:
                cells = line.strip().split(",")
                out[cells[0]] = float(cells[-1])
        return out

    @staticmethod
    def _save_cache(cache, records):
        flat = {}
        for i, (rid, tt, vals, mask, label) in enumerate(records):
            flat[f"rid_{i}"] = np.asarray(rid)
            flat[f"tt_{i}"] = tt
            flat[f"vals_{i}"] = vals
            flat[f"mask_{i}"] = mask
            flat[f"label_{i}"] = np.asarray(label, np.float64)
        flat["n"] = np.asarray(len(records))
        np.savez_compressed(cache, **flat)

    @staticmethod
    def _load_cache(cache):
        z = np.load(cache, allow_pickle=False)
        n = int(z["n"])
        return [(str(z[f"rid_{i}"]), z[f"tt_{i}"], z[f"vals_{i}"],
                 z[f"mask_{i}"], float(z[f"label_{i}"])) for i in range(n)]

    def __len__(self):
        return len(self.records)

    def __getitem__(self, i):
        return self.records[i]


def make_synthetic_records(n_records: int, n_vars: int = len(PARAMS),
                           max_hours: float = 48.0,
                           quantization: float = 0.1,
                           obs_perc: float = 0.05, seed: int = 0):
    """Stand-in records with the real dataset's structure: sparse
    per-feature masks, quantized times in [0, 48] hours, an all-zero t=0
    row. Not medical data."""
    rs = np.random.RandomState(seed)
    records = []
    bins = np.arange(0.0, max_hours + 1e-9, quantization)
    for i in range(n_records):
        n_t = rs.randint(5, max(6, int(len(bins) * 0.2)))
        tt = np.sort(rs.choice(bins[1:], n_t - 1, replace=False))
        tt = np.concatenate([[0.0], tt])
        vals = rs.normal(0.0, 1.0, (len(tt), n_vars)).astype(np.float32)
        mask = (rs.random((len(tt), n_vars)) < obs_perc).astype(np.float32)
        mask[0] = 0.0
        vals = vals * mask
        records.append((f"syn{i:06d}", tt.astype(np.float64), vals, mask,
                        float(rs.randint(2))))
    return records


def get_data_min_max(records):
    """Per-feature min/max over the observed entries; a feature never
    observed keeps (+inf, -inf)."""
    D = records[0][2].shape[1]
    data_min = np.full(D, np.inf)
    data_max = np.full(D, -np.inf)
    for _, _, vals, mask, _ in records:
        obs = mask > 0
        for j in range(D):
            v = vals[:, j][obs[:, j]]
            if len(v):
                data_min[j] = min(data_min[j], v.min())
                data_max[j] = max(data_max[j], v.max())
    return data_min.astype(np.float32), data_max.astype(np.float32)


def normalize_masked_data(data, mask, att_min, att_max):
    """``(x - min) / max`` with a zero max read as 1 and masked entries set
    to 0 (the reference divides by ``att_max``, not by the range)."""
    att_max = np.where(att_max == 0.0, 1.0, att_max)
    norm = (data - att_min) / att_max
    if np.isnan(norm).any():
        raise ValueError("nans!")
    return np.where(mask > 0, norm, 0.0).astype(np.float32)


def collate_records(batch, data_min, data_max, data_type: str = "train",
                    eval_input_prob: Optional[float] = None,
                    eval_input_seed: Optional[int] = 3892):
    """The latent-ODE collate (``variable_time_collate_fn1``): the union of
    the batch's times, normalized values, times ``/48``.

    :return: event dict with ``times``, ``time_ptr``, ``X/M [total_obs,
        D]``, ``obs_idx``, ``batch_size``; in test mode also the held-out
        second half of the timeline, ``times_val [L]`` and ``vals_val /
        mask_val [B, L, D]``, and with ``eval_input_prob`` the held-out
        points re-injected as inputs with that probability (the pointer
        advances only at times where one was drawn: the JAX module's fix of
        the reference).
    """
    D = batch[0][2].shape[1]
    B = len(batch)
    all_tt = np.concatenate([ex[1] for ex in batch])
    combined_tt, inverse = np.unique(all_tt, return_inverse=True)
    T_u = len(combined_tt)
    combined_vals = np.zeros((B, T_u, D), np.float32)
    combined_mask = np.zeros((B, T_u, D), np.float32)
    offset = 0
    for b, (_, tt, vals, mask, _) in enumerate(batch):
        idx = inverse[offset:offset + len(tt)]
        offset += len(tt)
        combined_vals[b, idx] = vals
        combined_mask[b, idx] = mask
    times = (combined_tt / 48.0).astype(np.float64)

    if data_type == "train":
        # only the observed rows survive: normalize those [E, D] rows, not
        # the dense [B, T, D] block (the same per-entry formula)
        present = combined_mask.sum(-1) > 0
        t_ind_ev, i_ev = np.nonzero(present.T)          # t-major, i asc
        X = normalize_masked_data(combined_vals[i_ev, t_ind_ev],
                                  combined_mask[i_ev, t_ind_ev],
                                  data_min, data_max)
        M = combined_mask[i_ev, t_ind_ev]
        counts = np.bincount(t_ind_ev, minlength=len(times))
        time_ptr = np.concatenate([[0], np.cumsum(counts)]).astype(np.int64)
        return {"times": np.asarray(times, np.float64), "time_ptr": time_ptr,
                "X": X.reshape(len(X), D), "M": M.reshape(len(M), D),
                "obs_idx": i_ev.astype(np.int64), "batch_size": B,
                "times_val": None, "vals_val": None, "mask_val": None}

    combined_vals = normalize_masked_data(combined_vals, combined_mask,
                                          data_min, data_max)
    times_val = vals_val = mask_val = None
    if data_type == "test":
        n_obs = len(times) // 2
        times_val = times[n_obs:]
        vals_val = combined_vals[:, n_obs:, :]
        mask_val = combined_mask[:, n_obs:, :]
        times = times[:n_obs]
        combined_vals = combined_vals[:, :n_obs, :]
        combined_mask = combined_mask[:, :n_obs, :]

    present = combined_mask.sum(-1) > 0
    t_ind_ev, i_ev = np.nonzero(present.T)
    X = list(combined_vals[i_ev, t_ind_ev])
    M = list(combined_mask[i_ev, t_ind_ev])
    obs_idx = list(i_ev)
    counts = np.bincount(t_ind_ev, minlength=len(times))
    time_ptr = list(np.concatenate([[0], np.cumsum(counts)]).astype(int))
    counter = int(time_ptr[-1])
    out_times = list(times)

    if data_type == "test" and eval_input_prob:
        rs = np.random.RandomState(eval_input_seed)
        for t_ind, t in enumerate(times_val):
            first = True
            for i in range(B):
                if mask_val[i, t_ind].sum() > 0 and \
                        rs.rand() < eval_input_prob:
                    counter += 1
                    X.append(vals_val[i, t_ind])
                    M.append(mask_val[i, t_ind])
                    obs_idx.append(i)
                    if first:
                        out_times.append(t)
                        first = False
            if not first:
                time_ptr.append(counter)

    return {
        "times": np.asarray(out_times, np.float64),
        "time_ptr": np.asarray(time_ptr, np.int64),
        "X": (np.asarray(X, np.float32).reshape(len(X), D)
              if X else np.zeros((0, D), np.float32)),
        "M": (np.asarray(M, np.float32).reshape(len(M), D)
              if M else np.zeros((0, D), np.float32)),
        "obs_idx": np.asarray(obs_idx, np.int64),
        "batch_size": B,
        "times_val": times_val,
        "vals_val": vals_val,
        "mask_val": mask_val,
    }


def train_test_split_indices(n: int, train_size: float = 0.8,
                             random_state: int = 42):
    """The row indices sklearn's ``train_test_split(train_size=train_size,
    random_state=random_state, shuffle=True)`` picks: ``n_train =
    floor(train_size * n)``, the test rows first in one permutation of a
    ``RandomState(random_state)``. Returns ``(train_idx, test_idx)``."""
    n_train = int(math.floor(train_size * n))
    n_test = n - n_train
    perm = np.random.RandomState(random_state).permutation(n)
    return perm[n_test:n_test + n_train], perm[:n_test]


def parse_datasets(root: str, n_samples: int = 8000,
                   quantization: float = 0.016, download: bool = False,
                   records: Optional[List[Tuple]] = None):
    """set-a + set-b, split 80/20 as the reference splits them.

    :param records: a record list (e.g. :func:`make_synthetic_records`)
        used instead of the files.
    :return: dict with train_records, test_records, input_dim, data_min,
        data_max
    """
    if records is None:
        a = PhysioNetData(root, train=True, quantization=quantization,
                          download=download, n_samples=min(10_000, n_samples))
        b = PhysioNetData(root, train=False, quantization=quantization,
                          download=download, n_samples=min(10_000, n_samples))
        records = list(a.records) + list(b.records)
    train_idx, test_idx = train_test_split_indices(len(records))
    data_min, data_max = get_data_min_max(records)
    return {
        "train_records": [records[i] for i in train_idx],
        "test_records": [records[i] for i in test_idx],
        "input_dim": records[0][2].shape[1],
        "data_min": data_min,
        "data_max": data_max,
    }


def compute_masked_likelihood_mse(mu, data, mask):
    """The latent-ODE masked-MSE metric: per (patient, dim) mean squared
    error over that patient's masked points (0 when none), averaged over
    dims, then patients."""
    B, T, D = data.shape
    per = np.zeros((B, D))
    for i in range(B):
        for j in range(D):
            sel = mask[i, :, j] > 0
            if sel.any():
                per[i, j] = np.mean((mu[i, sel, j] - data[i, sel, j]) ** 2)
    return float(per.mean())


def max_batch_events(records, batch_size: int) -> int:
    """Event count that bounds any ``batch_size``-record batch: at most one
    event per (record, record time)."""
    lens = np.sort([len(r[1]) for r in records])[::-1]
    return int(lens[:batch_size].sum())


def max_union_grid_steps(records, delta_t: float, T: float) -> int:
    """Grid length that covers any batch of these records. The times are
    multiples of ``quantization/48`` = ``delta_t`` up to float rounding;
    off-grid times add one fractional step each."""
    times = np.unique(np.concatenate([r[1] for r in records])) / 48.0
    times = times[times <= T + 1e-10]
    frac = times / delta_t
    # +1: a t=0 observation adds a leading dt=0 step; +4: float drift of the
    # step accumulator can insert a rare fractional step on aligned times
    n_grid = int(np.ceil(T / delta_t - 1e-9)) + 1
    if np.all(np.abs(frac - np.round(frac)) <= 1e-6):
        return n_grid + 4
    return n_grid + len(times) + 5


def prestack_train_records(records, data_min, data_max, delta_t, T,
                           max_steps):
    """The training records stacked once for batches built on the device
    (``training/steps.prestacked_batch``): per record the rows with any
    observed coordinate, normalized as :func:`collate_records` normalizes
    them, each mapped to its step on the union grid of ALL record times
    plus t=0.

    After a batch's last observation this grid still lands on the other
    records' later times where a per-batch grid steps plainly to T, so tail
    steps may differ by up to one ``delta_t`` from the collated batch (the
    JAX module documents the same); observation steps and events are
    identical.

    :return: dict with 'times'/'dt' [K] float32, 'k' [N, Emax] int32 (grid
        step per event, K = padding), 'X'/'M' [N, Emax, D] float32, 'n_ev'
        [N]; or None when the record times are off the ``delta_t`` grid
        (the caller collates per batch).
    """
    all_tt = np.unique(np.concatenate([[0.0]]
                                      + [r[1] for r in records])) / 48.0
    frac = all_tt / delta_t
    if not np.all(np.abs(frac - np.round(frac)) <= 1e-6):
        return None
    g_times, g_dts, obs_step = build_union_grid(all_tt, delta_t, T,
                                                max_steps)
    K = len(g_times)
    D = records[0][2].shape[1]
    n_ev = np.array([int((r[3].sum(-1) > 0).sum()) for r in records])
    Emax = int(n_ev.max())
    N = len(records)
    k_all = np.full((N, Emax), K, np.int32)
    X_all = np.zeros((N, Emax, D), np.float32)
    M_all = np.zeros((N, Emax, D), np.float32)
    for i, r in enumerate(records):
        _, tt, vals, mask = r[:4]
        keep = mask.sum(-1) > 0
        tt_n = np.asarray(tt)[keep] / 48.0
        steps = obs_step[np.searchsorted(all_tt, tt_n)]
        e = int(keep.sum())
        k_all[i, :e] = np.where(steps >= 0, steps, K)
        X_all[i, :e] = normalize_masked_data(vals[keep], mask[keep],
                                             data_min, data_max)
        M_all[i, :e] = mask[keep]
    return {"times": g_times.astype(np.float32),
            "dt": g_dts.astype(np.float32), "k": k_all, "X": X_all,
            "M": M_all, "n_ev": n_ev}
