"""Dataset creation, persistence, and loading with an overview registry.

The port's copy of ``njode_tpu/data/datasets.py``, with the same on-disk
format so the two packages read each other's datasets:
``training_data/<name>-<time_id>/data.npy`` (three consecutive
``np.save``s: paths, observed dates, observation counts), ``metadata.txt``
(sorted JSON) and ``dataset_overview.csv`` in pandas' ``to_csv`` layout.
Paths are simulated by the torch samplers (data/sde.py) on the device of
the caller's choice; observation masks come from ``np.random.RandomState``
exactly as in the JAX package, so a seed gives the same masks in both.
"""

from __future__ import annotations

import copy
import json
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from njode_tpu_torch.data import sde
from njode_tpu_torch.utils.csv_frame import read_frame, write_frame
from njode_tpu_torch.utils.paths import makedirs, training_data_path

# canonical dataset hyperparameters (``data_utils.py:25-31``)
hyperparam_default = {
    "drift": 2.0, "volatility": 0.3, "mean": 4,
    "speed": 2.0, "correlation": 0.5, "nb_paths": 10_000, "nb_steps": 100,
    "S0": 1, "maturity": 1.0, "dimension": 1,
    "obs_perc": 0.1,
    "scheme": "euler", "return_vol": False, "v0": 1,
}

_OVERVIEW_COLUMNS = ["name", "id", "description"]


def get_dataset_overview(base_path: Optional[str] = None):
    """Return ``(rows, overview_file)``; rows are ``[name, id, desc]``."""
    base = base_path or training_data_path
    overview_file = os.path.join(base, "dataset_overview.csv")
    makedirs(base)
    if not os.path.exists(overview_file):
        return [], overview_file
    _, rows = read_frame(overview_file)
    return rows, overview_file


def _register(rows, overview_file, name, time_id, desc):
    write_frame(overview_file, _OVERVIEW_COLUMNS,
                list(rows) + [[name, time_id, desc]])


def _persist(path, stock_paths, observed_dates, nb_obs, metadata):
    makedirs(path)
    with open(os.path.join(path, "data.npy"), "wb") as f:
        np.save(f, stock_paths)
        np.save(f, observed_dates)
        np.save(f, nb_obs)
    with open(os.path.join(path, "metadata.txt"), "w") as f:
        json.dump(metadata, f, sort_keys=True)


def create_dataset(stock_model_name: str = "BlackScholes",
                   hyperparam_dict: Optional[dict] = None,
                   seed: int = 0, base_path: Optional[str] = None,
                   device="cuda"):
    """Simulate and persist a synthetic dataset; returns (path, time_id).

    :param device: where the paths are simulated (a ``torch.Generator``
        seeded with ``seed`` lives there)"""
    base = base_path or training_data_path
    rows, overview_file = get_dataset_overview(base)

    hp = copy.deepcopy(hyperparam_dict or hyperparam_default)
    hp["model_name"] = stock_model_name
    obs_perc = hp["obs_perc"]

    model = sde.make_model(stock_model_name, hp)
    gen = torch.Generator(device=device).manual_seed(seed)
    stock_paths, dt = model.generate_paths(gen)
    stock_paths = stock_paths.cpu().numpy().astype(np.float64)
    size = stock_paths.shape
    rs = np.random.RandomState(seed)
    observed_dates = (rs.random((size[0], size[2])) < obs_perc).astype(np.int64)
    nb_obs = observed_dates[:, 1:].sum(axis=1)

    time_id = int(time.time())
    # bump the id instead of aborting when two datasets are created within
    # one second (the JAX package's fix of the reference)
    while os.path.exists(os.path.join(base,
                                      f"{stock_model_name}-{time_id}")):
        time_id += 1
    path = os.path.join(base, f"{stock_model_name}-{time_id}")
    desc = json.dumps(hp, sort_keys=True)
    _register(rows, overview_file, stock_model_name, time_id, desc)
    hp["dt"] = float(dt)
    _persist(path, stock_paths, observed_dates, nb_obs, hp)
    return path, time_id


def create_combined_dataset(
        stock_model_names: Sequence[str] = ("BlackScholes",
                                            "OrnsteinUhlenbeck"),
        hyperparam_dicts: Sequence[dict] = (hyperparam_default,
                                            hyperparam_default),
        seed: int = 0, base_path: Optional[str] = None, device="cuda"):
    """Chain several models in time into one dataset (``sde.Combined``),
    stored as ``combined_<names>-<time_id>`` with the JAX package's
    metadata; returns (path, time_id).

    :param device: where the paths are simulated"""
    base = base_path or training_data_path
    rows, overview_file = get_dataset_overview(base)
    if len(stock_model_names) != len(hyperparam_dicts):
        raise ValueError("one hyperparameter dict per model is needed")
    hyperparam_dicts = [copy.deepcopy(h) for h in hyperparam_dicts]

    filename = "combined_" + "_".join(stock_model_names)
    maturity = sum(h["maturity"] for h in hyperparam_dicts)
    for n, h in zip(stock_model_names, hyperparam_dicts):
        h["model_name"] = n
    obs_perc = hyperparam_dicts[0]["obs_perc"]

    combined = sde.Combined(stock_model_names=list(stock_model_names),
                            hyperparam_dicts=hyperparam_dicts)
    gen = torch.Generator(device=device).manual_seed(seed)
    stock_paths, dt = combined.generate_paths(gen)
    stock_paths = stock_paths.cpu().numpy().astype(np.float64)
    size = stock_paths.shape
    rs = np.random.RandomState(seed)
    observed_dates = (rs.random((size[0], size[2])) < obs_perc).astype(np.int64)
    nb_obs = observed_dates[:, 1:].sum(axis=1)

    time_id = int(time.time())
    while os.path.exists(os.path.join(base, f"{filename}-{time_id}")):
        time_id += 1
    path = os.path.join(base, f"{filename}-{time_id}")
    metadata = {"dt": float(dt), "maturity": maturity,
                "dimension": hyperparam_dicts[0]["dimension"],
                "nb_paths": hyperparam_dicts[0]["nb_paths"],
                "model_name": "combined",
                "stock_model_names": list(stock_model_names),
                "hyperparam_dicts": hyperparam_dicts}
    desc = json.dumps(metadata, sort_keys=True)
    _register(rows, overview_file, filename, time_id, desc)
    _persist(path, stock_paths, observed_dates, nb_obs, metadata)
    return path, time_id


def _get_time_id(stock_model_name: str, time_id=None,
                 base_path: Optional[str] = None):
    """Latest dataset id for a name if ``time_id`` is None."""
    base = base_path or training_data_path
    if time_id is None:
        makedirs(base)
        candidates = [d for d in os.listdir(base)
                      if d.rsplit("-", 1)[0] == stock_model_name
                      and "-" in d]
        times = [int(d.rsplit("-", 1)[1]) for d in candidates]
        time_id = max(times) if times else None
    return time_id


def load_metadata(stock_model_name="BlackScholes", time_id=None,
                  base_path: Optional[str] = None):
    base = base_path or training_data_path
    time_id = _get_time_id(stock_model_name, time_id, base)
    path = os.path.join(base, f"{stock_model_name}-{int(time_id)}")
    with open(os.path.join(path, "metadata.txt"), "r") as f:
        return json.load(f)


def load_dataset(stock_model_name="BlackScholes", time_id=None,
                 base_path: Optional[str] = None):
    base = base_path or training_data_path
    time_id = _get_time_id(stock_model_name, time_id, base)
    path = os.path.join(base, f"{stock_model_name}-{int(time_id)}")
    with open(os.path.join(path, "data.npy"), "rb") as f:
        stock_paths = np.load(f)
        observed_dates = np.load(f)
        nb_obs = np.load(f)
    with open(os.path.join(path, "metadata.txt"), "r") as f:
        metadata = json.load(f)
    return stock_paths, observed_dates, nb_obs, metadata


class PathDataset:
    """Numpy-backed dataset over selected path indices (the reference's
    ``IrregularDataset``)."""

    def __init__(self, model_name=None, time_id=None, idx=None,
                 base_path=None, data=None):
        if data is not None:
            stock_paths, observed_dates, nb_obs, metadata = data
        else:
            stock_paths, observed_dates, nb_obs, metadata = load_dataset(
                model_name, time_id, base_path)
        if idx is None:
            idx = np.arange(len(stock_paths))
        self.metadata = metadata
        self.stock_paths = np.asarray(stock_paths)[idx]
        self.observed_dates = np.asarray(observed_dates)[idx]
        self.nb_obs = np.asarray(nb_obs)[idx]

    def __len__(self):
        return len(self.nb_obs)

    def __getitem__(self, idx):
        return {"idx": idx, "stock_path": self.stock_paths[idx],
                "observed_dates": self.observed_dates[idx],
                "nb_obs": self.nb_obs[idx], "dt": self.metadata["dt"]}

    @property
    def dt(self):
        return self.metadata["dt"]

    def dense_arrays(self, functions=None):
        """Full dataset as float32 arrays ready for on-device batching:
        (paths [N, D(*mult), T+1], observed [N, T+1])."""
        paths = self.stock_paths.astype(np.float32)
        if functions:
            paths = np.concatenate(
                [paths] + [f(paths) for f in functions], axis=1)
        return paths, self.observed_dates.astype(np.float32)


def get_func(name: str):
    """Resolve a ``func_appl_X`` function name: 'exp' or 'power-<x>'."""
    if name in ("exp", "exponential"):
        return np.exp
    if "power-" in name:
        x = float(name.split("-")[1])
        return lambda v: np.power(v, x)
    return None


def resolve_functions(func_names):
    """Return ([callables], mult) for ``func_appl_X``."""
    functions = []
    if func_names:
        for n in func_names:
            f = get_func(n)
            if f is not None:
                functions.append(f)
    return functions, len(functions) + 1
