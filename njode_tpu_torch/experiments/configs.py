"""Canonical experiment configurations, the port's copy of
``njode_tpu/experiments/configs.py``.

The paper's hyperparameter grids as functions returning (params_list,
suggested_first_id), ready for
:func:`njode_tpu_torch.training.sweeps.parallel_training`; each cites the
reference's block. The grids that need datasets create the missing ones
first, on ``device`` (the card unless the caller asks for the CPU).
Registry rows are lists here (``data/datasets.get_dataset_overview``), not
DataFrames.
"""

from __future__ import annotations

import copy
import json
import os

import numpy as np

from njode_tpu_torch.data import datasets as data_utils
from njode_tpu_torch.parallel import multihost, sharding
from njode_tpu_torch.training.sweeps import get_parameter_array
from njode_tpu_torch.utils import paths as path_cfg

NN50 = ((50, "tanh"), (50, "tanh"))


def _default_path(name):
    """Dedicated default saved-models dir per experiment: colliding ids in
    a shared registry would silently resume the wrong models (the reference
    isolates each study the same way, e.g. parallel_train.py:650)."""
    return os.path.join(path_cfg.data_path, name) + os.sep


def _expand_repeats(params, repeats):
    """Replicate a grid ``repeats`` times with a DISTINCT ``repeat_seed``
    per copy. The reference's ``params_list * 5`` repeats differ through
    its unseeded torch init/DataLoader (``parallel_train.py:338``); our
    trainers are fully seeded, so identical copies would be bit-identical
    and a mean±std over them would measure nothing. ``repeat_seed``
    offsets the init/shuffle/dropout streams (split unchanged); copy 0
    omits the key, staying byte-identical to the single-run grid."""
    out = []
    for r in range(repeats):
        for p in params:
            q = dict(p)
            if r:
                q["repeat_seed"] = r
            out.append(q)
    return out


def base_synthetic(epochs=200):
    """The three headline synthetic runs (BS/Heston/OU), demo-parity
    hyperparams (``parallel_train.py:254-290``)."""
    params = get_parameter_array({
        "epochs": [epochs], "batch_size": [200], "save_every": [5],
        "learning_rate": [0.001], "test_size": [0.2], "seed": [398],
        "hidden_size": [10], "bias": [True], "dropout_rate": [0.1],
        "ode_nn": [NN50], "readout_nn": [NN50], "enc_nn": [NN50],
        "use_rnn": [False], "func_appl_X": [[]], "solver": ["euler"],
        "weight": [0.5], "weight_decay": [1.0],
        "dataset": ["BlackScholes", "Heston", "OrnsteinUhlenbeck"],
        "dataset_id": [None], "plot": [True],
        "paths_to_plot": [(0, 1, 2, 3, 4)]})
    return params, 4


def ensure_base_datasets(nb_paths=20_000, base_path=None, device="cuda"):
    """Create the three synthetic datasets when absent
    (``parallel_train.py:244-251``)."""
    for name in ("BlackScholes", "Heston", "OrnsteinUhlenbeck"):
        if data_utils._get_time_id(name, None, base_path) is None:
            hp = dict(data_utils.hyperparam_default)
            hp["nb_paths"] = nb_paths
            data_utils.create_dataset(name, hp, base_path=base_path,
                                      device=device)


def convergence_study(dataset="Heston", epochs=100, repeats=5,
                      saved_models_path=None):
    """training_size x network_size grid, ``repeats`` identical runs each
    (``parallel_train.py:292-351``)."""
    training_size = [int(100 * 2 ** x) for x in np.linspace(1, 7, 7)]
    network_size = [int(5 * 2 ** x) for x in np.linspace(1, 6, 6)]
    params = []
    for size in network_size:
        nn = ((size, "tanh"), (size, "tanh"))
        grid = {
            "epochs": [epochs], "batch_size": [20], "save_every": [10],
            "learning_rate": [0.001], "test_size": [0.2],
            "training_size": training_size, "seed": [398],
            "hidden_size": [10], "bias": [True], "dropout_rate": [0.1],
            "ode_nn": [nn], "readout_nn": [nn], "enc_nn": [nn],
            "use_rnn": [False], "func_appl_X": [[]], "solver": ["euler"],
            "weight": [0.5], "weight_decay": [1.0], "dataset": [dataset],
            "dataset_id": [None], "plot": [True], "paths_to_plot": [(0,)],
            "evaluate": [True]}
        grid["saved_models_path"] = [
            saved_models_path or _default_path(
                f"conv-study-{dataset}-saved_models")]
        params += get_parameter_array(grid)
    return _expand_repeats(params, repeats), 1


def gru_ode_bayes_comparison(epochs=100, saved_models_path=None):
    """GRU-ODE-Bayes grid (impute/logvar/mixing x hidden 50/100) plus the
    NJODE counterpart (``parallel_train.py:354-424``)."""
    params = get_parameter_array({
        "epochs": [epochs], "batch_size": [20], "save_every": [5],
        "learning_rate": [0.001], "test_size": [0.2], "seed": [398],
        "hidden_size": [50, 100], "bias": [True], "dropout_rate": [0.1],
        "ode_nn": [None], "readout_nn": [None], "enc_nn": [None],
        "use_rnn": [False], "func_appl_X": [[]], "solver": ["euler"],
        "weight": [0.5], "weight_decay": [1.0],
        "dataset": ["BlackScholes", "Heston", "OrnsteinUhlenbeck"],
        "dataset_id": [None], "plot": [True],
        "paths_to_plot": [(0, 1, 2, 3, 4)], "evaluate": [True],
        "other_model": ["GRU_ODE_Bayes"],
        "GRU_ODE_Bayes-impute": [True, False],
        "GRU_ODE_Bayes-logvar": [True, False],
        "GRU_ODE_Bayes-mixing": [0.0001, 0.5],
        "saved_models_path": [saved_models_path or _default_path(
            "saved_models_gob_comparison")]})
    params += get_parameter_array({
        "epochs": [epochs], "batch_size": [20], "save_every": [5],
        "learning_rate": [0.001], "test_size": [0.2], "seed": [398],
        "hidden_size": [10], "bias": [True], "dropout_rate": [0.1],
        "ode_nn": [NN50], "readout_nn": [NN50], "enc_nn": [NN50],
        "use_rnn": [False], "func_appl_X": [[]], "solver": ["euler"],
        "weight": [0.5], "weight_decay": [1.0],
        "dataset": ["BlackScholes", "Heston", "OrnsteinUhlenbeck"],
        "dataset_id": [None], "plot": [True],
        "paths_to_plot": [(0, 1, 2, 3, 4)], "evaluate": [True],
        "saved_models_path": [saved_models_path or _default_path(
            "saved_models_gob_comparison")]})
    return params, 1


def climate_cross_validation(epochs=200):
    """5-fold climate CV at two network sizes + the GRU-ODE-Bayes reference
    configuration (``parallel_train.py:428-515``)."""
    params = []
    for size, hidden in ((50, 10), (400, 50)):
        nn = ((size, "tanh"), (size, "tanh"))
        params += get_parameter_array({
            "epochs": [epochs], "batch_size": [100], "save_every": [1],
            "learning_rate": [0.001], "hidden_size": [hidden],
            "bias": [True], "dropout_rate": [0.1],
            "ode_nn": [nn], "readout_nn": [nn], "enc_nn": [nn],
            "use_rnn": [False], "solver": ["euler"], "weight": [0.5],
            "weight_decay": [1.0], "dataset": ["climate"],
            "data_index": [0, 1, 2, 3, 4], "delta_t": [0.1]})
    params += get_parameter_array({
        "epochs": [50], "batch_size": [100], "save_every": [1],
        "learning_rate": [0.001], "hidden_size": [50], "bias": [True],
        "dropout_rate": [0.2], "ode_nn": [None], "readout_nn": [None],
        "enc_nn": [None], "use_rnn": [False], "solver": ["euler"],
        "weight": [0.5], "weight_decay": [1.0], "dataset": ["climate"],
        "data_index": [1], "delta_t": [0.1],
        "other_model": ["GRU_ODE_Bayes"],
        "GRU_ODE_Bayes-impute": [False], "GRU_ODE_Bayes-logvar": [True],
        "GRU_ODE_Bayes-mixing": [1e-4], "GRU_ODE_Bayes-p_hidden": [25],
        "GRU_ODE_Bayes-prep_hidden": [10],
        "GRU_ODE_Bayes-cov_hidden": [50]})
    return params, 101


def heston_wo_feller(epochs=200, base_path=None, device="cuda"):
    """Heston-without-Feller incl. the 2-dim return_vol variant
    (``parallel_train.py:519-581``): datasets first, then one run per
    HestonWOFeller dataset id."""
    hp = {"drift": 2.0, "volatility": 3.0, "mean": 1.0, "speed": 2.0,
          "correlation": 0.5, "nb_paths": 20_000, "nb_steps": 100,
          "S0": 1, "maturity": 1.0, "dimension": 1, "obs_perc": 0.1,
          "scheme": "euler", "return_vol": False, "v0": 0.5}
    hp2 = dict(hp)
    hp2["return_vol"] = True
    hp2["dimension"] = 2
    # per-variant existence (a one-shot gate would never repair a partially
    # created pair): match the registered descriptions
    rows0, _ = data_utils.get_dataset_overview(base_path)
    have = {bool(json.loads(desc).get("return_vol"))
            for name, _, desc in rows0 if name == "HestonWOFeller"}
    if False not in have:
        data_utils.create_dataset("HestonWOFeller", hp, base_path=base_path,
                                  device=device)
    if True not in have:
        data_utils.create_dataset("HestonWOFeller", hp2, base_path=base_path,
                                  device=device)
    rows, _ = data_utils.get_dataset_overview(base_path)
    data_ids = [int(did) for name, did, _ in rows
                if "HestonWOFeller" in name]
    params = []
    for did in data_ids:
        params += get_parameter_array({
            "epochs": [epochs], "batch_size": [100], "save_every": [5],
            "learning_rate": [0.001], "test_size": [0.2], "seed": [398],
            "hidden_size": [10], "bias": [True], "dropout_rate": [0.1],
            "ode_nn": [NN50], "readout_nn": [NN50], "enc_nn": [NN50],
            "use_rnn": [False], "func_appl_X": [[]], "solver": ["euler"],
            "weight": [0.5], "weight_decay": [1.0],
            "dataset": ["HestonWOFeller"], "dataset_id": [did],
            "plot": [True], "paths_to_plot": [(0, 1, 2, 3, 4)],
            "evaluate": [True]})
    return params, 401


def combined_regime(epochs=200, base_path=None, device="cuda"):
    """Regime-switching OU->BS dataset + run (``parallel_train.py:584-641``)."""
    names = ["OrnsteinUhlenbeck", "BlackScholes"]
    dat_name = "combined_" + "_".join(names)
    if data_utils._get_time_id(dat_name, None, base_path) is None:
        hp = copy.deepcopy(data_utils.hyperparam_default)
        hp.update(nb_paths=20_000, nb_steps=50, maturity=0.5, mean=10)
        data_utils.create_combined_dataset(
            stock_model_names=names, hyperparam_dicts=[hp] * len(names),
            base_path=base_path, device=device)
    nn = ((100, "tanh"), (100, "tanh"))
    params = get_parameter_array({
        "epochs": [epochs], "batch_size": [100], "save_every": [20],
        "learning_rate": [0.001], "test_size": [0.2], "seed": [398],
        "hidden_size": [10], "bias": [True], "dropout_rate": [0.1],
        "ode_nn": [nn], "readout_nn": [nn], "enc_nn": [nn],
        "use_rnn": [False], "func_appl_X": [[]], "solver": ["euler"],
        "weight": [0.5], "weight_decay": [1.0], "dataset": [dat_name],
        "plot": [True], "paths_to_plot": [(0, 1, 2, 3, 4)],
        "evaluate": [True]})
    return params, 501


def physionet_comparison(epochs=175, repeats=5, saved_models_path=None):
    """PhysioNet mean/std study: network sizes 50/200, ``repeats`` runs each
    (``parallel_train.py:645-683``)."""
    params = []
    for size in (50, 200):
        nn = ((size, "tanh"), (size, "tanh"))
        grid = {
            "epochs": [epochs], "batch_size": [50], "save_every": [1],
            "learning_rate": [0.001], "hidden_size": [41], "bias": [True],
            "dropout_rate": [0.1], "ode_nn": [nn], "readout_nn": [nn],
            "enc_nn": [nn], "use_rnn": [False], "solver": ["euler"],
            "weight": [0.5], "weight_decay": [1.0],
            "dataset": ["physionet"], "quantization": [0.016],
            "n_samples": [8000],
            "saved_models_path": [saved_models_path or _default_path(
                "saved_models_physionet_comparison")]}
        params += get_parameter_array(grid)
    return _expand_repeats(params, repeats), 1


def sine_models(epochs=100, base_path=None, saved_models_path=None,
                device="cuda"):
    """Explicitly time-dependent sine models, sine_coeff in {2pi, 4pi}
    (``parallel_train.py:686-748``)."""
    name = "sine_BlackScholes"
    rows0, _ = data_utils.get_dataset_overview(base_path)
    have = {round(json.loads(desc).get("sine_coeff") or 0, 6)
            for dname, _, desc in rows0 if dname == name}
    for sc in (2 * np.pi, 4 * np.pi):
        if round(sc, 6) not in have:
            hd = copy.deepcopy(data_utils.hyperparam_default)
            hd["sine_coeff"] = sc
            hd["nb_paths"] = 20_000
            data_utils.create_dataset(name, hd, base_path=base_path,
                                      device=device)
    rows, _ = data_utils.get_dataset_overview(base_path)
    pairs = [(dname, int(did)) for dname, did, _ in rows
             if "sine_" in str(dname)]
    nn = ((400, "tanh"), (400, "tanh"))
    params = []
    for dat_name, dat_id in pairs:
        grid = {
            "epochs": [epochs], "batch_size": [100], "save_every": [10],
            "learning_rate": [0.001], "test_size": [0.2], "seed": [398],
            "hidden_size": [10], "bias": [True], "dropout_rate": [0.1],
            "ode_nn": [nn], "readout_nn": [nn], "enc_nn": [nn],
            "use_rnn": [False], "func_appl_X": [[]], "solver": ["euler"],
            "weight": [0.5], "weight_decay": [1.0], "dataset": [dat_name],
            "dataset_id": [dat_id], "plot": [True],
            "paths_to_plot": [(0, 1, 2, 3, 4)], "evaluate": [True],
            "saved_models_path": [saved_models_path or _default_path(
                "saved_models_sine")]}
        params += get_parameter_array(grid)
    return params, 1


EXPERIMENTS = {
    "base_synthetic": base_synthetic,
    "convergence_study": convergence_study,
    "gru_ode_bayes_comparison": gru_ode_bayes_comparison,
    "climate_cross_validation": climate_cross_validation,
    "heston_wo_feller": heston_wo_feller,
    "combined_regime": combined_regime,
    "physionet_comparison": physionet_comparison,
    "sine_models": sine_models,
}


def run_experiment(name: str, nb_jobs: int = 1, vmap_groups: bool = False,
                   **kwargs):
    """Expand and run a named canonical experiment via the sweep runner
    (``kwargs`` go to the grid function, e.g. ``device`` and ``base_path``
    for those that create datasets): one run after another on the card, or
    with ``vmap_groups=True`` its repeats and folds as grouped ensembles
    (``sweeps.parallel_training``), with a ``group_mesh`` split over its
    ranks (rank 0 creates the grid's datasets before the others read
    them)."""
    from njode_tpu_torch.training.sweeps import parallel_training
    group_mesh = sharding.check_mesh(kwargs.pop("group_mesh", None))
    coordinator = multihost.is_coordinator(group_mesh)
    if coordinator:
        params, first_id = EXPERIMENTS[name](**kwargs)
    multihost.barrier("run_experiment", group_mesh)
    if not coordinator:
        params, first_id = EXPERIMENTS[name](**kwargs)
    return parallel_training(params=params, nb_jobs=nb_jobs,
                             first_id=first_id, vmap_groups=vmap_groups,
                             group_mesh=group_mesh)
