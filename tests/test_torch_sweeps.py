"""The port's sweep runner and experiment grids against the JAX package's:
the parameter grids of all eight published experiments, id assignment,
resume and failure isolation in ``parallel_training``, and the registry
each package reads from the other."""

import json
import os

import pytest

import conftest  # noqa: F401

from njode_tpu.data import datasets as jdatasets
from njode_tpu.experiments import configs as jconfigs
from njode_tpu.training import registry as jregistry
from njode_tpu.training import sweeps as jsweeps
from njode_tpu_torch.data import datasets as tdatasets
from njode_tpu_torch.experiments import configs as tconfigs
from njode_tpu_torch.training import sweeps as tsweeps
from njode_tpu_torch.utils.csv_frame import read_frame

SMALL_HP = dict(drift=2.0, volatility=0.3, mean=4, speed=2.0,
                correlation=0.5, nb_paths=40, nb_steps=20, S0=1,
                maturity=1.0, dimension=1, obs_perc=0.15,
                scheme="euler", return_vol=False, v0=1)
NN = ((10, "tanh"),)


@pytest.fixture(scope="module")
def tiny_dataset(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("training_data_sweep"))
    tdatasets.create_dataset("BlackScholes", SMALL_HP, seed=1,
                             base_path=base, device="cpu")
    return base


def _shrunk(monkeypatch, du):
    """Let the grids of ``du``'s package create their datasets at 40 paths
    of 5 steps (the published 20,000 paths take long on the CPU)."""
    create, combined = du.create_dataset, du.create_combined_dataset

    def small(hp):
        return dict(hp, nb_paths=40, nb_steps=5)

    monkeypatch.setattr(du, "create_dataset", lambda name, hp, **kw: create(
        name, small(hp), **kw))
    monkeypatch.setattr(du, "create_combined_dataset",
                        lambda stock_model_names, hyperparam_dicts, **kw:
                        combined(stock_model_names,
                                 [small(h) for h in hyperparam_dicts], **kw))


def _ranked_ids(params):
    """Dataset ids are creation times: replace each by its rank."""
    ids = sorted({p["dataset_id"] for p in params
                  if p.get("dataset_id") is not None})
    return [dict(p, dataset_id=ids.index(p["dataset_id"]))
            if p.get("dataset_id") is not None else p for p in params]


def test_get_parameter_array_is_sklearns_grid():
    from sklearn.model_selection import ParameterGrid

    for grid in ({"lr": [0.1, 0.01], "h": [5, 10, 20], "a": [None]}, {},
                 {"z": [1], "b": [(1, 2), (3,)], "m": ["x", "y"]}):
        assert tsweeps.get_parameter_array(grid) == list(ParameterGrid(grid))


@pytest.mark.parametrize("name", sorted(jconfigs.EXPERIMENTS))
def test_grids_match_jax(name, tmp_path, monkeypatch):
    """Every published grid, in order, equal to the JAX package's (whose
    grids expand with sklearn's ParameterGrid); the grids that create
    datasets create the same ones (dataset ids compared by order)."""
    assert set(tconfigs.EXPERIMENTS) == set(jconfigs.EXPERIMENTS)
    kw_j, kw_t = {}, {}
    if name in ("heston_wo_feller", "combined_regime", "sine_models"):
        _shrunk(monkeypatch, jdatasets)
        _shrunk(monkeypatch, tdatasets)
        kw_j = dict(base_path=str(tmp_path / "j"))
        kw_t = dict(base_path=str(tmp_path / "t"), device="cpu")
    jp, jfirst = jconfigs.EXPERIMENTS[name](**kw_j)
    tp, tfirst = tconfigs.EXPERIMENTS[name](**kw_t)
    assert tfirst == jfirst and len(tp) == len(jp) > 0
    assert _ranked_ids(tp) == _ranked_ids(jp)
    if kw_t:
        jrows = jdatasets.get_dataset_overview(kw_j["base_path"])[0]
        trows = tdatasets.get_dataset_overview(kw_t["base_path"])[0]
        assert list(jrows["name"]) == [r[0] for r in trows]
        # a second call finds its datasets and creates none
        again, _ = tconfigs.EXPERIMENTS[name](**kw_t)
        assert again == tp
        assert len(tdatasets.get_dataset_overview(
            kw_t["base_path"])[0]) == len(trows)


def test_train_switcher_dispatch_errors():
    with pytest.raises(KeyError):
        tsweeps.train_switcher(epochs=1)
    with pytest.raises(ValueError):
        tsweeps.train_switcher(dataset="nope")


def _base_param(smp, base, **kw):
    return dict(epochs=1, batch_size=20, save_every=1, learning_rate=0.01,
                test_size=0.2, seed=398, hidden_size=10, dropout_rate=0.0,
                ode_nn=NN, readout_nn=NN, enc_nn=NN, dataset="BlackScholes",
                plot=False, saved_models_path=smp, base_data_path=base,
                device="cpu", **kw)


def test_parallel_training_and_resume(tiny_dataset, tmp_path):
    """``tests/test_sweeps.py::test_parallel_training_and_resume`` on the
    port: ids 1 and 2, resume by model_ids with overwrite_params, resume
    by first_id; the registry reads back in the JAX package with the same
    ids and descriptions."""
    smp = str(tmp_path / "sweep_models")
    base_param = _base_param(smp, tiny_dataset)
    grid = tsweeps.get_parameter_array(
        {**{k: [v] for k, v in base_param.items()},
         "learning_rate": [0.01, 0.005]})
    assert len(grid) == 2

    assert tsweeps.parallel_training(params=grid, nb_jobs=1) == [0, 0]
    df = jregistry.load_overview(smp)
    assert df["id"].values.tolist() == [1, 2]
    want = [json.dumps(p, sort_keys=True, default=str)
            for p in tsweeps.get_parameter_array(
                {**{k: [v] for k, v in base_param.items()},
                 "learning_rate": [0.01, 0.005]})]
    assert df["description"].values.tolist() == want
    for mid in (1, 2):
        assert os.path.exists(os.path.join(smp, f"id-{mid}",
                                           f"metric_id-{mid}.csv"))

    # resume both ids, extending epochs via overwrite_params
    assert tsweeps.parallel_training(
        model_ids=[1, 2, 7], saved_models_path=smp,
        overwrite_params={"epochs": 2}) == [0, 0]
    df = jregistry.load_overview(smp)
    for mid in (1, 2):
        desc = json.loads(df["description"].loc[df["id"] == mid].values[0])
        assert desc["epochs"] == 2
        _, rows = read_frame(os.path.join(smp, f"id-{mid}",
                                          f"metric_id-{mid}.csv"))
        assert [int(r[0]) for r in rows] == [1, 2]

    # re-running the same sweep with first_id resumes (no new ids); a new
    # entry past them gets the next id
    extra = dict(grid[0], learning_rate=0.002)
    assert tsweeps.parallel_training(params=list(grid) + [extra],
                                     first_id=1) == [0, 0, 0]
    df = jregistry.load_overview(smp)
    assert df["id"].values.tolist() == [1, 2, 3]
    assert json.loads(df["description"].values[2])["learning_rate"] == 0.002
    # the JAX sweep resumes from the port's registry the same way
    assert jsweeps.parallel_training(model_ids=[9], saved_models_path=smp) \
        == []


def test_parallel_training_isolates_per_run_failures(tiny_dataset,
                                                     tmp_path):
    """``tests/test_sweeps.py::test_parallel_training_isolates_per_run_
    failures`` on the port: the failing run's result is its exception, the
    others train, also when joblib runs them (``nb_jobs > 1``); under
    DEBUG the exception propagates."""
    smp = str(tmp_path / "iso_models")
    good = _base_param(smp, tiny_dataset)
    bad = dict(good, dataset="NoSuchDataset")
    results = tsweeps.parallel_training(params=[dict(good), bad, dict(good)],
                                        nb_jobs=1)
    assert results is not None and len(results) == 3
    assert results[0] == 0 and results[2] == 0
    assert isinstance(results[1], ValueError)
    for mid in (1, 3):
        assert os.path.exists(os.path.join(smp, f"id-{mid}"))
    import joblib
    with joblib.parallel_backend("threading"):
        results = tsweeps.parallel_training(
            params=[dict(good)], nb_jobs=2, first_id=1,
            overwrite_params={"dataset": "nope"})
    assert len(results) == 1 and isinstance(results[0], ValueError)
    tsweeps.DEBUG = True
    try:
        with pytest.raises(ValueError, match="nope"):
            tsweeps.parallel_training(params=[dict(good)], first_id=1)
    finally:
        tsweeps.DEBUG = False


def test_parallel_training_joblib_and_live_keys(tmp_path, monkeypatch):
    """``nb_jobs > 1`` fans out through joblib (its threading backend
    here); a PhysioNet run's 'records' reaches the trainer but stays out
    of the registry description."""
    import joblib

    from njode_tpu_torch.data import physionet

    smp = str(tmp_path / "models")
    recs = physionet.make_synthetic_records(20, n_vars=4, quantization=2.0,
                                            obs_perc=0.4)
    phys = dict(epochs=1, batch_size=8, quantization=2.0, n_samples=20,
                hidden_size=4, ode_nn=NN, readout_nn=NN, enc_nn=NN,
                dataset="physionet", records=recs, device="cpu",
                saved_models_path=smp)
    with joblib.parallel_backend("threading"):
        assert tsweeps.parallel_training(
            params=[dict(phys), dict(phys, seed=3)], nb_jobs=2) == [0, 0]
    _, rows = read_frame(os.path.join(smp, "model_overview.csv"))
    for _, desc in rows:
        desc = json.loads(desc)
        assert "records" not in desc and desc["dataset"] == "physionet"
    for mid in (1, 2):
        assert os.path.exists(os.path.join(smp, f"id-{mid}",
                                           f"metric_id-{mid}.csv"))


def test_grouping_raises_naming_roadmap(tmp_path):
    """The groups' mesh (``group_mesh``) is ported (its runs:
    tests/test_torch_parallel_trainers.py); an object that is not a
    ``parallel.sharding.Mesh`` is refused, with or without
    ``vmap_groups``, before anything is created."""
    for kw in (dict(group_mesh=object()),
               dict(vmap_groups=True, group_mesh=object())):
        with pytest.raises(ValueError, match="1-D .*Mesh"):
            tsweeps.parallel_training(params=[{"dataset": "BlackScholes"}],
                                      saved_models_path=str(tmp_path), **kw)
        with pytest.raises(ValueError, match="1-D .*Mesh"):
            tconfigs.run_experiment("heston_wo_feller", **kw)
    # nothing was created before the raise
    assert not os.listdir(tmp_path)


def test_run_experiment_drives_the_grid(tmp_path, monkeypatch):
    """``run_experiment`` expands a grid and hands it to the sweep with the
    grid's first id."""
    seen = {}

    def fake(params, nb_jobs, first_id, vmap_groups, group_mesh):
        seen.update(n=len(params), nb_jobs=nb_jobs, first_id=first_id)
        return [0] * len(params)

    monkeypatch.setattr(tsweeps, "parallel_training", fake)
    assert tconfigs.run_experiment("climate_cross_validation",
                                   nb_jobs=3, epochs=2) == [0] * 11
    assert seen == dict(n=11, nb_jobs=3, first_id=101)
