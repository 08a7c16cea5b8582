"""The port's analysis layer (``analysis/extras.py``, no pandas) against
the JAX package's on the same saved-models tree: the training overview
and the cross-validation tables, returned and written (read back with
pandas, equal values; floats rtol 1e-12 where numpy's and pandas' means
may sum in another order), the warnings of runs without a column; the
figures on the CPU and their one-line skip without matplotlib."""

import json
import os
import sys

import numpy as np
import pandas as pd
import pytest

import conftest  # noqa: F401

from njode_tpu.analysis import extras as jextras
from njode_tpu_torch.analysis import extras as textras
from njode_tpu_torch.data import datasets as tdatasets
from njode_tpu_torch.training import trainer as ttrainer


def _registry(tmp_path, seed=0):
    """Runs with varied descriptions (flat, nested options, relu, missing
    keys) and metric files (NaNs, an all-NaN column, a missing column)."""
    rs = np.random.RandomState(seed)
    smp = str(tmp_path / "smp")
    descs = []
    for i in range(1, 8):
        width = [50, 200, 400][i % 3]
        act = ["tanh", "relu"][i % 2]
        d = {"enc_nn": [[width, act], [width, act]],
             "hidden_size": [10, 50][i % 2],
             "dropout_rate": [0.1, 0.2][i % 2], "dataset": "climate"}
        if i % 3 == 0:
            d = {"enc_nn": d["enc_nn"],
                 "options": {k: v for k, v in d.items() if k != "enc_nn"}}
        descs.append([i, json.dumps(d)])
        os.makedirs(os.path.join(smp, f"id-{i}"))
        n = 5
        data = {"epoch": np.arange(1, n + 1),
                "train_loss": rs.random(n), "eval_loss": rs.random(n),
                "eval_metric": rs.random(n)}
        if i != 5:
            data["test_metric"] = rs.random(n)
            data["evaluation_mean_diff"] = rs.random(n)
        if i == 2:
            data["eval_metric"][1] = np.nan
        if i == 7:
            data["eval_metric"][:] = np.nan
        pd.DataFrame(data).to_csv(os.path.join(smp, f"id-{i}",
                                               f"metric_id-{i}.csv"))
    pd.DataFrame(descs, columns=["id", "description"]).to_csv(
        os.path.join(smp, "model_overview.csv"))
    return smp


def _same_csv(a, b):
    da, db = pd.read_csv(a, index_col=0), pd.read_csv(b, index_col=0)
    assert list(da.columns) == list(db.columns)
    for c in da.columns:
        x, y = da[c].to_numpy(), db[c].to_numpy()
        if x.dtype.kind == "f" or y.dtype.kind == "f":
            np.testing.assert_allclose(x.astype(float), y.astype(float),
                                       rtol=1e-12, err_msg=c)
        else:
            np.testing.assert_array_equal(x, y, err_msg=c)


@pytest.mark.parametrize("kw", [
    dict(), dict(early_stop_after_epoch=2), dict(ids_from=2, ids_to=5),
    dict(params_extract_desc=("network_size", "activation_function_2",
                              "dropout_rate", "nope"))],
    ids=["default", "early_stop", "ids", "params"])
def test_training_overview_matches_jax(tmp_path, kw):
    smp = _registry(tmp_path)
    ja, to = str(tmp_path / "jax.csv"), str(tmp_path / "torch.csv")
    with pytest.warns(UserWarning) as jw:
        ref = jextras.get_training_overview(path=smp, save_file=ja, **kw)
    with pytest.warns(UserWarning) as tw:
        cols, rows = textras.get_training_overview(path=smp, save_file=to,
                                                   **kw)
    assert sorted(str(w.message) for w in tw) == \
        sorted(str(w.message) for w in jw)
    assert cols == list(ref.columns)
    assert [r["id"] for r in rows] == list(ref["id"])
    for r, (_, j) in zip(rows, ref.iterrows()):
        for c in cols:
            if j[c] is None or (isinstance(j[c], float) and np.isnan(j[c])):
                assert r[c] is None or np.isnan(r[c]), c
            else:
                assert r[c] == pytest.approx(j[c], rel=1e-12) \
                    if isinstance(r[c], float) else r[c] == j[c], c
    _same_csv(to, ja)


def test_cross_validation_matches_jax(tmp_path):
    smp = _registry(tmp_path, seed=3)
    combos = ({"network_size": 50, "activation_function_1": "relu"},
              {"network_size": 200}, {"hidden_size": 10,
                                      "dataset": "climate"},
              {"network_size": 999})
    ja, to = str(tmp_path / "cv_jax.csv"), str(tmp_path / "cv_torch.csv")
    with pytest.warns(UserWarning):
        jextras.get_cross_validation(param_combinations=combos, path=smp,
                                     save_path=ja)
    with pytest.warns(UserWarning):
        cols, rows = textras.get_cross_validation(param_combinations=combos,
                                                  path=smp, save_path=to)
    assert len(rows) == 4
    _same_csv(to, ja)
    with pytest.warns(UserWarning):
        jextras.get_climate_cross_validation(path=smp, save_path=ja)
    with pytest.warns(UserWarning):
        textras.get_climate_cross_validation(path=smp, save_path=to)
    _same_csv(to, ja)


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """Two tiny runs of the port's trainer (png figures, evaluate)."""
    base = str(tmp_path_factory.mktemp("an_data"))
    hp = dict(tdatasets.hyperparam_default, nb_paths=40, nb_steps=20)
    tdatasets.create_dataset("BlackScholes", hp, seed=1, base_path=base,
                             device="cpu")
    smp = str(tmp_path_factory.mktemp("an_models"))
    for tsize in (16, 32):
        assert ttrainer.train(
            epochs=2, batch_size=16, learning_rate=0.01, hidden_size=6,
            dropout_rate=0.0, ode_nn=((10, "tanh"),),
            readout_nn=((10, "tanh"),), enc_nn=((10, "tanh"),),
            dataset="BlackScholes", plot=True, paths_to_plot=(0,),
            saved_models_path=smp, base_data_path=base, evaluate=True,
            training_size=tsize, plot_save_format="png",
            device="cpu") == 0
    return base, smp


def test_figures_on_the_cpu(port_runs, tmp_path):
    base, smp = port_runs
    files = [os.path.join(smp, f"id-{i}", f"metric_id-{i}.csv")
             for i in (1, 2)]
    for f in (
            textras.plot_losses(files, ["a", "b"], path=str(tmp_path),
                                filename="l.png"),
            textras.plot_convergence_study(path=smp,
                                           save_path=str(tmp_path)),
            textras.generate_training_progress_gif(1, which_path=0,
                                                   saved_models_path=smp)):
        assert f and os.path.getsize(f) > 0
    outs = textras.plot_loss_and_metric((1, 2), saved_models_path=smp)
    assert all(os.path.exists(o) for o in outs)
    assert textras.plot_paths_from_checkpoint(
        (1, 5), which="both", saved_models_path=smp, device="cpu",
        base_data_path=base) == 0
    assert any(f.startswith("demo-plot") for f in
               os.listdir(os.path.join(smp, "id-1", "plots")))
    cols, rows = textras.get_training_overview(path=smp, save_file=False)
    assert [r["training_size"] for r in rows] == [16, 32]
    assert [r["epochs_trained"] for r in rows] == [2, 2]


def test_figures_skip_without_matplotlib(port_runs, monkeypatch, capsys,
                                         tmp_path):
    _, smp = port_runs
    for m in [m for m in sys.modules if m.split(".")[0] == "matplotlib"]:
        monkeypatch.delitem(sys.modules, m)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert textras.plot_loss_and_metric((1,), saved_models_path=smp) is None
    assert textras.plot_convergence_study(path=smp,
                                          save_path=str(tmp_path)) is None
    assert capsys.readouterr().out.count(ttrainer.PLOT_SKIPPED) == 2
    _, rows = textras.get_training_overview(path=smp, save_file=False)
    assert len(rows) == 2
