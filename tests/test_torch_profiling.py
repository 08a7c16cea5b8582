"""The port's tracing and anomaly checks (``utils/profiling.py``) and the
trainer's ``profile_dir`` / ``anomaly_detection`` options, beside the JAX
package's ``utils/profiling.py`` (the same StepTimer surface)."""

import glob
import json
import os

import numpy as np
import pytest

import conftest  # noqa: F401

import torch

from njode_tpu.utils import profiling as jprof
from njode_tpu_torch.data import datasets as tdatasets
from njode_tpu_torch.models import njode as tnjode
from njode_tpu_torch.training import steps as tsteps
from njode_tpu_torch.training import trainer as ttrainer
from njode_tpu_torch.utils import profiling as tprof


def test_step_timer_matches_the_jax_surface():
    for mod in (jprof, tprof):
        t = mod.StepTimer()
        with pytest.raises(RuntimeError, match="before start"):
            t.stop()
    t, j = tprof.StepTimer(), jprof.StepTimer()
    for timer in (t, j):
        timer.start()
        for _ in range(3):
            timer.step(20)
    out = t.stop(sync_on=torch.zeros(2))
    ref = j.stop()
    assert set(out) == set(ref)
    assert t.steps == j.steps == 3 and t.items == j.items == 60
    assert out["steps_per_sec"] == pytest.approx(3 / out["elapsed_s"])
    assert out["items_per_sec"] == pytest.approx(60 / out["elapsed_s"])
    t.reset()
    assert t.steps == 0 and t.items == 0


def test_trace_is_a_no_op_without_a_dir_and_captures_with_one(tmp_path):
    with tprof.trace(None) as prof:
        assert prof is None
    d = tmp_path / "trace"
    with tprof.trace(str(d)) as prof:
        (torch.randn(64, 64) @ torch.randn(64, 64)).sum()
    names = {e.key for e in prof.key_averages()}
    assert "aten::mm" in names
    files = glob.glob(str(d / "trace_*.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "aten::mm" for e in events)


def _model_and_step(seed=0):
    cfg = tnjode.NJODEConfig(1, 4, 1, ((8, "tanh"),), ((8, "tanh"),),
                             ((8, "tanh"),))
    torch.manual_seed(seed)
    model = tnjode.NJODE(cfg)
    opt = tsteps.make_optimizer(model.parameters(), 1e-3)
    K = 10
    fns = tsteps.make_step_fns(model, opt, torch.arange(1, K + 1) / K,
                               torch.full((K,), 1.0 / K))
    rs = np.random.RandomState(seed)
    paths = torch.as_tensor(rs.lognormal(0, 0.3, (6, 1, K + 1)),
                            dtype=torch.float32)
    obs = torch.as_tensor(rs.random((6, K + 1)) < 0.5, dtype=torch.float32)
    idx = torch.arange(6)
    return model, lambda: fns["train_step"](paths, obs, idx, 0.5, None)


def test_anomaly_detection_raises_on_a_nan_step_and_restores():
    model, step = _model_and_step()
    assert np.isfinite(float(step()))
    with torch.no_grad():
        model.ode_f.f[0].weight[0, 0] = float("nan")
    assert np.isnan(float(step()))        # off: the NaN trains on
    with torch.no_grad():
        model.ode_f.f[0].weight[0, 0] = float("nan")
    with tprof.anomaly_detection():
        assert torch.is_anomaly_enabled()
        with pytest.raises((RuntimeError, FloatingPointError),
                           match="nan|non-finite"):
            step()
    assert not torch.is_anomaly_enabled()
    assert tprof._CHECK is None


def test_check_step_infs_half():
    p = torch.nn.Parameter(torch.zeros(3))
    p.grad = torch.tensor([0.0, float("inf"), 1.0])
    loss = torch.tensor(2.0)
    tprof.check_step(loss, [p])                          # off: no check
    with tprof.anomaly_detection(nans=True, infs=False):
        tprof.check_step(loss, [p])                      # infs not asked
    with tprof.anomaly_detection(nans=False, infs=True):
        with pytest.raises(FloatingPointError, match="gradient 0"):
            tprof.check_step(loss, [p])
        with pytest.raises(FloatingPointError, match="loss"):
            tprof.check_step(torch.tensor(float("inf")), [])
    with tprof.anomaly_detection(nans=True):
        with pytest.raises(FloatingPointError, match="loss"):
            tprof.check_step(torch.tensor(float("nan")), [])
    assert tprof._CHECK is None


def test_trainer_profile_dir_and_anomaly_detection(tmp_path):
    import pandas as pd

    data = str(tmp_path / "data")
    hp = dict(tdatasets.hyperparam_default, nb_paths=60, nb_steps=20)
    tdatasets.create_dataset("BlackScholes", hp, seed=0, base_path=data,
                             device="cpu")
    prof = str(tmp_path / "prof")
    kw = dict(epochs=2, batch_size=20, hidden_size=6, dropout_rate=0.1,
              ode_nn=((8, "tanh"),), readout_nn=((8, "tanh"),),
              enc_nn=((8, "tanh"),), dataset="BlackScholes",
              base_data_path=data, device="cpu")
    models = str(tmp_path / "models")
    assert ttrainer.train(saved_models_path=models, profile_dir=prof,
                          anomaly_detection=True, **kw) == 0
    assert not torch.is_anomaly_enabled()
    files = glob.glob(os.path.join(prof, "trace_*.json"))
    assert len(files) == 1                      # the first epoch only
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "autograd::engine::evaluate_function: AddmmBackward0" in names
    plain = str(tmp_path / "plain")
    assert ttrainer.train(saved_models_path=plain, **kw) == 0
    a = pd.read_csv(os.path.join(models, "id-1", "metric_id-1.csv"))
    b = pd.read_csv(os.path.join(plain, "id-1", "metric_id-1.csv"))
    cols = ["train_loss", "eval_loss"]
    np.testing.assert_array_equal(a[cols].to_numpy(), b[cols].to_numpy())
