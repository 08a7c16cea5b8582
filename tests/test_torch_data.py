"""The port's data layer (grid, oracle, datasets, samplers, split) against
the JAX package on the same numpy data."""

import json
import os

import numpy as np
import pytest

import conftest  # noqa: F401

import jax.numpy as jnp
import torch

import torch_port_helpers as H
from njode_tpu.data import datasets as jdatasets
from njode_tpu.data import grid as jgrid
from njode_tpu.data import oracle as joracle
from njode_tpu.data import sde as jsde
from njode_tpu_torch.data import datasets as tdatasets
from njode_tpu_torch.data import grid as tgrid
from njode_tpu_torch.data import oracle as toracle
from njode_tpu_torch.data import sde as tsde

HP = dict(drift=2.0, volatility=0.3, mean=4.0, speed=2.0, nb_steps=15,
          maturity=1.0, S0=1.0, nb_paths=8)


def _paths(seed=0, B=8, D=2, steps=15):
    rs = np.random.RandomState(seed)
    paths = rs.lognormal(0.0, 0.3, size=(B, D, steps + 1))
    obs = (rs.random((B, steps + 1)) < 0.35).astype(np.int64)
    return paths, obs


def test_batch_from_paths_and_recompute_n_obs_match_jax():
    paths, obs = _paths()
    fns = [np.exp]
    for functions in (None, fns):
        jb = jgrid.recompute_n_obs(jgrid.batch_from_paths(
            paths, obs, 1 / 15, functions=functions))
        tb = tgrid.recompute_n_obs(tgrid.batch_from_paths(
            paths, obs, 1 / 15, functions=functions))
        for a, b in zip(tb, jb):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert tgrid.validate_batch(tb) == []
    bad = tb._replace(n_obs_ot=tb.n_obs_ot + 1)
    assert tgrid.validate_batch(bad, strict=False)
    with pytest.raises(ValueError):
        tgrid.validate_batch(bad)
    tt = tgrid.recompute_n_obs(tgrid.to_torch(tb, "cpu"))
    np.testing.assert_array_equal(tt.n_obs_ot.numpy(), tb.n_obs_ot)


@pytest.mark.parametrize("name", ["BlackScholes", "OrnsteinUhlenbeck",
                                  "Heston"])
def test_oracle_matches_jax(name):
    b = H.make_np_batch(seed=1, D=1, pad=2)
    jm = jsde.make_model(name, HP)
    tm = tsde.make_model(name, HP)
    jpre, jpost = joracle.cond_exp_paths(jm.next_cond_exp, H.jbatch(b))
    tb = H.tbatch(b)
    tpre, tpost = toracle.cond_exp_paths(tm.next_cond_exp, tb)
    np.testing.assert_allclose(tpre.numpy(), np.asarray(jpre), rtol=1e-6)
    np.testing.assert_allclose(tpost.numpy(), np.asarray(jpost), rtol=1e-6)
    jl = joracle.optimal_loss(jm.next_cond_exp, H.jbatch(b), weight=0.6)
    tl = toracle.optimal_loss(tm.next_cond_exp, tb, weight=0.6)
    np.testing.assert_allclose(float(tl), float(jl), **H.LOSS_TOL)
    rs = np.random.RandomState(2)
    noise = [rs.normal(size=a.shape).astype(np.float32)
             for a in (tpre, tpost, tb.start_X)]
    args_t = (tpre + torch.as_tensor(noise[0]), tpost
              + torch.as_tensor(noise[1]), tpre, tpost,
              tb.start_X + torch.as_tensor(noise[2]), tb.start_X, tb.obs,
              tb.dt)
    args_j = tuple(jnp.asarray(a.numpy()) for a in args_t)
    np.testing.assert_allclose(
        float(toracle.evaluation_mean_diff(*args_t)),
        float(joracle.evaluation_mean_diff(*args_j)), rtol=1e-6)
    pick = (4, 0, 1, 6, 7)                  # y0, y_pre, y_post, obs, dt
    np.testing.assert_array_equal(
        toracle.stack_path_entries(*(args_t[i] for i in pick)),
        joracle.stack_path_entries(*(args_j[i] for i in pick)))


def test_jax_dataset_loads_in_port(tmp_path):
    base = str(tmp_path)
    hp = dict(jdatasets.hyperparam_default, nb_paths=50, nb_steps=10)
    _, tid = jdatasets.create_dataset("BlackScholes", hp, seed=3,
                                      base_path=base)
    ref = jdatasets.load_dataset("BlackScholes", tid, base)
    got = tdatasets.load_dataset("BlackScholes", None, base)
    for a, b in zip(got[:3], ref[:3]):
        np.testing.assert_array_equal(a, b)
    assert got[3] == ref[3]
    assert tdatasets.load_metadata("BlackScholes", tid, base) == ref[3]
    assert tdatasets._get_time_id("BlackScholes", None, base) == tid
    rows, _ = tdatasets.get_dataset_overview(base)
    assert rows[0][0] == "BlackScholes" and int(rows[0][1]) == tid
    ds = tdatasets.PathDataset("BlackScholes", tid, np.arange(5), base)
    assert len(ds) == 5 and ds.dt == ref[3]["dt"]
    np.testing.assert_array_equal(ds.dense_arrays()[0],
                                  ref[0][:5].astype(np.float32))


def test_port_dataset_loads_in_jax(tmp_path):
    base = str(tmp_path)
    hp = dict(tdatasets.hyperparam_default, nb_paths=50, nb_steps=10)
    _, tid = tdatasets.create_dataset("OrnsteinUhlenbeck", hp, seed=3,
                                      base_path=base, device="cpu")
    _, tid2 = tdatasets.create_dataset("OrnsteinUhlenbeck", hp, seed=4,
                                       base_path=base, device="cpu")
    assert tid2 == tid + 1
    got = tdatasets.load_dataset("OrnsteinUhlenbeck", tid, base)
    ref = jdatasets.load_dataset("OrnsteinUhlenbeck", tid, base)
    for a, b in zip(got[:3], ref[:3]):
        np.testing.assert_array_equal(a, b)
    assert got[3] == ref[3] and ref[3]["dt"] == pytest.approx(0.1)
    assert got[0].shape == (50, 1, 11) and got[0].dtype == np.float64
    # the observation masks come from RandomState(seed) in both packages
    jhp = dict(hp)
    _, jid = jdatasets.create_dataset("OrnsteinUhlenbeck", jhp, seed=3,
                                      base_path=base)
    np.testing.assert_array_equal(
        jdatasets.load_dataset("OrnsteinUhlenbeck", jid, base)[1], got[1])
    df, _ = jdatasets.get_dataset_overview(base)
    assert list(df["id"]) == [tid, tid2, jid]
    assert json.loads(df["description"][0])["model_name"] == \
        "OrnsteinUhlenbeck"


def _euler_means(name, hp):
    dt = hp["maturity"] / hp["nb_steps"]
    n = hp["nb_steps"]
    if name == "BlackScholes":
        return hp["S0"] * (1 + hp["drift"] * dt) ** n
    return hp["mean"] + (hp["S0"] - hp["mean"]) * (1 - hp["speed"] * dt) ** n


@pytest.mark.parametrize("name", ["BlackScholes", "OrnsteinUhlenbeck"])
def test_sampler_moments(name):
    """Mean of X_T within 3 standard errors of the Euler scheme's exact
    mean (S0(1+mu dt)^N for BlackScholes; the OU analogue), for the port
    and for the JAX sampler; the streams differ, the moments agree."""
    import jax
    hp = dict(HP, nb_paths=20_000, nb_steps=100)
    want = _euler_means(name, hp)
    tp, dt = tsde.make_model(name, hp).generate_paths(
        torch.Generator().manual_seed(0))
    jp, _ = jsde.make_model(name, hp).generate_paths(jax.random.PRNGKey(0))
    assert tuple(tp.shape) == (20_000, 1, 101) and dt == pytest.approx(0.01)
    for p in (tp.numpy(), np.asarray(jp)):
        xT = p[:, 0, -1].astype(np.float64)
        se = xT.std() / np.sqrt(len(xT))
        assert abs(xT.mean() - want) < 3 * se, (xT.mean(), want, se)
    h = tsde.make_model("Heston", dict(HP, nb_paths=100, correlation=0.5)
                        ).generate_paths(torch.Generator().manual_seed(0))[0]
    assert torch.isfinite(h).all() and tuple(h.shape) == (100, 1, 16)


def test_unported_models_raise():
    for name in ("HestonWOFeller", "combined", "sine_BlackScholes"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            tsde.make_model(name, HP)


@pytest.mark.parametrize("n,test_size,seed", [(200, 0.2, 398),
                                              (20_000, 0.2, 398),
                                              (37, 0.3, 5)])
def test_split_matches_sklearn(n, test_size, seed):
    from sklearn.model_selection import train_test_split

    from njode_tpu_torch.training.trainer import train_val_split
    ref_tr, ref_te = train_test_split(np.arange(n), test_size=test_size,
                                      random_state=seed)
    tr, te = train_val_split(n, test_size, seed)
    np.testing.assert_array_equal(tr, ref_tr)
    np.testing.assert_array_equal(te, ref_te)


def test_paths_layout_is_shared():
    from njode_tpu.utils import paths as jpaths
    from njode_tpu_torch.utils import paths as tpaths
    assert tpaths.training_data_path == jpaths.training_data_path
    assert tpaths.saved_models_path == jpaths.saved_models_path
    assert os.path.basename(tpaths.data_path) == "data" or \
        "NJODE_DATA_PATH" in os.environ
