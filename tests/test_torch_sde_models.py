"""The port's HestonWOFeller, sine and combined models against the JAX
package: their samplers by moments, the combined model's chaining, the
return_vol layout, the combined dataset on disk and the debug plots. (The
oracles are held to the JAX ``next_cond_exp`` in
``tests/test_torch_data.py::test_oracle_matches_jax``.)"""

import json
import os

import numpy as np
import pytest

import conftest  # noqa: F401

import jax
import torch

from njode_tpu.data import datasets as jdatasets
from njode_tpu.data import sde as jsde
from njode_tpu_torch.data import datasets as tdatasets
from njode_tpu_torch.data import sde as tsde

HP = dict(drift=2.0, volatility=0.3, mean=4.0, speed=2.0, correlation=0.5,
          nb_paths=20_000, nb_steps=100, S0=1.0, maturity=1.0, dimension=1)
# the published Heston-without-Feller dataset (experiments/configs.py)
WOF = dict(HP, volatility=3.0, mean=1.0, v0=0.5, scheme="euler")
COMBINED = dict(
    stock_model_names=["OrnsteinUhlenbeck", "BlackScholes"],
    hyperparam_dicts=[dict(HP, nb_paths=4000, nb_steps=50, maturity=0.5,
                           mean=10)] * 2)


def _paths(name, hp, seed=0):
    """(port paths, JAX paths) as float64 numpy arrays, each sampler on
    its own stream from ``seed``."""
    tp, tdt = tsde.make_model(name, hp).generate_paths(
        torch.Generator().manual_seed(seed))
    jp, jdt = jsde.make_model(name, hp).generate_paths(
        jax.random.PRNGKey(seed))
    assert tdt == pytest.approx(jdt, abs=1e-15)
    return tp.numpy().astype(np.float64), np.asarray(jp, np.float64)


def _same_mean(a, b, what):
    """Means of two independent samples within 4 standard errors of their
    difference."""
    se = np.sqrt(a.var() / a.size + b.var() / b.size)
    assert abs(a.mean() - b.mean()) < 4 * se, (what, a.mean(), b.mean(), se)


@pytest.mark.parametrize("name,hp", [
    ("HestonWOFeller", WOF),
    ("HestonWOFeller", dict(WOF, return_vol=True, dimension=2)),
    ("sine_BlackScholes", dict(HP, sine_coeff=2 * np.pi)),
    ("sine_OrnsteinUhlenbeck", dict(HP, sine_coeff=4 * np.pi)),
    ("sine_Heston", dict(HP, sine_coeff=2 * np.pi)),
    ("combined", COMBINED)], ids=[
    "HestonWOFeller", "HestonWOFeller-return_vol", "sine_BlackScholes",
    "sine_OrnsteinUhlenbeck", "sine_Heston", "combined"])
def test_sampler_moments_match_jax(name, hp):
    """Each dimension's mean at a quarter, half and all of the horizon:
    the port against the JAX sampler within 4 standard errors; the layout
    [paths, D, steps + 1] and the start values equal."""
    tp, jp = _paths(name, hp)
    assert tp.shape == jp.shape
    assert np.isfinite(tp).all()
    np.testing.assert_array_equal(tp[:, :, 0], jp[:, :, 0].astype(
        np.float32).astype(np.float64))
    K = tp.shape[2] - 1
    for d in range(tp.shape[1]):
        for k in (K // 4, K // 2, K):
            _same_mean(tp[:, d, k], jp[:, d, k], (name, d, k))


def test_return_vol_layout():
    """return_vol stacks spot and variance as dimensions 0 and 1; the
    variance starts at v0 and the spot at S0; without return_vol only the
    spot is returned, simulated by the same draws."""
    hp = dict(WOF, nb_paths=500, return_vol=True, dimension=2)
    both, dt = tsde.make_model("HestonWOFeller", hp).generate_paths(
        torch.Generator().manual_seed(3))
    spot, _ = tsde.make_model("HestonWOFeller", dict(
        hp, return_vol=False, dimension=1)).generate_paths(
        torch.Generator().manual_seed(3))
    assert tuple(both.shape) == (500, 2, 101) and dt == pytest.approx(0.01)
    assert torch.equal(both[:, :1], spot)
    assert torch.all(both[:, 0, 0] == 1.0) and torch.all(both[:, 1, 0] == 0.5)
    # without the Feller condition the variance goes below 0, the spot not
    assert (both[:, 1] < 0).any() and (both[:, 0] > 0).all()
    with pytest.raises(ValueError, match="scheme"):
        tsde.make_model("HestonWOFeller", dict(
            hp, scheme="milstein")).generate_paths(torch.Generator())


def test_combined_chains_continuously():
    """The regimes draw in turn from one generator: the first K1 + 1
    columns are regime 1's paths, and regime 2 starts from their last
    column; the oracle switches formula at the boundary."""
    hp1 = dict(HP, nb_paths=50, nb_steps=20, maturity=0.2)
    hp2 = dict(hp1, nb_steps=30, maturity=0.3)
    m = tsde.Combined(["BlackScholes", "OrnsteinUhlenbeck"], [hp1, hp2])
    gen = torch.Generator().manual_seed(5)
    paths, dt = m.generate_paths(gen)
    assert tuple(paths.shape) == (50, 1, 51) and dt == pytest.approx(0.01)
    gen = torch.Generator().manual_seed(5)
    p1, _ = tsde.make_model("BlackScholes", hp1).generate_paths(gen)
    p2, _ = tsde.make_model("OrnsteinUhlenbeck", hp2).generate_paths(
        gen, start_X=p1[:, :, -1])
    assert torch.equal(paths[:, :, :21], p1)
    assert torch.equal(paths[:, :, 20:], p2)
    np.testing.assert_allclose(m.boundaries(), [0.2, 0.5])
    y = torch.tensor([[2.0]])
    for t_prev, want in ((0.1, 2.0 * np.exp(2.0 * 0.01)),
                         (torch.tensor(0.3), 2.0 * np.exp(-0.02)
                          + 4.0 * (1 - np.exp(-0.02)))):
        out = m.next_cond_exp(y, torch.tensor(0.01), t_prev)
        np.testing.assert_allclose(out.numpy(), [[want]], rtol=1e-6)
    bad = tsde.Combined(["BlackScholes", "BlackScholes"],
                        [hp1, dict(hp1, nb_steps=10)])
    with pytest.raises(ValueError, match="dt"):
        bad.generate_paths(torch.Generator())


def test_make_model_registry():
    """The sine aliases map to the same classes; only HestonWOFeller takes
    scheme, return_vol and v0; the registry names equal the JAX
    package's."""
    hp = dict(HP, sine_coeff=np.pi, v0=0.7, return_vol=True, scheme="x")
    assert type(tsde.make_model("sine_Heston", hp)) is tsde.Heston
    m = tsde.make_model("HestonWOFeller", hp)
    assert (m.v0, m.return_vol, m.scheme, m.sine_coeff) == (
        0.7, True, "x", np.pi)
    assert set(tsde.STOCK_MODELS) == set(jsde.STOCK_MODELS)
    assert tsde.STOCK_MODELS["combined"] is tsde.Combined


def _combined_hp():
    hp = dict(tdatasets.hyperparam_default, nb_paths=30, nb_steps=6,
              maturity=0.3)
    return ["OrnsteinUhlenbeck", "BlackScholes"], [hp, dict(hp, mean=10)]


def test_combined_dataset_crosses_packages(tmp_path):
    """A combined dataset written by each package loads in the other, with
    the same metadata, registry row and observation masks (both draw them
    from RandomState(seed))."""
    names, hps = _combined_hp()
    base_t, base_j = str(tmp_path / "t"), str(tmp_path / "j")
    _, tid = tdatasets.create_combined_dataset(names, hps, seed=2,
                                               base_path=base_t, device="cpu")
    _, jid = jdatasets.create_combined_dataset(names, hps, seed=2,
                                               base_path=base_j)
    fname = "combined_OrnsteinUhlenbeck_BlackScholes"
    for base, ident in ((base_t, tid), (base_j, jid)):
        got = tdatasets.load_dataset(fname, None, base)
        ref = jdatasets.load_dataset(fname, ident, base)
        for a, b in zip(got[:3], ref[:3]):
            np.testing.assert_array_equal(a, b)
        assert got[3] == ref[3]
        assert got[0].shape == (30, 1, 13) and got[0].dtype == np.float64
        df, _ = jdatasets.get_dataset_overview(base)
        rows, _ = tdatasets.get_dataset_overview(base)
        assert list(df["name"]) == [r[0] for r in rows] == [fname]
        assert json.loads(df["description"][0]) == json.loads(rows[0][2])
    tmeta = tdatasets.load_metadata(fname, tid, base_t)
    jmeta = jdatasets.load_metadata(fname, jid, base_j)
    assert tmeta == jmeta and tmeta["model_name"] == "combined"
    np.testing.assert_array_equal(
        tdatasets.load_dataset(fname, tid, base_t)[1],
        jdatasets.load_dataset(fname, jid, base_j)[1])
    # the trainer's oracle for the dataset
    assert isinstance(tsde.make_model("combined", tmeta), tsde.Combined)
    with pytest.raises(ValueError, match="one hyperparameter dict"):
        tdatasets.create_combined_dataset(names, hps[:1], base_path=base_t,
                                          device="cpu")


@pytest.mark.parametrize("draw", ["stock_model", "path_heston"])
def test_draw_paths_writes_a_figure(tmp_path, draw):
    """``draw_stock_model`` / ``draw_path_heston`` write the figure they
    name (as ``tests/test_climate.py::test_draw_stock_model`` checks the
    JAX one)."""
    if draw == "stock_model":
        out = tsde.draw_stock_model("OrnsteinUhlenbeck", n_paths=3,
                                    save_path=str(tmp_path / "ou.png"))
    else:
        out = tsde.draw_path_heston(n_paths=2,
                                    save_path=str(tmp_path / "h.pdf"))
    assert os.path.exists(out) and os.path.getsize(out) > 0


@pytest.mark.parametrize("sine_coeff", [None, 2 * np.pi])
def test_heston_wof_scheme_step_by_step(sine_coeff):
    """The port's log-Euler recursion on its own normals against the JAX
    sampler's update (``njode_tpu/data/sde.py``, ``HestonWOFeller``:
    ``vp = max(v, 0)`` in the spot's drift and diffusion and the
    variance's) written out in float64 numpy: spot and variance of every
    step at rtol 1e-4 / atol 1e-5 (the port runs in float32)."""
    hp = dict(WOF, nb_paths=200, return_vol=True, dimension=2,
              sine_coeff=sine_coeff)
    K, dt = hp["nb_steps"], 1.0 / hp["nb_steps"]
    got, _ = tsde.make_model("HestonWOFeller", hp).generate_paths(
        torch.Generator().manual_seed(7))
    n = torch.randn((K, 2, 200, 1), generator=torch.Generator().manual_seed(
        7)).double().numpy()
    rho = hp["correlation"]
    logs, v = np.zeros((200, 1)), np.full((200, 1), hp["v0"])
    spot, var = [np.exp(logs)], [v]
    for k in range(1, K + 1):
        dW = n[k - 1, 0] * np.sqrt(dt)
        dZ = (rho * n[k - 1, 0] + np.sqrt(1 - rho ** 2) * n[k - 1, 1]) \
            * np.sqrt(dt)
        vp = np.maximum(v, 0.0)
        pc = 1.0 if sine_coeff is None else 1 + np.sin(sine_coeff
                                                       * (k - 1) * dt)
        logs = logs + (hp["drift"] * pc - 0.5 * vp) * dt + np.sqrt(vp) * dW
        v = v - hp["speed"] * (vp - hp["mean"]) * dt \
            + hp["volatility"] * np.sqrt(vp) * dZ
        spot.append(np.exp(logs))
        var.append(v)
    want = np.concatenate([np.stack(spot, 2), np.stack(var, 2)], axis=1)
    assert (want[:, 1] < 0).any()
    np.testing.assert_allclose(got.double().numpy(), want, rtol=1e-4,
                               atol=1e-5)
