"""The port's climate helpers (``data/climate.py``: ``add_jitter``,
``map_to_closest``, ``adjust_learning_rate``, ``compute_corr``,
``sort_array_on_other``, ``log_lik_gaussian``, ``tail_fun_gaussian``,
``preprocess_ushcn_daily``) against the JAX module's, on the same inputs
(pandas frames for JAX, dicts of numpy columns for the port).

Tolerances: exact where both sides run the same numpy; the normalised
values of ``preprocess_ushcn_daily`` rtol 1e-12 (pandas' and numpy's
mean/std may sum in another order); ``tail_fun_gaussian`` atol 1e-15
(torch's erf against scipy's)."""

import os

import numpy as np
import pandas as pd
import pytest

import conftest  # noqa: F401

from njode_tpu.data import climate as jclimate
from njode_tpu_torch.data import climate as tclimate


def _jitter_frame(seed, n=40):
    rs = np.random.RandomState(seed)
    m1 = (rs.random(n) < 0.7).astype(np.float64)
    m2 = (rs.random(n) < 0.7).astype(np.float64)
    m1[(m1 + m2) == 0] = 1.0
    return pd.DataFrame({
        "ID": rs.randint(0, 5, n), "Time": rs.random(n) * 0.003,
        "Value_1": rs.normal(size=n) * m1, "Value_2": rs.normal(size=n) * m2,
        "Mask_1": m1, "Mask_2": m2})


@pytest.mark.parametrize("seed", [0, 3])
def test_add_jitter_matches_jax(seed):
    df = _jitter_frame(seed)
    ref = jclimate.add_jitter(df, jitter_time=1e-3, seed=seed)
    out = tclimate.add_jitter({c: df[c].to_numpy() for c in df}, 1e-3,
                              seed=seed)
    assert list(out) == list(ref.columns)
    for c in ref.columns:
        np.testing.assert_array_equal(out[c], ref[c].to_numpy(), err_msg=c)
    assert (out["Time"] >= 0).all() and out["Time"].min() == 0.0
    with pytest.raises(ValueError, match="6 columns"):
        tclimate.add_jitter({c: df[c].to_numpy() for c in
                             list(df.columns)[:5]})


def test_misc_helpers_match_jax():
    rs = np.random.RandomState(0)
    ref_pts = np.sort(rs.random(7))
    vals = rs.random(30) * 1.2 - 0.1
    np.testing.assert_array_equal(tclimate.map_to_closest(vals, ref_pts),
                                  jclimate.map_to_closest(vals, ref_pts))
    for epoch in (0, 20, 21, 50):
        assert tclimate.adjust_learning_rate(epoch, 0.3) == \
            jclimate.adjust_learning_rate(epoch, 0.3)
    Xt = rs.normal(size=(25, 3))
    Xh = Xt + 0.3 * rs.normal(size=(25, 3))
    M = (rs.random((25, 3)) < 0.6).astype(np.float64)
    np.testing.assert_array_equal(tclimate.compute_corr(Xt * M, Xh * M, M),
                                  jclimate.compute_corr(Xt * M, Xh * M, M))
    x1 = rs.permutation(40)
    x2 = rs.permutation(40)
    perm = tclimate.sort_array_on_other(x1, x2)
    np.testing.assert_array_equal(perm, jclimate.sort_array_on_other(x1, x2))
    np.testing.assert_array_equal(x2[perm], x1)
    x, mu, lv = rs.normal(size=50), rs.normal(size=50), rs.normal(size=50)
    np.testing.assert_array_equal(tclimate.log_lik_gaussian(x, mu, lv),
                                  jclimate.log_lik_gaussian(x, mu, lv))
    np.testing.assert_allclose(tclimate.tail_fun_gaussian(x, mu, lv),
                               jclimate.tail_fun_gaussian(x, mu, lv),
                               rtol=0, atol=1e-15)


def _raw_file(path, seed=0, stations=3, days=430):
    """A synthesized raw daily file (tests/test_climate.py's recipe)."""
    rs = np.random.RandomState(seed)
    rows = []
    for sid in range(stations):
        for day in range(days):
            mask = (rs.random(5) < 0.3).astype(int)
            if mask.sum() == 0:
                continue
            vals = rs.normal(10, 5, 5) * mask
            rows.append([sid, day] + list(vals) + list(mask))
    raw = pd.DataFrame(rows, columns=["ID", "day"]
                       + [f"Value_{i}" for i in range(5)]
                       + [f"Mask_{i}" for i in range(5)])
    raw.to_csv(path, index=False)


@pytest.mark.parametrize("chunk,min_obs", [(200, 10), (60, 25)])
def test_preprocess_ushcn_daily_matches_jax(tmp_path, chunk, min_obs):
    raw = str(tmp_path / "raw.csv")
    _raw_file(raw, seed=chunk)
    j_csv = str(tmp_path / "jax" / "small_chunked_sporadic.csv")
    t_csv = str(tmp_path / "torch" / "small_chunked_sporadic.csv")
    ref = jclimate.preprocess_ushcn_daily(raw, j_csv, chunk_days=chunk,
                                          min_obs_per_chunk=min_obs)
    out = tclimate.preprocess_ushcn_daily(raw, t_csv, chunk_days=chunk,
                                          min_obs_per_chunk=min_obs)
    assert list(out) == list(ref.columns)
    for c in ref.columns:
        np.testing.assert_allclose(out[c], ref[c].to_numpy(), rtol=1e-12,
                                   atol=0, err_msg=c)
    a, b = pd.read_csv(j_csv), pd.read_csv(t_csv)
    assert list(a.columns) == list(b.columns)
    np.testing.assert_allclose(b.to_numpy(), a.to_numpy(), rtol=1e-12)
    # the file loads through the port's dataset
    ds = tclimate.ClimateDataset(csv_file=t_csv)
    ev = ds.collate(np.arange(min(8, len(ds))))
    assert ev["X"].shape[1] == 5
    with pytest.raises(FileNotFoundError, match="raw USHCN"):
        tclimate.preprocess_ushcn_daily(str(tmp_path / "nope.csv"), t_csv)
    assert not os.path.exists(str(tmp_path / "nope.csv"))
