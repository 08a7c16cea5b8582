"""The port's latent-ODE helpers (``data/lode_utils.py``, on tensors)
against the JAX module's (numpy), every public function on the same
inputs; the random time points from the same ``RandomState`` seed.

Tolerances: the split, subsample and cut outputs exactly (both sides copy
and zero the same float32 entries); the float32 metrics rtol 1e-5 / atol
1e-6 (torch and numpy reduce in other orders); the float64 Poisson term
exactly."""

from types import SimpleNamespace

import numpy as np
import pytest

import conftest  # noqa: F401

import torch

from njode_tpu.data import lode_utils as jlu
from njode_tpu_torch.data import lode_utils as tlu

TOL = dict(rtol=1e-5, atol=1e-6)
KEYS = ("observed_data", "observed_tp", "data_to_predict", "tp_to_predict",
        "observed_mask", "mask_predicted_data", "labels")


def _batch(B=5, T=30, D=3, seed=0, with_mask=True):
    rs = np.random.RandomState(seed)
    return {"data": rs.normal(0, 1, (B, T, D)).astype(np.float32),
            "time_steps": np.linspace(0.0, 1.0, T).astype(np.float32),
            "mask": ((rs.random((B, T, D)) < 0.5).astype(np.float32)
                     if with_mask else None),
            "labels": rs.randint(0, 2, (B,)).astype(np.float32)}


def _same(out, ref):
    for k in KEYS:
        if ref[k] is None:
            assert out[k] is None, k
        else:
            assert isinstance(out[k], torch.Tensor), k
            np.testing.assert_array_equal(out[k].numpy(), ref[k],
                                          err_msg=k)
    assert out["mode"] == ref["mode"]


@pytest.mark.parametrize("with_mask", [True, False])
@pytest.mark.parametrize("dataset", ["physionet", "hopper"])
def test_split_data_matches_jax(with_mask, dataset):
    d = _batch(with_mask=with_mask)
    _same(tlu.split_data_extrap(d, dataset), jlu.split_data_extrap(d,
                                                                   dataset))
    _same(tlu.split_data_interp(d), jlu.split_data_interp(d))


@pytest.mark.parametrize("n", [None, 7, 0.5])
def test_subsample_timepoints_matches_jax(n):
    d = _batch(seed=3)
    ref = jlu.subsample_timepoints(d["data"], d["time_steps"], d["mask"],
                                   n, rng=np.random.RandomState(7))
    out = tlu.subsample_timepoints(torch.tensor(d["data"]), d["time_steps"],
                                   torch.tensor(d["mask"]), n,
                                   rng=np.random.RandomState(7))
    for a, r in zip(out, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(r))


@pytest.mark.parametrize("n", [None, 6])
def test_cut_out_timepoints_matches_jax(n):
    d = _batch(seed=4)
    ref = jlu.cut_out_timepoints(d["data"], d["time_steps"], d["mask"], n,
                                 rng=np.random.RandomState(1))
    out = tlu.cut_out_timepoints(d["data"], d["time_steps"], d["mask"], n,
                                 rng=np.random.RandomState(1))
    for a, r in zip(out, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(r))
    with pytest.raises(ValueError):
        tlu.cut_out_timepoints(d["data"], d["time_steps"], d["mask"], 0)


@pytest.mark.parametrize("extrap", [False, True])
@pytest.mark.parametrize("sample_tp,cut_tp", [(None, None), (0.5, None),
                                               (None, 6)])
def test_split_and_subsample_batch_matches_jax(extrap, sample_tp, cut_tp):
    d = _batch(T=40, seed=2, with_mask=sample_tp is None)
    args = SimpleNamespace(extrap=extrap, dataset="physionet",
                           sample_tp=sample_tp, cut_tp=cut_tp)
    if sample_tp is not None:
        d["mask"] = (np.random.RandomState(9).random(d["data"].shape)
                     < 0.5).astype(np.float32)
    np.random.seed(11)
    ref = jlu.split_and_subsample_batch(dict(d), args)
    out = tlu.split_and_subsample_batch(dict(d), args,
                                        rng=np.random.RandomState(11))
    for k in KEYS:
        np.testing.assert_array_equal(
            np.asarray(out[k]) if out[k] is not None else None,
            np.asarray(ref[k]) if ref[k] is not None else None, err_msg=k)


@pytest.mark.parametrize("masked", [True, False])
@pytest.mark.parametrize("data_shape", ["full", "3d"])
def test_masked_gaussian_log_density_matches_jax(masked, data_shape):
    rs = np.random.RandomState(5)
    S, B, T, D = 2, 4, 8, 3
    mu = rs.normal(0, 1, (S, B, T, D)).astype(np.float32)
    data = rs.normal(0, 1, (S, B, T, D) if data_shape == "full"
                     else (B, T, D)).astype(np.float32)
    mask = ((rs.random((S, B, T, D)) < 0.6).astype(np.float32)
            if masked else None)
    mask_t = None if mask is None else torch.tensor(mask)
    ref = jlu.masked_gaussian_log_density(mu, data, 0.3, mask)
    out = tlu.masked_gaussian_log_density(torch.tensor(mu),
                                          torch.tensor(data), 0.3, mask_t)
    assert tuple(out.shape) == ref.shape == (B, S)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_metric_helpers_match_jax():
    rs = np.random.RandomState(6)
    mu = rs.normal(0, 1, (3, 17)).astype(np.float32)
    x = rs.normal(0, 1, (3, 17)).astype(np.float32)
    np.testing.assert_allclose(
        tlu.gaussian_log_likelihood(torch.tensor(mu), x, 0.5).numpy(),
        jlu.gaussian_log_likelihood(mu, x, 0.5), **TOL)
    assert float(tlu.gaussian_log_likelihood(np.zeros((2, 0)),
                                             np.zeros((2, 0)), 0.5)) == 0.0

    logits = rs.normal(0, 2, (2, 6)).astype(np.float32)
    labels = rs.randint(0, 2, 6).astype(np.float32)
    labels[2] = np.nan
    np.testing.assert_allclose(
        float(tlu.compute_binary_CE_loss(torch.tensor(logits), labels)),
        float(jlu.compute_binary_CE_loss(logits, labels)), **TOL)
    np.testing.assert_allclose(
        float(tlu.compute_binary_CE_loss(logits[0], labels)),
        float(jlu.compute_binary_CE_loss(logits[0], labels)), **TOL)

    for S in (1, 2):
        B, T, C = 3, 5, 4
        lg = rs.normal(0, 1, (S, B, T, C)).astype(np.float32)
        lab = np.eye(C, dtype=np.float32)[rs.randint(0, C, (B, T))]
        mask = (rs.random((B, T, 2)) < 0.7).astype(np.float32)
        np.testing.assert_allclose(
            float(tlu.compute_multiclass_CE_loss(lg, lab, mask)),
            float(jlu.compute_multiclass_CE_loss(lg, lab, mask)), **TOL)

    lam = np.array([0.1, 0.2])
    ints = np.array([5.0, 7.0])
    assert float(tlu.poisson_log_likelihood(lam, np.array([1., 2.]), 1,
                                            ints)) == \
        float(jlu.poisson_log_likelihood(lam, np.array([1., 2.]), 1, ints))
    assert float(tlu.poisson_log_likelihood(np.zeros(0), np.zeros(0), 0,
                                            ints)) == 0.0
