"""The port's climate data module (njode_tpu_torch/data/climate.py, no
pandas) against ``njode_tpu.data.climate`` on the schema-true stand-in at a
small size (40 series, 3 variables, T = 20): the CSV it writes, the arrays
parsed from it, the collated batches of the train, val and test splits of
two folds, the static bounds, the pre-stacked bank, ``T_closest`` and the
covariate and label files."""

import os

import numpy as np
import pytest

import conftest  # noqa: F401

from njode_tpu.data import climate as jcdu
from njode_tpu_torch.data import climate as tcdu

VAL = {"T_val": 12, "max_val_samples": 3}
PARSED = ("ids", "_times", "_vals", "_masks", "_cov_by_pos",
          "_label_by_pos")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("climate_port"))
    csv = os.path.join(d, "small_chunked_sporadic.csv")
    jcdu.make_synthetic_climate_csv(csv, n_series=40, n_vars=3, T=20.0,
                                    obs_perc=0.06, seed=3)
    jcdu.make_fold_indices(d, n_series=40, n_folds=2, seed=1)
    return d, csv


def _pair(csv, **kw):
    return (jcdu.ClimateDataset(csv_file=csv, **kw),
            tcdu.ClimateDataset(csv, **kw))


def _assert_same(ref, got, names):
    for n in names:
        np.testing.assert_array_equal(np.asarray(getattr(got, n)),
                                      np.asarray(getattr(ref, n)),
                                      err_msg=n)


def test_stand_in_csv_is_the_jax_file(data, tmp_path):
    """The same seed writes the same bytes (the same RandomState draws in
    the same order, floats at full precision)."""
    _, csv = data
    out = str(tmp_path / "port.csv")
    tcdu.make_synthetic_climate_csv(out, n_series=40, n_vars=3, T=20.0,
                                    obs_perc=0.06, seed=3)
    with open(out) as a, open(csv) as b:
        assert a.read() == b.read()
    cols, rows = tcdu.read_table(out)
    assert cols[:2] == ["ID", "Time"] and rows.shape[1] == 8


def test_parsed_arrays_are_identical(data):
    _, csv = data
    ref, got = _pair(csv)
    _assert_same(ref, got, PARSED)
    assert got.value_cols == ref.value_cols
    assert got.mask_cols == ref.mask_cols
    assert got._times.dtype == np.float64 and got._vals.dtype == np.float32


@pytest.mark.parametrize("fold", [0, 1])
def test_collate_of_every_split(data, fold):
    d, csv = data
    idx = [np.load(os.path.join(d, f"small_chunk_fold_idx_{fold}",
                                f"{s}_idx.npy"))
           for s in ("train", "val", "test")]
    for split, ids, val in (("train", idx[0], False), ("val", idx[1], True),
                            ("test", idx[2], True)):
        kw = dict(idx=ids, validation=val, val_options=VAL if val else None)
        ref, got = _pair(csv, **kw)
        _assert_same(ref, got, PARSED)
        assert len(got) == len(ref)
        assert got.max_grid_steps(0.1, 20.0) == ref.max_grid_steps(0.1, 20.0)
        assert got.max_grid_steps(0.07, 20.0) == \
            ref.max_grid_steps(0.07, 20.0)
        assert got.max_batch_events(7) == ref.max_batch_events(7)
        rs = np.random.RandomState(fold)
        for batch in (np.arange(len(got)), rs.permutation(len(got))[:7]):
            er, eg = ref.collate(batch), got.collate(batch)
            assert set(er) == set(eg), split
            for k in er:
                np.testing.assert_array_equal(np.asarray(eg[k]),
                                              np.asarray(er[k]),
                                              err_msg=f"{split} {k}")
        if not val:
            K = ref.max_grid_steps(0.1, 20.0)
            pr = jcdu.prestack_series(ref, 0.1, 20.0, K)
            pg = tcdu.prestack_series(got, 0.1, 20.0, K)
            assert set(pr) == set(pg)
            for k in pr:
                np.testing.assert_array_equal(pg[k], pr[k], err_msg=k)
            ev = got.collate(np.arange(5))
            br = jcdu.dense_batch_from_events(ev, 0.1, 20.0, K,
                                              pad_batch_to=8)
            bg = tcdu.dense_batch_from_events(ev, 0.1, 20.0, K,
                                              pad_batch_to=8)
            for name, a, b in zip(br._fields, bg, br):
                np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("opts", [dict(T_closest=14.0),
                                  dict(T_val_from=15.0, max_val_samples=2),
                                  dict(max_val_samples=1)],
                         ids=["closest", "from", "one"])
def test_validation_filters(data, opts):
    _, csv = data
    vo = dict(VAL, **opts)
    ref, got = _pair(csv, validation=True, val_options=vo,
                     t_mult=1.0 if "T_closest" in opts else 0.5)
    _assert_same(ref, got, PARSED + ("_a_times", "_a_vals", "_a_masks"))
    er, eg = ref.collate(np.arange(len(ref))), got.collate(np.arange(
        len(got)))
    for k in ("X_val", "M_val", "times_val", "index_val"):
        np.testing.assert_array_equal(eg[k], er[k], err_msg=k)
    if "T_closest" in opts:
        assert len(np.unique(eg["index_val"])) == len(eg["index_val"])


def test_cov_and_label_files(data, tmp_path):
    """Per-series covariates and labels from files, and the dummies
    without them: the same arrays and collated ``cov``/``y``."""
    d, csv = data
    rs = np.random.RandomState(0)
    ids = np.arange(40)
    cov_f, lab_f = str(tmp_path / "cov.csv"), str(tmp_path / "lab.csv")
    with open(cov_f, "w") as f:
        f.write("ID,c0,c1\n")
        for i in rs.permutation(ids):
            f.write(f"{i},{rs.normal()!r},{rs.normal()!r}\n")
    with open(lab_f, "w") as f:
        f.write("ID,label\n")
        for i in ids:
            f.write(f"{i},{i % 3}\n")
    val_idx = np.load(os.path.join(d, "small_chunk_fold_idx_0",
                                   "val_idx.npy"))
    for kw in (dict(), dict(cov_file=cov_f, label_file=lab_f)):
        for extra in (dict(), dict(idx=val_idx, validation=True,
                                   val_options=VAL)):
            ref, got = _pair(csv, **kw, **extra)
            _assert_same(ref, got, PARSED)
            assert got.cov_dim == ref.cov_dim == (2 if kw else 1)
            er = ref.collate(np.arange(len(ref)))
            eg = got.collate(np.arange(len(got)))
            for k in ("cov", "y"):
                np.testing.assert_array_equal(eg[k], er[k], err_msg=k)


def test_held_out_helpers():
    rs = np.random.RandomState(2)
    pred_t = np.concatenate([[0.0], np.arange(1, 31) * 0.1])
    path = rs.normal(size=(31, 4, 3)).astype(np.float32)
    t = rs.uniform(0, 3.0, 9)
    i = rs.randint(0, 4, 9)
    p_ref = jcdu.extract_at_times(pred_t, path, t, i)
    np.testing.assert_array_equal(tcdu.extract_at_times(pred_t, path, t, i),
                                  p_ref)
    X = rs.normal(size=p_ref.shape)
    M = (rs.random(p_ref.shape) < 0.5).astype(np.float32)
    assert tcdu.masked_mse_parts(p_ref, X, M) == \
        jcdu.masked_mse_parts(p_ref, X, M)


def test_fold_indices(tmp_path):
    a, b = str(tmp_path / "j"), str(tmp_path / "t")
    jcdu.make_fold_indices(a, n_series=57, n_folds=3, seed=4)
    tcdu.make_fold_indices(b, n_series=57, n_folds=3, seed=4)
    for i in range(3):
        for s in ("train", "val", "test"):
            f = os.path.join(f"small_chunk_fold_idx_{i}", f"{s}_idx.npy")
            np.testing.assert_array_equal(np.load(os.path.join(b, f)),
                                          np.load(os.path.join(a, f)))
