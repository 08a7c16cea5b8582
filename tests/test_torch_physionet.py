"""The port's PhysioNet data module (data/physionet.py) against the JAX
package's: every function gives the JAX module's arrays exactly, on small
stand-ins (quantization 2.0, as tests/test_physionet.py uses), the
sklearn-free 80/20 split against sklearn's ``train_test_split`` at several
sizes, and the raw-file parser and cache on a few written records."""

import os

import numpy as np
import pytest

import conftest  # noqa: F401

from njode_tpu.data import physionet as jpdu
from njode_tpu_torch.data import physionet as tpdu

RAW_RECORD = """Time,Parameter,Value
00:00,RecordID,132539
00:07,HR,73
00:07,Temp,35.1
00:37,HR,77
00:37,HR,79
01:08,Urine,250
"""


def _records(n=12, seed=7, **kw):
    args = dict(n_vars=4, max_hours=48.0, quantization=2.0, obs_perc=0.25,
                seed=seed)
    args.update(kw)
    return args, n


def _assert_records_equal(a, b):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        assert ra[0] == rb[0]
        for x, y in zip(ra[1:4], rb[1:4]):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(ra[4], rb[4])


def _assert_dicts_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        if a[k] is None or isinstance(a[k], int):
            assert a[k] == b[k], k
        else:
            assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("reduce", ["average", "last"])
def test_parse_record_lines_matches_jax(reduce):
    lines = RAW_RECORD.strip().split("\n")
    got = tpdu.parse_record_lines("132539", lines, 0.5, reduce)
    ref = jpdu.parse_record_lines("132539", lines, 0.5, reduce)
    _assert_records_equal([got + (0.0,)], [ref + (0.0,)])
    assert tpdu.PARAMS == jpdu.PARAMS


@pytest.mark.parametrize("kw", [dict(), dict(n_vars=41, obs_perc=0.05),
                                dict(quantization=0.5, max_hours=10.0)],
                         ids=["small", "41_vars", "fine_bins"])
def test_synthetic_records_match_jax(kw):
    """The stand-in draws the JAX module's numpy stream: the same records
    from a seed."""
    args, n = _records(**kw)
    _assert_records_equal(tpdu.make_synthetic_records(n, **args),
                          jpdu.make_synthetic_records(n, **args))


def test_min_max_and_normalize_match_jax():
    args, n = _records(seed=1, obs_perc=0.3)
    recs = tpdu.make_synthetic_records(n, **args)
    got, ref = tpdu.get_data_min_max(recs), jpdu.get_data_min_max(recs)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
    data = np.stack([r[2] for r in recs[:2]])[:, :3]
    mask = np.stack([r[3] for r in recs[:2]])[:, :3]
    np.testing.assert_array_equal(
        tpdu.normalize_masked_data(data, mask, *got),
        jpdu.normalize_masked_data(data, mask, *ref))


@pytest.mark.parametrize("data_type,eval_input_prob",
                         [("train", None), ("test", None), ("test", 0.5),
                          ("eval", None)])
def test_collate_matches_jax(data_type, eval_input_prob):
    args, n = _records(n=9, seed=3)
    recs = tpdu.make_synthetic_records(n, **args)
    dmin, dmax = tpdu.get_data_min_max(recs)
    got = tpdu.collate_records(recs, dmin, dmax, data_type=data_type,
                               eval_input_prob=eval_input_prob,
                               eval_input_seed=123)
    ref = jpdu.collate_records(recs, dmin, dmax, data_type=data_type,
                               eval_input_prob=eval_input_prob,
                               eval_input_seed=123)
    _assert_dicts_equal(got, ref)


@pytest.mark.parametrize("n", [7, 24, 33, 101, 8000])
def test_split_matches_sklearn(n):
    """``train_test_split_indices`` picks the rows sklearn's
    ``train_test_split(train_size=0.8, random_state=42)`` picks."""
    from sklearn.model_selection import train_test_split

    tr, te = train_test_split(np.arange(n), train_size=0.8, random_state=42,
                              shuffle=True)
    got_tr, got_te = tpdu.train_test_split_indices(n)
    np.testing.assert_array_equal(got_tr, tr)
    np.testing.assert_array_equal(got_te, te)


def test_parse_datasets_matches_jax():
    args, n = _records(n=23, seed=2)
    recs = tpdu.make_synthetic_records(n, **args)
    got = tpdu.parse_datasets("/nonexistent", records=recs)
    ref = jpdu.parse_datasets("/nonexistent", records=recs)
    assert got["input_dim"] == ref["input_dim"] == 4
    _assert_records_equal(got["train_records"], ref["train_records"])
    _assert_records_equal(got["test_records"], ref["test_records"])
    np.testing.assert_array_equal(got["data_min"], ref["data_min"])
    np.testing.assert_array_equal(got["data_max"], ref["data_max"])


def test_metric_and_bounds_match_jax():
    rs = np.random.RandomState(3)
    mu, data = rs.normal(size=(2, 4, 7, 3)).astype(np.float32)
    mask = (rs.random((4, 7, 3)) < 0.4).astype(np.float32)
    assert tpdu.compute_masked_likelihood_mse(mu, data, mask) == \
        jpdu.compute_masked_likelihood_mse(mu, data, mask)
    args, n = _records(n=15, seed=4)
    recs = tpdu.make_synthetic_records(n, **args)
    for bs in (1, 4, 15):
        assert tpdu.max_batch_events(recs, bs) == \
            jpdu.max_batch_events(recs, bs)
    for dt in (2.0 / 48.0, 0.03):
        assert tpdu.max_union_grid_steps(recs, dt, 1 + 1e-12) == \
            jpdu.max_union_grid_steps(recs, dt, 1 + 1e-12)


def test_prestack_matches_jax():
    """The pre-stacked bank equals the JAX module's, and both refuse
    records off the ``delta_t`` grid."""
    args, n = _records(n=10, seed=5, obs_perc=0.3)
    recs = tpdu.make_synthetic_records(n, **args)
    dmin, dmax = tpdu.get_data_min_max(recs)
    T, dt = 1 + 1e-12, 2.0 / 48.0
    K = tpdu.max_union_grid_steps(recs, dt, T)
    got = tpdu.prestack_train_records(recs, dmin, dmax, dt, T, K)
    ref = jpdu.prestack_train_records(recs, dmin, dmax, dt, T, K)
    _assert_dicts_equal(got, ref)
    r0 = recs[0]
    recs[0] = (r0[0], r0[1] + 0.3) + tuple(r0[2:])
    assert tpdu.prestack_train_records(recs, dmin, dmax, dt, T, K) is None


def _write_raw(root, n=3):
    raw = os.path.join(root, "PhysioNet", "raw")
    os.makedirs(os.path.join(raw, "set-a"))
    rs = np.random.RandomState(0)
    ids = []
    for i in range(n):
        rid = str(132539 + i)
        ids.append(rid)
        lines = ["Time,Parameter,Value", f"00:00,RecordID,{rid}"]
        for _ in range(12):
            h, m = rs.randint(0, 48), rs.randint(0, 60)
            p = tpdu.PARAMS[rs.randint(len(tpdu.PARAMS))]
            lines.append(f"{h:02d}:{m:02d},{p},{rs.normal() * 10:.3f}")
        lines[2:] = sorted(lines[2:])
        with open(os.path.join(raw, "set-a", f"{rid}.txt"), "w") as f:
            f.write("\n".join(lines) + "\n")
    with open(os.path.join(raw, "Outcomes-a.txt"), "w") as f:
        f.write("RecordID,a,b,c,d,In-hospital_death\n")
        for i, rid in enumerate(ids):
            f.write(f"{rid},1,2,3,4,{i % 2}\n")


def test_raw_records_and_cache_match_jax(tmp_path):
    """Both packages parse the same raw records into the same cache, and
    each reads the other's cache."""
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    _write_raw(a)
    _write_raw(b)
    got = tpdu.PhysioNetData(a, quantization=0.5, download=True)
    ref = jpdu.PhysioNetData(b, quantization=0.5, download=True)
    _assert_records_equal(got.records, ref.records)
    assert [r[4] for r in got.records] == [0.0, 1.0, 0.0]
    _assert_records_equal(jpdu.PhysioNetData(a, quantization=0.5).records,
                          tpdu.PhysioNetData(b, quantization=0.5).records)


def test_download_gating_never_fetches(tmp_path):
    with pytest.raises(RuntimeError, match="download=True"):
        tpdu.PhysioNetData(str(tmp_path), train=True)
    with pytest.raises(RuntimeError, match="set-b.tar.gz"):
        tpdu.PhysioNetData(str(tmp_path), train=False, download=True)
