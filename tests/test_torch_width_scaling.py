"""The port's width-scaling study (``experiments/width_scaling.py``): its
path draws bit for bit the JAX study's, ``card_side`` on the CPU at tiny
widths (the kernels' plain versions where ``fused_scan.supported``), the
table and JSON of ``main``, and ``ref_side`` refusing while the reference
code is not in the repository. Tolerance: the draws exactly."""

import json

import numpy as np
import pytest

import conftest  # noqa: F401

from njode_tpu.experiments import width_scaling as jws
from njode_tpu_torch.experiments import width_scaling as tws
from njode_tpu_torch.ops import fused_scan


@pytest.mark.parametrize("n,seed", [(37, 0), (200, 5)])
def test_sim_paths_match_jax_bit_for_bit(n, seed):
    p, o = tws._sim_paths(n, seed)
    jp, jo = jws._sim_paths(n, seed)
    assert p.dtype == jp.dtype and o.dtype == jo.dtype
    np.testing.assert_array_equal(p, jp)
    np.testing.assert_array_equal(o, jo)


def test_config_matches_jax():
    for w in (50, 400):
        assert tws._cfg(w, 50).__dict__ == {
            k: v for k, v in jws._cfg(w, 50).__dict__.items()}


def test_card_side_on_the_cpu_at_tiny_widths(tmp_path):
    out = tws.main(str(tmp_path / "ws.json"), device="cpu", widths=(6, 12),
                   hidden=3, n_paths=40, batch_size=20, n_rep=1)
    rows = out["rows"]
    assert [r["width"] for r in rows] == [6, 12]
    for r in rows:
        spec = fused_scan.Spec(tws._cfg(r["width"], 3))
        assert r["kernel"] and r["plan"] == spec.plan
        assert r["rows_bwd"] == spec.rows_for(20, True)
        assert np.isfinite(r["last_loss"]) and r["paths_per_sec"] > 0
        assert r["launches"] == {}        # plain versions on the CPU
    saved = json.loads((tmp_path / "ws.json").read_text())
    assert saved["rows"] == rows and saved["config"]["batch_size"] == 20
    table = tws.table(rows)
    assert table.count("\n") == 3 and "resident / 1, 1" in table
    with pytest.raises(NotImplementedError, match="not in this repository"):
        tws.main(str(tmp_path / "ws2.json"), run_ref=True, device="cpu",
                 widths=(6,), hidden=3, n_paths=20, batch_size=20, n_rep=1)


def test_card_side_refuses_to_run_on_the_cpu_when_asked_for_the_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA card"):
        tws.card_side(widths=(6,), n_paths=20, batch_size=20)
