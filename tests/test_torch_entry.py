"""The port's entry points (njode_tpu_torch/entry.py) against the repo's
``__graft_entry__.py``: the flagship's arrays bit for bit, its eval-mode
loss against the JAX ``njode.forward`` with the JAX parameters carried
across (rtol 1e-5 / atol 1e-6), and the dry run at four gloo ranks on the
CPU, which checks every part of ``dryrun_multichip`` at its tolerances."""

import numpy as np
import pytest

import conftest  # noqa: F401

import jax
import torch

import __graft_entry__ as ge
import torch_port_helpers as H
from njode_tpu.models import njode as jnjode
from njode_tpu_torch import entry


@pytest.fixture(scope="module")
def flagship():
    return ge._flagship(), entry.entry(device="cpu")


def test_flagship_arrays_equal_graft_entry_bit_for_bit(flagship):
    (jcfg, _, jb), (_, (model, tb, _)) = flagship
    for f in jb._fields:
        a, b = np.asarray(getattr(jb, f)), getattr(tb, f).numpy()
        assert a.dtype == b.dtype and np.array_equal(a, b), f
    assert model.cfg == entry.flagship("cpu")[0]
    assert (model.cfg.hidden_size, model.cfg.ode_nn, model.cfg.dropout_rate,
            tb.start_X.shape[0], tb.times.shape[0]) == (
        jcfg.hidden_size, jcfg.ode_nn, jcfg.dropout_rate, 200, 100)


def test_entry_eval_loss_matches_jax_forward(flagship):
    (jcfg, params, jb), (fn, (model, tb, gen)) = flagship
    model.load_state_dict(H.state_dict_from_jax_params(
        jax.tree.map(np.asarray, params)))
    _, ref = jnjode.forward(params, jcfg, jb, weight=0.5, train=False,
                            get_loss=True)
    with torch.no_grad():
        got = fn(model, tb, gen, train=False)
    np.testing.assert_allclose(float(got), float(ref), **H.LOSS_TOL)
    loss = fn(model, tb, gen)
    assert np.isfinite(float(loss.detach())) and loss.requires_grad


@pytest.mark.subprocess
def test_dryrun_multichip_four_cpu_ranks(capsys):
    res = entry.dryrun_multichip(4, device="cpu")
    assert "dryrun_multichip(4, cpu, gloo): ok" in capsys.readouterr().out
    assert np.isfinite(res["loss_tp"]) and "dparam_tp" in res
    assert "dgrad" in res and "dgrad_tp" in res
    assert res["dloss"] <= 1e-5 * max(1.0, abs(res["loss"]))


@pytest.mark.parametrize("call", ["entry", "dryrun"])
def test_entry_points_raise_without_a_card(monkeypatch, call):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fn = {"entry": entry.entry,
          "dryrun": lambda: entry.dryrun_multichip(2)}[call]
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        fn()
