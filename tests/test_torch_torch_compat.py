"""The port's reference-checkpoint import and export
(``training/torch_compat.py``) on files the JAX package's
``export_torch_checkpoint`` writes (never on the reference's own files):
the imported model's forward against the JAX forward of the exported
parameters (loss rtol 1e-5 / atol 1e-6), the slot it writes, and the round
trip back through the JAX importer (bit for bit)."""

import os

import numpy as np
import pytest

import conftest  # noqa: F401

import jax
import torch

import torch_port_helpers as H
from njode_tpu.models import njode as jnjode
from njode_tpu.training import torch_compat as jcompat
from njode_tpu_torch.models import njode as tnjode
from njode_tpu_torch.training import checkpoints as tckpt
from njode_tpu_torch.training import torch_compat as tcompat
from njode_tpu_torch.training.steps import make_optimizer


@pytest.mark.parametrize("use_rnn", [False, True])
def test_import_of_a_jax_export_matches_the_jax_forward(tmp_path, use_rnn):
    jcfg, tcfg = H.configs(1, 10, use_rnn=use_rnn)
    params = jnjode.init_params(jax.random.PRNGKey(4), jcfg)
    src = str(tmp_path / "ref" / "last_checkpoint")
    jcompat.export_torch_checkpoint(params, src, epoch=7, weight=0.3,
                                    learning_rate=2e-3)
    ck = tcompat.load_torch_checkpoint(src)
    assert (ck["epoch"], ck["weight"]) == (7, 0.3)

    model = tnjode.NJODE(tcfg)
    opt = make_optimizer(model.parameters(), 1e-3)
    slot = str(tmp_path / "port" / "last_checkpoint")
    assert tcompat.import_torch_checkpoint(src, slot, model, opt) == (7, 0.3)
    assert opt.param_groups[0]["lr"] == 2e-3

    b = H.make_np_batch(seed=2, B=8, steps=15)
    l_ref = jnjode.forward(params, jcfg, H.jbatch(b), train=False)[1]
    with torch.no_grad():
        loss = tnjode.forward(model, H.tbatch(b))[1]
    np.testing.assert_allclose(float(loss), float(l_ref), **H.LOSS_TOL)

    # the slot resumes into a fresh model with the same weights
    fresh = tnjode.NJODE(tcfg)
    fopt = make_optimizer(fresh.parameters(), 1e-3)
    assert tckpt.load_checkpoint(slot, fresh, fopt) == (7, 0.3)
    for (k, a), (_, c) in zip(model.state_dict().items(),
                              fresh.state_dict().items()):
        assert torch.equal(a, c), k


@pytest.mark.parametrize("with_optimizer", [False, True])
def test_export_round_trips_through_the_jax_importer(tmp_path,
                                                    with_optimizer):
    jcfg, tcfg = H.configs(2, 6, use_rnn=True)
    params, model = H.twin_models(jcfg, tcfg, seed=5)
    opt = make_optimizer(model.parameters(), 1e-3)
    if with_optimizer:                # one step: Adam holds moments
        b = H.tbatch(H.make_np_batch(seed=1, B=8, D=2, steps=10))
        tnjode.forward(model, b)[1].backward()
        opt.step()
    out = tcompat.export_torch_checkpoint(
        model, str(tmp_path / "exp"), 3, 0.5,
        optimizer=opt if with_optimizer else None)
    assert os.path.basename(out) == "checkpt.tar"
    ck = jcompat.load_torch_checkpoint(str(tmp_path / "exp"))
    assert (ck["epoch"], ck["weight"]) == (3, 0.5)
    back = jcompat.njode_params_from_torch_state(ck["state"], use_rnn=True)
    sd = model.state_dict()
    want = jcompat.njode_params_from_torch_state(
        {k: v.numpy() for k, v in sd.items()}, use_rnn=True)
    np.testing.assert_array_equal(H.flat(back), H.flat(want))
    if not with_optimizer:
        np.testing.assert_array_equal(
            H.flat(back), H.flat(jax.tree.map(np.asarray, params)))
    raw = torch.load(out, weights_only=True)
    assert len(raw["optimizer_state_dict"]["param_groups"][0]["params"]) \
        == len(sd)
    if with_optimizer:
        model2 = tnjode.NJODE(tcfg)
        opt2 = make_optimizer(model2.parameters(), 1e-3)
        tcompat.import_torch_checkpoint(str(tmp_path / "exp"),
                                        str(tmp_path / "slot"), model2, opt2)
        s1, s2 = opt.state_dict()["state"], opt2.state_dict()["state"]
        assert set(s1) == set(s2)
        for i in s1:
            assert torch.equal(s1[i]["exp_avg"], s2[i]["exp_avg"])
