"""The port's training layer (steps, trainer, checkpoints, registry) against
the JAX package: the optimizer, one epoch of steps from the same weights,
and the trainer's files on disk."""

import os

import numpy as np
import pytest

import conftest  # noqa: F401

import jax
import jax.numpy as jnp
import optax
import torch

import torch_port_helpers as H
from njode_tpu.training import steps as jsteps
from njode_tpu.training import trainer as jtrainer
from njode_tpu_torch.data import datasets as tdatasets
from njode_tpu_torch.training import steps as tsteps
from njode_tpu_torch.training import trainer as ttrainer
from njode_tpu_torch.training.jax_compat import state_dict_from_jax_params


def _assert_params_close(model, params, **tol):
    ref = state_dict_from_jax_params(jax.tree.map(np.asarray, params))
    got = model.state_dict()
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(),
                                   err_msg=k, **tol)


def test_adam_with_l2_matches_optax():
    """``torch.optim.Adam(lr, weight_decay=5e-4)`` takes the same three
    steps as ``add_decayed_weights(5e-4)`` -> ``adam(lr)``."""
    jcfg, tcfg = H.configs(2, 10)
    params, model = H.twin_models(jcfg, tcfg)
    jopt = jsteps.make_optimizer(1e-3)
    state = jopt.init(params)
    update = jax.jit(jopt.update)
    topt = tsteps.make_optimizer(model.parameters(), 1e-3)
    rs = np.random.RandomState(0)
    for _ in range(3):
        grads = jax.tree.map(
            lambda p: jnp.asarray(rs.normal(size=p.shape).astype(np.float32)),
            params)
        upd, state = update(grads, state, params)
        params = optax.apply_updates(params, upd)
        gsd = state_dict_from_jax_params(jax.tree.map(np.asarray, grads))
        for name, p in model.named_parameters():
            p.grad = gsd[name].clone()
        topt.step()
    _assert_params_close(model, params, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["eager", "fused_plain"])
def test_train_epoch_matches_jax(use_kernels):
    """One epoch of Adam steps over the same index matrix, from the same
    weights, at dropout 0: per-batch losses and final weights agree with
    the JAX ``train_epoch``. ``fused_plain`` runs the kernels' route
    (FusedNJODELoss, its plain versions on the CPU)."""
    jcfg, tcfg = H.configs(1, 10)
    params, model = H.twin_models(jcfg, tcfg, seed=3)
    rs = np.random.RandomState(4)
    N, K, B = 24, 12, 6
    paths = rs.lognormal(0.0, 0.3, size=(N, 1, K + 1)).astype(np.float32)
    obs = (rs.random((N, K + 1)) < 0.3).astype(np.float32)
    idx_mat = rs.permutation(N).reshape(-1, B).astype(np.int32)
    times = (np.arange(1, K + 1) / K).astype(np.float32)
    dts = np.full(K, 1.0 / K, np.float32)

    jopt = jsteps.make_optimizer(1e-3)
    jfns = jsteps.make_step_fns(jcfg, jopt, times, dts)
    params, _, jl = jfns["train_epoch"](
        params, jopt.init(params), jnp.asarray(paths), jnp.asarray(obs),
        jnp.asarray(idx_mat), jnp.float32(0.6), jax.random.PRNGKey(0))

    topt = tsteps.make_optimizer(model.parameters(), 1e-3)
    tfns = tsteps.make_step_fns(model, topt, torch.as_tensor(times),
                                torch.as_tensor(dts),
                                use_kernels=use_kernels)
    tl = tfns["train_epoch"](torch.as_tensor(paths), torch.as_tensor(obs),
                             torch.as_tensor(idx_mat).long(), 0.6,
                             torch.Generator())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4)
    _assert_params_close(model, params, rtol=1e-4, atol=1e-6)
    # the eval loss and the predicted path from the trained weights
    idx = np.arange(N)
    jargs = (jnp.asarray(paths), jnp.asarray(obs), jnp.asarray(idx))
    targs = (torch.as_tensor(paths), torch.as_tensor(obs),
             torch.as_tensor(idx))
    np.testing.assert_allclose(
        float(tfns["eval_loss"](*targs, 0.6)),
        float(jfns["eval_loss"](params, *jargs, jnp.float32(0.6))),
        rtol=1e-4)
    pj = jfns["pred_path"](params, *jargs)
    pt = tfns["pred_path"](*targs)
    for k in ("pred_t", "pred", "pred_bj"):
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]),
                                   rtol=1e-4, atol=1e-6)


def test_trainer_writes_metrics_checkpoints_and_resumes(tmp_path):
    """``trainer.train`` on the CPU: the metric CSV has the JAX trainer's
    columns (pandas reads it), both checkpoint slots are written, and a
    second call with the same id resumes at epoch 3."""
    import pandas as pd

    data = str(tmp_path / "data")
    models = str(tmp_path / "models")
    hp = dict(tdatasets.hyperparam_default, nb_paths=200, nb_steps=20)
    tdatasets.create_dataset("BlackScholes", hp, seed=0, base_path=data,
                             device="cpu")
    kw = dict(batch_size=20, dropout_rate=0.1, dataset="BlackScholes",
              base_data_path=data, saved_models_path=models, evaluate=True,
              device="cpu", hidden_size=6, ode_nn=((16, "tanh"),),
              readout_nn=((16, "tanh"),), enc_nn=((16, "tanh"),))
    assert ttrainer.train(epochs=2, **kw) == 0
    mdir = os.path.join(models, "id-1")
    metric_file = os.path.join(mdir, "metric_id-1.csv")
    df = pd.read_csv(metric_file, index_col=0)
    assert list(df.columns) == jtrainer.METR_COLUMNS + [
        "evaluation_mean_diff"]
    assert list(df["epoch"]) == [1, 2]
    assert np.isfinite(df.to_numpy(dtype=np.float64)).all()
    for slot in ("last_checkpoint", "best_checkpoint"):
        ckpt = torch.load(os.path.join(mdir, slot, "checkpt.tar"),
                          weights_only=True)
        assert set(ckpt) == {"epoch", "weight", "model_state_dict",
                             "optimizer_state_dict"}
    last = torch.load(os.path.join(mdir, "last_checkpoint", "checkpt.tar"),
                      weights_only=True)
    assert last["epoch"] == 2

    assert ttrainer.train(model_id=1, epochs=3, **kw) == 0
    df = pd.read_csv(metric_file, index_col=0)
    assert list(df["epoch"]) == [1, 2, 3]
    assert np.isfinite(df.to_numpy(dtype=np.float64)).all()
    overview = pd.read_csv(os.path.join(models, "model_overview.csv"),
                           index_col=0)
    assert list(overview["id"]) == [1]


@pytest.mark.parametrize("option,value", [
    ("mesh", object()), ("epoch_chunk", 4), ("ema_decay", 0.99),
    ("profile_dir", "p"),
    ("anomaly_detection", True), ("plot", True)])
def test_unported_trainer_options_raise(option, value):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ttrainer.train(**{option: value}, device="cpu")
