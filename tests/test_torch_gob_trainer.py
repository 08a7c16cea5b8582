"""The port's GRU-ODE-Bayes training layer against the JAX package: one
epoch of Adam steps from the same weights, and the trainer's files on
disk."""

import os

import numpy as np
import pytest

import conftest  # noqa: F401

import jax
import jax.numpy as jnp
import torch

import torch_port_helpers as H
from njode_tpu.models import gru_ode_bayes as jgob
from njode_tpu.training import steps as jsteps
from njode_tpu.training import trainer as jtrainer
from njode_tpu_torch.data import datasets as tdatasets
from njode_tpu_torch.models import gru_ode_bayes as tgob
from njode_tpu_torch.training import steps as tsteps
from njode_tpu_torch.training import trainer as ttrainer
from njode_tpu_torch.training.jax_compat import \
    gob_state_dict_from_jax_params


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["eager", "fused_plain"])
def test_train_epoch_matches_jax(use_kernels):
    """One epoch of Adam (+ L2 5e-4) steps over the same index matrix,
    from the same weights, at dropout 0: per-batch losses and every weight
    after the epoch (classification_model included, which only the L2 term
    moves) agree with the JAX ``train_epoch``. ``fused_plain`` runs the
    kernels' route (FusedGOBLoss, its plain versions on the CPU)."""
    jcfg, tcfg = H.gob_configs(D=1, full_gru_ode=True, impute=True,
                               mixing=1e-4)
    params, model = H.gob_twin_models(jcfg, tcfg, seed=3)
    rs = np.random.RandomState(4)
    N, K, B = 24, 12, 6
    paths = rs.lognormal(0.0, 0.3, size=(N, 1, K + 1)).astype(np.float32)
    obs = (rs.random((N, K + 1)) < 0.3).astype(np.float32)
    idx_mat = rs.permutation(N).reshape(-1, B).astype(np.int32)
    times = (np.arange(1, K + 1) / K).astype(np.float32)
    dts = np.full(K, 1.0 / K, np.float32)

    jopt = jsteps.make_optimizer(1e-3)
    jfns = jgob.make_step_fns(jcfg, jopt, times, dts)
    params, _, jl = jfns["train_epoch"](
        params, jopt.init(params), jnp.asarray(paths), jnp.asarray(obs),
        jnp.asarray(idx_mat), jnp.float32(0.5), jax.random.PRNGKey(0))

    topt = tsteps.make_optimizer(model.parameters(), 1e-3)
    tfns = tgob.make_step_fns(model, topt, torch.as_tensor(times),
                              torch.as_tensor(dts), use_kernels=use_kernels)
    tl = tfns["train_epoch"](torch.as_tensor(paths), torch.as_tensor(obs),
                             torch.as_tensor(idx_mat).long(), 0.5,
                             torch.Generator())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4)
    ref = gob_state_dict_from_jax_params(jax.tree.map(np.asarray, params))
    got = model.state_dict()
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=k)
    # the eval loss and the predicted path from the trained weights
    idx = np.arange(N)
    jargs = (jnp.asarray(paths), jnp.asarray(obs), jnp.asarray(idx))
    targs = (torch.as_tensor(paths), torch.as_tensor(obs),
             torch.as_tensor(idx))
    np.testing.assert_allclose(
        float(tfns["eval_loss"](*targs, 0.5)),
        float(jfns["eval_loss"](params, *jargs, jnp.float32(0.5))),
        rtol=1e-4)
    pj = jfns["pred_path"](params, *jargs)
    pt = tfns["pred_path"](*targs)
    for k in ("pred_t", "pred", "pred_bj"):
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]),
                                   rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["eager", "fused_plain"])
def test_trainer_gob_writes_metrics_and_checkpoints(tmp_path, use_pallas):
    """``trainer.train(other_model="GRU_ODE_Bayes")`` on the CPU: the
    metric CSV has the JAX trainer's columns with ``optimal_eval_loss``
    NaN and every other value finite, and both checkpoint slots hold the
    GOB module's state."""
    import pandas as pd

    data = str(tmp_path / "data")
    models = str(tmp_path / "models")
    hp = dict(tdatasets.hyperparam_default, nb_paths=60, nb_steps=10)
    tdatasets.create_dataset("BlackScholes", hp, seed=0, base_path=data,
                             device="cpu")
    assert ttrainer.train(
        epochs=1, batch_size=16, dropout_rate=0.1, dataset="BlackScholes",
        base_data_path=data, saved_models_path=models, evaluate=True,
        device="cpu", hidden_size=6, other_model="GRU_ODE_Bayes",
        use_pallas=use_pallas,
        **{"GRU_ODE_Bayes-impute": True, "GRU_ODE_Bayes-logvar": True,
           "GRU_ODE_Bayes-mixing": 1e-4}) == 0
    mdir = os.path.join(models, "id-1")
    df = pd.read_csv(os.path.join(mdir, "metric_id-1.csv"), index_col=0)
    assert list(df.columns) == jtrainer.METR_COLUMNS + [
        "evaluation_mean_diff"]
    assert list(df["epoch"]) == [1]
    assert np.isnan(df["optimal_eval_loss"]).all()
    rest = df.drop(columns=["optimal_eval_loss"]).to_numpy(np.float64)
    assert np.isfinite(rest).all()
    for slot in ("last_checkpoint", "best_checkpoint"):
        ckpt = torch.load(os.path.join(mdir, slot, "checkpt.tar"),
                          weights_only=True)
        assert ckpt["epoch"] == 1
        assert "gru_obs.w_prep" in ckpt["model_state_dict"]
        assert "classification_model.0.weight" in ckpt["model_state_dict"]


def test_trainer_rejects_unknown_other_model(tmp_path):
    data = str(tmp_path / "data")
    hp = dict(tdatasets.hyperparam_default, nb_paths=20, nb_steps=5)
    tdatasets.create_dataset("BlackScholes", hp, seed=0, base_path=data,
                             device="cpu")
    with pytest.raises(ValueError, match="other_model"):
        ttrainer.train(epochs=1, dataset="BlackScholes", base_data_path=data,
                       saved_models_path=str(tmp_path / "models"),
                       device="cpu", other_model="Seq_GRU_ODE_Bayes")
