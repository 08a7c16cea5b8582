"""The port's climate training layer against the JAX package: an epoch of
the pre-stacked and the sparse step functions from the same weights over
the same batches at dropout 0 (NJODE, masked, eager and through the fused
kernels' plain versions; GRU-ODE-Bayes), the held-out evaluation, and
``climate_trainer.train`` end to end on the CPU (metric CSV, checkpoints,
resume). Losses to rtol 1e-5 / atol 1e-6, parameters after Adam to rtol
2e-4 / atol 2e-5 (GRU-ODE-Bayes: atol scaled by ``gob_grad_tol``)."""

import os

import numpy as np
import pytest

import conftest  # noqa: F401

import jax
import jax.numpy as jnp
import torch

import torch_port_helpers as H
from njode_tpu.models import gru_ode_bayes as jgob
from njode_tpu.training import climate_trainer as jct
from njode_tpu.training import steps as jsteps
from njode_tpu_torch.data import climate as tcdu
from njode_tpu_torch.data import grid as tgrid
from njode_tpu_torch.models import gru_ode_bayes as tgob
from njode_tpu_torch.training import climate_trainer as tct
from njode_tpu_torch.training import steps as tsteps
from njode_tpu_torch.training.jax_compat import (
    gob_jax_params_from_state_dict, gob_state_dict_from_jax_params,
    state_dict_from_jax_params)

NN = ((8, "tanh"),)
T, DT, B = 5.0, 0.1, 6
VAL = {"T_val": 3.0, "max_val_samples": 3}


@pytest.fixture(scope="module")
def clim(tmp_path_factory):
    """A small stand-in (16 series, 3 variables, T = 5), fold 0's splits,
    the pre-stacked training bank with its sentinel row, the epoch-1
    batches and the full validation batch."""
    d = str(tmp_path_factory.mktemp("climate_steps"))
    csv = os.path.join(d, "small_chunked_sporadic.csv")
    tcdu.make_synthetic_climate_csv(csv, n_series=16, n_vars=3, T=T,
                                    obs_perc=0.1, seed=5)
    tcdu.make_fold_indices(d, n_series=16, n_folds=1, seed=2)
    f = os.path.join(d, "small_chunk_fold_idx_0")
    tr, va = (np.load(os.path.join(f, f"{s}_idx.npy"))
              for s in ("train", "val"))
    train = tcdu.ClimateDataset(csv, idx=tr)
    val = tcdu.ClimateDataset(csv, idx=va, validation=True, val_options=VAL)
    K = max(train.max_grid_steps(DT, T), val.max_grid_steps(DT, T))
    pre = tcdu.prestack_series(train, DT, T, K)
    E = pre["k"].shape[1]
    bank = (np.concatenate([pre["k"], np.full((1, E), K, np.int32)]),
            np.concatenate([pre["X"], np.zeros((1, E, 3), np.float32)]),
            np.concatenate([pre["M"], np.zeros((1, E, 3), np.float32)]))
    idx_mat, scales, _ = tct.epoch_batches(398, 1, len(train), B)
    ev = val.collate(np.arange(len(val)))
    sb = tgrid.sparse_from_events(ev, DT, T, K, max_events=len(ev["obs_idx"]))
    k = tgrid.nearest_grid_steps(sb.times, ev["times_val"])
    pairs = (k.astype(np.int64), ev["index_val"].astype(np.int64),
             ev["X_val"], ev["M_val"])
    with open(os.path.join(d, "cov.csv"), "w") as fh:
        fh.write("ID,c0,c1\n")
        for i, c in enumerate(np.random.RandomState(1).normal(size=(16, 2))):
            fh.write(f"{i},{float(c[0])!r},{float(c[1])!r}\n")
    sbs = [tgrid.sparse_from_events(train.collate(i[i < len(train)]), DT, T,
                                    K, max_events=train.max_batch_events(B),
                                    pad_batch_to=B) for i in idx_mat]
    return dict(d=d, pre=pre, bank=bank, idx_mat=idx_mat, scales=scales,
                sb_val=sb, pairs=pairs, sbs=sbs)


def _jtree(t):
    return jax.tree.map(jnp.asarray, t)


def _tstack(sbs):
    return tgrid.sparse_to_torch(
        type(sbs[0])(*(np.stack(f) for f in zip(*sbs))), "cpu")


def _close_params(got_sd, ref_sd, **tol):
    assert set(got_sd) == set(ref_sd)
    for k in ref_sd:
        np.testing.assert_allclose(got_sd[k].numpy(), ref_sd[k].numpy(),
                                   err_msg=k, **tol)


def _heldout_jax(fn, params, sb, pairs, *rest):
    return fn(params, _jtree(sb), *(jnp.asarray(a) for a in pairs), *rest)


def _heldout_torch(fns, sb, pairs, *rest):
    return fns["eval_loss_and_heldout_mse"](
        tgrid.sparse_to_torch(sb, "cpu"),
        *(torch.as_tensor(np.asarray(a)) for a in pairs), *rest)


@pytest.mark.parametrize("bank", [True, False], ids=["prestacked", "sparse"])
@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["eager", "fused_plain"])
def test_njode_epoch_matches_jax(clim, bank, use_kernels):
    """One epoch of Adam steps over fold 0's epoch-1 batches (the sentinel
    row pads the short batch, its loss scaled by B/len) from the same
    weights, then the held-out evaluation of the validation split."""
    jcfg, tcfg = H.configs(3, 6, ode_nn=NN, readout_nn=NN, enc_nn=NN,
                           masked=True)
    params, model = H.twin_models(jcfg, tcfg, seed=4)
    jopt = jsteps.make_optimizer(1e-3)
    topt = tsteps.make_optimizer(model.parameters(), 1e-3)
    n = len(clim["idx_mat"])
    rngs = jnp.stack([jax.random.PRNGKey(i) for i in range(n)])
    scales = jnp.asarray(clim["scales"], jnp.float32)
    gens = [torch.Generator() for _ in range(n)]
    sfns = jsteps.make_sparse_step_fns(jcfg, jopt)
    if bank:
        times, dts = clim["pre"]["times"], clim["pre"]["dt"]
        jfns = jsteps.make_prestacked_step_fns(jcfg, jopt, times, dts)
        params, _, jl = jfns["train_epoch"](
            params, jopt.init(params), *(jnp.asarray(a) for a in clim["bank"]),
            jnp.asarray(clim["idx_mat"], jnp.int32), jnp.float32(0.6), rngs,
            scales)
        tfns = tsteps.make_prestacked_step_fns(
            model, topt, torch.as_tensor(times), torch.as_tensor(dts),
            use_kernels=use_kernels)
        tl = tfns["train_epoch"](
            *(torch.as_tensor(a) for a in clim["bank"]),
            torch.as_tensor(clim["idx_mat"]), 0.6, gens, clim["scales"])
    else:
        stack = type(clim["sbs"][0])(*(np.stack(f)
                                       for f in zip(*clim["sbs"])))
        params, _, jl = sfns["train_epoch"](
            params, jopt.init(params), _jtree(stack), jnp.float32(0.6), rngs,
            scales)
        tfns = tsteps.make_sparse_step_fns(model, topt,
                                           use_kernels=use_kernels)
        tl = tfns["train_epoch"](_tstack(clim["sbs"]), 0.6, gens,
                                 clim["scales"])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **H.LOSS_TOL)
    _close_params(model.state_dict(),
                  state_dict_from_jax_params(jax.tree.map(np.asarray,
                                                          params)),
                  **H.GRAD_TOL)
    ref = _heldout_jax(sfns["eval_loss_and_heldout_mse"], params,
                       clim["sb_val"], clim["pairs"], jnp.float32(0.6),
                       jnp.float32(1.0))
    got = _heldout_torch(tsteps.make_sparse_step_fns(model, topt),
                         clim["sb_val"], clim["pairs"], 0.6)
    for a, r in zip(got, ref):
        np.testing.assert_allclose(float(a), float(r), **H.LOSS_TOL)


def _gob_cfgs(D=3, **kw):
    args = dict(D=D, hidden_size=6, p_hidden=5, prep_hidden=3, cov_size=D,
                cov_hidden=6, mixing=1e-4, full_gru_ode=True, impute=False,
                logvar=True)
    args.update(kw)
    return H.gob_configs(**args)


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["eager", "fused_plain"])
def test_gob_epoch_matches_jax(clim, use_kernels):
    """The GRU-ODE-Bayes climate arm's step functions (full field, impute
    off, logvar, unequal widths): a pre-stacked epoch and the held-out
    evaluation against the JAX functions."""
    jcfg, tcfg = _gob_cfgs()
    params, model = H.gob_twin_models(jcfg, tcfg, seed=2)
    jopt = jsteps.make_optimizer(1e-3)
    topt = tsteps.make_optimizer(model.parameters(), 1e-3)
    times, dts = clim["pre"]["times"], clim["pre"]["dt"]
    n = len(clim["idx_mat"])
    jfns = jgob.make_prestacked_step_fns(jcfg, jopt, times, dts)
    params, _, jl = jfns["train_epoch"](
        params, jopt.init(params), *(jnp.asarray(a) for a in clim["bank"]),
        jnp.asarray(clim["idx_mat"], jnp.int32), jnp.float32(0.5),
        jnp.stack([jax.random.PRNGKey(i) for i in range(n)]),
        jnp.ones(n, jnp.float32))
    tfns = tgob.make_prestacked_step_fns(
        model, topt, torch.as_tensor(times), torch.as_tensor(dts),
        use_kernels=use_kernels)
    tl = tfns["train_epoch"](*(torch.as_tensor(a) for a in clim["bank"]),
                             torch.as_tensor(clim["idx_mat"]), 0.5,
                             [torch.Generator() for _ in range(n)],
                             [1.0] * n)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **H.LOSS_TOL)
    ref_sd = gob_state_dict_from_jax_params(jax.tree.map(np.asarray, params))
    tol = H.gob_grad_tol(H.flat(params))
    _close_params(model.state_dict(), ref_sd, **tol)
    ref = _heldout_jax(jgob.make_sparse_step_fns(jcfg, jopt)[
        "eval_loss_and_heldout_mse"], params, clim["sb_val"], clim["pairs"],
        jnp.float32(0.5), jnp.float32(1.0))
    got = _heldout_torch(tgob.make_sparse_step_fns(model, topt),
                         clim["sb_val"], clim["pairs"], 0.5)
    for a, r in zip(got, ref):
        np.testing.assert_allclose(float(a), float(r), **H.LOSS_TOL)


def test_gob_climate_widths_carry_across():
    """The GOB climate arm's widths (D 5, hidden 50, p_hidden 25,
    prep_hidden 10, cov_hidden 50) carry across both ways."""
    jcfg, tcfg = _gob_cfgs(D=5, hidden_size=50, p_hidden=25, prep_hidden=10,
                           cov_hidden=50, dropout_rate=0.2)
    params, model = H.gob_twin_models(jcfg, tcfg)
    assert tuple(model.gru_obs.w_prep.shape) == (5, 4, 10)
    assert tuple(model.p_model[0].weight.shape) == (25, 50)
    back = gob_jax_params_from_state_dict(model.state_dict())
    np.testing.assert_array_equal(H.flat(back), H.flat(params))


def _train(clim, tmp, **kw):
    return tct.train(epochs=kw.pop("epochs", 2), batch_size=B,
                     hidden_size=6, ode_nn=NN, readout_nn=NN, enc_nn=NN,
                     device="cpu", climate_dir=clim["d"], T=T, T_val=3.0,
                     saved_models_path=str(tmp), **kw)


@pytest.mark.parametrize("kw", [
    dict(use_pallas=True), dict(prestack=False, use_pallas=True),
    dict(other_model="GRU_ODE_Bayes", use_pallas=True,
         **{"GRU_ODE_Bayes-p_hidden": 5, "GRU_ODE_Bayes-prep_hidden": 3}),
    dict(other_model="GRU_ODE_Bayes", cov_file="cov.csv", use_pallas=True,
         **{"GRU_ODE_Bayes-p_hidden": 5, "GRU_ODE_Bayes-prep_hidden": 3}),
    dict(use_rnn=True, use_pallas=True)],
    ids=["njode_kernels", "njode_collate", "gob_kernels", "gob_cov_file",
         "njode_rnn_kernels"])
def test_climate_trainer_end_to_end(clim, tmp_path, kw, capsys):
    """Two epochs on the CPU: the metric CSV has the JAX trainer's columns
    with finite values, both checkpoint slots hold the model, and a second
    call with the same id resumes at epoch 3."""
    import pandas as pd

    assert _train(clim, tmp_path, **kw) == 0
    out = capsys.readouterr().out
    assert ("prestacked training bank: ON" in out) == \
        (kw.get("prestack", True))
    assert "training loss: fused" in out
    mdir = os.path.join(str(tmp_path), "id-1")
    metric_file = os.path.join(mdir, "metric_id-1.csv")
    df = pd.read_csv(metric_file, index_col=0)
    assert list(df.columns) == jct.METR_COLUMNS
    assert list(df["epoch"]) == [1, 2]
    assert np.isfinite(df.to_numpy(np.float64)).all()
    for slot in ("last_checkpoint", "best_checkpoint"):
        ckpt = torch.load(os.path.join(mdir, slot, "checkpt.tar"),
                          weights_only=True)
        assert set(ckpt) == {"epoch", "weight", "model_state_dict",
                             "optimizer_state_dict"}
    if "other_model" in kw:
        sd = ckpt["model_state_dict"]
        assert "gru_obs.w_prep" in sd
        # real covariates feed covariates_map: its input is their width
        assert sd["covariates_map.0.weight"].shape[1] == (
            2 if "cov_file" in kw else 3)
        return
    assert _train(clim, tmp_path, model_id=1, epochs=3, **kw) == 0
    df = pd.read_csv(metric_file, index_col=0)
    assert list(df["epoch"]) == [1, 2, 3]
    assert np.isfinite(df.to_numpy(np.float64)).all()


def test_climate_trainer_options(clim, tmp_path, capsys):
    """'mesh' takes a ``parallel.sharding.Mesh`` (its runs:
    tests/test_torch_parallel_trainers.py) and refuses anything else; on
    the CPU the default training loss is the eager forward, and the
    initial print says so."""
    with pytest.raises(ValueError, match="1-D .*Mesh"):
        _train(clim, tmp_path, mesh=object())
    assert _train(clim, tmp_path, epochs=1) == 0
    assert "training loss: eager forward" in capsys.readouterr().out
    # the batches of an epoch are the JAX trainer's permutation
    idx, scales, starts = tct.epoch_batches(398, 2, 11, 4)
    perm = np.random.RandomState((398 * 100_003 + 2) % 2 ** 32).permutation(
        11)
    np.testing.assert_array_equal(idx.reshape(-1)[:11], perm)
    assert list(idx[-1]) == list(perm[8:]) + [11]
    assert scales == [1.0, 1.0, 4 / 3] and starts == [0, 4, 8]
