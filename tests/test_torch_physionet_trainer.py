"""The port's PhysioNet training layer against the JAX package: an epoch of
the pre-stacked and of the sparse step functions from the same weights over
the same batches at dropout 0 (eager and through the fused kernels' plain
versions), the on-device evaluation ``eval_loss_and_masked_metrics``, the
weight carrier at the PhysioNet widths, and
``physionet_trainer.train`` end to end on the CPU (metric CSV, checkpoints,
resume). Losses to rtol 1e-5 / atol 1e-6, parameters after Adam to rtol
2e-4 / atol 2e-5."""

import os

import numpy as np
import pytest

import conftest  # noqa: F401

import jax
import jax.numpy as jnp
import torch

import torch_port_helpers as H
from njode_tpu.training import physionet_trainer as jpt
from njode_tpu.training import steps as jsteps
from njode_tpu_torch.data import grid as tgrid
from njode_tpu_torch.data import physionet as tpdu
from njode_tpu_torch.ops import fused_scan as fs
from njode_tpu_torch.training import climate_trainer as tct
from njode_tpu_torch.training import physionet_trainer as tpt
from njode_tpu_torch.training import steps as tsteps
from njode_tpu_torch.training.jax_compat import (jax_params_from_state_dict,
                                                 state_dict_from_jax_params)

NN = ((8, "tanh"),)
B = 6
T = 1 + 1e-12
DT = 2.0 / 48.0


@pytest.fixture(scope="module")
def phys():
    """A small stand-in (20 records, 4 variables, 2-hour bins), its split,
    the pre-stacked bank with its sentinel row, the epoch-1 batches as
    collated sparse batches, and the held-out test batch."""
    recs = tpdu.make_synthetic_records(20, n_vars=4, quantization=2.0,
                                       obs_perc=0.25, seed=11)
    data = tpdu.parse_datasets("/nonexistent", records=recs)
    tr, te = data["train_records"], data["test_records"]
    dmin, dmax = data["data_min"], data["data_max"]
    K = tpdu.max_union_grid_steps(tr + te, DT, T)
    pre = tpdu.prestack_train_records(tr, dmin, dmax, DT, T, K)
    E = pre["k"].shape[1]
    bank = (np.concatenate([pre["k"], np.full((1, E), K, np.int32)]),
            np.concatenate([pre["X"], np.zeros((1, E, 4), np.float32)]),
            np.concatenate([pre["M"], np.zeros((1, E, 4), np.float32)]))
    idx_mat, scales, _ = tct.epoch_batches(398, 1, len(tr), B)
    max_ev = tpdu.max_batch_events(tr, B)
    sbs = []
    for idx in idx_mat:
        c = tpdu.collate_records([tr[i] for i in idx if i < len(tr)], dmin,
                                 dmax, data_type="train")
        sbs.append(tgrid.sparse_from_events(c, DT, T, K, max_events=max_ev,
                                            pad_batch_to=B))
    tc = tpdu.collate_records(te, dmin, dmax, data_type="test")
    sb_test = tgrid.sparse_from_events(tc, DT, T, K,
                                       max_events=len(tc["obs_idx"]))
    k_val = tgrid.nearest_grid_steps(sb_test.times, tc["times_val"])
    return dict(recs=recs, pre=pre, bank=bank, idx_mat=idx_mat,
                scales=scales, sbs=sbs, sb_test=sb_test,
                heldout=(k_val.astype(np.int64), tc["vals_val"],
                         tc["mask_val"]))


def _jtree(t):
    return jax.tree.map(jnp.asarray, t)


def _close_params(got_sd, ref_sd, **tol):
    assert set(got_sd) == set(ref_sd)
    for k in ref_sd:
        np.testing.assert_allclose(got_sd[k].numpy(), ref_sd[k].numpy(),
                                   err_msg=k, **tol)


def _twins(seed=4):
    jcfg, tcfg = H.configs(4, 8, ode_nn=NN, readout_nn=NN, enc_nn=NN,
                           masked=True)
    return jcfg, tcfg, *H.twin_models(jcfg, tcfg, seed=seed)


@pytest.mark.parametrize("bank", [True, False], ids=["prestacked", "sparse"])
@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["eager", "fused_plain"])
def test_epoch_matches_jax(phys, bank, use_kernels):
    """One epoch of Adam steps over the epoch-1 batches (the sentinel row
    pads the short batch, its loss scaled by B/len) from the same weights:
    the same per-batch losses and parameters."""
    jcfg, tcfg, params, model = _twins()
    jopt = jsteps.make_optimizer(1e-3)
    topt = tsteps.make_optimizer(model.parameters(), 1e-3)
    n = len(phys["idx_mat"])
    rngs = jnp.stack([jax.random.PRNGKey(i) for i in range(n)])
    scales = jnp.asarray(phys["scales"], jnp.float32)
    gens = [torch.Generator() for _ in range(n)]
    if bank:
        times, dts = phys["pre"]["times"], phys["pre"]["dt"]
        jfns = jsteps.make_prestacked_step_fns(jcfg, jopt, times, dts)
        params, _, jl = jfns["train_epoch"](
            params, jopt.init(params),
            *(jnp.asarray(a) for a in phys["bank"]),
            jnp.asarray(phys["idx_mat"], jnp.int32), jnp.float32(0.6), rngs,
            scales)
        tfns = tsteps.make_prestacked_step_fns(
            model, topt, torch.as_tensor(times), torch.as_tensor(dts),
            use_kernels=use_kernels)
        tl = tfns["train_epoch"](
            *(torch.as_tensor(a) for a in phys["bank"]),
            torch.as_tensor(phys["idx_mat"]), 0.6, gens, phys["scales"])
    else:
        stack = type(phys["sbs"][0])(*(np.stack(f)
                                       for f in zip(*phys["sbs"])))
        params, _, jl = jsteps.make_sparse_step_fns(jcfg, jopt)[
            "train_epoch"](params, jopt.init(params), _jtree(stack),
                           jnp.float32(0.6), rngs, scales)
        tfns = tsteps.make_sparse_step_fns(model, topt,
                                           use_kernels=use_kernels)
        tl = tfns["train_epoch"](tgrid.sparse_to_torch(stack, "cpu"), 0.6,
                                 gens, phys["scales"])
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **H.LOSS_TOL)
    _close_params(model.state_dict(),
                  state_dict_from_jax_params(jax.tree.map(np.asarray,
                                                          params)),
                  **H.GRAD_TOL)


@pytest.mark.parametrize("loss_scale", [1.0, 1.5])
def test_eval_masked_metrics_match_jax(phys, loss_scale):
    """The loss, the masked squared-error sum and count at the held-out
    points, and the per-(patient, dim) metric."""
    jcfg, tcfg, params, model = _twins(seed=6)
    k, xv, mv = phys["heldout"]
    ref = jsteps.make_sparse_step_fns(jcfg, jsteps.make_optimizer(1e-3))[
        "eval_loss_and_masked_metrics"](
        params, _jtree(phys["sb_test"]), jnp.asarray(k), jnp.asarray(xv),
        jnp.asarray(mv), jnp.float32(0.6), jnp.float32(loss_scale))
    got = tsteps.make_sparse_step_fns(
        model, tsteps.make_optimizer(model.parameters(), 1e-3))[
        "eval_loss_and_masked_metrics"](
        tgrid.sparse_to_torch(phys["sb_test"], "cpu"), torch.as_tensor(k),
        torch.as_tensor(xv), torch.as_tensor(mv), 0.6, loss_scale)
    assert float(got[2]) > 0
    for a, r in zip(got, ref):
        np.testing.assert_allclose(float(a), float(r), **H.LOSS_TOL)


def test_physionet_widths_carry_across():
    """The 50 and 200 arms' weights (D = H = 41) carry across both ways;
    the 50 arm runs the kernels' resident plan (8 rows the most that fit,
    one a CTA at the trainer's batch of 50), the 200 arm the global plan at
    8 (its K1/K3 at two rows a CTA at the trainer's batch: the global
    forward rule's fewest rows with every CTA resident at once, at least
    two where no net is wider than a CTA's threads)."""
    for w, plan, rows in ((50, "resident", 8), (200, "global", 8)):
        nn = ((w, "tanh"), (w, "tanh"))
        jcfg, tcfg = H.configs(41, 41, ode_nn=nn, readout_nn=nn, enc_nn=nn,
                               masked=True, dropout_rate=0.1)
        params, model = H.twin_models(jcfg, tcfg)
        back = jax_params_from_state_dict(model.state_dict())
        np.testing.assert_array_equal(H.flat(back), H.flat(params))
        spec = fs.Spec(tcfg)
        assert (spec.plan, spec.rows) == (plan, rows)
        assert spec.rows_for(50) == (1 if plan == "resident" else rows)
        assert spec.rows_for(50, False) == (1 if plan == "resident" else 2)


def _train(phys, tmp, **kw):
    return tpt.train(epochs=kw.pop("epochs", 2), batch_size=B,
                     hidden_size=8, ode_nn=NN, readout_nn=NN, enc_nn=NN,
                     quantization=2.0, n_samples=20, device="cpu",
                     records=phys["recs"], saved_models_path=str(tmp), **kw)


@pytest.mark.parametrize("kw", [dict(use_pallas=True),
                                dict(prestack=False, use_pallas=True,
                                     eval_input_prob=0.5),
                                dict(use_rnn=True, use_pallas=True)],
                         ids=["prestacked", "collate_eval_input",
                              "prestacked_rnn"])
def test_physionet_trainer_end_to_end(phys, tmp_path, kw, capsys):
    """Two epochs on the CPU through the fused kernels' plain versions: the
    metric CSV has the JAX trainer's columns with finite values, both
    checkpoint slots hold the model, and a second call with the same id
    resumes at epoch 3."""
    import pandas as pd

    assert _train(phys, tmp_path, **kw) == 0
    out = capsys.readouterr().out
    assert ("prestacked training bank: ON" in out) == kw.get("prestack",
                                                             True)
    assert "training loss: fused" in out
    mdir = os.path.join(str(tmp_path), "id-1")
    metric_file = os.path.join(mdir, "metric_id-1.csv")
    df = pd.read_csv(metric_file, index_col=0)
    assert list(df.columns) == jpt.METR_COLUMNS == tpt.METR_COLUMNS
    assert list(df["epoch"]) == [1, 2]
    assert np.isfinite(df.to_numpy(np.float64)).all()
    for slot in ("last_checkpoint", "best_checkpoint"):
        ckpt = torch.load(os.path.join(mdir, slot, "checkpt.tar"),
                          weights_only=True)
        assert set(ckpt) == {"epoch", "weight", "model_state_dict",
                             "optimizer_state_dict"}
    assert _train(phys, tmp_path, model_id=1, epochs=3, **kw) == 0
    df = pd.read_csv(metric_file, index_col=0)
    assert list(df["epoch"]) == [1, 2, 3]
    assert np.isfinite(df.to_numpy(np.float64)).all()


def test_physionet_trainer_options(phys, tmp_path, capsys):
    """'mesh' takes a ``parallel.sharding.Mesh`` (its runs:
    tests/test_torch_parallel_trainers.py) and refuses anything else;
    'other_model' is refused as the JAX trainer refuses it; on the CPU the
    default training loss is the eager forward, and the initial print
    says so."""
    with pytest.raises(ValueError, match="1-D .*Mesh"):
        _train(phys, tmp_path, mesh=object())
    with pytest.raises(ValueError, match="other_model"):
        _train(phys, tmp_path, other_model="GRU_ODE_Bayes")
    assert _train(phys, tmp_path / "eager", epochs=1) == 0
    assert "training loss: eager forward" in capsys.readouterr().out
