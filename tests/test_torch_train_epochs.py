"""The port's multi-epoch training against the JAX package: ``train_epochs``
(NJODE and GRU-ODE-Bayes) against the JAX ``train_epochs`` over 3 epochs
from the same weights, and the trainer's 'epoch_chunk' and 'ema_decay'
options against its own per-epoch loop."""

import copy
import os

import numpy as np
import pytest

import conftest  # noqa: F401

import jax
import jax.numpy as jnp
import optax
import torch

import torch_port_helpers as H
from njode_tpu.data import sde as jsde
from njode_tpu.models import gru_ode_bayes as jgob
from njode_tpu.training import steps as jsteps
from njode_tpu_torch.data import datasets as tdatasets
from njode_tpu_torch.data import sde as tsde
from njode_tpu_torch.models import gru_ode_bayes as tgob
from njode_tpu_torch.models import njode as tnjode
from njode_tpu_torch.training import steps as tsteps
from njode_tpu_torch.training import trainer as ttrainer
from njode_tpu_torch.training.jax_compat import \
    gob_state_dict_from_jax_params, state_dict_from_jax_params
from njode_tpu_torch.utils.csv_frame import read_frame, to_float

N_PATHS, N_VAL, K, B, EPOCHS = 32, 8, 15, 8, 3
WEIGHTS = [0.7, 0.63, 0.567]
NETS = dict(ode_nn=((20, "tanh"),), enc_nn=((20, "tanh"), (20, "tanh")),
            readout_nn=((20, "tanh"),))
BS_HP = dict(tdatasets.hyperparam_default, nb_steps=K)


def _inputs(seed=4):
    """Training and validation paths, observation indicators and the 3
    epochs' index matrices (numpy, from a seed)."""
    rs = np.random.RandomState(seed)
    n = N_PATHS + N_VAL
    paths = rs.lognormal(0.0, 0.3, size=(n, 1, K + 1)).astype(np.float32)
    obs = (rs.random((n, K + 1)) < 0.3).astype(np.float32)
    obs[:, K] = 1.0
    idx_mats = np.stack([rs.permutation(N_PATHS).reshape(-1, B)
                         for _ in range(EPOCHS)]).astype(np.int32)
    times = (np.arange(1, K + 1) / K).astype(np.float32)
    dts = np.full(K, 1.0 / K, np.float32)
    return (paths[:N_PATHS], obs[:N_PATHS], paths[N_PATHS:], obs[N_PATHS:],
            idx_mats, times, dts)


def _epoch_args(inputs, epochs, as_jax):
    """The arguments of a ``train_epochs`` call over ``epochs`` (indices
    into the 3 epochs' index matrices, weights and generator seeds)."""
    tr_p, tr_o, va_p, va_o, idx_mats, _, _ = inputs
    val_idx = np.arange(N_VAL, dtype=np.int32)
    mats, ws = idx_mats[list(epochs)], [WEIGHTS[e] for e in epochs]
    if as_jax:
        return (jnp.asarray(tr_p), jnp.asarray(tr_o), jnp.asarray(mats),
                jnp.asarray(ws, jnp.float32),
                jnp.stack([jax.random.PRNGKey(e) for e in epochs]),
                jnp.asarray(va_p), jnp.asarray(va_o), jnp.asarray(val_idx),
                True)
    return (torch.as_tensor(tr_p), torch.as_tensor(tr_o),
            torch.as_tensor(mats).long(), ws,
            [torch.Generator().manual_seed(e) for e in epochs],
            torch.as_tensor(va_p), torch.as_tensor(va_o),
            torch.as_tensor(val_idx).long(), True)


def _adam(o_hist):
    """The JAX optimizer history's Adam state (leading [N] axis)."""
    return next(s for s in jax.tree_util.tree_leaves(
        o_hist, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState))


def _at(tree, e, to_sd):
    return to_sd(jax.tree.map(lambda x: np.asarray(x[e]), tree))


def _load_jax_state(model, optimizer, j, e, to_sd):
    """Carry the JAX run's parameters and Adam state after epoch ``e``
    into the port's module and optimizer."""
    model.load_state_dict(_at(j[5], e, to_sd))
    adam = _adam(j[6])
    mu, nu = _at(adam.mu, e, to_sd), _at(adam.nu, e, to_sd)
    for name, p in model.named_parameters():
        optimizer.state[p] = {
            "step": torch.tensor(float(adam.count[e])),
            "exp_avg": mu[name].clone(), "exp_avg_sq": nu[name].clone()}


def _check_against_jax(make_port, jfns, params, to_sd, param_tol):
    """The port's ``train_epochs`` against the JAX one over 3 epochs (dropout
    0, a decaying loss weight, the oracle difference on).

    One 3-epoch call from the same initial weights: every epoch's snapshot
    (parameters and Adam's first moments) at ``param_tol``, Adam's step
    count exact, the last snapshot equal to the live module and the first
    apart from it (the snapshots are copies). Then each epoch again as a
    1-epoch call from the JAX run's weights and Adam state at the start of
    that epoch, carried across: its last training loss, eval loss and
    oracle difference at the loss tolerance, its parameters at
    ``param_tol``. (Over the un-carried 3-epoch call the parameters part
    by a few ulps, which moves these small batches' losses by up to ~1.3
    times the loss tolerance: fp32 rounding of two training runs, not a
    defect; the carried epochs hold the losses to it.)

    ``make_port() -> (model, optimizer, fns)``: a fresh port module with
    the initial weights."""
    inputs = _inputs()
    jopt = jsteps.make_optimizer(1e-3)
    j = jfns(jopt, inputs)["train_epochs"](
        params, jopt.init(params), *_epoch_args(inputs, range(EPOCHS), True))
    model, optimizer, fns = make_port(inputs)
    tl, ev, ms, p_hist, o_hist = fns["train_epochs"](
        *_epoch_args(inputs, range(EPOCHS), False))
    assert tl.shape == ev.shape == ms.shape == (EPOCHS,)
    names = [n for n, _ in model.named_parameters()]
    n_steps = N_PATHS // B
    for e in range(EPOCHS):
        ref, mu = _at(j[5], e, to_sd), _at(_adam(j[6]).mu, e, to_sd)
        assert set(p_hist[e]) == set(ref)
        for k in ref:
            np.testing.assert_allclose(p_hist[e][k].numpy(), ref[k].numpy(),
                                       err_msg=f"epoch {e} {k}",
                                       **param_tol(ref[k]))
        for i, k in enumerate(names):
            st = o_hist[e]["state"][i]
            assert int(st["step"]) == (e + 1) * n_steps
            np.testing.assert_allclose(st["exp_avg"].numpy(), mu[k].numpy(),
                                       err_msg=f"epoch {e} mu {k}",
                                       **param_tol(mu[k]))
    live = model.state_dict()
    for k in live:
        assert torch.equal(p_hist[-1][k], live[k])
        assert not torch.equal(p_hist[0][k], live[k]), k

    for e in range(EPOCHS):
        model, optimizer, fns = make_port(inputs)
        if e:
            _load_jax_state(model, optimizer, j, e - 1, to_sd)
        tl, ev, ms, p_hist, _ = fns["train_epochs"](
            *_epoch_args(inputs, [e], False))
        for name, a, b in (("train_last", tl, j[2]), ("eval", ev, j[3]),
                           ("msd", ms, j[4])):
            np.testing.assert_allclose(a.numpy(), np.asarray(b)[e:e + 1],
                                       err_msg=f"epoch {e} {name}",
                                       **H.LOSS_TOL)
        ref = _at(j[5], e, to_sd)
        for k in ref:
            np.testing.assert_allclose(p_hist[0][k].numpy(), ref[k].numpy(),
                                       err_msg=f"carried epoch {e} {k}",
                                       **param_tol(ref[k]))


def _fixed(_ref):
    return H.GRAD_TOL


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["eager", "fused_plain"])
def test_train_epochs_matches_jax(use_kernels):
    """NJODE (``_check_against_jax``): parameters and Adam moments at the
    gradient tolerance. ``fused_plain``: the kernels' route (their plain
    versions on the CPU, K3's for the eval loss)."""
    jcfg, tcfg = H.configs(1, 10, **NETS)
    params = H.twin_models(jcfg, tcfg, seed=3)[0]

    def jfns(jopt, inputs):
        return jsteps.make_step_fns(
            jcfg, jopt, inputs[5], inputs[6],
            jsde.make_model("BlackScholes", BS_HP).next_cond_exp,
            use_pallas=False)

    def make_port(inputs):
        model = H.twin_models(jcfg, tcfg, seed=3)[1]
        opt = tsteps.make_optimizer(model.parameters(), 1e-3)
        return model, opt, tsteps.make_step_fns(
            model, opt, torch.as_tensor(inputs[5]),
            torch.as_tensor(inputs[6]),
            tsde.make_model("BlackScholes", BS_HP).next_cond_exp,
            use_kernels=use_kernels)

    _check_against_jax(make_port, jfns, params, state_dict_from_jax_params,
                       _fixed)


def test_train_epochs_without_msd_gives_zeros():
    """``do_msd`` off: the oracle differences are zeros, and the losses
    those of a run with it on."""
    _, tcfg = H.configs(1, 10, **NETS)
    inputs = _inputs()
    times, dts = inputs[5], inputs[6]
    out = []
    for do_msd in (False, True):
        torch.manual_seed(0)
        model = tnjode.NJODE(tcfg)
        fns = tsteps.make_step_fns(
            model, tsteps.make_optimizer(model.parameters(), 1e-3),
            torch.as_tensor(times), torch.as_tensor(dts),
            tsde.make_model("BlackScholes", BS_HP).next_cond_exp)
        out.append(fns["train_epochs"](
            *_epoch_args(inputs, range(EPOCHS), False)[:-1], do_msd))
    assert torch.equal(out[0][2], torch.zeros(EPOCHS))
    assert (out[1][2] > 0).all()
    for a, b in zip(out[0][:2], out[1][:2]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["eager", "fused_plain"])
def test_gob_train_epochs_matches_jax(use_kernels):
    """GRU-ODE-Bayes (``_check_against_jax``, the weight accepted and
    ignored): parameters and Adam moments at the GOB gradient tolerance
    (``torch_port_helpers.gob_grad_tol``)."""
    jcfg, tcfg = H.gob_configs(D=1, full_gru_ode=True, impute=True,
                               mixing=1e-4)
    params = H.gob_twin_models(jcfg, tcfg, seed=3)[0]

    def jfns(jopt, inputs):
        return jgob.make_step_fns(
            jcfg, jopt, inputs[5], inputs[6],
            jsde.make_model("BlackScholes", BS_HP).next_cond_exp)

    def make_port(inputs):
        model = H.gob_twin_models(jcfg, tcfg, seed=3)[1]
        opt = tsteps.make_optimizer(model.parameters(), 1e-3)
        return model, opt, tgob.make_step_fns(
            model, opt, torch.as_tensor(inputs[5]),
            torch.as_tensor(inputs[6]),
            tsde.make_model("BlackScholes", BS_HP).next_cond_exp,
            use_kernels=use_kernels)

    _check_against_jax(make_port, jfns, params,
                       gob_state_dict_from_jax_params, H.gob_grad_tol)


# ---------------------------------------------------------------------------
# the trainer's options
# ---------------------------------------------------------------------------

TRAIN_HP = dict(tdatasets.hyperparam_default, nb_paths=80, nb_steps=K,
                obs_perc=0.15)
GOB_OPTS = {"other_model": "GRU_ODE_Bayes", "GRU_ODE_Bayes-impute": False,
            "GRU_ODE_Bayes-logvar": True, "GRU_ODE_Bayes-mixing": 0.0001}


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("train_epochs_data"))
    tdatasets.create_dataset("BlackScholes", TRAIN_HP, seed=1,
                             base_path=base, device="cpu")
    return base


def _train(base, smp, **kw):
    args = dict(model_id=None, epochs=5, batch_size=16, save_every=2,
                learning_rate=0.01, test_size=0.2, seed=398,
                hidden_size=10, bias=True, dropout_rate=0.1,
                ode_nn=((20, "tanh"),), readout_nn=((20, "tanh"),),
                enc_nn=((20, "tanh"),), weight=0.7, weight_decay=0.9,
                dataset="BlackScholes", saved_models_path=smp,
                base_data_path=base, evaluate=True, device="cpu")
    args.update(kw)
    assert ttrainer.train(**args) == 0
    cols, rows = read_frame(os.path.join(smp, "id-1", "metric_id-1.csv"))
    return {c: np.array([to_float(r[i]) for r in rows])
            for i, c in enumerate(cols)}


def _ckpt(smp, slot):
    return torch.load(os.path.join(smp, "id-1", slot, "checkpt.tar"),
                      weights_only=True)


def _assert_tensors_close(a, b, where):
    """Two (nested) state dicts: the same keys, every tensor close."""
    if isinstance(a, torch.Tensor):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-7, err_msg=where)
    elif isinstance(a, dict):
        assert set(a) == set(b), where
        for k in a:
            _assert_tensors_close(a[k], b[k], f"{where}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_tensors_close(x, y, f"{where}[{i}]")
    else:
        assert a == b, where


@pytest.mark.parametrize("model,use_pallas", [
    ("njode", False), ("njode", True), ("gob", False), ("gob", True)],
    ids=["njode_eager", "njode_fused_plain", "gob_eager", "gob_fused_plain"])
def test_epoch_chunk_matches_per_epoch_loop(dataset, tmp_path, capsys,
                                            monkeypatch, model, use_pallas):
    """'epoch_chunk'=2 (chunks of 2, 2 and 1 epochs through train_epochs)
    reproduces the per-epoch loop: every metric but the times to rtol
    1e-6 / atol 1e-7, and every checkpoint written, in order, by its slot,
    epoch, weight and tensors (model and optimizer state; those from the
    first epoch of a chunk come from its snapshot), and both slots on disk
    at the end. Dropout 0.1 ('prng' on the kernels' route)."""
    kw = dict(use_pallas=use_pallas)
    if model == "gob":
        kw.update(GOB_OPTS, epochs=4)
    saves = []
    save_state = ttrainer.checkpoints.save_state

    def recorded(path, model_state, opt_state, epoch, weight):
        saves[-1].append((os.path.basename(path), epoch, weight,
                          copy.deepcopy((model_state, opt_state))))
        save_state(path, model_state, opt_state, epoch, weight)

    monkeypatch.setattr(ttrainer.checkpoints, "save_state", recorded)
    saves.append([])
    dc = _train(dataset, str(tmp_path / "chunked"), epoch_chunk=2, **kw)
    assert "epoch_chunk disabled" not in capsys.readouterr().out
    saves.append([])
    dp = _train(dataset, str(tmp_path / "plain"), **kw)
    assert [s[:3] for s in saves[0]] == [s[:3] for s in saves[1]]
    for (slot, ep, _, a), (_, _, _, b) in zip(*saves):
        _assert_tensors_close(a, b, f"{slot} epoch {ep}")
    n = kw.get("epochs", 5)
    assert list(dc["epoch"]) == list(dp["epoch"]) == list(range(1, n + 1))
    assert (dc["eval_time"] == 0.0).all() and (dp["eval_time"] > 0).all()
    for col in ("train_loss", "eval_loss", "optimal_eval_loss",
                "evaluation_mean_diff"):
        np.testing.assert_allclose(dc[col], dp[col], rtol=1e-6, atol=1e-7,
                                   err_msg=col)
    for slot in ("last_checkpoint", "best_checkpoint"):
        a, b = _ckpt(str(tmp_path / "chunked"), slot), \
            _ckpt(str(tmp_path / "plain"), slot)
        _assert_tensors_close(a, b, slot)


# the per-epoch state of _train's model: 3 x its 981 float32 parameters
STATE_BYTES = 3 * 4 * 981


@pytest.mark.parametrize("opts,reason", [
    (dict(batch_size=24), "ragged last batch"),
    (dict(ema_decay=0.5), "(ema_decay)"),
    (dict(epoch_chunk_hist_bytes=STATE_BYTES + 1),
     "exceeds the history budget"),
    (dict(epoch_chunk=8, epoch_chunk_hist_bytes=5 * STATE_BYTES),
     "capping 8 -> 5")], ids=["ragged", "ema", "budget", "cap"])
def test_epoch_chunk_gating_is_printed(dataset, tmp_path, capsys, opts,
                                       reason):
    """Chunking turns off (or is capped) with a printed reason: a ragged
    last batch (64 training paths, batch 24), 'ema_decay', a history
    budget below two epochs' state, a budget of five; the rows are written
    either way."""
    kw = dict(epoch_chunk=2, epochs=2)
    kw.update(opts)
    d = _train(dataset, str(tmp_path / "m"), **kw)
    assert reason in capsys.readouterr().out
    assert list(d["epoch"]) == [1, 2]
    assert np.isfinite(d["eval_loss"]).all()


def _val_batch(base):
    """The trainer's validation split as one GridBatch (CPU)."""
    meta = tdatasets.load_metadata("BlackScholes", None, base)
    _, val_idx = ttrainer.train_val_split(meta["nb_paths"], 0.2, 398)
    data = tdatasets.load_dataset("BlackScholes", None, base)
    p, o = tdatasets.PathDataset(idx=val_idx, data=data).dense_arrays()
    times = torch.as_tensor((np.arange(1, K + 1) * meta["dt"])
                            .astype(np.float32))
    return tsteps.gather_dense_batch(
        torch.as_tensor(p), torch.as_tensor(o), torch.arange(len(val_idx)),
        times, torch.full((K,), meta["dt"], dtype=torch.float32))


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["eager", "fused_plain"])
def test_ema_decay_columns_and_epoch_one_average(dataset, tmp_path,
                                                 use_pallas):
    """'ema_decay' adds 'eval_loss_ema' and 'evaluation_mean_diff_ema',
    finite and apart from the live weights' columns; the epoch-1 EMA eval
    loss is the eval loss of ``d*init + (1-d)*params_1`` computed here from
    the seeded initial weights and the epoch-1 checkpoint; resuming to
    epoch 3 keeps the columns."""
    smp = str(tmp_path / "ema")
    d = 0.5
    kw = dict(save_every=1, ema_decay=d, use_pallas=use_pallas)
    d1 = _train(dataset, smp, epochs=1, **kw)
    params_1 = _ckpt(smp, "last_checkpoint")["model_state_dict"]
    _, cfg = H.configs(1, 10, ode_nn=((20, "tanh"),),
                       readout_nn=((20, "tanh"),), enc_nn=((20, "tanh"),),
                       dropout_rate=0.1)
    torch.manual_seed(398)                # the trainer's rseed
    avg = tnjode.NJODE(cfg)
    with torch.no_grad():
        for name, p in avg.named_parameters():
            p.mul_(d).add_(params_1[name], alpha=1.0 - d)
        _, loss = tnjode.forward(avg, _val_batch(dataset), weight=0.7,
                                 train=False)
    np.testing.assert_allclose(d1["eval_loss_ema"], [float(loss)],
                               **H.LOSS_TOL)

    dm = _train(dataset, smp, model_id=1, epochs=3, **kw)
    assert list(dm["epoch"]) == [1, 2, 3]
    for col in ("eval_loss_ema", "evaluation_mean_diff_ema"):
        assert np.isfinite(dm[col]).all(), col
    assert not np.allclose(dm["eval_loss_ema"], dm["eval_loss"])


@pytest.mark.parametrize("use_pallas", [False, True],
                         ids=["eager", "fused_plain"])
def test_gob_ema_decay_columns(dataset, tmp_path, use_pallas):
    """GRU-ODE-Bayes under 'ema_decay': the EMA columns exist, are finite
    and differ from the live weights' (the averaged module is evaluated
    through its own step functions, K5's eval form on the kernels'
    route)."""
    d = _train(dataset, str(tmp_path / "gob_ema"), epochs=2,
               ema_decay=0.5, use_pallas=use_pallas, **GOB_OPTS)
    for col in ("eval_loss_ema", "evaluation_mean_diff_ema"):
        assert np.isfinite(d[col]).all(), col
    assert not np.allclose(d["eval_loss_ema"], d["eval_loss"])
