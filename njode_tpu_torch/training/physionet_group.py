"""Grouped PhysioNet training, the port's copy of
``njode_tpu/training/physionet_group.py``: repeated sweep entries as one
ensemble on the card.

The PhysioNet comparison trains one architecture several times; its
repeats differ only in ``seed``/``repeat_seed``, everything else (records,
80/20 split, test split, architecture, loop constants) is shared. So the
members train over ONE pre-stacked record bank on the device
(``physionet.prestack_train_records``, ``steps.prestacked_batch``): a step
gathers each member's batch out of the same bank and runs K1 and K2 once
each over the member axis (the masked branch; the 200 arm and the GRU
jump in the global plan).

Member numerics are the port's solo trainer's (``physionet_trainer.py``):
``NJODE`` initialised under ``torch.manual_seed(rseed)``, the batches and
loss scales of ``climate_trainer.epoch_batches(rseed, epoch, ...)`` and one
``torch.Generator`` a batch seeded ``batch_seed(rseed, epoch, b0)``. The
evaluation runs one member after another (the JAX package's ``lax.map``),
eager, on the shared test batch, as the solo trainer's does. Artifacts are
the solo trainer's: ``metric_id-<id>.csv`` (the same columns), the best
checkpoint on ``eval_metric``, the ``save_every`` cadence. Deviations, as
in the JAX package: ``train_time``/``eval_time`` are the group's wall time
divided by E, and no figures.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from njode_tpu_torch.data import physionet as pdu
from njode_tpu_torch.data.grid import nearest_grid_steps, \
    sparse_from_events, sparse_to_torch
from njode_tpu_torch.models import njode
from njode_tpu_torch.ops import fused_scan
from njode_tpu_torch.training import group_common, steps
from njode_tpu_torch.training.climate_trainer import batch_seed, \
    epoch_batches
from njode_tpu_torch.training.group_sweep import _reject_mesh
from njode_tpu_torch.training.physionet_trainer import METR_COLUMNS, \
    _events, default_enc_nn, default_ode_nn, default_readout_nn
from njode_tpu_torch.utils import paths as path_cfg

# everything train_group reads from the first member (so members must
# agree); an option outside the known keys makes the entry ungroupable
_MATCH_KEYS = (
    ("epochs", 100), ("batch_size", 50), ("save_every", 1),
    ("learning_rate", 1e-3), ("hidden_size", 41), ("bias", True),
    ("dropout_rate", 0.1), ("ode_nn", default_ode_nn),
    ("readout_nn", default_readout_nn), ("enc_nn", default_enc_nn),
    ("use_rnn", False), ("solver", "euler"), ("weight", 0.5),
    ("weight_decay", 1.0), ("saved_models_path", None),
    ("quantization", 0.016), ("n_samples", 8000),
    ("eval_input_prob", None), ("eval_input_seed", 3892),
    ("which_loss", "standard"), ("residual_enc_dec", True),
    ("input_current_t", False), ("compute_dtype", "float32"),
    ("delta_t", None), ("physionet_root", None), ("download", False),
    ("use_pallas", None), ("pallas_mask_mode", "prng"),
    ("device", "cuda"))
_VARY_KEYS = ("seed", "repeat_seed", "model_id")
# read by group_key or group-invariant, and the JAX package's TPU-only
# keys (ignored by the port's solo trainer)
_INERT_KEYS = ("dataset", "parallel", "masked", "prestack", "records",
               "resume_training", "load_best", "plot_only", "other_model",
               "remat", "pallas_interpret", "use_orbax", "orbax_async")
_NN_KEYS = ("ode_nn", "readout_nn", "enc_nn")


def _norm_val(k, v):
    return group_common.norm_val(k, v, _NN_KEYS)


def group_key(p):
    """Hashable key of everything the members of one PhysioNet group must
    share, or None (not groupable: the solo path honours every option).
    'records' (an in-memory stand-in) is matched by identity: members share
    the very same list."""
    if (p.get("dataset") != "physionet" or p.get("other_model") is not None
            or p.get("resume_training") or p.get("load_best")
            or p.get("prestack") is False or p.get("plot_only")):
        return None
    known = {k for k, _ in _MATCH_KEYS} | set(_VARY_KEYS) | set(_INERT_KEYS)
    if set(p) - known:
        return None
    return (("records", id(p.get("records"))),) + tuple(
        _norm_val(k, p.get(k, d)) for k, d in _MATCH_KEYS)


def plan_groups(params_list, min_group=2):
    """The planner of ``group_sweep.plan_groups`` on :func:`group_key`."""
    return group_common.plan_groups(params_list, group_key, min_group)


def make_pg_step_fns(models, optimizers, times, dts, use_kernels,
                     mask_mode):
    """``train_epoch(d_k, d_X, d_M, idx_mats, weight, generators,
    loss_scales)``: ``idx_mats [E, n, B]`` rows of the shared bank (the
    sentinel row pads a short batch), ``generators[e][j]`` member e's
    generator of batch j, ``loss_scales [n]`` (shared: every member's
    short batch sits at the same place); one member-axis step a batch;
    returns the scaled losses ``[n, E]``."""
    step = group_common.make_group_step(models, optimizers, use_kernels,
                                        mask_mode)
    everyone = list(range(len(models)))

    def train_epoch(d_k, d_X, d_M, idx_mats, weight, generators,
                    loss_scales):
        out = []
        for j, ls in enumerate(loss_scales):
            batches = [steps.prestacked_batch(d_k, d_X, d_M, idx_mats[e, j],
                                              times, dts) for e in everyone]
            out.append(step(batches, weight, [g[j] for g in generators],
                            everyone, [ls] * len(everyone)))
        return torch.stack(out)

    return {"train_epoch": train_epoch}


def train_group(group_params, verbose=True, mesh=None):
    """Train one PhysioNet group end to end with the solo trainer's
    artifacts; where the records are off the ``delta_t`` grid (no bank),
    its members train solo one after another.

    :param mesh: raises ``NotImplementedError`` (ROADMAP Queue 1 item 7).
    :return: list of 0s, one per member
    """
    _reject_mesh(mesh)
    E = len(group_params)
    p0 = group_params[0]
    device = torch.device(p0.get("device", "cuda"))
    saved_models_path = p0.get("saved_models_path") or os.path.join(
        os.path.dirname(path_cfg.saved_models_path.rstrip("/")),
        "saved_models_physionet")

    # ------- shared data (the solo trainer's) -------
    quantization = float(p0.get("quantization", 0.016))
    n_samples = int(p0.get("n_samples", 8000))
    root = p0.get("physionet_root") or os.path.join(
        path_cfg.training_data_path, "physionet")
    data = pdu.parse_datasets(root, n_samples=n_samples,
                              quantization=quantization,
                              download=bool(p0.get("download", False)),
                              records=p0.get("records"))
    train_records = data["train_records"]
    test_records = data["test_records"]
    data_min, data_max = data["data_min"], data["data_max"]
    input_size = data["input_dim"]
    T = 1 + 1e-12
    delta_t = p0.get("delta_t") or quantization / 48.0
    max_steps = pdu.max_union_grid_steps(train_records + test_records,
                                         delta_t, T)
    pre = pdu.prestack_train_records(train_records, data_min, data_max,
                                     delta_t, T, max_steps)
    if pre is None:
        if verbose:
            print("physionet group: no pre-stacked bank -> solo runs")
        from njode_tpu_torch.training import physionet_trainer
        return [physionet_trainer.train(**p) for p in group_params]

    epochs = int(p0.get("epochs", 100))
    batch_size = int(p0.get("batch_size", 50))
    save_every = int(p0.get("save_every", 1))
    lr = float(p0.get("learning_rate", 1e-3))
    cfg = njode.NJODEConfig(
        input_size=input_size, hidden_size=int(p0.get("hidden_size", 41)),
        output_size=input_size,
        ode_nn=group_common.norm_nn(p0.get("ode_nn", default_ode_nn)),
        readout_nn=group_common.norm_nn(p0.get("readout_nn",
                                               default_readout_nn)),
        enc_nn=group_common.norm_nn(p0.get("enc_nn", default_enc_nn)),
        use_rnn=bool(p0.get("use_rnn", False)),
        bias=bool(p0.get("bias", True)),
        dropout_rate=float(p0.get("dropout_rate", 0.1)),
        solver=str(p0.get("solver", "euler")),
        which_loss=str(p0.get("which_loss", "standard")),
        residual_enc_dec=bool(p0.get("residual_enc_dec", True)),
        input_current_t=bool(p0.get("input_current_t", False)),
        masked=True,
        compute_dtype=str(p0.get("compute_dtype", "float32")))
    use_kernels = p0.get("use_pallas")
    if use_kernels is None:
        use_kernels = fused_scan._is_cuda(device) and fused_scan.supported(
            cfg)
    mask_mode = str(p0.get("pallas_mask_mode", "prng"))

    rseeds = [int(p.get("seed", 398))
              + 7_654_321 * int(p.get("repeat_seed", 0) or 0)
              for p in group_params]
    models, optimizers, evals = [], [], []
    for r in rseeds:
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(r)
            model = njode.NJODE(cfg)
        model.to(device)
        opt = steps.make_optimizer(model.parameters(), lr)
        models.append(model)
        optimizers.append(opt)
        evals.append(steps.make_sparse_step_fns(model, opt, use_kernels,
                                                mask_mode))

    # ------- the shared bank (sentinel row N) and test batch -------
    Kp, Emax, Dp = (pre["times"].shape[0], pre["k"].shape[1],
                    pre["X"].shape[2])
    bank = (torch.as_tensor(np.concatenate(
        [pre["k"], np.full((1, Emax), Kp, np.int32)]).astype(np.int64),
        device=device),
        torch.as_tensor(np.concatenate(
            [pre["X"], np.zeros((1, Emax, Dp), np.float32)]), device=device),
        torch.as_tensor(np.concatenate(
            [pre["M"], np.zeros((1, Emax, Dp), np.float32)]), device=device))
    fns = make_pg_step_fns(models, optimizers,
                           torch.as_tensor(pre["times"], device=device),
                           torch.as_tensor(pre["dt"], device=device),
                           use_kernels, mask_mode)
    del pre
    test_collate = pdu.collate_records(
        test_records, data_min, data_max, data_type="test",
        eval_input_prob=p0.get("eval_input_prob"),
        eval_input_seed=int(p0.get("eval_input_seed", 3892)))
    ev_test = _events(test_collate)
    sb_test = sparse_from_events(ev_test, delta_t, T, max_steps,
                                 max_events=len(ev_test["obs_idx"]))
    b_test = sparse_to_torch(sb_test, device)
    k_per_t = torch.as_tensor(nearest_grid_steps(
        sb_test.times, test_collate["times_val"]).astype(np.int64),
        device=device)
    d_vals_val = torch.as_tensor(test_collate["vals_val"], device=device)
    d_mask_val = torch.as_tensor(test_collate["mask_val"], device=device)

    arts = group_common.MemberArtifacts(group_params, saved_models_path,
                                        METR_COLUMNS)
    n_train = len(train_records)
    cur_weight = float(p0.get("weight", 0.5))
    w_decay = float(p0.get("weight_decay", 1.0))
    best = np.full(E, np.inf)
    if verbose:
        print(f"physionet group: {E} members, ids="
              f"{[p['model_id'] for p in group_params]}, arch={cfg.ode_nn}, "
              f"n_train={n_train}, training loss: "
              f"{'member-axis kernels' if use_kernels else 'eager forward'}")

    for epoch in range(1, epochs + 1):
        t0 = time.time()
        mats, gens = [], []
        for r in rseeds:
            idx_mat, scales, starts = epoch_batches(r, epoch, n_train,
                                                    batch_size)
            mats.append(idx_mat)
            gens.append([torch.Generator(device=device).manual_seed(
                batch_seed(r, epoch, b0)) for b0 in starts])
        losses = fns["train_epoch"](
            *bank, torch.as_tensor(np.stack(mats), device=device),
            cur_weight, gens, scales)
        train_losses = losses[-1].cpu().numpy()
        train_time = (time.time() - t0) / E

        t0 = time.time()
        rows = []
        for e in range(E):
            loss, sq, cnt, mse2 = evals[e]["eval_loss_and_masked_metrics"](
                b_test, k_per_t, d_vals_val, d_mask_val, cur_weight)
            rows.append((float(loss), float(sq) / max(float(cnt), 1.0),
                         float(mse2)))
        eval_time = (time.time() - t0) / E
        if verbose:
            print(f"epoch {epoch}, weight={cur_weight:.5f}, eval-metric="
                  f"{[round(r[1], 5) for r in rows]}")

        host = None
        for i, (loss_val, mse, mse2) in enumerate(rows):
            arts.append(i, [epoch, train_time, eval_time,
                            float(train_losses[i]), loss_val, mse, mse2])
            improved = mse < best[i]
            save_last = epoch % save_every == 0
            if not (improved or save_last):
                continue
            if host is None:
                host = group_common.member_states(
                    [(m.state_dict(), o.state_dict())
                     for m, o in zip(models, optimizers)])
            state = host[i]
            if improved:
                arts.save(i, "best_checkpoint", state, epoch, cur_weight)
                best[i] = mse
            if save_last:
                arts.flush(i)
                arts.save(i, "last_checkpoint", state, epoch, cur_weight)
        cur_weight = njode.weight_decay_step(cur_weight, w_decay)

    arts.flush_pending()
    return [0] * E
