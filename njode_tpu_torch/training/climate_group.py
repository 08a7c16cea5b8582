"""Grouped climate training, the port's copy of
``njode_tpu/training/climate_group.py``: the 5-fold cross-validation as
one ensemble on the card.

Every fold indexes into the same sporadic CSV, so the members (folds, or
repeat seeds of a fold) train over ONE pre-stacked bank of all series on
the device (``climate.prestack_series``, ``steps.prestacked_batch``):
member m gathers its batches out of it through its fold's positions mapped
to bank rows, and a step runs K1 and K2 once each over the member axis
(the masked branch). Folds differ in train size by a few series, so their
batch counts differ: at a step past a member's last batch that member sits
out (no launch for it, no optimizer step), the counterpart of the JAX
package's dead batches, whose updates it suppresses.

Member numerics are the port's solo trainer's (``climate_trainer.py``):
``NJODE`` initialised under ``torch.manual_seed(rseed)``, the batches and
loss scales of ``epoch_batches(rseed, epoch, n_train_m, B)`` over the
fold's positions, one ``torch.Generator`` a batch seeded
``batch_seed(rseed, epoch, b0)``. With grid-aligned times (the USHCN file
at delta_t = 0.1) the bank's grid is every fold's, so a member's
trajectory is its solo run's; off-grid times fall back to solo runs. The
evaluation (each member's validation and test split, built once as the
solo trainer builds them) runs one member after another, eager. Artifacts
are the solo trainer's (the same columns, the best checkpoint on
``eval_metric``, the ``save_every`` cadence); ``train_time``/``eval_time``
are the group's wall time divided by E. Under a ``mesh`` the members split
over the ranks as in ``group_sweep`` (``group_common.MemberShard``), rank 0
writing every member's artifacts.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from njode_tpu_torch.data import climate as cdu
from njode_tpu_torch.data.grid import nearest_grid_steps, \
    sparse_from_events, sparse_to_torch
from njode_tpu_torch.models import njode
from njode_tpu_torch.ops import fused_scan
from njode_tpu_torch.training import group_common, steps
from njode_tpu_torch.training.climate_trainer import METR_COLUMNS, \
    _load_fold_idx, batch_seed, default_enc_nn, default_ode_nn, \
    default_readout_nn, epoch_batches
from njode_tpu_torch.utils import paths as path_cfg

_MATCH_KEYS = (
    ("epochs", 100), ("batch_size", 100), ("save_every", 1),
    ("learning_rate", 1e-3), ("hidden_size", 10), ("bias", True),
    ("dropout_rate", 0.1), ("ode_nn", default_ode_nn),
    ("readout_nn", default_readout_nn), ("enc_nn", default_enc_nn),
    ("use_rnn", False), ("solver", "euler"), ("weight", 0.5),
    ("weight_decay", 1.0), ("saved_models_path", None),
    ("T", 200), ("delta_t", 0.1), ("T_val", 150), ("max_val_samples", 3),
    ("climate_dir", None), ("csv_name", "small_chunked_sporadic.csv"),
    ("which_loss", "standard"), ("residual_enc_dec", True),
    ("input_current_t", False), ("compute_dtype", "float32"),
    ("use_pallas", None), ("pallas_mask_mode", "prng"),
    ("device", "cuda"))
_VARY_KEYS = ("data_index", "seed", "repeat_seed", "model_id")
_INERT_KEYS = ("dataset", "parallel", "masked", "prestack",
               "resume_training", "load_best", "plot_only", "other_model",
               "remat", "pallas_interpret", "use_orbax", "orbax_async")
_NN_KEYS = ("ode_nn", "readout_nn", "enc_nn")


def _norm_val(k, v):
    return group_common.norm_val(k, v, _NN_KEYS)


def group_key(p):
    """Hashable key of everything the members of one climate group (folds
    and/or repeats) must share, or None (not groupable: the solo path)."""
    if (p.get("dataset") != "climate" or p.get("other_model") is not None
            or p.get("resume_training") or p.get("load_best")
            or p.get("prestack") is False or p.get("plot_only")):
        return None
    known = {k for k, _ in _MATCH_KEYS} | set(_VARY_KEYS) | set(_INERT_KEYS)
    if set(p) - known:
        return None
    return tuple(_norm_val(k, p.get(k, d)) for k, d in _MATCH_KEYS)


def plan_groups(params_list, min_group=2):
    """The planner of ``group_sweep.plan_groups`` on :func:`group_key`."""
    return group_common.plan_groups(params_list, group_key, min_group)


def make_cg_step_fns(models, optimizers, times, dts, use_kernels,
                     mask_mode):
    """``train_epoch(d_k, d_X, d_M, batches, weight)``: ``batches[e]``
    member e's list of ``(rows [B] on the device, generator, loss
    scale)``; step j trains the members that have a batch j, one
    member-axis launch; returns each member's scaled losses (a list of
    ``[n_e]`` tensors)."""
    step = group_common.make_group_step(models, optimizers, use_kernels,
                                        mask_mode)

    def train_epoch(d_k, d_X, d_M, batches, weight):
        out = [[] for _ in batches]
        for j in range(max(len(b) for b in batches)):
            live = [e for e, b in enumerate(batches) if j < len(b)]
            got = step([steps.prestacked_batch(d_k, d_X, d_M,
                                               batches[e][j][0], times, dts)
                        for e in live], weight,
                       [batches[e][j][1] for e in live], live,
                       [batches[e][j][2] for e in live])
            for k, e in enumerate(live):
                out[e].append(got[k])
        return [torch.stack(o) for o in out]

    return {"train_epoch": train_epoch}


def train_group(group_params, verbose=True, mesh=None):
    """Train one climate group (folds x repeats of one architecture) end to
    end with the solo trainer's artifacts; where the times are off the
    ``delta_t`` grid (no bank) its members train solo.

    :param mesh: a ``parallel.sharding.Mesh`` whose ranks split the members
        (every rank calls with the same arguments)
    :return: list of 0s, one per member
    """
    E = len(group_params)
    shard = group_common.MemberShard(E, mesh)
    verbose = verbose and shard.writer
    p0 = group_params[0]
    device = torch.device(p0.get("device", "cuda"))
    saved_models_path = p0.get("saved_models_path") or os.path.join(
        os.path.dirname(path_cfg.saved_models_path.rstrip("/")),
        "saved_models_climate")
    climate_dir = p0.get("climate_dir") or os.path.join(
        path_cfg.training_data_path, "climate")
    csv_file = os.path.join(climate_dir,
                            p0.get("csv_name", "small_chunked_sporadic.csv"))
    T = p0.get("T", 200)
    delta_t = p0.get("delta_t", 0.1)
    val_options = {"T_val": p0.get("T_val", 150),
                   "max_val_samples": p0.get("max_val_samples", 3)}

    # ------- each member's fold, and the bank of all series -------
    ds_all = cdu.ClimateDataset(csv_file)
    folds = [int(p.get("data_index", 0)) for p in group_params]
    fold_sets = {}
    for f in sorted(set(folds)):
        tr, va, te = _load_fold_idx(climate_dir, f)
        fold_sets[f] = {
            "train": cdu.ClimateDataset(csv_file, idx=tr),
            "val": cdu.ClimateDataset(csv_file, idx=va, validation=True,
                                      val_options=val_options),
            "test": cdu.ClimateDataset(csv_file, idx=te, validation=True,
                                       val_options=val_options),
            "train_ids": np.sort(np.asarray(tr)),
        }
    max_steps = max(max(s[k].max_grid_steps(delta_t, T)
                        for k in ("train", "val", "test"))
                    for s in fold_sets.values())
    pre = cdu.prestack_series(ds_all, delta_t, T, max_steps)
    if pre is None:
        if verbose:
            print("climate group: no pre-stacked bank -> solo runs")
        from njode_tpu_torch.training import climate_trainer
        return [climate_trainer.train(**p) for p in group_params]

    input_size = ds_all.variable_num
    epochs = int(p0.get("epochs", 100))
    batch_size = int(p0.get("batch_size", 100))
    save_every = int(p0.get("save_every", 1))
    lr = float(p0.get("learning_rate", 1e-3))
    cfg = njode.NJODEConfig(
        input_size=input_size, hidden_size=int(p0.get("hidden_size", 10)),
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

    rseeds = shard.take([int(p.get("seed", 398))
                         + 7_654_321 * int(p.get("repeat_seed", 0) or 0)
                         for p in group_params])
    l_folds = shard.take(folds)
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
    # fold position -> bank row
    bank_pos = [np.searchsorted(ds_all.ids, fold_sets[f]["train_ids"])
                for f in l_folds]
    n_trains = [len(bp) for bp in bank_pos]

    Kp, Emax, Dp = (pre["times"].shape[0], pre["k"].shape[1],
                    pre["X"].shape[2])
    N_all = pre["k"].shape[0]
    bank = (torch.as_tensor(np.concatenate(
        [pre["k"], np.full((1, Emax), Kp, np.int32)]).astype(np.int64),
        device=device),
        torch.as_tensor(np.concatenate(
            [pre["X"], np.zeros((1, Emax, Dp), np.float32)]), device=device),
        torch.as_tensor(np.concatenate(
            [pre["M"], np.zeros((1, Emax, Dp), np.float32)]), device=device))
    fns = make_cg_step_fns(models, optimizers,
                           torch.as_tensor(pre["times"], device=device),
                           torch.as_tensor(pre["dt"], device=device),
                           use_kernels, mask_mode)
    del pre

    # ------- each member's validation and test batches (as solo) -------
    def _split(ds):
        ev = ds.collate(np.arange(len(ds)))
        sb = sparse_from_events(ev, delta_t, T, max_steps,
                                max_events=len(ev["obs_idx"]))
        k = nearest_grid_steps(sb.times, ev["times_val"])
        pairs = tuple(torch.as_tensor(a, device=device) for a in (
            k.astype(np.int64), np.asarray(ev["index_val"], np.int64),
            np.asarray(ev["X_val"], np.float32),
            np.asarray(ev["M_val"], np.float32)))
        return sparse_to_torch(sb, device), pairs

    splits = {f: (_split(fold_sets[f]["val"]), _split(fold_sets[f]["test"]))
              for f in set(l_folds)}

    arts = group_common.MemberArtifacts(group_params, saved_models_path,
                                        METR_COLUMNS, shard.writer)
    cur_weight = float(p0.get("weight", 0.5))
    w_decay = float(p0.get("weight_decay", 1.0))
    best = np.full(E, np.inf)
    if verbose:
        print(f"climate group: {E} members, ids="
              f"{[p['model_id'] for p in group_params]}, folds={folds}, "
              f"arch={cfg.ode_nn}, training loss: "
              f"{'member-axis kernels' if use_kernels else 'eager forward'}")

    def _evaluate(e, split):
        b_dev, pairs = split
        loss, se, n = evals[e]["eval_loss_and_heldout_mse"](
            b_dev, *pairs, cur_weight)
        return float(loss), float(se) / max(float(n), 1.0)

    for epoch in range(1, epochs + 1):
        t0 = time.time()
        batches = []
        for r, bp, n in zip(rseeds, bank_pos, n_trains):
            idx_mat, scales, starts = epoch_batches(r, epoch, n, batch_size)
            # fold positions (n: the fold's sentinel) -> bank rows (N_all)
            rows = np.where(idx_mat < n, bp[np.minimum(idx_mat, n - 1)],
                            N_all)
            rows_d = torch.as_tensor(rows, device=device)
            batches.append([(rows_d[j], torch.Generator(
                device=device).manual_seed(batch_seed(r, epoch, b0)), ls)
                for j, (ls, b0) in enumerate(zip(scales, starts))])
        losses = fns["train_epoch"](*bank, batches, cur_weight)
        train_losses = [float(l_[-1]) for l_ in losses]
        train_time = (time.time() - t0) / E

        t0 = time.time()
        rows = []
        for e, f in enumerate(l_folds):
            val_split, test_split = splits[f]
            rows.append([train_losses[e]] + list(_evaluate(e, val_split))
                        + list(_evaluate(e, test_split)))
        # every member's [train_loss, loss_val, mse_val, loss_test,
        # mse_test] on every rank
        rows = shard.gather(torch.tensor(rows, dtype=torch.float64)).tolist()
        eval_time = (time.time() - t0) / E
        if verbose:
            print(f"epoch {epoch}, weight={cur_weight:.5f}, eval-metric="
                  f"{[round(r[2], 5) for r in rows]}")
        group_common.record_epoch(
            arts, shard, [[epoch, train_time, eval_time] + r for r in rows],
            [r[2] for r in rows], best, epoch, cur_weight, save_every,
            lambda: [(m.state_dict(), o.state_dict())
                     for m, o in zip(models, optimizers)])
        cur_weight = njode.weight_decay_step(cur_weight, w_decay)

    arts.flush_pending()
    return [0] * E
