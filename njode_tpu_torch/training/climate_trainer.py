"""Climate (USHCN) training, the port's copy of
``njode_tpu/training/climate_trainer.py``: masked NJODE or GRU-ODE-Bayes on
sporadic series.

It forces ``masked=True``, loads the sporadic CSV with the 5-fold
train/val/test index files, trains with ``start_X = 0`` (or the real
covariates of a ``cov_file``, GRU-ODE-Bayes only) and per-batch
``n_obs_ot``, logs ``[epoch, train_time, eval_time, train_loss, eval_loss,
eval_metric, test_loss, test_metric]``, keys the best checkpoint on
``eval_metric`` (masked MSE of the pre-jump prediction at the held-out
observations after ``T_val``) and decays the loss weight per epoch.

Training batches come from a pre-stacked event bank on the device
(``climate.prestack_series``) unless ``prestack=False`` or the times are
off the ``delta_t`` grid; then each epoch's batches are collated on the
host. On a CUDA device with a config that ``fused_scan.supported`` (NJODE)
or ``fused_gob.supported`` (GRU-ODE-Bayes) admits, the training loss runs
through the hand-written kernels (the 400-wide arm in their global plan:
its weights do not fit one CTA); otherwise through the eager forward, and
the initial print says which. Evaluation runs the eager forward, as the JAX trainer's
runs the XLA scan.

Dropout draws from one ``torch.Generator`` per batch, seeded from (seed,
epoch, batch start): the batches are the JAX trainer's (the same numpy
permutations), the dropout masks are not (JAX's ``fold_in`` key stream
cannot be reproduced in torch).

With the option 'mesh' (a ``parallel.sharding.Mesh``; every rank calls
``train`` with the same arguments) each rank trains on its block of every
batch's rows, the validation and test batches are padded to a multiple of
the mesh size (their losses scaled back to 1/B) and split the same way,
and only rank 0 writes the registry, the metric CSV and the checkpoints.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from njode_tpu_torch.data import climate as cdu
from njode_tpu_torch.data.grid import nearest_grid_steps, \
    sparse_from_events, sparse_to_torch
from njode_tpu_torch.models import gru_ode_bayes as gob
from njode_tpu_torch.models import njode
from njode_tpu_torch.models.mlp import count_params
from njode_tpu_torch.parallel import multihost, sharding
from njode_tpu_torch.training import checkpoints
from njode_tpu_torch.training import steps
from njode_tpu_torch.utils import paths as path_cfg
from njode_tpu_torch.utils.csv_frame import read_frame, to_float, \
    write_frame
from njode_tpu_torch.utils.paths import makedirs

METR_COLUMNS = ["epoch", "train_time", "eval_time", "train_loss", "eval_loss",
                "eval_metric", "test_loss", "test_metric"]
default_ode_nn = ((50, "tanh"), (50, "tanh"))
default_readout_nn = ((50, "tanh"), (50, "tanh"))
default_enc_nn = ((50, "tanh"), (50, "tanh"))


def _load_fold_idx(climate_dir, data_index):
    d = os.path.join(climate_dir, f"small_chunk_fold_idx_{data_index}")
    return tuple(
        np.load(os.path.join(d, f"{s}_idx.npy"), allow_pickle=True)
        for s in ("train", "val", "test"))


def batch_seed(seed: int, epoch: int, b0: int) -> int:
    """The dropout generator's seed of the batch starting at row ``b0`` of
    ``epoch``."""
    return ((seed + 1) * 100_003 + epoch * 100_000 + b0) % 2 ** 63


def epoch_batches(seed: int, epoch: int, n_train: int, batch_size: int):
    """The JAX trainer's batches of one epoch: ``(idx [n, batch_size]``
    int64 padded with the sentinel row ``n_train``, per-batch loss scales
    ``batch_size / len(idx)``, per-batch starts ``b0)``."""
    perm = np.random.RandomState(
        (seed * 100_003 + epoch) % 2 ** 32).permutation(n_train)
    idxs, scales, starts = [], [], []
    for b0 in range(0, n_train, batch_size):
        idx = perm[b0:b0 + batch_size]
        scales.append(batch_size / len(idx))
        idxs.append(np.concatenate(
            [idx, np.full(batch_size - len(idx), n_train)]))
        starts.append(b0)
    return np.stack(idxs).astype(np.int64), scales, starts


def train(
        model_id=None, epochs=100, batch_size=100, save_every=1,
        learning_rate=0.001,
        hidden_size=10, bias=True, dropout_rate=0.1,
        ode_nn=default_ode_nn, readout_nn=default_readout_nn,
        enc_nn=default_enc_nn, use_rnn=False,
        solver="euler", weight=0.5, weight_decay=1.0,
        data_index=0, dataset="climate",
        saved_models_path=None, device="cuda",
        **options,
):
    """Train on the climate dataset fold ``data_index`` (0..4).

    The arguments are the JAX trainer's, plus ``device`` (``"cuda"`` unless
    the caller asks for the CPU). Options read: 'which_loss',
    'residual_enc_dec', 'input_current_t', 'delta_t' (default 0.1), 'T'
    (200), 'T_val' (150), 'max_val_samples' (3), 'load_best', 'parallel',
    'resume_training', 'seed' (398), 'repeat_seed', 'climate_dir' (the
    sporadic CSV and the fold index directories; default
    <training_data>/climate), 'csv_name', 'cov_file', 'label_file',
    'prestack' (default True), 'use_pallas' (the fused kernels; default: on
    CUDA for a supported config), 'pallas_mask_mode' ('prng' or 'input'),
    'other_model' ("GRU_ODE_Bayes" with its 'GRU_ODE_Bayes-<name>'
    options), 'mesh' (a ``parallel.sharding.Mesh``: data-parallel training;
    ``batch_size`` must divide by its size; kept out of the registry
    description). 'remat' and 'pallas_interpret' steer the JAX scan only
    and are ignored.
    :return: 0
    """
    mesh = sharding.check_mesh(options.pop("mesh", None))
    if mesh is not None and batch_size % mesh.size:
        raise ValueError(f"batch_size={batch_size} must be divisible by the "
                         f"mesh size {mesh.size} for data-parallel training")
    device = torch.device(device)
    saved_models_path = saved_models_path or os.path.join(
        os.path.dirname(path_cfg.saved_models_path.rstrip("/")),
        "saved_models_climate")
    options["masked"] = True
    initial_print = f"model-id: {model_id}"

    # ------- data -------
    climate_dir = options.get("climate_dir") or os.path.join(
        path_cfg.training_data_path, "climate")
    csv_file = os.path.join(climate_dir,
                            options.get("csv_name",
                                        "small_chunked_sporadic.csv"))
    train_idx, val_idx, test_idx = _load_fold_idx(climate_dir, data_index)
    val_options = {"T_val": options.get("T_val", 150),
                   "max_val_samples": options.get("max_val_samples", 3)}

    def _data_file(opt_name):
        f = options.get(opt_name)
        if f is None:
            return None
        return f if os.path.isabs(f) else os.path.join(climate_dir, f)

    cov_file = _data_file("cov_file")
    ds_kw = dict(cov_file=cov_file, label_file=_data_file("label_file"))
    data_train = cdu.ClimateDataset(csv_file, idx=train_idx, **ds_kw)
    data_val = cdu.ClimateDataset(csv_file, idx=val_idx, validation=True,
                                  val_options=val_options, **ds_kw)
    data_test = cdu.ClimateDataset(csv_file, idx=test_idx, validation=True,
                                   val_options=val_options, **ds_kw)

    input_size = data_train.variable_num
    output_size = input_size
    T = options.get("T", 200)
    delta_t = options.get("delta_t", 0.1)
    max_steps = max(data_train.max_grid_steps(delta_t, T),
                    data_val.max_grid_steps(delta_t, T),
                    data_test.max_grid_steps(delta_t, T))

    # ------- registry / resume -------
    params_dict = {
        "input_size": input_size, "epochs": epochs,
        "hidden_size": hidden_size, "output_size": output_size, "bias": bias,
        "ode_nn": ode_nn, "readout_nn": readout_nn, "enc_nn": enc_nn,
        "use_rnn": use_rnn,
        "dropout_rate": dropout_rate, "batch_size": batch_size,
        "solver": solver, "data_index": data_index,
        "learning_rate": learning_rate,
        "weight": weight, "weight_decay": weight_decay, "options": options}
    desc = json.dumps(params_dict, sort_keys=True, default=str)
    resume_training = False
    if not options.get("parallel", False):
        model_id, desc, saved_params, resume_training = \
            multihost.resolve_model_id_synced(saved_models_path, model_id,
                                              desc, mesh)
        if resume_training:
            initial_print += "\nmodel_id already exists -> resume training"
            params_dict = saved_params
            options = params_dict["options"]
        else:
            initial_print += f"\nnew model_id={model_id}"
    initial_print += f"\nmodel params:\n{desc}"
    if options.get("resume_training", False):
        resume_training = True

    model_path = os.path.join(saved_models_path, f"id-{model_id}")
    model_path_save_last = os.path.join(model_path, "last_checkpoint")
    model_path_save_best = os.path.join(model_path, "best_checkpoint")
    makedirs(model_path_save_last)
    makedirs(model_path_save_best)
    model_metric_file = os.path.join(model_path, f"metric_id-{model_id}.csv")

    # ------- model & optimizer -------
    seed = int(options.get("seed", 398))
    seed += 7_654_321 * int(options.get("repeat_seed", 0) or 0)
    mask_mode = options.get("pallas_mask_mode", "prng")
    if "other_model" not in options:
        cfg = njode.NJODEConfig(
            input_size=params_dict["input_size"],
            hidden_size=params_dict["hidden_size"],
            output_size=params_dict["output_size"],
            ode_nn=params_dict["ode_nn"],
            readout_nn=params_dict["readout_nn"],
            enc_nn=params_dict["enc_nn"],
            use_rnn=params_dict["use_rnn"],
            bias=params_dict["bias"],
            dropout_rate=params_dict["dropout_rate"],
            solver=params_dict["solver"],
            which_loss=options.get("which_loss", "standard"),
            residual_enc_dec=options.get("residual_enc_dec", True),
            input_current_t=options.get("input_current_t", False),
            masked=True,
            compute_dtype=options.get("compute_dtype", "float32"))
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = njode.NJODE(cfg)
        model_name = "NJ-ODE"
        from njode_tpu_torch.ops import fused_scan as fused_ops
    elif options["other_model"] == "GRU_ODE_Bayes":
        if cov_file is not None:
            # real covariates ride as start_X -> covariates_map -> h0
            options = dict(options, cov_size=data_train.cov_dim)
        cfg = gob.config_from_options(params_dict, options)
        model = gob.GOB(cfg, generator=torch.Generator().manual_seed(seed))
        model_name = "GRU-ODE-Bayes"
        from njode_tpu_torch.ops import fused_gob as fused_ops
    else:
        raise ValueError(
            "Invalid argument for (option) parameter 'other_model'.")
    model.to(device)
    optimizer = steps.make_optimizer(model.parameters(),
                                     params_dict["learning_rate"])
    use_kernels = options.get("use_pallas", fused_ops._is_cuda(device)
                              and fused_ops.supported(cfg))
    initial_print += ("\ntraining loss: fused CUDA kernels" if use_kernels
                      else "\ntraining loss: eager forward (the fused "
                      "kernels are off or do not cover this config)")
    if model_name == "NJ-ODE":
        fns = steps.make_sparse_step_fns(model, optimizer, use_kernels,
                                         mask_mode, mesh)
    else:
        fns = gob.make_sparse_step_fns(model, optimizer, use_kernels,
                                       mask_mode, mesh)

    max_events = data_train.max_batch_events(batch_size)
    use_cov = cov_file is not None and model_name == "GRU-ODE-Bayes"

    def _full_batch(ds):
        ev = ds.collate(np.arange(len(ds)))
        # under a mesh the full split is padded to a multiple of the mesh
        # size; the loss scale Bp / B undoes the changed 1/B
        B = ev["batch_size"]
        Bp = B if mesh is None else -(-B // mesh.size) * mesh.size
        sb = sparse_from_events(ev, delta_t, T, max_steps,
                                max_events=len(ev["obs_idx"]),
                                pad_batch_to=Bp,
                                cov=ev["cov"] if use_cov else None)
        return ev, sb, Bp / B

    def _heldout_pairs(ev, sb):
        k = nearest_grid_steps(sb.times, ev["times_val"])
        return tuple(torch.as_tensor(a, device=device) for a in (
            k.astype(np.int64), np.asarray(ev["index_val"], np.int64),
            np.asarray(ev["X_val"], np.float32),
            np.asarray(ev["M_val"], np.float32)))

    ev_val, sb_val, scale_val = _full_batch(data_val)
    ev_test, sb_test, scale_test = _full_batch(data_test)
    pairs_val = _heldout_pairs(ev_val, sb_val)
    pairs_test = _heldout_pairs(ev_test, sb_test)
    b_val = sparse_to_torch(sb_val, device)
    b_test = sparse_to_torch(sb_test, device)

    # ------- resume -------
    best_eval_metric = np.inf
    epoch = 1
    cur_weight = float(params_dict["weight"])
    w_decay = float(params_dict["weight_decay"])
    metric_rows = []
    if resume_training:
        initial_print += "\nload saved model ..."
        try:
            which = (model_path_save_best if options.get("load_best")
                     else model_path_save_last)
            epoch, cur_weight = checkpoints.load_checkpoint(
                which, model, optimizer, device)
            cols, rows = read_frame(model_metric_file)
            metric_rows = [[int(float(r[0]))] + [to_float(v) for v in r[1:]]
                           for r in rows]
            em = cols.index("eval_metric")
            best_eval_metric = min(r[em] for r in metric_rows)
            epoch += 1
            cur_weight = njode.weight_decay_step(cur_weight, w_decay)
        except (OSError, KeyError, ValueError, RuntimeError) as e:
            initial_print += "\nloading model failed -> initiate new model"
            initial_print += f"\nException:\n{e}"
            resume_training = False
    if not resume_training:
        initial_print += "\ninitiate new model ..."
    if mesh is not None:
        sharding.shard_params(model, mesh, optimizer)

    def evaluate_model(b_dev, pairs, scale):
        """(loss, masked-MSE metric) on a held-out split: one forward for
        the loss and the prediction path, the held-out points gathered on
        the device."""
        loss, se, n = fns["eval_loss_and_heldout_mse"](b_dev, *pairs,
                                                       cur_weight, scale)
        return float(loss), float(se) / max(float(n), 1.0)

    n_train = len(data_train)

    # ------- pre-stacked training bank on the device -------
    pre = (cdu.prestack_series(data_train, delta_t, T, max_steps)
           if options.get("prestack", True) else None)
    if pre is not None:
        times_d = torch.as_tensor(pre["times"], device=device)
        dts_d = torch.as_tensor(pre["dt"], device=device)
        Kp, Emax, Dp = (pre["times"].shape[0], pre["k"].shape[1],
                        pre["X"].shape[2])
        if model_name == "NJ-ODE":
            pre_fns = steps.make_prestacked_step_fns(
                model, optimizer, times_d, dts_d, use_kernels, mask_mode,
                mesh)
        else:
            cov_bank = (torch.as_tensor(np.concatenate(
                [pre["cov"], np.zeros((1, pre["cov"].shape[1]),
                                      np.float32)]), device=device)
                if use_cov else None)
            pre_fns = gob.make_prestacked_step_fns(
                model, optimizer, times_d, dts_d, use_kernels, mask_mode,
                cov_bank=cov_bank, mesh=mesh)
        # sentinel series N: zero events, pads the last short batch
        d_k = torch.as_tensor(np.concatenate(
            [pre["k"], np.full((1, Emax), Kp, np.int32)]).astype(np.int64),
            device=device)
        d_X = torch.as_tensor(np.concatenate(
            [pre["X"], np.zeros((1, Emax, Dp), np.float32)]), device=device)
        d_M = torch.as_tensor(np.concatenate(
            [pre["M"], np.zeros((1, Emax, Dp), np.float32)]), device=device)
        initial_print += "\nprestacked training bank: ON (device batches)"

    def _generators(ep, starts):
        return [torch.Generator(device=device).manual_seed(
            batch_seed(seed, ep, b0)) for b0 in starts]

    def _collate_epoch(ep):
        idx_mat, scales, starts = epoch_batches(seed, ep, n_train,
                                                batch_size)
        sbs = []
        for idx in idx_mat:
            idx = idx[idx < n_train]
            ev = data_train.collate(idx)
            sbs.append(sparse_from_events(
                ev, delta_t, T, max_steps, max_events=max_events,
                pad_batch_to=batch_size,
                cov=ev["cov"] if use_cov else None))
        stack = type(sbs[0])(*(np.stack(f) for f in zip(*sbs)))
        return sparse_to_torch(stack, device), scales, starts

    if epoch <= epochs:
        print(initial_print)
        print(f"# parameters={count_params(model)}\n")
        print("start training ...")

    def _save(path):
        multihost.coordinator_only(checkpoints.save_checkpoint, path, model,
                                   optimizer, epoch, cur_weight, mesh=mesh)

    def _write_rows():
        multihost.coordinator_only(write_frame, model_metric_file,
                                   METR_COLUMNS, metric_rows, mesh=mesh)

    pending = (None if (pre is not None or epoch > epochs)
               else _collate_epoch(epoch))
    while epoch <= epochs:
        t0 = time.time()
        if pre is not None:
            idx_mat, scales, starts = epoch_batches(seed, epoch, n_train,
                                                    batch_size)
            losses = pre_fns["train_epoch"](
                d_k, d_X, d_M, torch.as_tensor(idx_mat, device=device),
                cur_weight, _generators(epoch, starts), scales)
        else:
            stack, scales, starts = pending
            losses = fns["train_epoch"](stack, cur_weight,
                                        _generators(epoch, starts), scales)
            # the launches above are asynchronous: collate the next
            # epoch's batches on the host while the device runs this one
            pending = _collate_epoch(epoch + 1) if epoch < epochs else None
        train_loss = float(losses[-1])
        train_time = time.time() - t0

        t0 = time.time()
        loss_val, mse_val = evaluate_model(b_val, pairs_val, scale_val)
        eval_time = time.time() - t0
        print(f"epoch {epoch}, weight={cur_weight:.5f}, "
              f"train-loss={train_loss:.5f}, eval-loss={loss_val:.5f}, "
              f"eval-metric={mse_val:.5f}")

        if mse_val < best_eval_metric:
            print(f"save new best model: last-best-metric: "
                  f"{best_eval_metric:.5f}, new-best-metric: {mse_val:.5f}, "
                  f"epoch: {epoch}")
            _save(model_path_save_best)
            best_eval_metric = mse_val
        loss_test, mse_test = evaluate_model(b_test, pairs_test,
                                             scale_test)
        print(f"test-loss={loss_test:.5f}, test-metric={mse_test:.5f}")
        metric_rows.append([epoch, train_time, eval_time, train_loss,
                            loss_val, mse_val, loss_test, mse_test])

        if epoch % save_every == 0:
            print("save model ...")
            _write_rows()
            _save(model_path_save_last)
            print("saved!")

        epoch += 1
        cur_weight = njode.weight_decay_step(cur_weight, w_decay)

    # flush trailing metric rows (the JAX trainer's fix of the reference)
    if metric_rows:
        _write_rows()
    return 0
