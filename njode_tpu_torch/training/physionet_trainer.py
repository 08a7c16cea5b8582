"""PhysioNet-2012 training, the port's copy of
``njode_tpu/training/physionet_trainer.py``: masked NJODE on irregular
clinical series.

It forces ``masked=True``, reads set-a + set-b through the latent-ODE
pipeline (``data/physionet.py``, 80/20 split), uses ``T = 1 + 1e-12`` and
``delta_t = quantization/48``, trains with ``start_X = 0`` and per-batch
``n_obs_ot``, and evaluates on the test split with the first half of its
timeline observed and the second half held out: metric 1 is the masked MSE
of the pre-jump prediction at the held-out points over their mask count,
metric 2 the latent-ODE per-(patient, dim) masked MSE; ``eval_input_prob``
re-injects held-out points as inputs. It logs ``[epoch, train_time,
eval_time, train_loss, eval_loss, eval_metric, eval_metric_2]`` and keys
the best checkpoint on ``eval_metric``.

Training batches come from a pre-stacked event bank on the device
(``physionet.prestack_train_records``) unless ``prestack=False`` or the
times are off the ``delta_t`` grid; then each epoch's batches are collated
on the host. On a CUDA device with a config that ``fused_scan.supported``
admits (the PhysioNet arms run the kernels' global plan: their weights do
not fit one CTA), the training loss runs through the hand-written kernels,
else the eager forward; the initial print says which. Evaluation (the test
split in one batch) runs the eager forward, as the JAX trainer's runs the
XLA scan. Batches and loss scales are the JAX trainer's (the same numpy
permutations); dropout draws from one ``torch.Generator`` per batch, not
JAX's key stream.

With the option 'mesh' (a ``parallel.sharding.Mesh``; every rank calls
``train`` with the same arguments) each rank trains on its block of every
batch's rows, the test batch is padded to a multiple of the mesh size (its
loss scaled back to 1/B) and split the same way, and only rank 0 writes
the registry, the metric CSV and the checkpoints.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from njode_tpu_torch.data import physionet as pdu
from njode_tpu_torch.data.grid import nearest_grid_steps, \
    sparse_from_events, sparse_to_torch
from njode_tpu_torch.models import njode
from njode_tpu_torch.models.mlp import count_params
from njode_tpu_torch.ops import fused_scan
from njode_tpu_torch.parallel import multihost, sharding
from njode_tpu_torch.training import checkpoints, steps
from njode_tpu_torch.training.climate_trainer import batch_seed, \
    epoch_batches
from njode_tpu_torch.utils import paths as path_cfg
from njode_tpu_torch.utils.csv_frame import read_frame, to_float, \
    write_frame
from njode_tpu_torch.utils.paths import makedirs

METR_COLUMNS = ["epoch", "train_time", "eval_time", "train_loss", "eval_loss",
                "eval_metric", "eval_metric_2"]
default_ode_nn = ((50, "tanh"), (50, "tanh"))
default_readout_nn = ((50, "tanh"), (50, "tanh"))
default_enc_nn = ((50, "tanh"), (50, "tanh"))


def _events(c):
    return {k: c[k] for k in ("times", "time_ptr", "X", "M", "obs_idx",
                              "batch_size")}


def train(
        model_id=None, epochs=100, batch_size=50, save_every=1,
        learning_rate=0.001,
        hidden_size=41, bias=True, dropout_rate=0.1,
        ode_nn=default_ode_nn, readout_nn=default_readout_nn,
        enc_nn=default_enc_nn, use_rnn=False,
        solver="euler", weight=0.5, weight_decay=1.0,
        dataset="physionet", saved_models_path=None,
        quantization=0.016, n_samples=8000,
        eval_input_prob=None, eval_input_seed=3892, device="cuda",
        **options,
):
    """Train on PhysioNet-2012.

    The arguments are the JAX trainer's, plus ``device`` (``"cuda"`` unless
    the caller asks for the CPU). Options read: 'which_loss',
    'residual_enc_dec', 'input_current_t', 'delta_t', 'load_best',
    'parallel', 'resume_training', 'seed' (398), 'repeat_seed',
    'physionet_root' (the data directory), 'records' (a record list, e.g.
    the stand-in, used instead of the files), 'download' (parse the raw
    tarballs; nothing is fetched), 'prestack' (default True), 'use_pallas'
    (the fused kernels; default: on CUDA for a supported config),
    'pallas_mask_mode' ('prng' or 'input'), 'mesh' (a
    ``parallel.sharding.Mesh``: data-parallel training; ``batch_size`` must
    divide by its size; kept out of the registry description). 'remat' and
    'pallas_interpret' steer the JAX scan only and are ignored;
    'other_model' raises ``ValueError``.
    :return: 0
    """
    mesh = sharding.check_mesh(options.pop("mesh", None))
    if mesh is not None and batch_size % mesh.size:
        raise ValueError(f"batch_size={batch_size} must be divisible by the "
                         f"mesh size {mesh.size} for data-parallel training")
    device = torch.device(device)
    saved_models_path = saved_models_path or os.path.join(
        os.path.dirname(path_cfg.saved_models_path.rstrip("/")),
        "saved_models_physionet")
    options["masked"] = True
    initial_print = f"model-id: {model_id}"

    # ------- data -------
    root = options.get("physionet_root") or os.path.join(
        path_cfg.training_data_path, "physionet")
    data = pdu.parse_datasets(root, n_samples=n_samples,
                              quantization=quantization,
                              download=options.get("download", False),
                              records=options.get("records"))
    train_records = data["train_records"]
    test_records = data["test_records"]
    data_min, data_max = data["data_min"], data["data_max"]
    input_size = data["input_dim"]
    T = 1 + 1e-12
    delta_t = options.get("delta_t", quantization / 48.0)
    max_steps = pdu.max_union_grid_steps(train_records + test_records,
                                         delta_t, T)

    # ------- registry / resume -------
    params_dict = {
        "input_size": input_size, "epochs": epochs,
        "hidden_size": hidden_size, "output_size": input_size, "bias": bias,
        "ode_nn": ode_nn, "readout_nn": readout_nn, "enc_nn": enc_nn,
        "use_rnn": use_rnn,
        "dropout_rate": dropout_rate, "batch_size": batch_size,
        "solver": solver, "dataset": dataset,
        "quantization": quantization, "n_samples": n_samples,
        "learning_rate": learning_rate,
        "weight": weight, "weight_decay": weight_decay,
        "options": {k: v for k, v in options.items() if k != "records"}}
    desc = json.dumps(params_dict, sort_keys=True, default=str)
    resume_training = False
    if not options.get("parallel", False):
        model_id, desc, saved_params, resume_training = \
            multihost.resolve_model_id_synced(saved_models_path, model_id,
                                              desc, mesh)
        if resume_training:
            initial_print += "\nmodel_id already exists -> resume training"
            params_dict = saved_params
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
    if "other_model" in options:
        raise ValueError("the other_model is not defined")
    opts = params_dict.get("options", options)
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
        which_loss=opts.get("which_loss", "standard"),
        residual_enc_dec=opts.get("residual_enc_dec", True),
        input_current_t=opts.get("input_current_t", False),
        masked=True,
        compute_dtype=opts.get("compute_dtype", "float32"))
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = njode.NJODE(cfg)
    model.to(device)
    optimizer = steps.make_optimizer(model.parameters(),
                                     params_dict["learning_rate"])
    mask_mode = options.get("pallas_mask_mode", "prng")
    use_kernels = options.get("use_pallas", fused_scan._is_cuda(device)
                              and fused_scan.supported(cfg))
    initial_print += ("\ntraining loss: fused CUDA kernels" if use_kernels
                      else "\ntraining loss: eager forward (the fused "
                      "kernels are off or do not cover this config)")
    fns = steps.make_sparse_step_fns(model, optimizer, use_kernels, mask_mode,
                                     mesh)
    max_events = pdu.max_batch_events(train_records, batch_size)

    # test split: one batch with the second half of the timeline held out
    test_collate = pdu.collate_records(
        test_records, data_min, data_max, data_type="test",
        eval_input_prob=eval_input_prob, eval_input_seed=eval_input_seed)
    ev_test = _events(test_collate)
    # under a mesh the test batch is padded to a multiple of the mesh size;
    # the loss scale Bp / B undoes the changed 1/B
    B_test = ev_test["batch_size"]
    Bp_test = B_test if mesh is None else -(-B_test // mesh.size) * mesh.size
    eval_scale = Bp_test / B_test
    sb_test = sparse_from_events(ev_test, delta_t, T, max_steps,
                                 max_events=len(ev_test["obs_idx"]),
                                 pad_batch_to=Bp_test)
    b_test = sparse_to_torch(sb_test, device)
    # held-out targets [B, L, D] and their grid steps stay on the device
    k_per_t = torch.as_tensor(nearest_grid_steps(
        sb_test.times, test_collate["times_val"]).astype(np.int64),
        device=device)
    d_vals_val = torch.as_tensor(test_collate["vals_val"], device=device)
    d_mask_val = torch.as_tensor(test_collate["mask_val"], device=device)

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

    def evaluate_model():
        """(eval_loss, mse, mse_2) on the held-out half: one forward, both
        metrics on the device, four scalars to the host."""
        loss, sq, cnt, mse2 = fns["eval_loss_and_masked_metrics"](
            b_test, k_per_t, d_vals_val, d_mask_val, cur_weight, eval_scale)
        return float(loss), float(sq) / max(float(cnt), 1.0), float(mse2)

    n_train = len(train_records)

    # ------- pre-stacked training bank on the device -------
    pre = (pdu.prestack_train_records(train_records, data_min, data_max,
                                      delta_t, T, max_steps)
           if options.get("prestack", True) else None)
    bank = None
    if pre is not None:
        pre_fns = steps.make_prestacked_step_fns(
            model, optimizer, torch.as_tensor(pre["times"], device=device),
            torch.as_tensor(pre["dt"], device=device), use_kernels,
            mask_mode, mesh)
        Kp, Emax, Dp = (pre["times"].shape[0], pre["k"].shape[1],
                        pre["X"].shape[2])
        # sentinel record N: zero events, pads the last short batch
        bank = (torch.as_tensor(np.concatenate(
            [pre["k"], np.full((1, Emax), Kp, np.int32)]).astype(np.int64),
            device=device),
            torch.as_tensor(np.concatenate(
                [pre["X"], np.zeros((1, Emax, Dp), np.float32)]),
                device=device),
            torch.as_tensor(np.concatenate(
                [pre["M"], np.zeros((1, Emax, Dp), np.float32)]),
                device=device))
        del pre
        initial_print += "\nprestacked training bank: ON (device batches)"

    def _generators(ep, starts):
        return [torch.Generator(device=device).manual_seed(
            batch_seed(seed, ep, b0)) for b0 in starts]

    def _collate_epoch(ep):
        idx_mat, scales, starts = epoch_batches(seed, ep, n_train,
                                                batch_size)
        sbs = []
        for idx in idx_mat:
            c = pdu.collate_records([train_records[i] for i in idx
                                     if i < n_train],
                                    data_min, data_max, data_type="train")
            sbs.append(sparse_from_events(
                _events(c), delta_t, T, max_steps, max_events=max_events,
                pad_batch_to=batch_size))
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

    pending = (None if (bank is not None or epoch > epochs)
               else _collate_epoch(epoch))
    while epoch <= epochs:
        t0 = time.time()
        if bank is not None:
            idx_mat, scales, starts = epoch_batches(seed, epoch, n_train,
                                                    batch_size)
            losses = pre_fns["train_epoch"](
                *bank, torch.as_tensor(idx_mat, device=device),
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
        loss_val, mse_val, mse_val_2 = evaluate_model()
        eval_time = time.time() - t0
        print(f"epoch {epoch}, weight={cur_weight:.5f}, "
              f"train-loss={train_loss:.5f}, eval-loss={loss_val:.5f}, "
              f"eval-metric={mse_val:.5f}, eval-metric_2={mse_val_2:.5f}")

        if mse_val < best_eval_metric:
            print(f"save new best model: last-best-metric: "
                  f"{best_eval_metric:.5f}, new-best-metric: {mse_val:.5f}, "
                  f"epoch: {epoch}")
            _save(model_path_save_best)
            best_eval_metric = mse_val
        metric_rows.append([epoch, train_time, eval_time, train_loss,
                            loss_val, mse_val, mse_val_2])

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
