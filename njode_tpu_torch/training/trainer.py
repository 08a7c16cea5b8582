"""Synthetic-dataset training, the port's copy of ``njode_tpu/training/trainer.py``.

Dataset resolution, train/val split, optimal-loss oracle, model registry
with resume-by-id, Adam (+5e-4 L2), epoch loop, full-validation-batch
eval (+ optional oracle mean-squared difference), last/best checkpoints on
the same cadence, the metric CSV with the same columns, and loss-weight
decay per epoch; NJODE, or GRU-ODE-Bayes with ``other_model=
"GRU_ODE_Bayes"``.

The dataset is resident on the device; each epoch queues its steps
(training/steps.py) and reads the losses once at its end. On a CUDA device
with a supported config the training and eval losses run through the
hand-written kernels (ops/fused_scan.py for NJODE, ops/fused_gob.py for
GRU-ODE-Bayes), as the JAX trainer picks its Pallas kernels on a TPU.
Options the port does not handle yet raise ``NotImplementedError`` naming
their ROADMAP.md entry."""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from njode_tpu_torch.data import datasets as du
from njode_tpu_torch.data import oracle, sde
from njode_tpu_torch.data.grid import batch_from_paths, recompute_n_obs, \
    to_torch
from njode_tpu_torch.models import gru_ode_bayes as gob
from njode_tpu_torch.models import njode
from njode_tpu_torch.models.mlp import count_params
from njode_tpu_torch.training import checkpoints, registry
from njode_tpu_torch.training.steps import make_optimizer, make_step_fns
from njode_tpu_torch.utils import paths as path_cfg
from njode_tpu_torch.utils.csv_frame import read_frame, to_float, \
    write_frame
from njode_tpu_torch.utils.paths import makedirs

METR_COLUMNS = ["epoch", "train_time", "eval_time", "train_loss", "eval_loss",
                "optimal_eval_loss"]
default_ode_nn = ((50, "tanh"), (50, "tanh"))
default_readout_nn = ((50, "tanh"), (50, "tanh"))
default_enc_nn = ((50, "tanh"), (50, "tanh"))

# options of the JAX trainer that this port does not handle yet
_UNPORTED = {
    "mesh": "Queue 1 item 7 (data parallelism)",
    "epoch_chunk": "Queue 1 item 3 (train_epochs, several epochs per call)",
    "ema_decay": "Queue 1 item 3 (epoch-level parameter EMA)",
    "profile_dir": "Queue 1 item 8 (utils/profiling.py)",
    "anomaly_detection": "Queue 1 item 8 (utils/profiling.py)",
    "plot_only": "Queue 1 item 3 (plots and the demo's pretrained ids)",
}


def _reject_unported(plot, options):
    if plot:
        raise NotImplementedError(
            "plot=True is not ported yet (ROADMAP.md Queue 1 item 3: "
            "training/plots.py)")
    for key, entry in _UNPORTED.items():
        val = options.get(key)
        if key == "epoch_chunk" and val is not None and int(val) <= 1:
            continue
        if val:
            raise NotImplementedError(
                f"option '{key}' is not ported yet (ROADMAP.md {entry})")


def train_val_split(nb_paths: int, test_size: float, seed: int):
    """The split of sklearn's ``train_test_split(np.arange(nb_paths),
    test_size=test_size, random_state=seed)``, reimplemented with numpy:
    ``n_test = ceil(test_size * n)``, the first ``n_test`` entries of
    ``RandomState(seed).permutation(n)`` are the test set."""
    n_test = int(np.ceil(test_size * nb_paths))
    perm = np.random.RandomState(seed).permutation(nb_paths)
    return perm[n_test:], perm[:n_test]


def train(
        model_id=None, epochs=100, batch_size=100, save_every=1,
        learning_rate=0.001, test_size=0.2, seed=398,
        hidden_size=10, bias=True, dropout_rate=0.1,
        ode_nn=default_ode_nn, readout_nn=default_readout_nn,
        enc_nn=default_enc_nn, use_rnn=False,
        solver="euler", weight=0.5, weight_decay=1.0,
        dataset="BlackScholes", dataset_id=None, plot=False,
        paths_to_plot=(0,),
        saved_models_path=None, device="cuda",
        **options,
):
    """Train an NJODE model on a synthetic dataset.

    The arguments are the JAX trainer's, plus ``device`` (``"cuda"`` unless
    the caller asks for the CPU). ``plot`` defaults to False here: plots
    are not ported yet. Options read: 'base_data_path', 'training_size',
    'func_appl_X', 'which_loss', 'residual_enc_dec', 'input_current_t',
    'masked', 'evaluate', 'load_best', 'resume_training', 'repeat_seed',
    'parallel', 'use_pallas' (use the fused kernels; default: on CUDA for
    a supported config), 'pallas_mask_mode' ('prng' or 'input'),
    'other_model' ("GRU_ODE_Bayes" trains that model instead of NJODE; its
    'GRU_ODE_Bayes-<name>' options as in ``gru_ode_bayes.
    config_from_options``; the optimal eval loss is then NaN).
    :return: 0 (reference convention)
    """
    _reject_unported(plot, options)
    device = torch.device(device)
    saved_models_path = saved_models_path or path_cfg.saved_models_path
    base_data_path = options.get("base_data_path")
    rseed = seed + 7_654_321 * int(options.get("repeat_seed", 0) or 0)
    initial_print = f"model-id: {model_id}\n"

    # ------- dataset metadata & split -------
    dataset_id = int(du._get_time_id(dataset, dataset_id, base_data_path))
    metadata = du.load_metadata(dataset, dataset_id, base_data_path)
    input_size = metadata["dimension"]
    output_size = input_size
    delta_t = metadata["dt"]

    train_idx, val_idx = train_val_split(metadata["nb_paths"], test_size,
                                         seed)
    if "training_size" in options:
        if options["training_size"] < len(train_idx):
            train_idx = np.random.RandomState(rseed).choice(
                train_idx, options["training_size"], replace=False)
    data = du.load_dataset(dataset, dataset_id, base_data_path)
    data_train = du.PathDataset(idx=train_idx, data=data)
    data_val = du.PathDataset(idx=val_idx, data=data)

    # ------- func_appl_X moment features -------
    functions, mult = du.resolve_functions(options.get("func_appl_X"))
    functions = functions or None
    input_size *= mult
    output_size *= mult

    # ------- oracle & optimal eval loss -------
    next_cond_exp = sde.make_model(metadata["model_name"],
                                   metadata).next_cond_exp
    val_batch = to_torch(recompute_n_obs(batch_from_paths(
        data_val.stock_paths, data_val.observed_dates, delta_t,
        functions=functions)), device)
    opt_eval_loss = float(oracle.optimal_loss(next_cond_exp, val_batch,
                                              weight=0.5))
    initial_print += ("\noptimal eval loss (achieved by true cond exp): "
                      f"{opt_eval_loss:.5f}")
    if "other_model" in options:
        opt_eval_loss = np.nan

    # ------- registry / resume -------
    params_dict = {
        "input_size": input_size, "epochs": epochs,
        "hidden_size": hidden_size, "output_size": output_size, "bias": bias,
        "ode_nn": ode_nn, "readout_nn": readout_nn, "enc_nn": enc_nn,
        "use_rnn": use_rnn,
        "dropout_rate": dropout_rate, "batch_size": batch_size,
        "solver": solver, "dataset": dataset, "dataset_id": dataset_id,
        "learning_rate": learning_rate, "test_size": test_size, "seed": seed,
        "weight": weight, "weight_decay": weight_decay,
        "optimal_eval_loss": opt_eval_loss, "options": options}
    desc = json.dumps(params_dict, sort_keys=True, default=str)
    resume_training = False
    if not options.get("parallel", False):
        model_id, desc, saved_params, resume_training = \
            registry.resolve_model_id(saved_models_path, model_id, desc)
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
    model_metric_file = os.path.join(model_path,
                                     f"metric_id-{model_id}.csv")

    # ------- model & optimizer -------
    opts = params_dict.get("options", options)
    if "other_model" not in options:
        cfg = njode.NJODEConfig(
            input_size=params_dict["input_size"],
            hidden_size=params_dict["hidden_size"],
            output_size=params_dict["output_size"],
            ode_nn=params_dict["ode_nn"],
            readout_nn=params_dict["readout_nn"],
            enc_nn=params_dict["enc_nn"], use_rnn=params_dict["use_rnn"],
            bias=params_dict["bias"],
            dropout_rate=params_dict["dropout_rate"],
            solver=params_dict["solver"],
            which_loss=opts.get("which_loss", "standard"),
            residual_enc_dec=opts.get("residual_enc_dec", True),
            input_current_t=opts.get("input_current_t", False),
            masked=opts.get("masked", False))
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(rseed)
            model = njode.NJODE(cfg)
        model_name = "NJODE"
    elif options["other_model"] == "GRU_ODE_Bayes":
        cfg = gob.config_from_options(params_dict, options)
        model = gob.GOB(cfg, generator=torch.Generator().manual_seed(rseed))
        model_name = "GRU-ODE-Bayes"
    else:
        raise ValueError(
            "Invalid argument for (option) parameter 'other_model'.")
    model.to(device)
    optimizer = make_optimizer(model.parameters(),
                               params_dict["learning_rate"])

    # ------- step functions -------
    K = data_train.stock_paths.shape[2] - 1
    times = torch.as_tensor((np.arange(1, K + 1) * delta_t)
                            .astype(np.float32), device=device)
    dts = torch.full((K,), delta_t, dtype=torch.float32, device=device)
    if model_name == "NJODE":
        from njode_tpu_torch.ops import fused_scan
        use_kernels = opts.get("use_pallas", device.type == "cuda"
                               and fused_scan.supported(cfg))
        fns = make_step_fns(model, optimizer, times, dts, next_cond_exp,
                            use_kernels=use_kernels,
                            mask_mode=opts.get("pallas_mask_mode", "prng"))
    else:
        # the JAX trainer passes no mask mode: 'prng', make_step_fns' default
        from njode_tpu_torch.ops import fused_gob
        use_kernels = opts.get("use_pallas", device.type == "cuda"
                               and fused_gob.supported(cfg))
        fns = gob.make_step_fns(model, optimizer, times, dts, next_cond_exp,
                                use_kernels=use_kernels,
                                mask_mode=opts.get("pallas_mask_mode",
                                                   "prng"))

    # device-resident dataset
    train_paths_np, train_obs_np = data_train.dense_arrays(functions)
    val_paths_np, val_obs_np = data_val.dense_arrays(functions)
    d_train_paths = torch.as_tensor(train_paths_np, device=device)
    d_train_obs = torch.as_tensor(train_obs_np, device=device)
    d_val_paths = torch.as_tensor(val_paths_np, device=device)
    d_val_obs = torch.as_tensor(val_obs_np, device=device)
    n_train = len(data_train)
    val_idx_all = torch.arange(len(data_val), device=device)

    # ------- resume from checkpoint -------
    best_eval_loss = np.inf
    metr_columns = list(METR_COLUMNS)
    if options.get("evaluate"):
        metr_columns.append("evaluation_mean_diff")
    metric_rows = []
    epoch = 1
    cur_weight = float(params_dict["weight"])
    w_decay = float(params_dict["weight_decay"])
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
            ev = cols.index("eval_loss")
            best_eval_loss = min(r[ev] for r in metric_rows)
            epoch += 1
            cur_weight = njode.weight_decay_step(cur_weight, w_decay)
            initial_print += f"\nepoch: {epoch}, weight: {cur_weight}"
        except (OSError, KeyError, ValueError, RuntimeError) as e:
            initial_print += "\nloading model failed -> initiate new model"
            initial_print += f"\nException:\n{e}"
            resume_training = False
    if not resume_training:
        initial_print += "\ninitiate new model ..."

    # ------- training loop -------
    if epoch <= epochs:
        initial_print += f"\n\nmodel overview ({model_name}):"
        print(initial_print)
        print(f"# parameters={count_params(model)}\n")
        print("start training ...")

    def _save(path):
        checkpoints.save_checkpoint(path, model, optimizer, epoch,
                                    cur_weight)

    def _flush_metrics():
        write_frame(model_metric_file, metr_columns, metric_rows)

    while epoch <= epochs:
        t0 = time.time()
        # seeded per-epoch shuffle and dropout stream
        perm = np.random.RandomState(
            (rseed * 100_003 + epoch) % 2**32).permutation(n_train)
        gen = torch.Generator(device=device).manual_seed(
            ((rseed + 1) * 100_003 + epoch) % 2**63)
        n_full = (n_train // batch_size) * batch_size
        perm_d = torch.as_tensor(perm, device=device)
        losses = []
        if n_full:
            losses.append(fns["train_epoch"](
                d_train_paths, d_train_obs,
                perm_d[:n_full].view(-1, batch_size), cur_weight, gen))
        if n_full < n_train:
            losses.append(fns["train_step"](
                d_train_paths, d_train_obs, perm_d[n_full:], cur_weight,
                gen).view(1))
        train_loss = float(torch.cat(losses)[-1])
        train_time = time.time() - t0

        # -------- evaluation --------
        t0 = time.time()
        loss_val = float(fns["eval_loss"](d_val_paths, d_val_obs,
                                          val_idx_all, cur_weight))
        eval_msd = 0.0
        if options.get("evaluate"):
            eval_msd = float(fns["eval_msd"](d_val_paths, d_val_obs,
                                             val_idx_all))
        eval_time = time.time() - t0
        print(f"epoch {epoch}, weight={cur_weight:.5f}, "
              f"train-loss={train_loss:.5f}, "
              f"optimal-eval-loss={opt_eval_loss:.5f}, "
              f"eval-loss={loss_val:.5f}, ")
        row = [epoch, train_time, eval_time, train_loss, loss_val,
               opt_eval_loss]
        if options.get("evaluate"):
            row.append(eval_msd)
            print(f"evaluation mean square difference={eval_msd:.5f}")
        metric_rows.append(row)

        # -------- save cadence --------
        if epoch % save_every == 0:
            print("save model ...")
            _flush_metrics()
            _save(model_path_save_last)
            print("saved!")
        if loss_val < best_eval_loss:
            print(f"save new best model: last-best-loss: "
                  f"{best_eval_loss:.5f}, new-best-loss: {loss_val:.5f}, "
                  f"epoch: {epoch}")
            _flush_metrics()
            _save(model_path_save_last)
            _save(model_path_save_best)
            best_eval_loss = loss_val
            print("saved!")

        epoch += 1
        cur_weight = njode.weight_decay_step(cur_weight, w_decay)

    # flush trailing metric rows (the JAX trainer's fix of the reference)
    if metric_rows:
        _flush_metrics()
    return 0
