"""Synthetic-dataset training, the port's copy of ``njode_tpu/training/trainer.py``.

Dataset resolution, train/val split, optimal-loss oracle, model registry
with resume-by-id, Adam (+5e-4 L2), epoch loop, full-validation-batch
eval (+ optional oracle mean-squared difference), last/best checkpoints on
the same cadence, the metric CSV with the same columns, loss-weight decay
per epoch, path plots on the save cadence and the plot-only mode; NJODE, or
GRU-ODE-Bayes with ``other_model="GRU_ODE_Bayes"``.

The dataset is resident on the device; each epoch queues its steps
(training/steps.py) and reads the losses once at its end, or with
'epoch_chunk' once at the end of a chunk of epochs (``train_epochs``,
which keeps each epoch's evaluation and snapshot on the device for the
rows and checkpoints). On a CUDA device
with a supported config the training and eval losses run through the
hand-written kernels (ops/fused_scan.py for NJODE, ops/fused_gob.py for
GRU-ODE-Bayes), as the JAX trainer picks its Pallas kernels on a TPU.
With the option 'mesh' (a ``parallel.sharding.Mesh``) the run is
data-parallel: every rank of the mesh calls ``train`` with the same
arguments, trains on its block of each batch's rows, and only rank 0
writes the registry, the metric CSV, the checkpoints and the plots.
The options 'profile_dir' and 'anomaly_detection' trace the first epoch
and check every step (utils/profiling.py)."""

from __future__ import annotations

import copy
import functools
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
from njode_tpu_torch.parallel import multihost, sharding
from njode_tpu_torch.training import checkpoints
from njode_tpu_torch.training.plots import have_matplotlib, \
    plot_one_path_with_pred
from njode_tpu_torch.training.steps import make_optimizer, make_step_fns
from njode_tpu_torch.utils import paths as path_cfg
from njode_tpu_torch.utils import profiling
from njode_tpu_torch.utils.csv_frame import read_frame, to_float, \
    write_frame
from njode_tpu_torch.utils.paths import makedirs

METR_COLUMNS = ["epoch", "train_time", "eval_time", "train_loss", "eval_loss",
                "optimal_eval_loss"]
default_ode_nn = ((50, "tanh"), (50, "tanh"))
default_readout_nn = ((50, "tanh"), (50, "tanh"))
default_enc_nn = ((50, "tanh"), (50, "tanh"))

# printed once by a run asked to plot where matplotlib cannot be imported
PLOT_SKIPPED = "plot: matplotlib is not installed, figures skipped"
# the per-epoch history of a chunk of epochs (parameters and Adam's two
# moments, 3x the parameters' bytes an epoch) is capped to this many bytes
HIST_BUDGET = 2 << 30


def train_val_split(nb_paths: int, test_size: float, seed: int):
    """The split of sklearn's ``train_test_split(np.arange(nb_paths),
    test_size=test_size, random_state=seed)``, reimplemented with numpy:
    ``n_test = ceil(test_size * n)``, the first ``n_test`` entries of
    ``RandomState(seed).permutation(n)`` are the test set."""
    n_test = int(np.ceil(test_size * nb_paths))
    perm = np.random.RandomState(seed).permutation(nb_paths)
    return perm[n_test:], perm[:n_test]


def _train(
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
    the caller asks for the CPU). ``plot`` defaults to False here, so that
    a call that does not ask for figures writes none (the JAX trainer's
    default is True; the demo and the published grids pass True). With
    ``plot`` the paths ``paths_to_plot`` of the validation set are drawn
    on the save cadence into ``id-<n>/plots/epoch-<e>_path-<i>.<fmt>``;
    where matplotlib cannot be imported (a GPU host without it) one line says
    so, the prediction and the optimal loss are still computed and
    printed, and no figure is written. Options read: 'base_data_path',
    'training_size', 'func_appl_X', 'which_loss', 'residual_enc_dec',
    'input_current_t', 'masked', 'evaluate', 'load_best',
    'resume_training', 'repeat_seed', 'parallel', 'plot_only' (draw the
    current model's paths as ``demo-plot_epoch-<e>_path-<i>.<fmt>`` and
    return without training), 'plot_variance' and 'std_factor' (a +-std
    band from a 'power-2' ``func_appl_X`` moment), 'ylabels',
    'save_extras' (``savefig`` keywords), 'plot_save_format' ('pdf'),
    'use_pallas' (use the fused kernels; default: on CUDA for
    a supported config), 'pallas_mask_mode' ('prng' or 'input'),
    'other_model' ("GRU_ODE_Bayes" trains that model instead of NJODE; its
    'GRU_ODE_Bayes-<name>' options as in ``gru_ode_bayes.
    config_from_options``; the optimal eval loss is then NaN),
    'epoch_chunk' (N > 1: queue N epochs and their evaluations through
    ``train_epochs`` before the host reads a loss; the metric rows and
    checkpoints are the per-epoch loop's, ``train_time`` the chunk's time
    an epoch and ``eval_time`` 0), 'epoch_chunk_hist_bytes' (the cap on a
    chunk's per-epoch history, default 2 GiB), 'ema_decay' (d: an
    epoch-level average ``ema = d*ema + (1-d)*params`` from the initial
    weights, evaluated after each epoch into the columns 'eval_loss_ema'
    and, with 'evaluate', 'evaluation_mean_diff_ema'; turns chunking off),
    'mesh' (a ``parallel.sharding.Mesh``: data-parallel training, every
    rank calling with the same arguments; ``batch_size`` must divide by
    its size, a last batch that does not is dropped; kept out of the
    registry description), 'compute_dtype' ('float32' or 'bfloat16': the
    matmuls' operands rounded to bfloat16, float32 sums; such a model
    trains through the eager forward), 'profile_dir' (a ``torch.profiler``
    Chrome trace of the first epoch's training written there,
    ``utils/profiling.trace``), 'anomaly_detection' (for the call: torch's
    autograd anomaly mode, and a NaN loss or gradient after a step raises
    FloatingPointError, ``utils/profiling.anomaly_detection``).
    :return: 0 (reference convention)
    """
    mesh = sharding.check_mesh(options.pop("mesh", None))
    if mesh is not None and batch_size % mesh.size:
        raise ValueError(f"batch_size={batch_size} must be divisible by the "
                         f"mesh size {mesh.size} for data-parallel training")
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
    T = metadata["maturity"]
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
    plot_variance = False
    std_factor = 1
    if functions is not None and mult > 1:
        plot_variance = options.get("plot_variance", False)
        std_factor = options.get("std_factor", 1)

    # ------- oracle & optimal eval loss -------
    stockmodel = sde.make_model(metadata["model_name"], metadata)
    next_cond_exp = stockmodel.next_cond_exp
    val_batch = to_torch(recompute_n_obs(batch_from_paths(
        data_val.stock_paths, data_val.observed_dates, delta_t,
        functions=functions)), device)
    opt_eval_loss = compute_optimal_eval_loss(val_batch, stockmodel,
                                              delta_t, T)
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
    model_metric_file = os.path.join(model_path,
                                     f"metric_id-{model_id}.csv")
    plot_save_path = os.path.join(model_path, "plots")

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
            masked=opts.get("masked", False),
            compute_dtype=opts.get("compute_dtype", "float32"))
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
        from njode_tpu_torch.ops import fused_scan as fused
        make = make_step_fns
    else:
        from njode_tpu_torch.ops import fused_gob as fused
        make = gob.make_step_fns
    use_kernels = opts.get("use_pallas", fused._is_cuda(device)
                           and fused.supported(cfg))

    def _make_fns(m, opt):
        # the JAX trainer passes GOB no mask mode: 'prng', the default
        return make(m, opt, times, dts, next_cond_exp,
                    use_kernels=use_kernels,
                    mask_mode=opts.get("pallas_mask_mode", "prng"),
                    mesh=mesh)

    fns = _make_fns(model, optimizer)

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
    ema_decay = options.get("ema_decay")
    metr_columns = list(METR_COLUMNS)
    if options.get("evaluate"):
        metr_columns.append("evaluation_mean_diff")
    if ema_decay:
        metr_columns.append("eval_loss_ema")
        if options.get("evaluate"):
            metr_columns.append("evaluation_mean_diff_ema")
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
    if mesh is not None:
        sharding.shard_params(model, mesh, optimizer)

    want_plots = bool(plot or options.get("plot_only"))
    draw = want_plots and have_matplotlib()
    if want_plots and not draw:
        print(PLOT_SKIPPED)

    def _pred_path(model_state):
        """The prediction on the validation set, from ``model_state`` (a
        snapshot of the model's state dict) if given, else from the live
        weights, which are restored after the call."""
        args = (d_val_paths, d_val_obs, val_idx_all)
        if model_state is None:
            return fns["pred_path"](*args)
        live = {k: v.clone() for k, v in model.state_dict().items()}
        model.load_state_dict(model_state)
        try:
            return fns["pred_path"](*args)
        finally:
            model.load_state_dict(live)

    def _plot(filename_tpl, weight_for_opt, model_state=None):
        """Draw ``paths_to_plot`` (where matplotlib is present); returns
        the optimal loss at ``weight_for_opt``."""
        pred = _pred_path(model_state)
        if draw and multihost.is_coordinator(mesh):
            _, y_post = oracle.cond_exp_paths(next_cond_exp, val_batch)
            true_t = np.concatenate([[0.0], val_batch.times.cpu().numpy()])
            true_y = np.concatenate([val_batch.start_X.cpu().numpy()[None],
                                     y_post.cpu().numpy()], axis=0)
            plot_one_path_with_pred(
                None, pred["pred_t"].cpu().numpy(),
                pred["pred"].cpu().numpy(), true_t, true_y,
                data_val.stock_paths, data_val.observed_dates, delta_t, T,
                path_to_plot=paths_to_plot, save_path=plot_save_path,
                filename=filename_tpl, plot_variance=plot_variance,
                functions=options.get("func_appl_X"), std_factor=std_factor,
                model_name=model_name, ylabels=options.get("ylabels"),
                save_extras=options.get("save_extras", {}))
        return compute_optimal_eval_loss(val_batch, stockmodel, delta_t, T,
                                         weight=weight_for_opt)

    # ------- plot-only mode -------
    plot_fmt = options.get("plot_save_format", "pdf")
    if options.get("plot_only"):
        epoch -= 1
        initial_print += "\nplotting ..."
        curr_opt = _plot(f"demo-plot_epoch-{epoch}" + "_path-{}." + plot_fmt,
                         cur_weight)
        initial_print += (f"\noptimal eval-loss (with current weight="
                          f"{cur_weight:.5f}): {curr_opt:.5f}")
        print(initial_print)
        return 0

    # ------- training loop -------
    if epoch <= epochs:
        initial_print += f"\n\nmodel overview ({model_name}):"
        print(initial_print)
        print(f"# parameters={count_params(model)}\n")
        print("start training ...")

    # 'epoch_chunk' = N: N epochs and their evaluations queued through
    # train_epochs before the host reads a loss, with the per-epoch loop's
    # streams, rows and checkpoints (from each epoch's snapshot)
    epoch_chunk = int(options.get("epoch_chunk", 0) or 0)
    if epoch_chunk > 1:
        state_bytes = 3 * sum(p.numel() * p.element_size()
                              for p in model.parameters())
        hist_budget = int(options.get("epoch_chunk_hist_bytes",
                                      HIST_BUDGET))
        max_chunk = hist_budget // max(state_bytes, 1)
        if max_chunk < 2:
            print(f"epoch_chunk disabled: model state "
                  f"({state_bytes >> 20} MiB x chunk) exceeds the "
                  f"history budget ({hist_budget >> 20} MiB; raise with "
                  "the 'epoch_chunk_hist_bytes' option); using per-epoch "
                  "dispatch")
            epoch_chunk = -1  # already explained
        elif epoch_chunk > max_chunk:
            print(f"epoch_chunk: capping {epoch_chunk} -> {max_chunk} "
                  f"(per-epoch history = {state_bytes >> 20} MiB/epoch, "
                  f"budget {hist_budget >> 20} MiB; raise with the "
                  "'epoch_chunk_hist_bytes' option)")
            epoch_chunk = max_chunk
    use_chunked = (epoch_chunk > 1 and not ema_decay
                   and n_train % batch_size == 0)
    if epoch_chunk > 1 and not use_chunked:
        why = ("ema_decay" if ema_decay else
               "ragged last batch (training size not divisible by "
               "batch_size)")
        print(f"epoch_chunk disabled ({why}); using per-epoch dispatch")
    ema_model = ema_fns = None
    if ema_decay:
        # a second module holding the average, evaluated through the same
        # step functions (the kernels' eval on the card) as the live one
        ema_model = copy.deepcopy(model).requires_grad_(False)
        ema_fns = _make_fns(ema_model, None)

    def _flush_metrics():
        multihost.coordinator_only(write_frame, model_metric_file,
                                   metr_columns, metric_rows, mesh=mesh)

    def _save_state(*a):
        multihost.coordinator_only(checkpoints.save_state, *a, mesh=mesh)

    def _perm(ep):
        # seeded per-epoch shuffle
        return np.random.RandomState(
            (rseed * 100_003 + ep) % 2**32).permutation(n_train)

    def _generator(ep):
        # the epoch's dropout stream
        return torch.Generator(device=device).manual_seed(
            ((rseed + 1) * 100_003 + ep) % 2**63)

    def _after_epoch(ep, weight, row, loss_val, state, snapshot=False):
        """Append the epoch's metric row, draw its plots and write its
        checkpoints (``state``: the epoch's (model, optimizer) state dicts;
        ``snapshot``: a copy taken at the epoch's end, not the live
        weights)."""
        nonlocal best_eval_loss
        metric_rows.append(row)
        if ep % save_every == 0:
            if plot:
                print("plotting ...")
                curr_opt = _plot(f"epoch-{ep}" + "_path-{}." + plot_fmt,
                                 weight, state[0] if snapshot else None)
                print(f"optimal eval-loss (with current weight="
                      f"{weight:.5f}): {curr_opt:.5f}")
            print("save model ...")
            _flush_metrics()
            _save_state(model_path_save_last, *state, ep, weight)
            print("saved!")
        if loss_val < best_eval_loss:
            print(f"save new best model: last-best-loss: "
                  f"{best_eval_loss:.5f}, new-best-loss: {loss_val:.5f}, "
                  f"epoch: {ep}")
            _flush_metrics()
            _save_state(model_path_save_last, *state, ep, weight)
            _save_state(model_path_save_best, *state, ep, weight)
            best_eval_loss = loss_val
            print("saved!")

    def _print_epoch(ep, weight, train_loss, loss_val):
        print(f"epoch {ep}, weight={weight:.5f}, "
              f"train-loss={train_loss:.5f}, "
              f"optimal-eval-loss={opt_eval_loss:.5f}, "
              f"eval-loss={loss_val:.5f}, ")

    # the first epoch's (or chunk's) training is traced into 'profile_dir'
    profile_dir = options.get("profile_dir")
    profiled = False

    while epoch <= epochs and use_chunked:
        n_ep = min(epoch_chunk, epochs - epoch + 1)
        t0 = time.time()
        idx_mats = torch.as_tensor(np.stack([
            _perm(epoch + j).reshape(-1, batch_size) for j in range(n_ep)]),
            device=device)
        ws, w = [], cur_weight
        for _ in range(n_ep):
            ws.append(w)
            w = njode.weight_decay_step(w, w_decay)
        do_msd = bool(options.get("evaluate"))
        with profiling.trace(None if profiled else profile_dir):
            tl, ev, msd, p_hist, o_hist = fns["train_epochs"](
                d_train_paths, d_train_obs, idx_mats, ws,
                [_generator(epoch + j) for j in range(n_ep)], d_val_paths,
                d_val_obs, val_idx_all, do_msd)
            tl, ev, msd = (t.tolist() for t in (tl, ev, msd))
        profiled = True
        per_ep = (time.time() - t0) / n_ep
        for j in range(n_ep):
            _print_epoch(epoch + j, ws[j], tl[j], ev[j])
            row = [epoch + j, per_ep, 0.0, tl[j], ev[j], opt_eval_loss]
            if do_msd:
                row.append(msd[j])
                print(f"evaluation mean square difference={msd[j]:.5f}")
            _after_epoch(epoch + j, ws[j], row, ev[j],
                         (p_hist[j], o_hist[j]), snapshot=True)
        epoch += n_ep
        cur_weight = w

    while epoch <= epochs:
        t0 = time.time()
        perm = _perm(epoch)
        gen = _generator(epoch)
        n_full = (n_train // batch_size) * batch_size
        perm_d = torch.as_tensor(perm, device=device)
        losses = []
        with profiling.trace(None if profiled else profile_dir):
            if n_full:
                losses.append(fns["train_epoch"](
                    d_train_paths, d_train_obs,
                    perm_d[:n_full].view(-1, batch_size), cur_weight, gen))
            if n_full < n_train and (mesh is None or
                                     (n_train - n_full) % mesh.size == 0):
                # under a mesh a last batch it does not divide is dropped
                losses.append(fns["train_step"](
                    d_train_paths, d_train_obs, perm_d[n_full:],
                    cur_weight, gen).view(1))
            train_loss = float(torch.cat(losses)[-1])
        profiled = True
        if ema_decay:
            with torch.no_grad():
                for e, p in zip(ema_model.parameters(), model.parameters()):
                    e.mul_(ema_decay).add_(p, alpha=1.0 - ema_decay)
        train_time = time.time() - t0

        # -------- evaluation --------
        t0 = time.time()
        args = (d_val_paths, d_val_obs, val_idx_all)
        loss_val = float(fns["eval_loss"](*args, cur_weight))
        extra = []
        if options.get("evaluate"):
            extra.append(float(fns["eval_msd"](*args)))
        if ema_decay:
            extra.append(float(ema_fns["eval_loss"](*args, cur_weight)))
            if options.get("evaluate"):
                extra.append(float(ema_fns["eval_msd"](*args)))
        eval_time = time.time() - t0
        _print_epoch(epoch, cur_weight, train_loss, loss_val)
        row = [epoch, train_time, eval_time, train_loss, loss_val,
               opt_eval_loss] + extra
        if options.get("evaluate"):
            print(f"evaluation mean square difference={extra[0]:.5f}")
            if ema_decay:
                print(f"EMA eval-loss={extra[1]:.5f}, "
                      f"EMA mean square difference={extra[2]:.5f}")
        _after_epoch(epoch, cur_weight, row, loss_val,
                     (model.state_dict(), optimizer.state_dict()))

        epoch += 1
        cur_weight = njode.weight_decay_step(cur_weight, w_decay)

    # flush trailing metric rows (the JAX trainer's fix of the reference)
    if metric_rows:
        _flush_metrics()
    return 0


@functools.wraps(_train)
def train(*args, **kwargs):
    with profiling.anomaly_detection(bool(kwargs.get("anomaly_detection"))):
        return _train(*args, **kwargs)


def compute_optimal_eval_loss(val_batch, stockmodel, delta_t, T,
                              weight=0.5):
    """Optimal evaluation loss on a GridBatch (the reference's
    ``train.py:648-670``): the loss of ``stockmodel``'s true conditional
    expectation. ``delta_t`` and ``T`` are the reference's arguments; the
    grid batch carries both. ``weight`` is the loss's weight (the
    reference's 0.5)."""
    return float(oracle.optimal_loss(stockmodel.next_cond_exp, val_batch,
                                     weight=weight))
