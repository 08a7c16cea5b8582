"""Analysis and reporting over the saved-models tree, the port's copy of
``njode_tpu/analysis/extras.py`` without pandas.

- :func:`get_training_overview`: the model registry joined with each
  run's metric file: description parameters (``network_size`` = the first
  encoder width, ``activation_function_<n>``, keys nested under
  ``options``) and min/max/last/average aggregates of metric columns, with
  an optional early stop;
- :func:`get_cross_validation` / :func:`get_climate_cross_validation`:
  mean and standard deviation of target columns over the runs matching
  each parameter combination;
- the figures: :func:`plot_loss_diff`, :func:`plot_losses`,
  :func:`plot_convergence_study`, :func:`plot_loss_and_metric`,
  :func:`generate_training_progress_gif` and
  :func:`plot_paths_from_checkpoint` (the trainer in plot-only mode).

Tables are read and written with ``utils/csv_frame.py`` in pandas'
``to_csv`` layout; a column whose cells all read as integers holds ints,
else floats where they parse (an empty cell is NaN), else strings, as
pandas infers them. A table is returned as ``(columns, rows)``, each row a
dict. matplotlib (and imageio) are imported inside the figure functions;
where one is missing (a card machine) a figure prints one line and returns
None, and the tables still work.
"""

from __future__ import annotations

import json
import math
import os
import warnings

import numpy as np

from njode_tpu_torch.utils import paths as path_cfg
from njode_tpu_torch.utils.csv_frame import read_frame, write_frame
from njode_tpu_torch.utils.paths import makedirs


# ---------------------------------------------------------------------------
# tables
# ---------------------------------------------------------------------------

def _column(cells):
    try:
        return [int(c) for c in cells]
    except ValueError:
        pass
    try:
        return [float(c) if c != "" else math.nan for c in cells]
    except ValueError:
        return list(cells)


def read_table(path):
    """``(columns, rows)`` of a CSV written with an index column (dropped),
    each column typed as pandas would read it."""
    columns, raw = read_frame(path)
    cols = [_column([r[j] for r in raw]) for j in range(len(columns))]
    return columns, [dict(zip(columns, vals)) for vals in zip(*cols)]


def write_table(path, columns, rows):
    """Write ``rows`` (dicts) with a 0-based index; None and NaN are empty
    cells."""
    write_frame(path, columns,
                [[None if r.get(c) is None else r[c] for c in columns]
                 for r in rows])


def _values(rows, col):
    return np.array([math.nan if r[col] is None else r[col] for r in rows],
                    dtype=np.float64)


def _registry(path, ids_from=None, ids_to=None):
    _, rows = read_table(os.path.join(path, "model_overview.csv"))
    if ids_from:
        rows = [r for r in rows if r["id"] >= ids_from]
    if ids_to:
        rows = [r for r in rows if r["id"] <= ids_to]
    return rows


def _desc_param(param_dict, param):
    """One description parameter of a run (None where it has none)."""
    try:
        if param == "network_size":
            return param_dict["enc_nn"][0][0]
        if "activation_function" in param:
            return param_dict["enc_nn"][int(param.split("_")[-1]) - 1][1]
        if param in param_dict:
            return param_dict[param]
        # solo-trained runs nest extra options under 'options'
        return param_dict["options"][param]
    except (KeyError, IndexError, TypeError):
        return None


def _aggregate(how, columns, metric, col, out):
    """``how`` ('min', 'max', 'last', 'average') of column ``col`` over the
    metric rows; for min/max the value of ``out`` in the first row where
    ``col`` takes it. Raises KeyError for a missing column, IndexError for
    no rows."""
    if col not in columns:
        raise KeyError(col)
    vals = _values(metric, col)
    if how in ("min", "max"):
        if not metric:
            raise IndexError("no rows")
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)
            target = np.nanmin(vals) if how == "min" else np.nanmax(vals)
        hit = np.nonzero(vals == target)[0]
        return metric[hit[0]][out]
    if how == "last":
        return metric[-1][col]
    if how == "average":
        return float(np.nanmean(vals))
    raise ValueError(f"unknown aggregate '{how}'")


def get_training_overview(
        path=None, ids_from=None, ids_to=None,
        params_extract_desc=("network_size", "training_size", "dataset",
                             "hidden_size"),
        val_test_params_extract=(
            ("max", "epoch", "epoch", "epochs_trained"),
            ("min", "evaluation_mean_diff", "evaluation_mean_diff",
             "eval_metric_min"),
            ("last", "evaluation_mean_diff", "evaluation_mean_diff",
             "eval_metric_last"),
            ("average", "evaluation_mean_diff", "evaluation_mean_diff",
             "eval_metric_average")),
        early_stop_after_epoch=0,
        save_file=None):
    """``model_overview.csv`` joined with each run's metric file.

    :param params_extract_desc: description parameters, one column each
    :param val_test_params_extract: ``(how, column, value column, name)``:
        ``how`` in min/max (the value column at the first row where the
        column takes its min/max), last, average
    :param early_stop_after_epoch: only metric rows after this epoch
    :param save_file: the CSV to write (default
        ``<path>/model_overview-training_results.csv``; False: none)
    :return: ``(columns, rows)``. A run that never logged an aggregate's
        column, or has no rows left, gets an empty cell and a warning
        naming it.
    """
    path = path or path_cfg.saved_models_path
    rows = _registry(path, ids_from, ids_to)
    extracts = list(val_test_params_extract or ())
    columns = (["id", "description"] + list(params_extract_desc)
               + [e[3] for e in extracts])
    for row in rows:
        param_dict = json.loads(row["description"])
        for param in params_extract_desc:
            row[param] = _desc_param(param_dict, param)
        mid = row["id"]
        metric_file = os.path.join(path, f"id-{mid}", f"metric_id-{mid}.csv")
        metric_cols, metric = read_table(metric_file)
        if early_stop_after_epoch:
            metric = [m for m in metric
                      if m["epoch"] > early_stop_after_epoch]
        for how, col, out, name in extracts:
            row[name] = None
            try:
                row[name] = _aggregate(how, metric_cols, metric, col, out)
            except KeyError:
                warnings.warn(
                    f"model id-{mid}: metric column '{col}'/'{out}' not in "
                    f"{metric_file} -> '{name}' left empty", UserWarning,
                    stacklevel=2)
            except IndexError:
                warnings.warn(
                    f"model id-{mid}: metric file {metric_file} has no rows "
                    f"(after early-stop filter) -> '{name}' left empty",
                    UserWarning, stacklevel=2)
    if save_file is not False:
        write_table(save_file or os.path.join(
            path, "model_overview-training_results.csv"), columns, rows)
    return columns, rows


def get_cross_validation(
        params_extract_desc=("dataset", "network_size", "dropout_rate",
                             "hidden_size", "activation_function_1"),
        val_test_params_extract=(
            ("min", "eval_metric", "test_metric",
             "test_metric_evaluation_min"),
            ("min", "eval_metric", "eval_metric", "eval_metric_min")),
        target_col=("eval_metric_min", "test_metric_evaluation_min"),
        early_stop_after_epoch=0,
        param_combinations=(),
        save_path=None, path=None):
    """Mean and (population) standard deviation of each target column over
    the runs matching each parameter combination, empty cells skipped:
    the climate 5-fold cross-validation table, written to ``save_path``
    (default ``<path>/cross_val.csv``). :return: ``(columns, rows)``"""
    path = path or path_cfg.saved_models_path
    save_path = save_path or os.path.join(path, "cross_val.csv")
    _, overview = get_training_overview(
        path=path, params_extract_desc=params_extract_desc,
        val_test_params_extract=val_test_params_extract,
        early_stop_after_epoch=early_stop_after_epoch, save_file=False)
    columns = ["param_combination"]
    for tc in target_col:
        columns += [f"mean_{tc}", f"std_{tc}"]
    out = []
    for pc in param_combinations:
        match = [r for r in overview
                 if all(r[k] == v for k, v in pc.items())]
        row = {"param_combination": json.dumps(pc, sort_keys=True)}
        for tc in target_col:
            vals = _values(match, tc)
            vals = vals[~np.isnan(vals)]
            row[f"mean_{tc}"] = float(np.mean(vals)) if vals.size \
                else math.nan
            row[f"std_{tc}"] = float(np.std(vals)) if vals.size \
                else math.nan
        out.append(row)
    write_table(save_path, columns, out)
    return columns, out


def get_climate_cross_validation(early_stop_after_epoch=0, path=None,
                                 save_path=None):
    """The climate 5-fold cross-validation with the reference's parameter
    combinations."""
    combos = (
        {"network_size": 50, "activation_function_1": "tanh",
         "dropout_rate": 0.1, "hidden_size": 10, "dataset": "climate"},
        {"network_size": 200, "activation_function_1": "tanh",
         "dropout_rate": 0.1, "hidden_size": 10, "dataset": "climate"},
        {"network_size": 400, "activation_function_1": "tanh",
         "dropout_rate": 0.1, "hidden_size": 50, "dataset": "climate"},
        {"network_size": 50, "activation_function_1": "relu",
         "dropout_rate": 0.2, "hidden_size": 50, "dataset": "climate"},
        {"network_size": 100, "activation_function_1": "relu",
         "dropout_rate": 0.2, "hidden_size": 50, "dataset": "climate"},
        {"network_size": 400, "activation_function_1": "relu",
         "dropout_rate": 0.2, "hidden_size": 10, "dataset": "climate"},
    )
    return get_cross_validation(
        early_stop_after_epoch=early_stop_after_epoch,
        param_combinations=combos, path=path, save_path=save_path)


# ---------------------------------------------------------------------------
# figures
# ---------------------------------------------------------------------------

def _pyplot():
    """matplotlib's pyplot on the Agg backend, or None (one line printed)
    where matplotlib is missing."""
    from njode_tpu_torch.training.plots import have_matplotlib

    if not have_matplotlib():
        from njode_tpu_torch.training.trainer import PLOT_SKIPPED
        print(PLOT_SKIPPED)
        return None
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_loss_diff(path, filename, losses, xlab="epoch",
                   ylab=r"$[\Psi(Y) - \Psi(\hat{X})]/\Psi(\hat{X})$",
                   save_extras=None, fig_size=None):
    """Loss-difference curves, ``losses`` a list of ``(epochs, loss_diff,
    legend)``; returns the file written (None without matplotlib)."""
    plt = _pyplot()
    if plt is None:
        return None
    save_extras = save_extras or {}
    plt.figure(figsize=fig_size) if fig_size else plt.figure()
    for t, loss_diff, name in losses:
        plt.plot(t, loss_diff, label=name)
    plt.legend()
    if xlab:
        plt.xlabel(xlab)
    if ylab:
        plt.ylabel(ylab)
    makedirs(path)
    out = os.path.join(path, filename)
    plt.savefig(out, **save_extras)
    plt.close()
    return out


def plot_losses(files, names, time_col="epoch", col1="eval_loss",
                col2="optimal_eval_loss", relative_error=True,
                filename="plot.pdf", path="./", save_extras=None, **kwargs):
    """(Relative) ``col1`` minus ``col2`` curves from metric files."""
    save_extras = save_extras or {"bbox_inches": "tight", "pad_inches": 0.01}
    losses = []
    for file, name in zip(files, names):
        _, rows = read_table(file)
        loss = _values(rows, col1) - _values(rows, col2)
        if relative_error:
            loss = loss / _values(rows, col2)
        losses.append([_values(rows, time_col), loss, name])
    return plot_loss_diff(path, filename, losses, save_extras=save_extras,
                          **kwargs)


def generate_training_progress_gif(model_id, which_path=1,
                                   saved_models_path=None, duration=0.5):
    """The per-epoch ``epoch-<e>_path-<p>.png`` plots of a model as one
    animated GIF (frames padded white to a common size); returns its path,
    or None (one line printed) where imageio is missing. Runs that drew
    pdf figures need ``plot_save_format='png'``."""
    try:
        import imageio.v2 as imageio
    except ImportError:
        print("gif: imageio is not installed, the GIF is skipped")
        return None
    base = saved_models_path or path_cfg.saved_models_path
    plot_dir = os.path.join(base, f"id-{model_id}", "plots")
    suffix = f"path-{which_path}"
    pngs = [f for f in os.listdir(plot_dir)
            if f"{suffix}.png" in f and "epoch-" in f]
    if not pngs:
        raise FileNotFoundError(f"no epoch-*_{suffix}.png plots in "
                                f"{plot_dir} (train with "
                                "plot_save_format='png')")
    pngs.sort(key=lambda s: int(s.split("epoch-")[1].split("_")[0]))
    images = [imageio.imread(os.path.join(plot_dir, f)) for f in pngs]
    h = max(im.shape[0] for im in images)
    w = max(im.shape[1] for im in images)
    padded = []
    for im in images:
        canvas = np.full((h, w) + im.shape[2:], 255, dtype=im.dtype)
        canvas[:im.shape[0], :im.shape[1]] = im
        padded.append(canvas)
    out = os.path.join(plot_dir, f"training-progress-path-{which_path}.gif")
    imageio.mimsave(out, padded, duration=duration)
    return out


def plot_convergence_study(path=None, ids_from=None, ids_to=None,
                           x_axis="training_size", x_log=False, y_log=False,
                           save_path=None, save_extras=None):
    """Errorbar plot of each run's least ``evaluation_mean_diff`` (mean and
    standard deviation over repeats) against training size or network
    size; returns the file (None without matplotlib). A run without that
    column raises ValueError naming it."""
    path = path or path_cfg.saved_models_path
    save_path = save_path or os.path.join(path_cfg.data_path, "plots")
    save_extras = save_extras or {"bbox_inches": "tight", "pad_inches": 0.01}
    rows = _registry(path, ids_from, ids_to)
    for r in rows:
        d = json.loads(r["description"])
        r["network_size"] = d["enc_nn"][0][0]
        r["training_size"] = d.get("training_size",
                                   d.get("options", {}).get("training_size"))
    n_sizes = sorted({r["network_size"] for r in rows})
    t_sizes = sorted({r["training_size"] for r in rows})
    if x_axis == "training_size":
        xs, other_name, others = t_sizes, "network_size", n_sizes
    else:
        x_axis = "network_size"
        xs, other_name, others = n_sizes, "training_size", t_sizes
    means, stds = [], []
    for val2 in others:
        _m, _s = [], []
        for val1 in xs:
            losses = []
            for r in rows:
                if r[x_axis] != val1 or r[other_name] != val2:
                    continue
                mid = r["id"]
                metric_file = os.path.join(path, f"id-{mid}",
                                           f"metric_id-{mid}.csv")
                cols, metric = read_table(metric_file)
                if "evaluation_mean_diff" not in cols:
                    raise ValueError(
                        f"model id-{mid} has no 'evaluation_mean_diff' "
                        f"column in {metric_file}: it was trained without "
                        "evaluate=True and cannot enter a convergence "
                        f"study (available columns: {cols})")
                losses.append(np.min(_values(metric,
                                             "evaluation_mean_diff")))
            _m.append(np.mean(losses) if losses else np.nan)
            _s.append(np.std(losses) if losses else np.nan)
        means.append(_m)
        stds.append(_s)
    plt = _pyplot()
    if plt is None:
        return None
    colors = plt.rcParams["axes.prop_cycle"].by_key()["color"]
    f = plt.figure()
    ax = f.add_subplot(1, 1, 1)
    for i, (mean, std, val2) in enumerate(zip(means, stds, others)):
        ax.errorbar(xs, mean, yerr=std, label=f"{other_name}={val2}",
                    ecolor="black", capsize=4, capthick=1, marker=".",
                    color=colors[i % len(colors)])
    plt.xlabel(x_axis)
    plt.ylabel("eval metric")
    plt.legend()
    if x_log:
        ax.set_xscale("log")
    if y_log:
        ax.set_yscale("log")
    makedirs(save_path)
    save_file = os.path.join(save_path, f"convergence_{x_axis}.png")
    plt.savefig(save_file, **save_extras)
    plt.close()
    return save_file


def plot_paths_from_checkpoint(model_ids=(1,), which="best",
                               paths_to_plot=(0,), saved_models_path=None,
                               **options):
    """Re-enter ``trainer.train`` in plot-only mode on the best and/or last
    checkpoint of each run (``options``, e.g. ``device``, are passed on).
    :return: 0, or 1 without a registry"""
    from njode_tpu_torch.training import trainer

    base = saved_models_path or path_cfg.saved_models_path
    overview = os.path.join(base, "model_overview.csv")
    if not os.path.exists(overview):
        print("No saved model_overview.csv file")
        return 1
    descs = {r["id"]: r["description"] for r in _registry(base)}
    for model_id in model_ids:
        if model_id not in descs:
            print(f"model_id={model_id} does not exist yet -> skip")
            continue
        params_dict = json.loads(descs[model_id])
        params_dict.update(params_dict.pop("options", {}))
        params_dict.pop("optimal_eval_loss", None)
        params_dict.update(model_id=model_id, resume_training=True,
                           plot_only=True, paths_to_plot=paths_to_plot,
                           parallel=True, saved_models_path=base)
        params_dict.update(options)
        for slot, best in (("best", True), ("last", False)):
            if which in (slot, "both"):
                trainer.train(**dict(params_dict, load_best=best))
    return 0


def plot_loss_and_metric(model_ids=(1,), save_extras=None,
                         file_name="loss_and_metric-id{}.pdf",
                         time_col="epoch",
                         cols=("train_loss", "eval_loss",
                               "evaluation_mean_diff"),
                         names=("train_loss", "eval_loss", "eval_metric"),
                         saved_models_path=None):
    """Stacked subplots of metric columns per run; returns the files (None
    without matplotlib)."""
    plt = _pyplot()
    if plt is None:
        return None
    base = saved_models_path or path_cfg.saved_models_path
    save_extras = save_extras or {"bbox_inches": "tight", "pad_inches": 0.01}
    colors = plt.rcParams["axes.prop_cycle"].by_key()["color"]
    names = names or cols
    outs = []
    for model_id in model_ids:
        _, rows = read_table(os.path.join(base, f"id-{model_id}",
                                          f"metric_id-{model_id}.csv"))
        t = _values(rows, time_col)
        fig, axes = plt.subplots(len(cols))
        for i, col in enumerate(cols):
            axes[i].plot(t, _values(rows, col), color=colors[i % len(colors)])
            axes[i].set(ylabel=names[i])
        axes[-1].set(xlabel=time_col)
        out = os.path.join(base, f"id-{model_id}",
                           file_name.format(model_id))
        plt.savefig(out, **save_extras)
        plt.close(fig)
        outs.append(out)
    return outs
