"""Path plotting: predicted vs true conditional expectation.

The port's copy of ``njode_tpu/training/plots.py``: the true path, its
observed points, the model's prediction, the true conditional expectation
(dotted) and an optional +-std band from the 'power-2' moment dimensions.
Takes numpy arrays. matplotlib is imported inside the functions, so the
package imports without it; where it is missing the trainer skips its
figures (:func:`have_matplotlib`)."""

from __future__ import annotations

import os

import numpy as np

from njode_tpu_torch.utils.paths import makedirs


def have_matplotlib() -> bool:
    """Whether matplotlib can be imported."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def plot_one_path_with_pred(
        batch_np, pred_t, pred_y, true_t, true_y, true_paths, observed_dates,
        delta_t, T, path_to_plot=(0,), save_path="", filename="plot_{}.pdf",
        plot_variance=False, functions=None, std_factor=1,
        model_name="NJODE", ylabels=None,
        save_extras=None):
    """Render per-path figures; returns the list of files written.

    :param pred_t/pred_y: model prediction grid [L] / [L, B, D_out]
    :param true_t/true_y: oracle cond-exp on the same grid
    :param true_paths: [B, D, T+1] raw paths; observed_dates: [B, T+1]
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.colors
    import matplotlib.pyplot as plt

    if model_name is None or model_name == "NJODE":
        model_name = "our model"
    save_extras = save_extras or {"bbox_inches": "tight", "pad_inches": 0.01}
    prop_cycle = plt.rcParams["axes.prop_cycle"]
    colors = prop_cycle.by_key()["color"]
    std_color = list(matplotlib.colors.to_rgb(colors[1])) + [0.5]
    makedirs(save_path)

    pred_y = np.asarray(pred_y)
    true_y = np.asarray(true_y)
    dim = true_paths.shape[1]
    grid_t = np.arange(true_paths.shape[2]) * delta_t

    # +-std band from the learned second moment when a 'power-2'
    # func_appl_X dimension is present; the moment dimensions follow the
    # identity block in the order of ``functions``
    band = None
    if plot_variance and functions and "power-2" in functions:
        m2_block = 1 + list(functions).index("power-2")
        second_moment = pred_y[..., m2_block * dim:(m2_block + 1) * dim]
        variance = second_moment - pred_y[..., :dim] ** 2
        if (variance < 0).any():
            print("WARNING: some predicted cond. variances below 0 -> clip")
            variance = np.clip(variance, 0.0, None)
        band = std_factor * np.sqrt(variance)

    files = []
    for i in path_to_plot:
        # observed points: grid column 0 counts as observed (start value)
        sel = np.asarray(observed_dates[i]).astype(bool).copy()
        sel[0] = True
        t_dots = grid_t[sel]
        x_dots = true_paths[i][:, sel].T                   # [n_obs, dim]

        fig, axs = plt.subplots(dim, squeeze=False)
        for d in range(dim):
            ax = axs[d, 0]
            ax.plot(grid_t, true_paths[i, d], color=colors[0],
                    label="true path")
            ax.scatter(t_dots, x_dots[:, d], color=colors[0],
                       label="observed")
            ax.plot(pred_t, pred_y[:, i, d], color=colors[1],
                    label=model_name)
            if band is not None:
                ax.fill_between(pred_t, pred_y[:, i, d] - band[:, i, d],
                                pred_y[:, i, d] + band[:, i, d],
                                color=std_color)
            ax.plot(true_t, true_y[:, i, d], linestyle=":", color=colors[2],
                    label="true conditional expectation")
            if ylabels:
                ax.set_ylabel(ylabels[d])
        plt.legend()
        plt.xlabel("$t$")
        out = os.path.join(save_path, filename.format(i))
        plt.savefig(out, **save_extras)
        plt.close(fig)
        files.append(out)
    return files
