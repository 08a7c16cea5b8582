"""Closed-form conditional-expectation oracle on the dense union grid.

The port's copy of ``njode_tpu/data/oracle.py``: per step, propagate the
conditional expectation with the model's closed form, then overwrite
observed rows with the observed values (the "jump"). The optimal loss is the
NJODE loss of this predictor. Eager loops over the K grid steps on tensors.

Path recording matches the reference: the pre-jump value is recorded after
every Euler step and the post-jump value again at each observation time
(duplicate entries), which :func:`evaluation_mean_diff` weighs in.
"""

from __future__ import annotations

import numpy as np
import torch

from njode_tpu_torch.data.grid import GridBatch
from njode_tpu_torch.models.losses import step_loss


def cond_exp_paths(next_cond_exp, batch: GridBatch):
    """Run the oracle recursion over the grid.

    :param next_cond_exp: callable ``(y, dt, t_prev) -> y`` on tensors
    :param batch: a GridBatch of tensors
    :return: (y_pre [K, B, D], y_post [K, B, D]); the t=0 entry is not
        included
    """
    y = batch.start_X
    pres, posts = [], []
    for k in range(batch.times.shape[0]):
        t, dt = batch.times[k], batch.dt[k]
        y_prop = next_cond_exp(y, dt, t - dt)
        # dt==0 marks padding steps: keep y unchanged
        y_pre = torch.where(dt > 0, y_prop, y)
        y = torch.where(batch.obs[k][:, None] > 0, batch.X[k], y_pre)
        pres.append(y_pre)
        posts.append(y)
    return torch.stack(pres), torch.stack(posts)


def optimal_loss(next_cond_exp, batch: GridBatch, weight: float = 0.5):
    """Loss achieved by the true conditional expectation: per observation,
    ``Y`` is the post-jump value and ``Y_bj`` the pre-jump one."""
    B = batch.start_X.shape[0]
    y_pre, y_post = cond_exp_paths(next_cond_exp, batch)
    loss = torch.zeros((), dtype=torch.float32, device=y_pre.device)
    for k in range(batch.times.shape[0]):
        loss = loss + step_loss(
            which="standard", X=batch.X[k], Y=y_post[k], Y_bj=y_pre[k],
            obs=batch.obs[k], n_obs_ot=batch.n_obs_ot, batch_size=B,
            weight=weight, M=None)
    return loss


def evaluation_mean_diff(pred_pre, pred_post, true_pre, true_post,
                         y0_pred, y0_true, obs, dt):
    """Duplicate-weighted MSE between predicted and true cond-exp paths:
    ``np.mean((path_y_pred - path_y_true)**2)`` over the reference's path
    arrays (the t=0 entry, one entry per Euler step, one extra entry per
    observation time with >=1 observation in the batch).

    :param pred_pre/true_pre: [K, B, D] pre-jump values per grid step
    :param pred_post/true_post: [K, B, D] post-jump values per grid step
    :param y0_pred/y0_true: [B, D] values at t=0
    :param obs: [K, B] observation indicators
    :param dt: [K] step sizes (0 => padding step, excluded)
    """
    real = (dt > 0).to(pred_pre.dtype)                            # [K]
    any_obs = (obs.sum(dim=1) > 0).to(pred_pre.dtype) * real      # [K]
    B, D = y0_pred.shape
    sq0 = torch.sum((y0_pred - y0_true) ** 2)
    sq_pre = torch.sum(((pred_pre - true_pre) ** 2).sum(dim=(1, 2)) * real)
    sq_post = torch.sum(((pred_post - true_post) ** 2).sum(dim=(1, 2))
                        * any_obs)
    n_entries = 1.0 + torch.sum(real) + torch.sum(any_obs)
    return (sq0 + sq_pre + sq_post) / (n_entries * B * D)


def stack_path_entries(y0, y_pre, y_post, obs, dt):
    """Assemble the reference's duplicated path array on the host:
    ``[n_entries, B, D]`` numpy (the t=0 entry, one pre-jump entry per
    Euler step, an extra post-jump entry at each observation time)."""
    def host(a):
        return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) \
            else np.asarray(a)

    y0, y_pre, y_post, obs, dt = map(host, (y0, y_pre, y_post, obs, dt))
    entries = [y0]
    for k in range(len(dt)):
        if dt[k] <= 0 and not (k == 0 and obs[k].sum() > 0):
            continue  # padding step
        if dt[k] > 0:
            entries.append(y_pre[k])
        if obs[k].sum() > 0:
            entries.append(y_post[k])
    return np.stack(entries, axis=0)
