"""Latent-ODE batch preparation and likelihood helpers, the port's copy of
``njode_tpu/data/lode_utils.py`` on tensors.

- :func:`split_and_subsample_batch` and what it calls: the interp/extrap
  split (:func:`split_data_interp`, :func:`split_data_extrap`), then
  optionally :func:`subsample_timepoints` or :func:`cut_out_timepoints`;
- the metric helpers: :func:`gaussian_log_likelihood`,
  :func:`masked_gaussian_log_density`, :func:`poisson_log_likelihood`,
  :func:`compute_binary_CE_loss`, :func:`compute_multiclass_CE_loss`.

The latent-ODE originals were torch; the dict keys (``observed_data``,
``data_to_predict``, ...) are theirs. Every function takes tensors (numpy
arrays are converted) and returns tensors on the input's device. The
random time points are drawn on the host from a numpy ``RandomState``
(``rng``; numpy's global state when None), the draws of the JAX module, so
both packages zero the same points. Nothing on the trainer path imports
this module.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "split_and_subsample_batch",
    "split_data_extrap",
    "split_data_interp",
    "subsample_timepoints",
    "cut_out_timepoints",
    "gaussian_log_likelihood",
    "masked_gaussian_log_density",
    "poisson_log_likelihood",
    "compute_binary_CE_loss",
    "compute_multiclass_CE_loss",
]


def _tensor(x):
    return None if x is None else torch.as_tensor(x)


def _clone(x):
    return None if x is None else x.clone()


# ---------------------------------------------------------------------------
# batch splitting (interp/extrap) and subsampling
# ---------------------------------------------------------------------------

def _split(data_dict, n_observed, mode):
    data = _tensor(data_dict["data"])
    ts = _tensor(data_dict["time_steps"])
    mask = _tensor(data_dict.get("mask"))
    obs = slice(None, n_observed)
    pred = slice(n_observed if mode == "extrap" else None, None)
    out = {
        "observed_data": data[:, obs].clone(),
        "observed_tp": ts[obs].clone(),
        "data_to_predict": data[:, pred].clone(),
        "tp_to_predict": ts[pred].clone(),
        "observed_mask": None if mask is None else mask[:, obs].clone(),
        "mask_predicted_data": None if mask is None
        else mask[:, pred].clone(),
        "labels": _clone(_tensor(data_dict.get("labels"))),
        "mode": mode,
    }
    return out


def split_data_extrap(data_dict, dataset: str = ""):
    """The first half of the timeline observed, the second to predict (a
    third observed for 'hopper')."""
    T = _tensor(data_dict["data"]).shape[1]
    return _split(data_dict, T // 3 if dataset == "hopper" else T // 2,
                  "extrap")


def split_data_interp(data_dict):
    """Observed and to-predict are both the whole timeline."""
    return _split(data_dict, None, "interp")


def subsample_timepoints(data, time_steps, mask, n_tp_to_sample=None,
                         rng=None):
    """Zero all but ``n_tp_to_sample`` time points per trajectory: above 1,
    that many grid points; in (0, 1], that fraction of each trajectory's
    non-empty points. Returns copies."""
    if n_tp_to_sample is None:
        return data, time_steps, mask
    rng = rng or np.random
    data = _tensor(data).clone()
    mask = _clone(_tensor(mask))
    n_tp_in_batch = len(time_steps)
    if n_tp_to_sample > 1:
        if n_tp_to_sample > n_tp_in_batch:
            raise ValueError("more time points to sample than in the batch")
        n_tp_to_sample = int(n_tp_to_sample)
        for i in range(data.shape[0]):
            missing = sorted(rng.choice(np.arange(n_tp_in_batch),
                                        n_tp_in_batch - n_tp_to_sample,
                                        replace=False))
            data[i, missing] = 0.0
            if mask is not None:
                mask[i, missing] = 0.0
    elif n_tp_to_sample > 0:
        for i in range(data.shape[0]):
            non_missing = np.where(mask[i].sum(-1).cpu().numpy() > 0)[0]
            n_to_sample = int(len(non_missing) * n_tp_to_sample)
            kept = sorted(rng.choice(non_missing, n_to_sample,
                                     replace=False))
            drop = np.setdiff1d(non_missing, kept)
            data[i, drop] = 0.0
            mask[i, drop] = 0.0
    return data, time_steps, mask


def cut_out_timepoints(data, time_steps, mask, n_points_to_cut=None,
                       rng=None):
    """Zero a random window of ``n_points_to_cut`` consecutive points per
    trajectory, its start drawn from [5, T - n - 5). Returns copies."""
    if n_points_to_cut is None:
        return data, time_steps, mask
    rng = rng or np.random
    data = _tensor(data).clone()
    mask = _clone(_tensor(mask))
    n_tp_in_batch = len(time_steps)
    if n_points_to_cut < 1:
        raise ValueError("Number of time points to cut out must be > 1")
    if n_points_to_cut > n_tp_in_batch:
        raise ValueError("more time points to cut than in the batch")
    n = int(n_points_to_cut)
    for i in range(data.shape[0]):
        start = int(rng.choice(np.arange(5, n_tp_in_batch - n - 5)))
        data[i, start:start + n] = 0.0
        if mask is not None:
            mask[i, start:start + n] = 0.0
    return data, time_steps, mask


def split_and_subsample_batch(data_dict, args, data_type: str = "train",
                              rng=None):
    """The latent-ODE batch preparation: the split by ``args.extrap``, a
    ones mask where none is given, then ``args.sample_tp`` subsampling or
    an ``args.cut_tp`` window (which cuts the prediction targets too)."""
    if getattr(args, "extrap", False):
        processed = split_data_extrap(data_dict,
                                      dataset=getattr(args, "dataset", ""))
    else:
        processed = split_data_interp(data_dict)
    if processed["observed_mask"] is None:
        processed["observed_mask"] = torch.ones_like(
            processed["observed_data"])
    sample_tp = getattr(args, "sample_tp", None)
    cut_tp = getattr(args, "cut_tp", None)
    if sample_tp is None and cut_tp is None:
        return processed
    if sample_tp is not None:
        data, ts, mask = subsample_timepoints(
            processed["observed_data"], processed["observed_tp"],
            processed["observed_mask"], n_tp_to_sample=sample_tp, rng=rng)
    if cut_tp is not None:
        data, ts, mask = cut_out_timepoints(
            processed["observed_data"], processed["observed_tp"],
            processed["observed_mask"], n_points_to_cut=cut_tp, rng=rng)
    processed = dict(processed, observed_data=data, observed_tp=ts,
                     observed_mask=mask)
    if cut_tp is not None:
        processed.update(data_to_predict=data.clone(), tp_to_predict=ts,
                         mask_predicted_data=mask.clone())
    return processed


# ---------------------------------------------------------------------------
# likelihood and cross-entropy helpers
# ---------------------------------------------------------------------------

_LOG_2PI = math.log(2.0 * math.pi)


def _normal_logpdf(x, mu, std):
    return -0.5 * ((x - mu) / std) ** 2 - math.log(std) - 0.5 * _LOG_2PI


def gaussian_log_likelihood(mu_2d, data_2d, obsrv_std):
    """Mean Gaussian log-density over the last axis (0 for an empty
    axis)."""
    mu_2d, data_2d = _tensor(mu_2d), _tensor(data_2d)
    n = mu_2d.shape[-1]
    if n == 0:
        return torch.zeros((), device=mu_2d.device)
    return _normal_logpdf(data_2d, mu_2d, float(obsrv_std)).sum(-1) / n


def masked_gaussian_log_density(mu, data, obsrv_std, mask=None):
    """Per-(trajectory, sample) Gaussian log-density ``[n_traj,
    n_traj_samples]``: over every point without a mask; with one, the mean
    over each (sample, trajectory, dim)'s observed time points, averaged
    over the dims (0 for a dim with none)."""
    mu, data = _tensor(mu), _tensor(data)
    std = float(obsrv_std)
    if mu.dim() == 3:
        mu = mu[None]
    if data.dim() == 2:
        data = data[None, :, None, :]
    elif data.dim() == 3:
        data = data[None]
    S, B, T, D = mu.shape
    if mask is None:
        lp = _normal_logpdf(data, mu, std).expand(S, B, T, D)
        return (lp.reshape(S, B, -1).sum(-1) / (T * D)).T
    mask = _tensor(mask)
    lp = (_normal_logpdf(data, mu, std) * mask).sum(dim=2)      # [S,B,D]
    cnt = mask.sum(dim=2)
    per_dim = torch.where(cnt > 0, lp / cnt.clamp(min=1.0),
                          torch.zeros_like(lp))
    return per_dim.mean(-1).T


def poisson_log_likelihood(masked_log_lambdas, masked_data, indices,
                           int_lambdas):
    """``sum(log lambda) - Lambda[indices]`` (0 for empty data)."""
    masked_data = _tensor(masked_data)
    if masked_data.shape[-1] == 0:
        return torch.zeros((), device=masked_data.device)
    return (torch.sum(_tensor(masked_log_lambdas))
            - _tensor(int_lambdas)[indices])


def compute_binary_CE_loss(label_predictions, mortality_label):
    """Binary cross-entropy with logits over the non-NaN labels, the labels
    repeated along the samples axis, divided by the number of samples."""
    pred = _tensor(label_predictions)
    label = _tensor(mortality_label).reshape(-1)
    if pred.dim() == 1:
        pred = pred[None]
    n_traj_samples = pred.shape[0]
    pred = pred.reshape(n_traj_samples, -1)
    ok = ~torch.isnan(label)
    pred, label = pred[:, ok], label[ok]
    ce = F.binary_cross_entropy_with_logits(
        pred, label.expand_as(pred).to(pred.dtype))
    return ce / n_traj_samples


def compute_multiclass_CE_loss(label_predictions, true_label, mask):
    """Mean cross-entropy of the time points with at least one
    measurement (a one-hot ``true_label`` is turned into class ids)."""
    pred = _tensor(label_predictions)
    true_label, mask = _tensor(true_label), _tensor(mask)
    if pred.dim() == 3:
        pred = pred[None]
    S, B, T, C = pred.shape
    labels = true_label.expand((S,) + tuple(true_label.shape))
    if C > 1 and true_label.shape[-1] > 1:
        labels = labels.argmax(-1)                              # [S,B,T]
    tp_mask = (mask.sum(-1) > 0).expand(S, B, T)
    lsm = torch.log_softmax(pred, dim=-1)
    ce = -torch.gather(lsm, -1, labels[..., None].long())[..., 0]
    sel = ce[tp_mask]
    return sel.mean() if sel.numel() else torch.zeros((), device=pred.device)
