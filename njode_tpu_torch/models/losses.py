"""NJODE loss in dense-masked (scan-step) form, the port's copy of
``njode_tpu/models/losses.py``.

The 'standard' loss

    (2w*sqrt(sum_d M*(X-Y)^2 + eps) + 2(1-w)*sqrt(sum_d M*(Y_bj-Y)^2 + eps))^2

summed over observed rows weighted by ``1/n_obs_ot``, divided by batch size,
and the 'easy' variant comparing ``Y_bj`` to ``X`` without the factor 2.
The dense form multiplies each row's contribution by the per-step
observation indicator instead of gathering observed rows.
"""

from __future__ import annotations

import torch

EPS = 1e-10


def _inner(which: str, X, Y, Y_bj, weight, M):
    """Per-row inner term of the loss; sums over the feature axis."""
    if M is None:
        M = torch.ones_like(X)
    e1 = torch.sum(M * (X - Y) ** 2, dim=-1)
    if which == "standard":
        e2 = torch.sum(M * (Y_bj - Y) ** 2, dim=-1)
        return (2.0 * weight * torch.sqrt(e1 + EPS)
                + 2.0 * (1.0 - weight) * torch.sqrt(e2 + EPS)) ** 2
    if which == "easy":
        e2 = torch.sum(M * (Y_bj - X) ** 2, dim=-1)
        return (weight * torch.sqrt(e1 + EPS)
                + (1.0 - weight) * torch.sqrt(e2 + EPS)) ** 2
    raise ValueError(f"unknown loss '{which}'")


def step_loss(which: str, X, Y, Y_bj, obs, n_obs_ot, batch_size,
              weight=0.5, M=None):
    """Dense per-step loss contribution.

    :param X: [B, D] observed values at this step (anything at unobserved rows)
    :param Y: [B, D] post-jump prediction
    :param Y_bj: [B, D] pre-jump prediction
    :param obs: [B] observation indicator for this step
    :param n_obs_ot: [B] total observations per row (0 allowed: masked out)
    :param batch_size: scalar
    :param M: optional [B, D] coordinate mask
    """
    inner = _inner(which, X, Y, Y_bj, weight, M)
    denom = torch.clamp(n_obs_ot, min=1.0)
    return torch.sum(obs * inner / denom) / batch_size
