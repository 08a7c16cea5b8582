"""GRU-ODE-Bayes over the dense union time grid, the port's copy of
``njode_tpu/models/gru_ode_bayes.py``.

The model of ``NNFOwithBayesianJumps`` (the reference's
``models_gru_ode_bayes.py``): ``covariates_map`` turns the covariates
(``start_X`` in the synthetic trainer) into ``h0``; ``p_model`` reads the
Gaussian (mean, var) of the next observation off ``h``; between
observations ``h`` follows a GRU-ODE field (minimal or full gate set,
driven by ``p`` when ``impute`` or autonomous otherwise) stepped by euler or
midpoint, or one discrete GRU cell tick (``discretized``); at an observation
the Gaussian NLL is taken and ``gru_obs`` jumps ``h``. The loss is the
**sum** over observations of the NLL plus ``mixing`` times the KL of the
post-jump Gaussian to the observation (noise std 1e-2).

:func:`forward` is the plain eager recursion, a Python loop over the K grid
steps; the training hot path on a CUDA device goes through
``ops/fused_gob.py`` instead. Dropout (in ``p_model`` and ``covariates_map``)
takes explicit keep-masks in the JAX package's fused-draw layout:
``drop_masks = (u0_cov [B, cov_hidden], u0_p [B, p_hidden], u [K, 3, B,
p_hidden])`` bool, slots ``[ode-midpoint, ode-final, post-jump]``, or drawn
from the caller's ``torch.Generator`` in that order when not given.

``solver='dopri5'`` runs through ops/odeint.py (eagerly, as in JAX: the
fused kernels cover euler and midpoint). Not ported yet (ROADMAP.md Queue 1
item 5): the Seq variants
(``GRUODEBayesSeq``, not wired into any trainer), the real-data step
functions (``make_grid_step_fns``, ``make_sparse_step_fns``,
``make_prestacked_step_fns``, with Queue 1 item 4).
"""

from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Optional

import numpy as np
import torch
from torch import nn

from njode_tpu_torch.data.grid import GridBatch

LOG_LIK_C = float(np.log(np.sqrt(2 * np.pi)))
OBS_NOISE_STD = 1e-2


@dataclasses.dataclass(frozen=True)
class GOBConfig:
    """Static config mirroring ``NNFOwithBayesianJumps.__init__`` (a plain
    copy of the JAX dataclass)."""

    input_size: int
    hidden_size: int
    p_hidden: int
    prep_hidden: int
    bias: bool = True
    cov_size: int = 1
    cov_hidden: int = 1
    logvar: bool = True
    mixing: float = 1.0
    dropout_rate: float = 0.0
    full_gru_ode: bool = False
    solver: str = "euler"
    impute: bool = True
    # Discretized_GRU: one GRUCell tick per grid step replaces the ODE step
    discretized: bool = False

    def __post_init__(self):
        if self.solver not in ("euler", "midpoint", "dopri5"):
            raise ValueError(
                "Solver must be either 'euler' or 'midpoint' or 'dopri5'.")
        if self.solver == "dopri5" and self.impute and not self.discretized:
            # the reference's dopri5 branch was written for the autonomous
            # (impute=False) field only; with impute the midpoint scheme runs
            warnings.warn(
                "GRU-ODE-Bayes solver='dopri5' supports impute=False only "
                "(the reference's dead dopri5 branch was autonomous-field "
                "only); running the fixed-grid midpoint scheme instead.",
                UserWarning, stacklevel=3)


def config_from_options(params_dict, options) -> GOBConfig:
    """The config from the trainer's option surface, with the reference
    trainer's defaults ('GRU_ODE_Bayes-<name>' options)."""
    hidden_size = params_dict["hidden_size"]

    def opt(name, default):
        return options.get(f"GRU_ODE_Bayes-{name}", default)

    return GOBConfig(
        input_size=params_dict["input_size"],
        hidden_size=hidden_size,
        p_hidden=opt("p_hidden", hidden_size),
        prep_hidden=opt("prep_hidden", hidden_size),
        bias=params_dict["bias"],
        # cov = start_X (dim = input_size) in the synthetic trainer
        cov_size=options.get("cov_size", params_dict["input_size"]),
        cov_hidden=opt("cov_hidden", hidden_size),
        logvar=opt("logvar", True),
        mixing=opt("mixing", 0.0001),
        dropout_rate=params_dict["dropout_rate"],
        full_gru_ode=opt("full_gru_ode", True),
        solver=opt("solver", "euler"),
        impute=opt("impute", False))


def propagation_mode(cfg: GOBConfig) -> str:
    """What the ODE step runs: 'disc', 'euler', 'midpoint' (also dopri5
    with impute) or 'dopri5' (the autonomous field through ops/odeint.py)."""
    if cfg.discretized:
        return "disc"
    if cfg.solver == "dopri5":
        return "midpoint" if cfg.impute else "dopri5"
    return cfg.solver


# ---------------------------------------------------------------------------
# modules (the reference's names)
# ---------------------------------------------------------------------------

def _linear(in_size, out_size, bias, generator):
    """Xavier-uniform weight, bias filled with 0.05 (``init_weights``)."""
    lin = nn.Linear(in_size, out_size, bias=bias)
    with torch.no_grad():
        nn.init.xavier_uniform_(lin.weight, generator=generator)
        if lin.bias is not None:
            lin.bias.fill_(0.05)
    return lin


def _mlp2_seq(in_size, hidden, out_size, rate, bias, generator,
              final_act=None):
    """Linear, ReLU, Dropout, Linear[, act]: Linear layers at 0 and 3."""
    layers = [_linear(in_size, hidden, bias, generator), nn.ReLU(),
              nn.Dropout(rate), _linear(hidden, out_size, bias, generator)]
    if final_act is not None:
        layers.append(final_act)
    return nn.Sequential(*layers)


def _gru_cell(in_size, hidden, bias, generator):
    """``nn.GRUCell`` with torch's default U(-1/sqrt(H), 1/sqrt(H)) init,
    drawn from ``generator``."""
    cell = nn.GRUCell(in_size, hidden, bias=bias)
    k = 1.0 / math.sqrt(hidden)
    with torch.no_grad():
        for p in cell.parameters():
            nn.init.uniform_(p, -k, k, generator=generator)
    return cell


class FullGRUODECell(nn.Module):
    """``FullGRUODECell`` (impute) / ``FullGRUODECell_Autonomous``:
    ``lin_x`` (input -> 3H, gates r, z, h), ``lin_hr``, ``lin_hz``,
    ``lin_hh`` (no bias)."""

    def __init__(self, in_size, hidden, bias, impute, generator):
        super().__init__()
        self.impute = impute
        if impute:
            self.lin_x = _linear(in_size, 3 * hidden, bias, generator)
        self.lin_hh = _linear(hidden, hidden, False, generator)
        self.lin_hz = _linear(hidden, hidden, False, generator)
        self.lin_hr = _linear(hidden, hidden, False, generator)

    def forward(self, x, h):
        if self.impute:
            xr, xz, xh = torch.chunk(self.lin_x(x), 3, dim=-1)
        else:
            xr = xz = xh = 0.0
        r = torch.sigmoid(xr + self.lin_hr(h))
        z = torch.sigmoid(xz + self.lin_hz(h))
        u = torch.tanh(xh + self.lin_hh(r * h))
        return (1.0 - z) * (u - h)


class GRUODECell(nn.Module):
    """``GRUODECell`` (impute) / ``GRUODECell_Autonomous``: ``lin_xz``,
    ``lin_xn`` (bias), ``lin_hz``, ``lin_hn`` (no bias)."""

    def __init__(self, in_size, hidden, bias, impute, generator):
        super().__init__()
        self.impute = impute
        if impute:
            self.lin_xz = _linear(in_size, hidden, bias, generator)
            self.lin_xn = _linear(in_size, hidden, bias, generator)
        self.lin_hz = _linear(hidden, hidden, False, generator)
        self.lin_hn = _linear(hidden, hidden, False, generator)

    def forward(self, x, h):
        if self.impute:
            z = torch.sigmoid(self.lin_xz(x) + self.lin_hz(h))
            n = torch.tanh(self.lin_xn(x) + self.lin_hn(z * h))
        else:
            z = torch.sigmoid(self.lin_hz(h))
            n = torch.tanh(self.lin_hn(z * h))
        return (1.0 - z) * (n - h)


class GRUObservationCell(nn.Module):
    """``GRUObservationCell[Logvar]``: the per-feature prep transform
    ``relu(stack([X, mean, (log)var, error]) @ w_prep + bias_prep)``,
    masked and flattened into the GRU jump ``gru_d``."""

    def __init__(self, D, hidden, prep, bias, generator):
        super().__init__()
        self.gru_d = _gru_cell(prep * D, hidden, bias, generator)
        std = math.sqrt(2.0 / (4 + prep))
        self.w_prep = nn.Parameter(
            std * torch.randn((D, 4, prep), generator=generator))
        self.bias_prep = nn.Parameter(torch.full((D, prep), 0.1))

    def forward(self, h, p, X, M, logvar: bool):
        """Dense update of every row; returns (h_jump, nll_per_row [B])."""
        mean, var = torch.chunk(p, 2, dim=-1)
        if logvar:
            sigma = torch.exp(0.5 * var)
            error = (X - mean) / sigma
            nll = 0.5 * ((error ** 2 + var + 2 * LOG_LIK_C) * M).sum(-1)
            feat2 = var
        else:
            var = torch.abs(var) + 1e-6
            error = (X - mean) / torch.sqrt(var)
            nll = 0.5 * ((error ** 2 + torch.log(var)) * M).sum(-1)
            feat2 = var
        stacked = torch.stack([X, mean, feat2, error], dim=-1)  # [B, D, 4]
        gru_in = torch.einsum("bdf,dfp->bdp", stacked, self.w_prep) \
            + self.bias_prep
        gru_in = torch.relu(gru_in) * M[:, :, None]
        h_jump = self.gru_d(gru_in.reshape(X.shape[0], -1), h)
        return h_jump, nll


class GOB(nn.Module):
    """The GRU-ODE-Bayes parameters under the reference's module names:
    ``p_model.{0,3}``, ``covariates_map.{0,3}``, ``classification_model.{0,3}``
    (kept though nothing reads it: Adam's L2 term updates it, as in the JAX
    pytree), ``gru_c`` (``lin_*``, or an ``nn.GRUCell`` when
    ``discretized``) and ``gru_obs`` (``gru_d``, ``w_prep``,
    ``bias_prep``).

    :param generator: the ``torch.Generator`` every initial weight is
        drawn from (the global one when None)
    """

    def __init__(self, cfg: GOBConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        H, D, rate, bias = (cfg.hidden_size, cfg.input_size,
                            cfg.dropout_rate, cfg.bias)
        g = generator
        self.p_model = _mlp2_seq(H, cfg.p_hidden, 2 * D, rate, bias, g)
        self.covariates_map = _mlp2_seq(cfg.cov_size, cfg.cov_hidden, H,
                                        rate, bias, g, final_act=nn.Tanh())
        self.classification_model = _mlp2_seq(H, 1, 1, rate, bias, g)
        if cfg.discretized:
            self.gru_c = _gru_cell(2 * D, H, bias, g)
        elif cfg.full_gru_ode:
            self.gru_c = FullGRUODECell(2 * D, H, bias, cfg.impute, g)
        else:
            self.gru_c = GRUODECell(2 * D, H, bias, cfg.impute, g)
        self.gru_obs = GRUObservationCell(D, H, cfg.prep_hidden, bias, g)

    def forward(self, batch: GridBatch, **kw):
        return forward(self, batch, **kw)


# ---------------------------------------------------------------------------
# the recursion
# ---------------------------------------------------------------------------

def mlp2(seq, x, rate, keep_mask=None):
    """Apply a :func:`_mlp2_seq` Sequential with dropout from a keep-mask
    ``[rows, >= hidden]`` (None: no dropout)."""
    y = torch.relu(seq[0](x))
    if keep_mask is not None and rate > 0.0:
        y = torch.where(keep_mask[..., :y.shape[-1]], y / (1.0 - rate),
                        torch.zeros_like(y))
    y = seq[3](y)
    if len(seq) > 4:
        y = seq[4](y)
    return y


def draw_masks(cfg: GOBConfig, K: int, B: int, generator, device):
    """Keep-masks for one training forward, Bernoulli(1-rate) from
    ``generator`` in this order: ``u0_cov [B, cov_hidden]``, ``u0_p [B,
    p_hidden]``, ``u [K, 3, B, p_hidden]``."""
    keep = 1.0 - cfg.dropout_rate
    u0c = torch.rand((B, cfg.cov_hidden), generator=generator,
                     device=device) < keep
    u0p = torch.rand((B, cfg.p_hidden), generator=generator,
                     device=device) < keep
    u = torch.rand((K, 3, B, cfg.p_hidden), generator=generator,
                   device=device) < keep
    return u0c, u0p, u


def _ode_step(model: GOB, h, p, dt, u_mid, u_fin, train: bool):
    """``ode_step``: euler, midpoint, dopri5 or the discretized cell;
    returns (h, p). Dropout applies where keep-masks are given.

    'dopri5' (impute=False) integrates the autonomous field with
    ops/odeint.py: in training one Dormand-Prince 5(4) step per grid
    interval (differentiable), in eval the adaptive integrator with PI
    step-size control over each interval (rtol 1e-6, atol 1e-8, at most 64
    attempts; a dt==0 padding step is a no-op), as the JAX package does."""
    cfg = model.cfg
    rate = cfg.dropout_rate
    if not cfg.impute:
        p = torch.zeros_like(p)
    mode = propagation_mode(cfg)
    if mode == "disc":
        h = model.gru_c(p, h)
        return h, mlp2(model.p_model, h, rate, u_fin)
    if mode == "euler":
        h = h + dt * model.gru_c(p, h)
    elif mode == "dopri5":
        from njode_tpu_torch.ops import odeint

        def field(t, y):
            return model.gru_c(p, y)

        if train:
            h, _ = odeint.dopri5_step(field, 0.0, h, dt)
        else:
            h, _ = odeint.integrate_segment_adaptive(
                field, h, 0.0, dt, dt, rtol=1e-6, atol=1e-8, max_steps=64)
    else:
        k = h + dt / 2.0 * model.gru_c(p, h)
        pk = mlp2(model.p_model, k, rate, u_mid)
        if not cfg.impute:
            pk = torch.zeros_like(pk)
        h = h + dt * model.gru_c(pk, k)
    return h, mlp2(model.p_model, h, rate, u_fin)


def kl_loss(p, X, M, logvar: bool, obs_noise_std=OBS_NOISE_STD):
    """``compute_KL_loss``, per-row sum."""
    mean, var = torch.chunk(p, 2, dim=-1)
    if logvar:
        std = torch.exp(0.5 * var)
    else:
        std = torch.sqrt(torch.abs(var) + 1e-5)
    s2 = obs_noise_std
    kl = (math.log(s2) - torch.log(std)
          + (std ** 2 + (mean - X) ** 2) / (2.0 * s2 ** 2) - 0.5)
    return (kl * M).sum(-1)


def forward(model: GOB, batch: GridBatch, train: bool = False,
            generator: Optional[torch.Generator] = None, drop_masks=None,
            get_loss: bool = True, return_path: bool = False):
    """Run the GRU-ODE-Bayes recursion over the grid (eager,
    differentiable); ``cov = start_X`` as in the synthetic trainer.

    :param drop_masks: ``(u0_cov, u0_p, u)`` keep-masks (see the module
        docstring); drawn from ``generator`` when ``train`` and dropout is
        on and none are given
    :returns: ``(h_final, loss)`` and, if ``return_path``,
        ``(p0, p_pre [K,B,2D], p_post [K,B,2D])``
    """
    cfg = model.cfg
    rate = cfg.dropout_rate
    B = batch.start_X.shape[0]
    K = batch.times.shape[0]
    device = batch.start_X.device
    dropping = train and rate > 0.0
    u0c = u0p = u = None
    if dropping:
        if drop_masks is None:
            drop_masks = draw_masks(cfg, K, B, generator, device)
        u0c, u0p, u = (torch.as_tensor(m, device=device).bool()
                       for m in drop_masks)
    r_eff = rate if dropping else 0.0
    h = mlp2(model.covariates_map, batch.start_X, r_eff, u0c)
    p = mlp2(model.p_model, h, r_eff, u0p)
    p0 = p
    loss1 = torch.zeros((), dtype=torch.float32, device=device)
    loss2 = torch.zeros((), dtype=torch.float32, device=device)
    pres, posts = [], []
    for k in range(K):
        dt, obs, X, M = batch.dt[k], batch.obs[k], batch.X[k], batch.M[k]
        u_mid = u[k, 0] if dropping else None
        u_fin = u[k, 1] if dropping else None
        u_post = u[k, 2] if dropping else None
        # (1) ODE propagation; dt==0 padding steps keep (h, p)
        h_prop, p_prop = _ode_step(model, h, p, dt, u_mid, u_fin, train)
        live = (dt > 0).to(h.dtype)
        h = live * h_prop + (1.0 - live) * h
        p = live * p_prop + (1.0 - live) * p
        p_pre = p
        # (2) jump + pre-jump NLL at observed rows
        h_jump, nll = model.gru_obs(h, p, X, M, cfg.logvar)
        obs_c = obs[:, None]
        h = obs_c * h_jump + (1.0 - obs_c) * h
        p_new = mlp2(model.p_model, h, r_eff, u_post)
        p = obs_c * p_new + (1.0 - obs_c) * p
        if get_loss:
            loss1 = loss1 + torch.sum(obs * nll)
            # (3) post-jump KL at observed rows
            loss2 = loss2 + torch.sum(obs * kl_loss(p, X, M, cfg.logvar))
        if return_path:
            pres.append(p_pre)
            posts.append(p)
    loss = loss1 + cfg.mixing * loss2
    if return_path:
        return h, loss, (p0, torch.stack(pres), torch.stack(posts))
    return h, loss


def get_pred(model: GOB, batch: GridBatch):
    """Predicted (mean) path on the grid: 'pred_t' [K+1], 'pred' [K+1, B,
    D] (post-jump) and 'pred_bj' [K, B, D]."""
    D = model.cfg.input_size
    with torch.no_grad():
        _, _, (p0, p_pre, p_post) = forward(model, batch, train=False,
                                            get_loss=False, return_path=True)
    ts = torch.cat([torch.zeros((1,), device=batch.times.device),
                    batch.times])
    ys = torch.cat([p0[None, :, :D], p_post[:, :, :D]], dim=0)
    return {"pred_t": ts, "pred": ys, "pred_bj": p_pre[:, :, :D]}


def evaluate(model: GOB, batch: GridBatch, next_cond_exp, diff_fun=None):
    """Duplicate-weighted MSE of the predicted mean path against the true
    conditional expectation (the same metric as NJODE's ``evaluate``), or a
    custom ``diff_fun`` on the duplicated numpy path arrays."""
    from njode_tpu_torch.data import oracle

    D = model.cfg.input_size
    with torch.no_grad():
        _, _, (p0, p_pre, p_post) = forward(model, batch, train=False,
                                            get_loss=False, return_path=True)
        true_pre, true_post = oracle.cond_exp_paths(next_cond_exp, batch)
        if diff_fun is None:
            return oracle.evaluation_mean_diff(
                p_pre[:, :, :D], p_post[:, :, :D], true_pre, true_post,
                p0[:, :D], batch.start_X, batch.obs, batch.dt)
    pred = oracle.stack_path_entries(p0[:, :D], p_pre[:, :, :D],
                                     p_post[:, :, :D], batch.obs, batch.dt)
    true = oracle.stack_path_entries(batch.start_X, true_pre, true_post,
                                     batch.obs, batch.dt)
    return diff_fun(pred, true)


# ---------------------------------------------------------------------------
# step functions
# ---------------------------------------------------------------------------

def make_step_fns(model: GOB, optimizer, times, dts, next_cond_exp=None,
                  use_kernels: bool = False, mask_mode: str = "prng"):
    """Step functions with the dict and signatures of
    ``training.steps.make_step_fns`` (the loss weight is accepted and
    ignored: ``mixing`` is fixed in the config).

    :param use_kernels: run the training loss through the fused GOB
        kernels (K5/K6, dropout K7) and the eval loss through K5's eval
        form (ops/fused_gob.py; their plain versions on CPU tensors).
        ``eval_msd`` and ``pred_path`` stay eager, as in the JAX package.
    :param mask_mode: the kernels' dropout-mask source ('prng' or 'input')
    """
    from njode_tpu_torch.training.steps import gather_dense_batch

    cfg = model.cfg
    if use_kernels:
        from njode_tpu_torch.ops import fused_gob
        fused = fused_gob.make_fused_loss_fn(cfg, mask_mode=mask_mode)
        fused_eval = fused_gob.make_fused_eval_fn(cfg)

        def _train_loss(batch, generator):
            return fused(model, batch, generator, True)

        def _eval_loss(batch):
            return fused_eval(model, batch)
    else:
        def _train_loss(batch, generator):
            return forward(model, batch, train=True, generator=generator)[1]

        def _eval_loss(batch):
            with torch.no_grad():
                return forward(model, batch, train=False)[1]

    def _batch(paths, obs, idx):
        return gather_dense_batch(paths, obs, idx, times, dts)

    # every parameter holds a gradient, zero where the loss does not reach
    # (classification_model): Adam's L2 term then updates it as the JAX
    # optimizer updates every leaf of the pytree
    for p in model.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)

    def train_step(paths, obs, idx, weight, generator):
        """One optimizer step on batch rows ``idx``; returns the loss."""
        batch = _batch(paths, obs, idx)
        optimizer.zero_grad(set_to_none=False)
        loss = _train_loss(batch, generator)
        loss.backward()
        optimizer.step()
        return loss.detach()

    def train_epoch(paths, obs, idx_mat, weight, generator):
        """One step per row of ``idx_mat [n_batches, B]``; returns the
        per-batch losses ``[n_batches]``."""
        return torch.stack([train_step(paths, obs, idx, weight, generator)
                            for idx in idx_mat])

    def eval_loss(paths, obs, idx, weight):
        return _eval_loss(_batch(paths, obs, idx))

    fns = {"train_step": train_step, "train_epoch": train_epoch,
           "eval_loss": eval_loss}
    if next_cond_exp is not None:
        def eval_msd(paths, obs, idx):
            return evaluate(model, _batch(paths, obs, idx), next_cond_exp)

        fns["eval_msd"] = eval_msd

    def pred_path(paths, obs, idx):
        return get_pred(model, _batch(paths, obs, idx))

    fns["pred_path"] = pred_path
    return fns
