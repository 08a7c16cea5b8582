"""The NJODE model over the dense union time grid, the port's copy of
``njode_tpu/models/njode.py``.

:func:`forward` is the plain eager recursion: a Python loop over the K grid
steps whose body performs (1) an Euler step ``h += dt * f(last_X, h, tau,
t-tau)``, (2) a masked jump ``h <- obs*encoder(X or imputation) +
(1-obs)*h``, (3) masked loss accumulation and (4) masked ``last_X``/``tau``
updates. It covers every branch of the JAX forward: masked imputation, the
``use_rnn`` GRU jump, ``input_current_t``, both losses, ``dt==0`` padding
steps and the batch-stacked readout. The training hot path on a CUDA device
goes through ``ops/fused_scan.py`` instead; this function is its reference.

Dropout takes explicit keep-masks in the JAX package's slot layout
``[ode..., enc..., readout_pre..., readout_post...]``: ``drop_masks =
(u0 [max(n_enc,1), B, Wmax], u [K, S, B, Wmax])`` bool, or drawn from the
caller's ``torch.Generator`` when not given.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from njode_tpu_torch.data.grid import GridBatch
from njode_tpu_torch.models import mlp
from njode_tpu_torch.models.losses import step_loss


def _norm_desc(nn_desc):
    if nn_desc is None:
        return None
    return tuple((int(w), str(a)) for w, a in nn_desc)


@dataclasses.dataclass(frozen=True)
class NJODEConfig:
    """Static model configuration (a plain copy of the JAX dataclass)."""

    input_size: int
    hidden_size: int
    output_size: int
    ode_nn: Optional[Tuple[Tuple[int, str], ...]]
    readout_nn: Optional[Tuple[Tuple[int, str], ...]]
    enc_nn: Optional[Tuple[Tuple[int, str], ...]]
    use_rnn: bool = False
    bias: bool = True
    dropout_rate: float = 0.0
    solver: str = "euler"
    which_loss: str = "standard"
    residual_enc_dec: bool = True
    input_current_t: bool = False
    masked: bool = False
    compute_dtype: str = "float32"

    def __post_init__(self):
        object.__setattr__(self, "ode_nn", _norm_desc(self.ode_nn))
        object.__setattr__(self, "readout_nn", _norm_desc(self.readout_nn))
        object.__setattr__(self, "enc_nn", _norm_desc(self.enc_nn))
        if self.solver != "euler":
            raise ValueError(f"Unknown solver '{self.solver}'.")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(
                f"Unknown compute_dtype '{self.compute_dtype}' "
                "(expected 'float32' or 'bfloat16').")

    @property
    def bf16(self) -> bool:
        """Mixed precision: every matmul's operands rounded to bfloat16,
        float32 sums and float32 everything else (``models/mlp.py``). The
        fused kernels are float32 only (``fused_scan.supported``), so such
        a config takes the eager forward."""
        return self.compute_dtype == "bfloat16"

    @property
    def enc_case(self):
        return mlp.residual_case(self.input_size, self.hidden_size,
                                 self.residual_enc_dec)

    @property
    def readout_case(self):
        return mlp.residual_case(self.hidden_size, self.output_size,
                                 self.residual_enc_dec)


def net_widths(cfg: NJODEConfig, which: str):
    """Full layer-width chain ``(in, hidden..., out)`` of one MLP stack:
    ode_f consumes ``[x, h, tau, t-tau(, t)]``, the encoder doubles its
    input under ``masked``."""
    time_feats = 3 if cfg.input_current_t else 2
    ins = {"ode_f": cfg.input_size + cfg.hidden_size + time_feats,
           "encoder": (2 * cfg.input_size if cfg.masked
                       else cfg.input_size),
           "readout": cfg.hidden_size}[which]
    outs = {"ode_f": cfg.hidden_size, "encoder": cfg.hidden_size,
            "readout": cfg.output_size}[which]
    nn_desc = {"ode_f": cfg.ode_nn, "encoder": cfg.enc_nn,
               "readout": cfg.readout_nn}[which]
    return (ins,) + tuple(w for (w, _) in (nn_desc or ())) + (outs,)


def dropout_slots(cfg: NJODEConfig):
    """(n_ode, n_enc, n_ro, Wmax): hidden-layer dropout-slot counts per
    sub-network and the max hidden width."""
    n_ode = len(cfg.ode_nn) if cfg.ode_nn else 0
    n_enc = len(cfg.enc_nn) if cfg.enc_nn else 0
    n_ro = len(cfg.readout_nn) if cfg.readout_nn else 0
    widths = [w for nn_desc in (cfg.ode_nn, cfg.enc_nn, cfg.readout_nn)
              if nn_desc for (w, _) in nn_desc]
    return n_ode, n_enc, n_ro, (max(widths) if widths else 1)


class NJODE(nn.Module):
    """The NJODE parameters under the reference's module names: ``ode_f.f``,
    ``encoder_map.ffnn``, ``readout_map.ffnn`` and, with ``use_rnn``,
    ``obs_c.gru_d``."""

    def __init__(self, cfg: NJODEConfig):
        super().__init__()
        self.cfg = cfg
        rate, bf16 = cfg.dropout_rate, cfg.bf16
        self.ode_f = mlp.ODEFunc(net_widths(cfg, "ode_f")[0], cfg.ode_nn,
                                 rate, cfg.bias, cfg.hidden_size, bf16)
        self.encoder_map = mlp.FFNN(cfg.input_size, cfg.hidden_size,
                                    cfg.enc_nn, rate, cfg.bias,
                                    cfg.residual_enc_dec, masked=cfg.masked,
                                    bf16=bf16)
        self.readout_map = mlp.FFNN(cfg.hidden_size, cfg.output_size,
                                    cfg.readout_nn, rate, cfg.bias,
                                    cfg.residual_enc_dec, masked=False,
                                    bf16=bf16)
        if cfg.use_rnn:
            self.obs_c = mlp.GRUJump(cfg.input_size, cfg.hidden_size,
                                     cfg.bias, bf16)

    def forward(self, batch: GridBatch, **kw):
        return forward(self, batch, **kw)


def draw_masks(cfg: NJODEConfig, K: int, B: int, generator, device):
    """Keep-masks for one training forward: ``(u0 [max(n_enc,1), B, Wmax],
    u [K, S, B, Wmax])`` bool, Bernoulli(1-rate) from ``generator``."""
    n_ode, n_enc, n_ro, w_max = dropout_slots(cfg)
    S = n_ode + n_enc + 2 * n_ro
    keep = 1.0 - cfg.dropout_rate
    u0 = torch.rand((max(n_enc, 1), B, w_max), generator=generator,
                    device=device) < keep
    u = torch.rand((K, S, B, w_max), generator=generator,
                   device=device) < keep
    return u0, u


def _slots(u, a, b):
    return None if u is None or b == a else [u[i] for i in range(a, b)]


def ode_input(cfg, last_X, h, tau, tdiff):
    feats = [torch.tanh(last_X), torch.tanh(h), tau, tdiff]
    if cfg.input_current_t:
        feats.append(tau + tdiff)
    return torch.cat(feats, dim=-1)


def forward(model: NJODE, batch: GridBatch, weight=0.5, train: bool = False,
            generator: Optional[torch.Generator] = None, drop_masks=None,
            get_loss: bool = True, return_path: bool = False):
    """Run the NJODE recursion over the grid (eager, differentiable).

    :param batch: a GridBatch of tensors on the model's device
    :param drop_masks: ``(u0, u)`` keep-masks (see module docstring); drawn
        from ``generator`` when ``train`` and dropout is on and none given
    :returns: ``(h_final, loss)`` and, if ``return_path``,
        ``(y0, y_pre [K,B,out], y_post [K,B,out])``
    """
    cfg = model.cfg
    B = batch.start_X.shape[0]
    K = batch.times.shape[0]
    device = batch.start_X.device
    n_ode, n_enc, n_ro, _ = dropout_slots(cfg)
    S = n_ode + n_enc + 2 * n_ro
    dropping = train and cfg.dropout_rate > 0.0 and S > 0
    u0 = u = None
    if dropping:
        if drop_masks is None:
            drop_masks = draw_masks(cfg, K, B, generator, device)
        u0, u = (torch.as_tensor(m, device=device).bool()
                 for m in drop_masks)

    zero_mask = torch.zeros_like(batch.start_X) if cfg.masked else None
    h = model.encoder_map(batch.start_X, zero_mask,
                          _slots(u0, 0, n_enc) if dropping else None)
    h0 = h
    last_X = batch.start_X
    tau = torch.zeros((B, 1), dtype=torch.float32, device=device)
    n_obs = batch.n_obs_ot
    loss = torch.zeros((), dtype=torch.float32, device=device)
    y_pres, y_posts = [], []
    for k in range(K):
        t, dt = batch.times[k], batch.dt[k]
        obs, X, M = batch.obs[k], batch.X[k], batch.M[k]
        uk = u[k] if dropping else None
        u_ode = _slots(uk, 0, n_ode)
        u_enc = _slots(uk, n_ode, n_ode + n_enc)
        u_r1 = _slots(uk, n_ode + n_enc, n_ode + n_enc + n_ro)
        u_r2 = _slots(uk, n_ode + n_enc + n_ro, S)
        tdiff = (t - dt) - tau
        # (1) Euler step; dt==0 padding steps are no-ops
        h = h + dt * model.ode_f(ode_input(cfg, last_X, h, tau, tdiff),
                                 u_ode)
        # (2) pre-jump prediction + jump at observed rows; use_rnn takes
        # precedence over masked (the GRU jump consumes the raw X_obs)
        obs_c = obs[:, None]
        if cfg.masked and not cfg.use_rnn:
            y_bj = model.readout_map(h, keep_masks=u_r1)
            X_imp = X * M + (1.0 - M) * y_bj
            h_jump = model.encoder_map(X_imp, M, u_enc)
            h_new = obs_c * h_jump + (1.0 - obs_c) * h
            y = model.readout_map(h_new, keep_masks=u_r2)
        else:
            if cfg.use_rnn:
                h_jump = model.obs_c(torch.tanh(X), torch.tanh(h))
            else:
                h_jump = model.encoder_map(X, None, u_enc)
            h_new = obs_c * h_jump + (1.0 - obs_c) * h
            # both readouts as one batch-stacked [2B] chain
            u_r = ([torch.cat([a, b], dim=0) for a, b in zip(u_r1, u_r2)]
                   if u_r1 is not None else None)
            y2 = model.readout_map(torch.cat([h, h_new], dim=0),
                                   keep_masks=u_r)
            y_bj, y = y2[:B], y2[B:]
        # (3) masked loss accumulation
        if get_loss:
            loss = loss + step_loss(
                which=cfg.which_loss, X=X, Y=y, Y_bj=y_bj, obs=obs,
                n_obs_ot=n_obs, batch_size=B, weight=weight,
                M=M if cfg.masked else None)
        # (4) masked last_X / tau updates
        new_last = y if cfg.masked else X
        last_X = torch.where(obs_c > 0, new_last, last_X)
        tau = torch.where(obs_c > 0, t.expand_as(tau), tau)
        h = h_new
        if return_path:
            y_pres.append(y_bj)
            y_posts.append(y)

    if return_path:
        if dropping and n_ro > 0:
            # t=0 readout dropout from its own draw, so the scan's mask
            # stream is untouched
            u0_ro = torch.rand((n_ro,) + tuple(u0.shape[1:]),
                               generator=generator, device=device) \
                < 1.0 - cfg.dropout_rate
            y0 = model.readout_map(h0, keep_masks=list(u0_ro))
        else:
            y0 = model.readout_map(h0)
        return h, loss, (y0, torch.stack(y_pres), torch.stack(y_posts))
    return h, loss


def get_pred(model: NJODE, batch: GridBatch):
    """Predicted path on the grid (eval mode): 'pred_t' [K+1], 'pred'
    [K+1, B, out] (post-jump at observation times) and 'pred_bj' [K,B,out]."""
    with torch.no_grad():
        _, _, (y0, y_pre, y_post) = forward(model, batch, train=False,
                                            get_loss=False, return_path=True)
    ts = torch.cat([torch.zeros((1,), device=batch.times.device),
                    batch.times])
    ys = torch.cat([y0[None], y_post], dim=0)
    return {"pred_t": ts, "pred": ys, "pred_bj": y_pre}


def evaluate(model: NJODE, batch: GridBatch, next_cond_exp, diff_fun=None):
    """Difference between predicted and true conditional expectation paths:
    the duplicate-weighted MSE of the reference's ``NJODE.evaluate``, or a
    custom ``diff_fun`` on the duplicated numpy path arrays."""
    from njode_tpu_torch.data import oracle

    with torch.no_grad():
        _, _, (y0, y_pre, y_post) = forward(model, batch, train=False,
                                            get_loss=False, return_path=True)
        true_pre, true_post = oracle.cond_exp_paths(next_cond_exp, batch)
        if diff_fun is None:
            return oracle.evaluation_mean_diff(
                y_pre, y_post, true_pre, true_post, y0, batch.start_X,
                batch.obs, batch.dt)
    pred = oracle.stack_path_entries(y0, y_pre, y_post, batch.obs, batch.dt)
    true = oracle.stack_path_entries(batch.start_X, true_pre, true_post,
                                     batch.obs, batch.dt)
    return diff_fun(pred, true)


def weight_decay_step(weight, weight_decay):
    """Decay the loss weight toward 0.5."""
    return 0.5 + (weight - 0.5) * weight_decay
