"""The GRU-ODE-Bayes training scan as hand-written CUDA kernels, with plain
versions.

The port's counterpart of ``njode_tpu/ops/fused_gob.py``. The whole K-step
scan over the state ``(h, mean, var)`` runs in one kernel launch
(``csrc/fused_gob.cu``): the forward (K5, ``gob_scan_fwd``) stores only the
step-entry carries ``h``, ``m``, ``v``; the backward (K6, ``gob_scan_bwd``)
re-materialises each step from them in reverse and sums every weight
gradient; the eval loss is K5 without histories or dropout; the ``p_model``
dropout keep-masks (K7, three slots ``[ode-midpoint, ode-final,
post-jump]`` of ``[B, p_hidden]`` per step) come from the Philox generator
the NJODE kernels use (``csrc/philox.cuh``, 'prng' mode) or from an int8
tensor ('input' mode). :class:`FusedGOBLoss` wraps the kernels as a
``torch.autograd.Function``; the t=0 prologue (``covariates_map`` -> h0,
``p_model`` -> (m0, v0)) stays outside in plain torch and its gradient
composes through the ``dh0``, ``dm0``, ``dv0`` the Function returns.

The kernels take the parameters as flat leaves in the JAX kernel's split
layout (``_flatten_params``): GRU gates as separate ``[., H]`` blocks, the
``p_model`` mean and var heads apart, the prep transform as four packed
block-diagonal ``[D, D*prep]`` blocks; every weight ``[in, out]``.
:func:`flat_leaves` builds them from the module with differentiable slices,
so autograd carries the leaf gradients back to the module's parameters. The
0/1 expander R of the per-feature mask (:func:`expander`) is implicit in the
kernels (they index ``M`` by ``column // prep``).

Every kernel has a plain PyTorch version here (``gob_scan_fwd_plain``,
``gob_scan_bwd_plain``, ``gob_masks_plain``). The wrappers take the plain
version only for tensors on the CPU; for CUDA tensors they launch the kernel
or raise. ``gob_scan_bwd_plain`` takes its gradients from ``torch.autograd``
over a re-run of each step, so it is independent of the hand-derived BPTT in
the CUDA source.

Kernel scope (``supported``, as the JAX kernel's): euler or midpoint, the
minimal or full GRU-ODE field, impute on or off, logvar or abs-var, the
discretized cell, bias on or off, dropout in both mask modes. Widths must
fit the kernels' shared memory (:meth:`Spec.smem_bytes`); the published
widths (D = 1, hidden 50 and 100) do, and ``supported`` is false for wider
ones, which the trainers run through the eager forward.
"""

from __future__ import annotations

import ctypes
import math

import torch

from njode_tpu_torch.models.gru_ode_bayes import (LOG_LIK_C, OBS_NOISE_STD,
                                                  propagation_mode)
from njode_tpu_torch.ops import fused_scan as fs
from njode_tpu_torch.ops.fused_scan import _check, _is_cuda, _ptr

ROWS = 8                  # batch rows per CTA (csrc/fused_gob.cu ROWS)
MAX_LEAVES = 40
SMEM_LIMIT = fs.SMEM_LIMIT

# launches per kernel; a wrapper adds one where it launches its kernel.
# 'gob_philox_keep' (K7) runs inside K5/K6: it counts their 'prng'-mode
# launches; 'gob_masks' counts the stand-alone mask dump (tests, timing).
# The per-CTA loss and gradient partials are summed by the NJODE library's
# reduce_partials (counted in fused_scan.LAUNCHES).
LAUNCHES = {"gob_scan_fwd": 0, "gob_scan_eval": 0, "gob_scan_bwd": 0,
            "gob_philox_keep": 0, "gob_masks": 0}


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def supported(cfg) -> bool:
    """Whether the CUDA kernels cover the given GOBConfig: the JAX kernel's
    rule (euler or midpoint; dopri5 runs eagerly) and widths whose buffers
    fit one CTA's shared memory (``Spec.smem_bytes`` within
    ``SMEM_LIMIT``). The trainers route a config outside to the eager
    ``gru_ode_bayes.forward`` (ROADMAP.md Queue 3 F1)."""
    return (cfg.solver in ("euler", "midpoint")
            and Spec(cfg).smem_bytes <= SMEM_LIMIT)


# shared-memory buffers of one CTA, per batch row: (name, width). The
# forward kernels use the first part, the backward all of it.
_FWD_BUFS = (
    ("h", "H"), ("m", "D"), ("v", "D"), ("X", "D"), ("M", "D"),
    ("obs", "1"), ("lrow", "1"), ("nll", "1"),
    ("f1a", "H"), ("f1b", "H"), ("f1c", "H"), ("f1d", "H"), ("fo", "H"),
    ("kk", "H"), ("mk", "D"), ("vk", "D"), ("prek", "P"), ("ak", "P"),
    ("f2a", "H"), ("f2b", "H"), ("f2c", "H"), ("f2d", "H"),
    ("h1p", "H"), ("pre1", "P"), ("a1", "P"), ("m1p", "D"), ("v1p", "D"),
    ("h1", "H"), ("m1", "D"), ("v1", "D"), ("err", "D"), ("ft2", "D"),
    ("pre", "DP"), ("gin", "DP"),
    ("ga", "H"), ("gb", "H"), ("gc", "H"), ("gd", "H"), ("gt", "H"),
    ("h2", "H"), ("pre2", "P"), ("a2", "P"), ("m2p", "D"), ("v2p", "D"),
    ("m2", "D"), ("v2", "D"))
_BWD_BUFS = (
    ("dh", "H"), ("dm", "D"), ("dv", "D"), ("dh2", "H"), ("dh1", "H"),
    ("dm1", "D"), ("dv1", "D"), ("dm2", "D"), ("dv2", "D"),
    ("dg0", "H"), ("dg1", "H"), ("dg2", "H"), ("dg3", "H"),
    ("dx", "W"), ("dp", "P"), ("dmk", "D"), ("dvk", "D"), ("dkk", "H"),
    ("df", "H"), ("fa0", "H"), ("fa1", "H"), ("fa2", "H"), ("dhf", "H"),
    ("dfm", "D"), ("dff", "D"), ("dfe", "D"))
BUFS = tuple(n for n, _ in _FWD_BUFS + _BWD_BUFS)

# named leaf slots (-1 where a configuration has none)
_SLOTS = (("pm", 6), ("fxm", 3), ("fxv", 3), ("fxb", 3), ("fh", 3),
          ("fhb", 3), ("wp", 4), ("bp", 1), ("ih", 3), ("hh", 3),
          ("bih", 3), ("bhh", 3))


# ---------------------------------------------------------------------------
# static spec
# ---------------------------------------------------------------------------

class Spec:
    """Static kernel specification derived from a GOBConfig.

    ``mask_mode``: 'input' (int8 keep-masks [K,3,B,P] drawn outside) or
    'prng' (Philox inside the kernels, keyed by a per-call seed)."""

    def __init__(self, cfg, mask_mode: str = "prng"):
        if mask_mode not in ("input", "prng"):
            raise ValueError(f"unknown mask_mode {mask_mode!r}")
        self.cfg = cfg
        self.mask_mode = mask_mode
        self.D, self.H, self.P = cfg.input_size, cfg.hidden_size, \
            cfg.p_hidden
        self.prep = cfg.prep_hidden
        self.DP = self.D * self.prep
        self.bias = bool(cfg.bias)
        self.logvar = bool(cfg.logvar)
        self.mixing = float(cfg.mixing)
        self.full = bool(cfg.full_gru_ode)
        self.impute = bool(cfg.impute)
        self.disc = bool(cfg.discretized)
        self.solver = cfg.solver
        self.rate = float(cfg.dropout_rate)
        # 0 euler, 1 midpoint, 2 the discretized cell (dopri5 has no kernel)
        self.prop = {"euler": 0, "midpoint": 1, "disc": 2,
                     "dopri5": -1}[propagation_mode(cfg)]
        self._build_leaves()

    def _build_leaves(self):
        D, H, P, DP = self.D, self.H, self.P, self.DP
        shapes, slots = [], {n: [-1] * k for n, k in _SLOTS}

        def add(slot, i, shape):
            slots[slot][i] = len(shapes)
            shapes.append(shape)

        for i, s in enumerate(((H, P), (1, P), (P, D), (1, D), (P, D),
                               (1, D))):
            add("pm", i, s)
        if self.disc:
            for k in range(3):                       # gates r, z, n
                add("fxm", k, (D, H))
                add("fxv", k, (D, H))
            for k in range(3):
                add("fh", k, (H, H))
            if self.bias:
                for k in range(3):
                    add("fxb", k, (1, H))
                for k in range(3):
                    add("fhb", k, (1, H))
        elif self.full:
            if self.impute:
                for k in range(3):                   # gates r, z, h
                    add("fxm", k, (D, H))
                    add("fxv", k, (D, H))
                if self.bias:
                    for k in range(3):
                        add("fxb", k, (1, H))
            for k in range(3):                       # Whr, Whz, Whh
                add("fh", k, (H, H))
        else:
            if self.impute:
                for k in range(2):                   # lin_xz, lin_xn
                    add("fxm", k, (D, H))
                    add("fxv", k, (D, H))
                    if self.bias:
                        add("fxb", k, (1, H))
            for k in range(2):                       # Whz, Whn
                add("fh", k, (H, H))
        for f in range(4):                           # X, mean, feat2, err
            add("wp", f, (D, DP))
        add("bp", 0, (1, DP))
        for k in range(3):
            add("ih", k, (DP, H))
        for k in range(3):
            add("hh", k, (H, H))
        if self.bias:
            for k in range(3):
                add("bih", k, (1, H))
            for k in range(3):
                add("bhh", k, (1, H))
        self.leaf_shapes = shapes
        self.slots = slots
        self.leaf_off = [0]
        for s in shapes:
            self.leaf_off.append(self.leaf_off[-1] + s[0] * s[1])
        self.n_params = self.leaf_off[-1]

    @property
    def thresh(self) -> int:
        return min(int((1.0 - self.rate) * 2.0 ** 32), 2 ** 32 - 1)

    def dropping(self, train: bool) -> bool:
        return bool(train) and self.rate > 0.0

    def layout(self, R: int = ROWS):
        """Float offsets of every shared-memory buffer of one CTA, the
        floats the forward kernels use and the total (backward)."""
        width = {"H": self.H, "D": self.D, "P": self.P, "DP": self.DP,
                 "W": max(self.P, self.DP), "1": 1}
        off, n = {}, 0
        for name, w in _FWD_BUFS + _BWD_BUFS:
            if name == _BWD_BUFS[0][0]:
                n_fwd = n
            off[name] = n
            n += (R * width[w] + 3) // 4 * 4       # 16-byte aligned
        return off, n_fwd, n

    @property
    def smem_bytes(self) -> int:
        return 4 * self.layout()[2]

    def weights(self, leaves):
        """Named view of the flat leaves (``None`` where absent)."""
        return {n: [None if i < 0 else leaves[i] for i in idx]
                for n, idx in self.slots.items()}


def expander(D: int, prep: int, dtype=torch.float32, device="cpu"):
    """The constant 0/1 expander R [D, D*prep] of the per-feature mask
    (``Mexp = M @ R``)."""
    R = torch.zeros((D, D * prep), dtype=dtype, device=device)
    for d in range(D):
        R[d, d * prep:(d + 1) * prep] = 1.0
    return R


def flat_leaves(model, spec: Spec):
    """The module's parameters as the kernels' leaves (differentiable
    slices and transposes, made contiguous)."""
    D, H, P, prep = spec.D, spec.H, spec.P, spec.prep
    dev = model.p_model[0].weight.device
    out = [None] * len(spec.leaf_shapes)
    sl = spec.slots

    def put(slot, i, t):
        out[sl[slot][i]] = t.contiguous()

    def bias_row(lin, n, a=0, b=None):
        if lin.bias is None:
            return torch.zeros((1, n), device=dev)
        return lin.bias[a:b].reshape(1, -1)

    pm0, pm1 = model.p_model[0], model.p_model[3]
    W1 = pm1.weight.t()
    for i, t in enumerate((pm0.weight.t(), bias_row(pm0, P), W1[:, :D],
                           bias_row(pm1, D, 0, D), W1[:, D:],
                           bias_row(pm1, D, D, 2 * D))):
        put("pm", i, t)
    g = model.gru_c
    if spec.disc:
        w_ih, w_hh = g.weight_ih.t(), g.weight_hh.t()
        for k in range(3):
            put("fxm", k, w_ih[:D, k * H:(k + 1) * H])
            put("fxv", k, w_ih[D:, k * H:(k + 1) * H])
            put("fh", k, w_hh[:, k * H:(k + 1) * H])
            if spec.bias:
                put("fxb", k, g.bias_ih[k * H:(k + 1) * H].reshape(1, H))
                put("fhb", k, g.bias_hh[k * H:(k + 1) * H].reshape(1, H))
    elif spec.full:
        if spec.impute:
            w = g.lin_x.weight.t()
            for k in range(3):
                put("fxm", k, w[:D, k * H:(k + 1) * H])
                put("fxv", k, w[D:, k * H:(k + 1) * H])
                if spec.bias:
                    put("fxb", k,
                        g.lin_x.bias[k * H:(k + 1) * H].reshape(1, H))
        for k, lin in enumerate((g.lin_hr, g.lin_hz, g.lin_hh)):
            put("fh", k, lin.weight.t())
    else:
        if spec.impute:
            for k, lin in enumerate((g.lin_xz, g.lin_xn)):
                w = lin.weight.t()
                put("fxm", k, w[:D])
                put("fxv", k, w[D:])
                if spec.bias:
                    put("fxb", k, lin.bias.reshape(1, H))
        for k, lin in enumerate((g.lin_hz, g.lin_hn)):
            put("fh", k, lin.weight.t())
    ob = model.gru_obs
    eye = torch.eye(D, device=dev)
    for f in range(4):
        # Wf[d, d*prep + q] = w_prep[d, f, q]: block-diagonal over d
        put("wp", f, torch.einsum("de,dq->edq", eye, ob.w_prep[:, f, :])
            .reshape(D, D * prep))
    put("bp", 0, ob.bias_prep.reshape(1, D * prep))
    cell = ob.gru_d
    w_ih, w_hh = cell.weight_ih.t(), cell.weight_hh.t()
    for k in range(3):
        put("ih", k, w_ih[:, k * H:(k + 1) * H])
        put("hh", k, w_hh[:, k * H:(k + 1) * H])
        if spec.bias:
            put("bih", k, cell.bias_ih[k * H:(k + 1) * H].reshape(1, H))
            put("bhh", k, cell.bias_hh[k * H:(k + 1) * H].reshape(1, H))
    return out


# ---------------------------------------------------------------------------
# K7: the p_model keep-masks (Philox of csrc/philox.cuh)
# ---------------------------------------------------------------------------

def gob_masks_plain(seed: int, k, B: int, P: int, thresh: int,
                    device="cpu"):
    """The three keep-mask slots of grid step(s) ``k``: bool ``[3, B, P]``
    (or ``[len(k), 3, B, P]``), exactly what the kernels draw: the NJODE
    kernels' Philox with slots 0-2, counter ``(col >> 2, row, k, slot)``.
    Slot 0 (midpoint) is drawn in every configuration."""
    return fs.philox_keep_plain(seed, k, 3, B, P, thresh, device)


def _step_masks_plain(spec, k, train, u, seed, B, device):
    """The three keep-masks [B, P] of step k, or None."""
    if not spec.dropping(train):
        return None
    if spec.mask_mode == "input":
        return [u[k, s] != 0 for s in range(3)]
    m = gob_masks_plain(seed, k, B, spec.P, spec.thresh, device)
    return [m[s] for s in range(3)]


# ---------------------------------------------------------------------------
# plain versions of K5/K6 (eager loops over the grid, on the split leaves)
# ---------------------------------------------------------------------------

def _lin(x, w, b=None):
    y = x @ w
    return y if b is None else y + b


def _p_model(spec, w, x, u, train):
    W0, b0, Wm, bm, Wv, bv = w["pm"]
    a = torch.relu(_lin(x, W0, b0))
    if u is not None and spec.dropping(train):
        a = torch.where(u, a / (1.0 - spec.rate), torch.zeros_like(a))
    return _lin(a, Wm, bm), _lin(a, Wv, bv)


def _xin(w, k, m, v):
    return _lin(m, w["fxm"][k]) + _lin(v, w["fxv"][k], w["fxb"][k])


def _field(spec, w, m, v, h):
    """GRU-ODE vector field dh."""
    fh = w["fh"]
    if spec.full:
        xr, xz, xh = ((_xin(w, k, m, v) for k in range(3)) if spec.impute
                      else (0.0, 0.0, 0.0))
        r = torch.sigmoid(xr + h @ fh[0])
        z = torch.sigmoid(xz + h @ fh[1])
        u = torch.tanh(xh + (r * h) @ fh[2])
        return (1.0 - z) * (u - h)
    xz, xn = ((_xin(w, 0, m, v), _xin(w, 1, m, v)) if spec.impute
              else (0.0, 0.0))
    z = torch.sigmoid(xz + h @ fh[0])
    n = torch.tanh(xn + (z * h) @ fh[1])
    return (1.0 - z) * (n - h)


def _gru(gi, hh, bhh, h):
    gh = [_lin(h, hh[k], bhh[k]) for k in range(3)]
    r = torch.sigmoid(gi[0] + gh[0])
    z = torch.sigmoid(gi[1] + gh[1])
    n = torch.tanh(gi[2] + r * gh[2])
    return (1.0 - z) * n + z * h


def _step_plain(spec, w, h, m, v, dt, obs, X, M, us, train):
    """One GOB step (the JAX kernel's ``_step_fwd``); returns (h2, m2,
    v2, loss_step)."""
    u_mid, u_fin, u_post = us if us is not None else (None, None, None)
    D = spec.D
    if dt > 0:
        zero = torch.zeros_like(m)
        m_in, v_in = (m, v) if spec.impute else (zero, zero)
        if spec.disc:
            gi = [_xin(w, k, m_in, v_in) if spec.impute else
                  (0.0 if w["fxb"][k] is None else w["fxb"][k])
                  for k in range(3)]
            h1 = _gru(gi, w["fh"], w["fhb"], h)
        elif spec.prop == 0:
            h1 = h + dt * _field(spec, w, m_in, v_in, h)
        else:
            kk = h + dt / 2.0 * _field(spec, w, m_in, v_in, h)
            if spec.impute:
                mk, vk = _p_model(spec, w, kk, u_mid, train)
            else:
                mk = vk = zero
            h1 = h + dt * _field(spec, w, mk, vk, kk)
        m1, v1 = _p_model(spec, w, h1, u_fin, train)
    else:                                   # dt==0 padding: no propagation
        h1, m1, v1 = h, m, v
    # observation update
    if spec.logvar:
        sigma = torch.exp(0.5 * v1)
        err = (X - m1) / sigma
        nll = 0.5 * ((err ** 2 + v1 + 2 * LOG_LIK_C) * M).sum(-1)
        feat2 = v1
    else:
        feat2 = torch.abs(v1) + 1e-6
        err = (X - m1) / torch.sqrt(feat2)
        nll = 0.5 * ((err ** 2 + torch.log(feat2)) * M).sum(-1)
    wp = w["wp"]
    pre = (X @ wp[0] + m1 @ wp[1] + feat2 @ wp[2] + err @ wp[3]
           + w["bp"][0])
    Mexp = M @ expander(D, spec.prep, device=M.device)
    gin = torch.relu(pre) * Mexp
    gi = [_lin(gin, w["ih"][k], w["bih"][k]) for k in range(3)]
    h_jump = _gru(gi, w["hh"], w["bhh"], h1)
    obs_c = obs[:, None]
    h2 = obs_c * h_jump + (1.0 - obs_c) * h1
    m2p, v2p = _p_model(spec, w, h2, u_post, train)
    m2 = obs_c * m2p + (1.0 - obs_c) * m1
    v2 = obs_c * v2p + (1.0 - obs_c) * v1
    s2 = OBS_NOISE_STD
    if spec.logvar:
        log_std, var = 0.5 * v2, torch.exp(v2)
    else:
        var = torch.abs(v2) + 1e-5
        log_std = 0.5 * torch.log(var)
    kl = ((math.log(s2) - log_std + (var + (m2 - X) ** 2) / (2.0 * s2 ** 2)
           - 0.5) * M).sum(-1)
    loss = torch.sum(obs * nll) + spec.mixing * torch.sum(obs * kl)
    return h2, m2, v2, loss


def _seed_int(seed):
    return None if seed is None else int(seed.reshape(-1)[0])


def gob_scan_fwd_plain(spec, leaves, arrays, h0, m0, v0, train, u=None,
                       seed=None, want_hists=True):
    """Plain K5: returns (loss, (h_hist [K,B,H], m_hist [K,B,D], v_hist
    [K,B,D]) or None), the histories holding each step's entry carries."""
    times, dts, obs, X, M = arrays
    K, B = obs.shape
    w = spec.weights(list(leaves))
    seed_i = _seed_int(seed)
    h, m, v = h0, m0, v0
    loss = torch.zeros((), dtype=torch.float32, device=h0.device)
    hists = ([], [], [])
    for k in range(K):
        if want_hists:
            for lst, x in zip(hists, (h, m, v)):
                lst.append(x)
        us = _step_masks_plain(spec, k, train, u, seed_i, B, h0.device)
        h, m, v, lk = _step_plain(spec, w, h, m, v, dts[k], obs[k], X[k],
                                  M[k], us, train)
        loss = loss + lk
    return loss, (tuple(torch.stack(x) for x in hists) if want_hists
                  else None)


def gob_scan_bwd_plain(spec, leaves, arrays, train, hists, dloss, u=None,
                       seed=None):
    """Plain K6: the reverse walk over the stored carries, each step re-run
    under autograd. Returns (grads in leaf order, dh0, dm0, dv0)."""
    times, dts, obs, X, M = arrays
    hh, mh, vh = hists
    K, B = obs.shape
    lv = [p.detach().requires_grad_(True) for p in leaves]
    w = spec.weights(lv)
    grads = [torch.zeros_like(p) for p in leaves]
    dh, dm, dv = (torch.zeros_like(x[0]) for x in hists)
    seed_i = _seed_int(seed)
    with torch.enable_grad():
        for k in reversed(range(K)):
            h = hh[k].detach().requires_grad_(True)
            m = mh[k].detach().requires_grad_(True)
            v = vh[k].detach().requires_grad_(True)
            us = _step_masks_plain(spec, k, train, u, seed_i, B, h.device)
            h2, m2, v2, lk = _step_plain(spec, w, h, m, v, dts[k], obs[k],
                                         X[k], M[k], us, train)
            objective = (lk * dloss + (h2 * dh).sum() + (m2 * dm).sum()
                         + (v2 * dv).sum())
            g = torch.autograd.grad(objective, [h, m, v] + lv,
                                    allow_unused=True)
            dh, dm, dv = (torch.zeros_like(x) if gx is None else gx
                          for x, gx in zip((h, m, v), g[:3]))
            for i, gi in enumerate(g[3:]):
                if gi is not None:
                    grads[i] = grads[i] + gi
    return grads, dh.detach(), dm.detach(), dv.detach()


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

class _GobCfg(ctypes.Structure):
    """Field-for-field mirror of ``struct GobCfg`` in csrc/fused_gob.cu."""
    _fields_ = ([(n, ctypes.c_int) for n in (
        "K", "B", "D", "H", "P", "DP", "prep", "n_params", "n_leaves",
        "full", "impute", "logvar", "prop", "bias", "mode")]
        + [("thresh", ctypes.c_uint32), ("keep", ctypes.c_float),
           ("mixing", ctypes.c_float)]
        + [(n, ctypes.c_int) for n in ("rows", "fwd_floats", "smem_floats")]
        + [("leaf_off", ctypes.c_int * (MAX_LEAVES + 1))]
        + [(n, ctypes.c_int * k) for n, k in _SLOTS]
        + [("o_" + n, ctypes.c_int) for n in BUFS])


def make_cfg(spec: Spec, K: int, B: int, train: bool):
    """The kernels' configuration for one call (host memory)."""
    off, n_fwd, total = spec.layout(ROWS)
    c = _GobCfg()
    c.K, c.B, c.D, c.H, c.P = K, B, spec.D, spec.H, spec.P
    c.DP, c.prep, c.n_params = spec.DP, spec.prep, spec.n_params
    c.n_leaves = len(spec.leaf_shapes)
    c.full, c.impute, c.logvar = int(spec.full), int(spec.impute), \
        int(spec.logvar)
    c.prop, c.bias = spec.prop, int(spec.bias)
    c.mode = (0 if not spec.dropping(train)
              else (1 if spec.mask_mode == "input" else 2))
    c.thresh = spec.thresh
    c.keep = 1.0 - spec.rate
    c.mixing = spec.mixing
    c.rows, c.fwd_floats, c.smem_floats = ROWS, n_fwd, total
    for i, o in enumerate(spec.leaf_off):
        c.leaf_off[i] = o
    for n, idx in spec.slots.items():
        arr = getattr(c, n)
        for i, j in enumerate(idx):
            arr[i] = j
    for n in BUFS:
        setattr(c, "o_" + n, off[n])
    return c


def _check_inputs(spec, leaves, arrays, train, u, seed):
    if spec.cfg.solver not in ("euler", "midpoint"):
        raise NotImplementedError(
            "config outside the GOB kernels' scope (solver "
            f"{spec.cfg.solver!r}: euler and midpoint only; dopri5 runs "
            "the eager models.gru_ode_bayes.forward)")
    if spec.smem_bytes > SMEM_LIMIT:
        raise NotImplementedError(
            f"GOB widths need {spec.smem_bytes} bytes of shared memory per "
            f"CTA, more than the card's {SMEM_LIMIT} (ROADMAP.md Queue 3 "
            "F1: the trainers run such configs through the eager "
            "models.gru_ode_bayes.forward)")
    times, dts, obs, X, M = arrays
    K, B = obs.shape
    for name, t, shp in (("times", times, (K,)), ("dts", dts, (K,)),
                         ("obs", obs, (K, B)), ("X", X, (K, B, spec.D)),
                         ("M", M, (K, B, spec.D))):
        _check(name, t, shp)
    if len(leaves) != len(spec.leaf_shapes):
        raise ValueError("wrong number of parameter leaves")
    for i, (p, s) in enumerate(zip(leaves, spec.leaf_shapes)):
        _check(f"leaf {i}", p, s)
    if spec.dropping(train):
        if spec.mask_mode == "input":
            _check("u", u, (K, 3, B, spec.P), torch.int8)
        else:
            _check("seed", seed, (1,), torch.int64)
    return K, B


def _raise_rc(lib, rc, what):
    if rc:
        raise RuntimeError(f"{what} failed: "
                           f"{lib.gob_error_string(rc).decode()} ({rc})")


def _leaf_ptrs(leaves):
    return (ctypes.c_void_p * len(leaves))(*[p.data_ptr() for p in leaves])


def gob_scan_fwd_cuda(spec, leaves, arrays, h0, m0, v0, train, u=None,
                      seed=None, want_hists=True):
    """Launch K5 (``want_hists``: the training form) or its eval form and
    reduce the per-CTA losses."""
    from njode_tpu_torch.ops import _build

    K, B = _check_inputs(spec, leaves, arrays, train, u, seed)
    if not want_hists and train:
        raise ValueError("the history-free kernel is the eval forward")
    _check("h0", h0, (B, spec.H))
    _check("m0", m0, (B, spec.D))
    _check("v0", v0, (B, spec.D))
    lib = _build.lib("fused_gob")
    times, dts, obs, X, M = arrays
    dev = h0.device
    n_cta = -(-B // ROWS)
    loss_part = torch.empty((n_cta,), dtype=torch.float32, device=dev)
    if want_hists:
        hists = (torch.empty((K, B, spec.H), device=dev),
                 torch.empty((K, B, spec.D), device=dev),
                 torch.empty((K, B, spec.D), device=dev))
    else:
        hists = (None, None, None)
    cfg = make_cfg(spec, K, B, train)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.gob_scan_fwd(
            ctypes.addressof(cfg), _leaf_ptrs(leaves), _ptr(dts), _ptr(obs),
            _ptr(X), _ptr(M), _ptr(u), _ptr(seed), _ptr(h0), _ptr(m0),
            _ptr(v0), _ptr(loss_part), *(_ptr(t) for t in hists),
            int(want_hists), stream)
    _raise_rc(lib, rc, "gob_scan_fwd")
    LAUNCHES["gob_scan_fwd" if want_hists else "gob_scan_eval"] += 1
    if cfg.mode == 2:
        LAUNCHES["gob_philox_keep"] += 1
    loss = fs._reduce(loss_part.view(n_cta, 1), 1.0)
    return loss.reshape(()), (hists if want_hists else None)


def gob_scan_bwd_cuda(spec, leaves, arrays, train, hists, dloss, u=None,
                      seed=None):
    """Launch K6 and reduce the per-CTA gradient partials; returns (grads
    as views of one flat buffer, in leaf order and shape, dh0, dm0, dv0)."""
    from njode_tpu_torch.ops import _build

    K, B = _check_inputs(spec, leaves, arrays, train, u, seed)
    hh, mh, vh = hists
    _check("h_hist", hh, (K, B, spec.H))
    _check("m_hist", mh, (K, B, spec.D))
    _check("v_hist", vh, (K, B, spec.D))
    dloss = dloss.reshape(1).to(torch.float32).contiguous()
    _check("dloss", dloss, (1,))
    lib = _build.lib("fused_gob")
    times, dts, obs, X, M = arrays
    dev = hh.device
    n_cta = -(-B // ROWS)
    partials = torch.empty((n_cta, spec.n_params), device=dev)
    dh0 = torch.empty((B, spec.H), device=dev)
    dm0 = torch.empty((B, spec.D), device=dev)
    dv0 = torch.empty((B, spec.D), device=dev)
    cfg = make_cfg(spec, K, B, train)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.gob_scan_bwd(
            ctypes.addressof(cfg), _leaf_ptrs(leaves), _ptr(dts), _ptr(obs),
            _ptr(X), _ptr(M), _ptr(u), _ptr(seed), _ptr(hh), _ptr(mh),
            _ptr(vh), _ptr(dloss), _ptr(partials), _ptr(dh0), _ptr(dm0),
            _ptr(dv0), stream)
    _raise_rc(lib, rc, "gob_scan_bwd")
    LAUNCHES["gob_scan_bwd"] += 1
    if cfg.mode == 2:
        LAUNCHES["gob_philox_keep"] += 1
    flat = fs._reduce(partials, 1.0)
    grads = [flat[a:b].view(s) for a, b, s in
             zip(spec.leaf_off[:-1], spec.leaf_off[1:], spec.leaf_shapes)]
    return grads, dh0, dm0, dv0


def gob_masks_cuda(seed, K: int, B: int, P: int, thresh: int):
    """All K7 keep-masks of K steps, ``[K, 3, B, P]`` int8, drawn by the
    kernels' Philox (the masks 'prng' mode uses; for tests and timing)."""
    from njode_tpu_torch.ops import _build

    _check("seed", seed, (1,), torch.int64)
    lib = _build.lib("fused_gob")
    out = torch.empty((K, 3, B, P), dtype=torch.int8, device=seed.device)
    stream = torch.cuda.current_stream(seed.device).cuda_stream
    with torch.cuda.device(seed.device):
        rc = lib.gob_masks(_ptr(seed), K, B, P, thresh, _ptr(out), stream)
    _raise_rc(lib, rc, "gob_masks")
    LAUNCHES["gob_masks"] += 1
    return out


def gob_scan_fwd(spec, leaves, arrays, h0, m0, v0, train, u=None, seed=None,
                 want_hists=True):
    """K5 on CUDA tensors, the plain version on CPU tensors."""
    if _is_cuda(h0):
        return gob_scan_fwd_cuda(spec, leaves, arrays, h0, m0, v0, train, u,
                                 seed, want_hists)
    with torch.no_grad():
        return gob_scan_fwd_plain(spec, leaves, arrays, h0, m0, v0, train,
                                  u, seed, want_hists)


def gob_scan_bwd(spec, leaves, arrays, train, hists, dloss, u=None,
                 seed=None):
    """K6 on CUDA tensors, the plain version on CPU tensors."""
    if _is_cuda(hists[0]):
        return gob_scan_bwd_cuda(spec, leaves, arrays, train, hists, dloss,
                                 u, seed)
    return gob_scan_bwd_plain(spec, leaves, arrays, train, hists, dloss, u,
                              seed)


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------

class FusedGOBLoss(torch.autograd.Function):
    """Loss of the GOB scan from the t=0 state ``(h0, m0, v0)``; the
    backward is K6 (CUDA) or its plain version (CPU). Differentiable in the
    t=0 state and the leaves; the batch arrays are data. The loss is a sum
    over observations: ``dloss`` reaches K6 as it is, not divided by B."""

    @staticmethod
    def forward(ctx, spec, train, u, seed, times, dts, obs, X, M, h0, m0,
                v0, *leaves):
        arrays = (times, dts, obs, X, M)
        loss, hists = gob_scan_fwd(spec, leaves, arrays, h0, m0, v0, train,
                                   u, seed, want_hists=True)
        ctx.spec, ctx.train = spec, train
        ctx.save_for_backward(times, dts, obs, X, M, u, seed, *hists,
                              *leaves)
        return loss

    @staticmethod
    def backward(ctx, dloss):
        saved = ctx.saved_tensors
        arrays = saved[:5]
        u, seed = saved[5], saved[6]
        hists = saved[7:10]
        leaves = saved[10:]
        grads, dh0, dm0, dv0 = gob_scan_bwd(ctx.spec, leaves, arrays,
                                            ctx.train, hists, dloss, u, seed)
        return (None,) * 9 + (dh0, dm0, dv0) + tuple(grads)


def _require_supported(cfg):
    if not supported(cfg):
        raise NotImplementedError(
            "config outside the GOB kernels' scope (solver "
            f"{cfg.solver!r}: euler and midpoint only; or widths beyond "
            "one CTA's shared memory, ROADMAP.md Queue 3 F1); use "
            "models.gru_ode_bayes.forward")


def make_fused_loss_fn(cfg, mask_mode: str = "prng", u_override=None):
    """Return ``loss_fn(model, batch, generator, train)``: the training loss
    through :class:`FusedGOBLoss`, differentiable in the model's parameters
    (the t=0 prologue runs in plain torch).

    Draws from ``generator`` in the order ``gru_ode_bayes.forward`` does:
    the t=0 ``covariates_map`` and ``p_model`` keep-masks, then the scan's
    masks ('input': a ``[K,3,B,P]`` Bernoulli draw; 'prng': one int64
    Philox seed that stays on the device). So in 'input' mode the kernel
    path and the eager forward given the same generator state use the same
    masks.

    :param u_override: 'input' mode only: keep-masks ``[K,3,B,P]`` used
        instead of the draw (replays another mask stream, e.g. the prng
        one, through the input path)."""
    from njode_tpu_torch.models import gru_ode_bayes as gob

    _require_supported(cfg)
    spec = Spec(cfg, mask_mode)

    def loss_fn(model, batch, generator, train):
        K, B = batch.obs.shape
        dev = batch.start_X.device
        dropping = spec.dropping(train)
        u = seed = None
        u0c = u0p = None
        if dropping:
            keep = 1.0 - spec.rate
            u0c = torch.rand((B, cfg.cov_hidden), generator=generator,
                             device=dev) < keep
            u0p = torch.rand((B, spec.P), generator=generator,
                             device=dev) < keep
            if mask_mode == "input":
                if u_override is not None:
                    u = torch.as_tensor(u_override, device=dev)
                else:
                    u = torch.rand((K, 3, B, spec.P), generator=generator,
                                   device=dev) < keep
                u = u.to(torch.int8).contiguous()
            else:
                seed = torch.randint(0, 2 ** 62, (1,), generator=generator,
                                     device=dev, dtype=torch.int64)
        rate = spec.rate if dropping else 0.0
        h0 = gob.mlp2(model.covariates_map, batch.start_X, rate, u0c)
        p0 = gob.mlp2(model.p_model, h0, rate, u0p)
        m0 = p0[:, :spec.D].contiguous()
        v0 = p0[:, spec.D:].contiguous()
        return FusedGOBLoss.apply(
            spec, train, u, seed, batch.times, batch.dt, batch.obs,
            batch.X, batch.M, h0.contiguous(), m0, v0,
            *flat_leaves(model, spec))

    return loss_fn


def make_fused_eval_fn(cfg):
    """Return ``eval_fn(model, batch)``: the eval loss through K5's
    history-free form (its plain version on CPU) at any batch size."""
    from njode_tpu_torch.models import gru_ode_bayes as gob

    _require_supported(cfg)
    spec = Spec(cfg, "input")

    def eval_fn(model, batch):
        with torch.no_grad():
            h0 = gob.mlp2(model.covariates_map, batch.start_X, 0.0)
            p0 = gob.mlp2(model.p_model, h0, 0.0)
            arrays = (batch.times, batch.dt, batch.obs, batch.X, batch.M)
            loss, _ = gob_scan_fwd(
                spec, flat_leaves(model, spec), arrays, h0.contiguous(),
                p0[:, :spec.D].contiguous(), p0[:, spec.D:].contiguous(),
                False, want_hists=False)
        return loss

    return eval_fn
