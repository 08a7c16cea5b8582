"""The NJODE training scan as hand-written CUDA kernels, with plain versions.

The port's counterpart of ``njode_tpu/ops/fused_scan.py``. The whole K-step
scan runs in one kernel launch (``csrc/fused_scan.cu``): the forward
(K1, ``njode_scan_fwd``) stores only the step-entry carries ``h``,
``last_X``, ``tau``; the backward (K2, ``njode_scan_bwd``) re-materialises
each step from them in reverse and sums every weight gradient; the eval
forward (K3) is K1 without histories or dropout; the dropout keep-masks
(K4) come from a counter-based Philox inside the kernels ('prng' mode) or
from an int8 tensor ('input' mode). :class:`FusedNJODELoss` wraps the
kernels as a ``torch.autograd.Function``; the t=0 encoder stays outside in
plain torch, its gradient composes through the ``dh0`` the Function
returns.

Every kernel has a plain PyTorch version here (``scan_fwd_plain``,
``scan_bwd_plain``, ``philox_keep_plain``, ``reduce_partials_plain``). The
wrappers take the plain version only for tensors on the CPU; for CUDA
tensors they launch the kernel or raise. ``scan_bwd_plain`` takes its
gradients from ``torch.autograd`` over a re-run of each step, so it is
independent of the hand-derived BPTT in the CUDA source.

Kernel scope (``supported``): unmasked, no GRU jump, euler, standard or
easy loss, tanh/relu MLPs of any depth up to ``MAX_LIN`` linears, residual
cases 0/1/2, ``input_current_t`` on or off, fp32, widths within the shared
memory of one CTA. The masked branch and the GRU jump come with the
real-data slice (ROADMAP.md Queue 1 item 4).
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from njode_tpu_torch.models import mlp
from njode_tpu_torch.models.losses import step_loss
from njode_tpu_torch.models.njode import dropout_slots, net_widths

ROWS = 16                 # batch rows per CTA (csrc/fused_scan.cu ROWS)
MAX_LIN = 8               # Linear layers per MLP
MAX_LEAVES = 3 * 2 * MAX_LIN
SMEM_LIMIT = 232448       # bytes of shared memory one CTA may use (H100)

# launches per kernel; a wrapper adds one where it launches its kernel.
# 'philox_keep' (K4) runs inside K1/K2: it counts their 'prng'-mode launches;
# 'philox_masks' counts the stand-alone mask dump used by tests and timing.
LAUNCHES = {"njode_scan_fwd": 0, "njode_scan_eval": 0, "njode_scan_bwd": 0,
            "philox_keep": 0, "reduce_partials": 0, "philox_masks": 0}


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# static spec
# ---------------------------------------------------------------------------

class Spec:
    """Static kernel specification derived from an NJODEConfig.

    ``mask_mode``: 'input' (int8 keep-masks [K,S,B,Wmax] drawn outside) or
    'prng' (Philox inside the kernels, keyed by a per-call seed)."""

    def __init__(self, cfg, mask_mode: str = "prng"):
        if mask_mode not in ("input", "prng"):
            raise ValueError(f"unknown mask_mode {mask_mode!r}")
        self.cfg = cfg
        self.mask_mode = mask_mode
        self.D, self.H, self.O = cfg.input_size, cfg.hidden_size, \
            cfg.output_size
        self.ict = bool(cfg.input_current_t)
        self.ode_w = net_widths(cfg, "ode_f")
        self.enc_w = net_widths(cfg, "encoder")
        self.ro_w = net_widths(cfg, "readout")
        self.ode_a = tuple(a for _, a in (cfg.ode_nn or ()))
        self.enc_a = tuple(a for _, a in (cfg.enc_nn or ()))
        self.ro_a = tuple(a for _, a in (cfg.readout_nn or ()))
        self.enc_case, self.enc_mult = mlp.residual_case(
            self.D, self.H, cfg.residual_enc_dec)
        self.ro_case, self.ro_mult = mlp.residual_case(
            self.H, self.O, cfg.residual_enc_dec)
        self.bias = bool(cfg.bias)
        self.rate = float(cfg.dropout_rate)
        self.easy = cfg.which_loss == "easy"
        self.n_ode, self.n_enc, self.n_ro, self.w_max = dropout_slots(cfg)
        # dropout slot layout [ode..., enc..., readout_pre..., readout_post...]
        self.s_ode = 0
        self.s_enc = self.n_ode
        self.s_r1 = self.n_ode + self.n_enc
        self.s_r2 = self.s_r1 + self.n_ro
        self.S = self.s_r2 + self.n_ro
        # flat leaf order: ode layers, enc layers, readout layers; per layer
        # weight [out, in] then bias [out]
        self.leaf_shapes = []
        for ws in (self.ode_w, self.enc_w, self.ro_w):
            for a, b in zip(ws[:-1], ws[1:]):
                self.leaf_shapes.append((b, a))
                if self.bias:
                    self.leaf_shapes.append((b,))
        self.leaf_off = [0]
        for s in self.leaf_shapes:
            n = 1
            for d in s:
                n *= d
            self.leaf_off.append(self.leaf_off[-1] + n)
        self.n_params = self.leaf_off[-1]
        self.buf_w = max(self.ode_w + self.enc_w + self.ro_w)

    @property
    def thresh(self) -> int:
        return min(int((1.0 - self.rate) * 2.0 ** 32), 2 ** 32 - 1)

    def split(self, flat):
        """Per-MLP lists of (W, b) from the flat leaf list."""
        out, i = [], 0
        for ws in (self.ode_w, self.enc_w, self.ro_w):
            layers = []
            for _ in range(len(ws) - 1):
                w = flat[i]
                i += 1
                b = None
                if self.bias:
                    b = flat[i]
                    i += 1
                layers.append((w, b))
            out.append(layers)
        return out

    def layout(self, R: int = ROWS):
        """Float offsets of every shared-memory region of one CTA, and the
        total; one layout serves K1-K3."""
        R2 = 2 * R
        D, H, O, P = self.D, self.H, self.O, self.n_params
        off, n = {}, 0

        def take(name, size):
            nonlocal n
            off[name] = n
            n += (size + 3) // 4 * 4        # 16-byte aligned regions

        take("w", P)
        take("g", P)
        for name, size in (("h", R * H), ("lx", R * D), ("tau", R),
                           ("X", R * D), ("obs", R), ("nobs", R),
                           ("lrow", R), ("h1", R * H), ("h2", R * H),
                           ("in_ode", R * self.ode_w[0]), ("tX", R * D),
                           ("in_ro", R2 * H), ("f", R * H), ("enc", R * H),
                           ("ro", R2 * O)):
            take(name, size)
        for name, ws, rows in (("s_ode", self.ode_w, R),
                               ("s_enc", self.enc_w, R),
                               ("s_ro", self.ro_w, R2)):
            take(name, 2 * rows * sum(ws[1:-1]))
        for name, size in (("dA", R2 * self.buf_w), ("dB", R2 * self.buf_w),
                           ("dh", R * H), ("dlx", R * D), ("dtau", R),
                           ("rs", 2 * R), ("dst", R2 * O), ("dh1", R * H),
                           ("dhe", R * H), ("df", R * H), ("dlxc", R * D),
                           ("dtauc", R)):
            take(name, size)
        return off, n

    @property
    def smem_bytes(self) -> int:
        return 4 * self.layout()[1]


def supported(cfg) -> bool:
    """Whether the CUDA kernels cover the given NJODEConfig."""
    if not (cfg.solver == "euler"
            and cfg.which_loss in ("standard", "easy")
            and cfg.ode_nn is not None and cfg.readout_nn is not None
            and cfg.enc_nn is not None
            and not cfg.masked and not cfg.use_rnn
            and cfg.output_size == cfg.input_size
            and getattr(cfg, "compute_dtype", "float32") == "float32"):
        return False
    nets = (cfg.ode_nn, cfg.enc_nn, cfg.readout_nn)
    if any(a not in ("tanh", "relu") for nn_desc in nets
           for _, a in nn_desc):
        return False
    if any(len(nn_desc) + 1 > MAX_LIN for nn_desc in nets):
        return False
    spec = Spec(cfg)
    return (len(spec.leaf_shapes) <= MAX_LEAVES
            and spec.smem_bytes <= SMEM_LIMIT)


def flat_leaves(model):
    """The model's parameters in the kernels' leaf order (no copies)."""
    out = []
    for seq in (model.ode_f.f, model.encoder_map.ffnn,
                model.readout_map.ffnn):
        for lin in mlp.linears(seq):
            out.append(lin.weight)
            if lin.bias is not None:
                out.append(lin.bias)
    return out


# ---------------------------------------------------------------------------
# K4: Philox4x32-10, plain version on int64 tensors masked to 32 bits
# ---------------------------------------------------------------------------

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK = 0xFFFFFFFF


def _mulhilo(a: int, b):
    """(hi, lo) 32-bit words of the 64-bit product a*b without int64
    overflow: split the constant into 16-bit halves."""
    p_lo = b * (a & 0xFFFF)                  # < 2^48
    p_hi = b * (a >> 16)                     # < 2^48
    s = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (s >> 32), s & _MASK


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """Random123's Philox4x32-10 on int64 tensors (or ints) holding
    32-bit words."""
    for i in range(10):
        if i:
            k0 = (k0 + _W0) & _MASK
            k1 = (k1 + _W1) & _MASK
        hi0, lo0 = _mulhilo(_M0, c0)
        hi1, lo1 = _mulhilo(_M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox_keep_plain(seed: int, k, S: int, B: int, w_max: int,
                      thresh: int, device="cpu"):
    """Keep-masks of all S slots at grid step(s) ``k``: bool
    ``[S, B, Wmax]`` (or ``[len(k), S, B, Wmax]`` for a tensor of steps),
    exactly what the kernels draw: counter ``(col >> 2, row, k, slot)``,
    key ``(seed_lo, seed_hi)``, word ``col & 3``, kept iff ``word <
    thresh``."""
    i64 = dict(dtype=torch.int64, device=device)
    col = torch.arange(w_max, **i64).view(1, 1, -1)
    row = torch.arange(B, **i64).view(1, -1, 1)
    slot = torch.arange(S, **i64).view(-1, 1, 1)
    kk = torch.as_tensor(k, **i64)
    if kk.dim():
        kk = kk.view(-1, 1, 1, 1)
    shape = torch.broadcast_shapes(kk.shape, (S, B, w_max))
    c0 = (col >> 2).expand(shape)
    c1 = row.expand(shape)
    c2 = kk.expand(shape)
    c3 = slot.expand(shape)
    r = philox4x32_10(c0, c1, c2, c3, seed & _MASK, (seed >> 32) & _MASK)
    w = (col & 3).expand(shape)
    word = torch.where(w == 0, r[0], torch.where(
        w == 1, r[1], torch.where(w == 2, r[2], r[3])))
    return word < thresh


# ---------------------------------------------------------------------------
# plain versions of K1-K3 (eager loops over the grid)
# ---------------------------------------------------------------------------

def _mlp_plain(layers, acts, x, masks, rate):
    w, b = layers[0]
    y = F.linear(x, w, b)
    keep = 1.0 - rate
    for i, name in enumerate(acts):
        y = mlp.act_fn(name, y)
        if masks is not None:
            y = torch.where(masks[i][:, :y.shape[-1]], y / keep,
                            torch.zeros_like(y))
        w, b = layers[i + 1]
        y = F.linear(y, w, b)
    return y


def _step_masks_plain(spec, k, train, u, seed, B, device):
    """The S per-slot keep-masks [B, Wmax] of step k, or None."""
    if not (train and spec.rate > 0.0 and spec.S > 0):
        return None
    if spec.mask_mode == "input":
        return [u[k, s] != 0 for s in range(spec.S)]
    m = philox_keep_plain(seed, k, spec.S, B, spec.w_max, spec.thresh,
                          device)
    return [m[s] for s in range(spec.S)]


def _step_plain(spec, nets, h, last_X, tau, t, dt, obs, X, us):
    """One step of the stacked-readout NJODE recursion; returns
    (h2, last_X', tau', y, y_bj)."""
    ws_ode, ws_enc, ws_ro = nets

    def sl(a, n):
        return None if us is None or n == 0 else us[a:a + n]

    tdiff = (t - dt) - tau
    feats = [torch.tanh(last_X), torch.tanh(h), tau, tdiff]
    if spec.ict:
        feats.append(tau + tdiff)
    f = _mlp_plain(ws_ode, spec.ode_a, torch.cat(feats, dim=-1),
                   sl(spec.s_ode, spec.n_ode), spec.rate)
    h1 = h + dt * f
    obs_c = obs[:, None]
    enc_o = _mlp_plain(ws_enc, spec.enc_a, torch.tanh(X),
                       sl(spec.s_enc, spec.n_enc), spec.rate)
    h_enc = mlp.residual_apply(spec.enc_case, spec.enc_mult, X, enc_o)
    h2 = obs_c * h_enc + (1.0 - obs_c) * h1
    hh = torch.cat([h1, h2], dim=0)
    u_r = None
    if us is not None and spec.n_ro:
        u_r = [torch.cat([a, b], dim=0) for a, b in
               zip(sl(spec.s_r1, spec.n_ro), sl(spec.s_r2, spec.n_ro))]
    y2 = mlp.residual_apply(spec.ro_case, spec.ro_mult, hh,
                            _mlp_plain(ws_ro, spec.ro_a, torch.tanh(hh),
                                       u_r, spec.rate))
    B = h.shape[0]
    y_bj, y = y2[:B], y2[B:]
    last_X2 = torch.where(obs_c > 0, X, last_X)
    tau2 = torch.where(obs_c > 0, t.expand_as(tau), tau)
    return h2, last_X2, tau2, y, y_bj


def _seed_int(seed):
    return None if seed is None else int(seed.reshape(-1)[0])


def scan_fwd_plain(spec, leaves, arrays, weight, h0, train, u=None,
                   seed=None, want_hists=True):
    """Plain K1/K3: returns (loss, (h_hist [K,B,H], lastX_hist [K,B,D],
    tau_hist [K,B,1]) or None)."""
    times, dts, obs, X, n_obs, start_X = arrays
    K, B = obs.shape
    nets = spec.split(list(leaves))
    seed_i = _seed_int(seed)
    h, lx = h0, start_X
    tau = torch.zeros((B, 1), dtype=torch.float32, device=h0.device)
    loss = torch.zeros((), dtype=torch.float32, device=h0.device)
    hists = ([], [], [])
    for k in range(K):
        if want_hists:
            for lst, v in zip(hists, (h, lx, tau)):
                lst.append(v)
        us = _step_masks_plain(spec, k, train, u, seed_i, B, h0.device)
        h, lx2, tau, y, y_bj = _step_plain(spec, nets, h, lx, tau, times[k],
                                           dts[k], obs[k], X[k], us)
        loss = loss + step_loss(
            "easy" if spec.easy else "standard", X=X[k], Y=y, Y_bj=y_bj,
            obs=obs[k], n_obs_ot=n_obs, batch_size=B, weight=weight)
        lx = lx2
    return loss, (tuple(torch.stack(v) for v in hists) if want_hists
                  else None)


def scan_bwd_plain(spec, leaves, arrays, weight, train, hists, dloss,
                   u=None, seed=None):
    """Plain K2: the reverse walk over the stored carries, each step re-run
    under autograd. Returns (grads in leaf order, dh0)."""
    times, dts, obs, X, n_obs, start_X = arrays
    hh, lxh, tauh = hists
    K, B = obs.shape
    lv = [p.detach().requires_grad_(True) for p in leaves]
    nets = spec.split(lv)
    grads = [torch.zeros_like(p) for p in leaves]
    dh = torch.zeros_like(hh[0])
    dlx = torch.zeros_like(lxh[0])
    dtau = torch.zeros_like(tauh[0])
    seed_i = _seed_int(seed)
    with torch.enable_grad():
        for k in reversed(range(K)):
            h = hh[k].detach().requires_grad_(True)
            lx = lxh[k].detach().requires_grad_(True)
            tau = tauh[k].detach().requires_grad_(True)
            us = _step_masks_plain(spec, k, train, u, seed_i, B, h.device)
            h2, lx2, tau2, y, y_bj = _step_plain(spec, nets, h, lx, tau,
                                                 times[k], dts[k], obs[k],
                                                 X[k], us)
            lk = step_loss("easy" if spec.easy else "standard", X=X[k], Y=y,
                           Y_bj=y_bj, obs=obs[k], n_obs_ot=n_obs,
                           batch_size=B, weight=weight)
            obj = (lk * dloss + (h2 * dh).sum() + (lx2 * dlx).sum()
                   + (tau2 * dtau).sum())
            g = torch.autograd.grad(obj, [h, lx, tau] + lv,
                                    allow_unused=True)
            dh, dlx, dtau = (torch.zeros_like(v) if gv is None else gv
                             for v, gv in zip((h, lx, tau), g[:3]))
            for i, gi in enumerate(g[3:]):
                if gi is not None:
                    grads[i] = grads[i] + gi
    return grads, dh.detach()


def reduce_partials_plain(partials, scale=1.0):
    return partials.sum(dim=0) * scale


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

class _MLPDesc(ctypes.Structure):
    _fields_ = [("n_lin", ctypes.c_int),
                ("w", ctypes.c_int * (MAX_LIN + 1)),
                ("act", ctypes.c_int * MAX_LIN),
                ("w_off", ctypes.c_int * MAX_LIN),
                ("b_off", ctypes.c_int * MAX_LIN),
                ("slot0", ctypes.c_int),
                ("save_off", ctypes.c_int)]


_LAYOUT_FIELDS = ("w", "g", "h", "lx", "tau", "X", "obs", "nobs", "lrow",
                  "h1", "h2", "in_ode", "tX", "in_ro", "f", "enc", "ro",
                  "dA", "dB", "dh", "dlx", "dtau", "rs", "dst", "dh1", "dhe",
                  "df", "dlxc", "dtauc")


class _ScanCfg(ctypes.Structure):
    """Field-for-field mirror of ``struct ScanCfg`` in csrc/fused_scan.cu."""
    _fields_ = ([(n, ctypes.c_int) for n in (
        "K", "B", "D", "H", "O", "S", "Wmax", "n_params", "n_leaves",
        "enc_case", "enc_mult", "ro_case", "ro_mult", "easy", "ict",
        "mode")]
        + [("thresh", ctypes.c_uint32), ("keep", ctypes.c_float),
           ("weight", ctypes.c_float)]
        + [(n, ctypes.c_int) for n in ("rows", "buf_w", "smem_floats")]
        + [("leaf_off", ctypes.c_int * (MAX_LEAVES + 1))]
        + [("o_" + n, ctypes.c_int) for n in _LAYOUT_FIELDS]
        + [("ode", _MLPDesc), ("enc", _MLPDesc), ("ro", _MLPDesc)])


def make_cfg(spec: Spec, K: int, B: int, train: bool, weight: float):
    """The kernels' configuration for one call (host memory)."""
    off, total = spec.layout(ROWS)
    c = _ScanCfg()
    c.K, c.B, c.D, c.H, c.O = K, B, spec.D, spec.H, spec.O
    c.S, c.Wmax, c.n_params = spec.S, spec.w_max, spec.n_params
    c.n_leaves = len(spec.leaf_shapes)
    c.enc_case, c.enc_mult = spec.enc_case, spec.enc_mult
    c.ro_case, c.ro_mult = spec.ro_case, spec.ro_mult
    c.easy, c.ict = int(spec.easy), int(spec.ict)
    dropping = train and spec.rate > 0.0 and spec.S > 0
    c.mode = 0 if not dropping else (1 if spec.mask_mode == "input" else 2)
    c.thresh = spec.thresh
    c.keep = 1.0 - spec.rate
    c.weight = float(weight)
    c.rows, c.buf_w, c.smem_floats = ROWS, spec.buf_w, total
    for i, o in enumerate(spec.leaf_off):
        c.leaf_off[i] = o
    for n in _LAYOUT_FIELDS:
        setattr(c, "o_" + n, off[n])
    leaf = 0
    for desc, ws, acts, slot0, save in (
            (c.ode, spec.ode_w, spec.ode_a, spec.s_ode, "s_ode"),
            (c.enc, spec.enc_w, spec.enc_a, spec.s_enc, "s_enc"),
            (c.ro, spec.ro_w, spec.ro_a, spec.s_r1, "s_ro")):
        desc.n_lin = len(ws) - 1
        for i, w in enumerate(ws):
            desc.w[i] = w
        for i, a in enumerate(acts):
            desc.act[i] = 0 if a == "tanh" else 1
        for i in range(desc.n_lin):
            desc.w_off[i] = spec.leaf_off[leaf]
            leaf += 1
            if spec.bias:
                desc.b_off[i] = spec.leaf_off[leaf]
                leaf += 1
            else:
                desc.b_off[i] = -1
        desc.slot0 = slot0
        desc.save_off = off[save]
    return c


def _is_cuda(t: torch.Tensor) -> bool:
    """Which route a tensor takes: True for CUDA (kernel), False for the
    CPU (plain version); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise RuntimeError(f"fused scan kernels: unsupported device {t.device}")


def _check(name, t, shape, dtype=torch.float32):
    if t is None:
        raise ValueError(f"{name} is required")
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _raise_rc(lib, rc, what):
    if rc:
        raise RuntimeError(f"{what} failed: "
                           f"{lib.njode_error_string(rc).decode()} ({rc})")


def _check_inputs(spec, leaves, arrays, train, u, seed):
    if not supported(spec.cfg):
        raise NotImplementedError(
            "config outside the CUDA kernels' scope (masked / use_rnn "
            "branches: ROADMAP.md Queue 1 item 4)")
    times, dts, obs, X, n_obs, start_X = arrays
    K, B = obs.shape
    for name, t, shp in (("times", times, (K,)), ("dts", dts, (K,)),
                         ("obs", obs, (K, B)), ("X", X, (K, B, spec.D)),
                         ("n_obs", n_obs, (B,)),
                         ("start_X", start_X, (B, spec.D))):
        _check(name, t, shp)
    for i, (p, s) in enumerate(zip(leaves, spec.leaf_shapes)):
        _check(f"leaf {i}", p, s)
    if len(leaves) != len(spec.leaf_shapes):
        raise ValueError("wrong number of parameter leaves")
    if train and spec.rate > 0.0 and spec.S > 0:
        if spec.mask_mode == "input":
            _check("u", u, (K, spec.S, B, spec.w_max), torch.int8)
        else:
            _check("seed", seed, (1,), torch.int64)
    return K, B


def scan_fwd_cuda(spec, leaves, arrays, weight, h0, train, u=None,
                  seed=None, want_hists=True):
    """Launch K1 (``want_hists``) or K3 and reduce the per-CTA losses."""
    from njode_tpu_torch.ops import _build

    K, B = _check_inputs(spec, leaves, arrays, train, u, seed)
    if not want_hists and train:
        raise ValueError("the history-free kernel is the eval forward")
    _check("h0", h0, (B, spec.H))
    lib = _build.load("fused_scan")
    times, dts, obs, X, n_obs, start_X = arrays
    dev = h0.device
    n_cta = -(-B // ROWS)
    loss_part = torch.empty((n_cta,), dtype=torch.float32, device=dev)
    if want_hists:
        hists = (torch.empty((K, B, spec.H), device=dev),
                 torch.empty((K, B, spec.D), device=dev),
                 torch.empty((K, B, 1), device=dev))
    else:
        hists = (None, None, None)
    cfg = make_cfg(spec, K, B, train, weight)
    ptrs = (ctypes.c_void_p * len(leaves))(*[p.data_ptr() for p in leaves])
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.njode_scan_fwd(
            ctypes.addressof(cfg), ptrs, _ptr(times), _ptr(dts), _ptr(obs),
            _ptr(X), _ptr(u), _ptr(seed), _ptr(n_obs), _ptr(h0),
            _ptr(start_X), _ptr(loss_part), *(_ptr(t) for t in hists),
            int(want_hists), stream)
    _raise_rc(lib, rc, "njode_scan_fwd")
    LAUNCHES["njode_scan_fwd" if want_hists else "njode_scan_eval"] += 1
    if cfg.mode == 2:
        LAUNCHES["philox_keep"] += 1
    loss = reduce_partials_cuda(loss_part.view(n_cta, 1), 1.0 / B)
    return loss.reshape(()), (hists if want_hists else None)


def scan_bwd_cuda(spec, leaves, arrays, weight, train, hists, dloss,
                  u=None, seed=None):
    """Launch K2 and reduce the per-CTA gradient partials; returns (grads
    as views of one flat buffer, in leaf order and layout, dh0)."""
    from njode_tpu_torch.ops import _build

    K, B = _check_inputs(spec, leaves, arrays, train, u, seed)
    hh, lxh, tauh = hists
    _check("h_hist", hh, (K, B, spec.H))
    _check("lastX_hist", lxh, (K, B, spec.D))
    _check("tau_hist", tauh, (K, B, 1))
    dloss = dloss.reshape(1).to(torch.float32).contiguous()
    _check("dloss", dloss, (1,))
    lib = _build.load("fused_scan")
    times, dts, obs, X, n_obs, start_X = arrays
    dev = hh.device
    n_cta = -(-B // ROWS)
    partials = torch.empty((n_cta, spec.n_params), device=dev)
    dh0 = torch.empty((B, spec.H), device=dev)
    cfg = make_cfg(spec, K, B, train, weight)
    ptrs = (ctypes.c_void_p * len(leaves))(*[p.data_ptr() for p in leaves])
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.njode_scan_bwd(
            ctypes.addressof(cfg), ptrs, _ptr(times), _ptr(dts), _ptr(obs),
            _ptr(X), _ptr(u), _ptr(seed), _ptr(n_obs), _ptr(hh), _ptr(lxh),
            _ptr(tauh), _ptr(dloss), _ptr(partials), _ptr(dh0), stream)
    _raise_rc(lib, rc, "njode_scan_bwd")
    LAUNCHES["njode_scan_bwd"] += 1
    if cfg.mode == 2:
        LAUNCHES["philox_keep"] += 1
    flat = reduce_partials_cuda(partials, 1.0)
    grads = [flat[a:b].view(s) for a, b, s in
             zip(spec.leaf_off[:-1], spec.leaf_off[1:], spec.leaf_shapes)]
    return grads, dh0


def reduce_partials_cuda(partials, scale=1.0):
    """Sum ``partials [n_parts, n]`` over its rows in a fixed order."""
    from njode_tpu_torch.ops import _build

    n_parts, n = partials.shape
    _check("partials", partials, (n_parts, n))
    lib = _build.load("fused_scan")
    out = torch.empty((n,), dtype=torch.float32, device=partials.device)
    stream = torch.cuda.current_stream(partials.device).cuda_stream
    with torch.cuda.device(partials.device):
        rc = lib.njode_reduce_partials(_ptr(partials), n_parts, n,
                                       float(scale), _ptr(out), stream)
    _raise_rc(lib, rc, "njode_reduce_partials")
    LAUNCHES["reduce_partials"] += 1
    return out


def philox_masks_cuda(seed, K: int, S: int, B: int, w_max: int,
                      thresh: int):
    """All K4 keep-masks of K steps, ``[K, S, B, Wmax]`` int8, drawn by
    the kernels' Philox (the masks 'prng' mode uses; for tests and
    timing)."""
    from njode_tpu_torch.ops import _build

    _check("seed", seed, (1,), torch.int64)
    lib = _build.load("fused_scan")
    out = torch.empty((K, S, B, w_max), dtype=torch.int8, device=seed.device)
    stream = torch.cuda.current_stream(seed.device).cuda_stream
    with torch.cuda.device(seed.device):
        rc = lib.njode_philox_masks(_ptr(seed), K, S, B, w_max, thresh,
                                    _ptr(out), stream)
    _raise_rc(lib, rc, "njode_philox_masks")
    LAUNCHES["philox_masks"] += 1
    return out


def scan_fwd(spec, leaves, arrays, weight, h0, train, u=None, seed=None,
             want_hists=True):
    """K1/K3 on CUDA tensors, the plain version on CPU tensors."""
    if _is_cuda(h0):
        return scan_fwd_cuda(spec, leaves, arrays, weight, h0, train, u,
                             seed, want_hists)
    with torch.no_grad():
        return scan_fwd_plain(spec, leaves, arrays, weight, h0, train, u,
                              seed, want_hists)


def scan_bwd(spec, leaves, arrays, weight, train, hists, dloss, u=None,
             seed=None):
    """K2 on CUDA tensors, the plain version on CPU tensors."""
    if _is_cuda(hists[0]):
        return scan_bwd_cuda(spec, leaves, arrays, weight, train, hists,
                             dloss, u, seed)
    return scan_bwd_plain(spec, leaves, arrays, weight, train, hists,
                          dloss, u, seed)


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------

class FusedNJODELoss(torch.autograd.Function):
    """Loss of the NJODE scan from the t=0 hidden state ``h0``; the
    backward is K2 (CUDA) or its plain version (CPU). Differentiable in
    ``h0`` and the parameter leaves; the batch arrays are data."""

    @staticmethod
    def forward(ctx, spec, train, weight, u, seed, times, dts, obs, X,
                n_obs, start_X, h0, *leaves):
        arrays = (times, dts, obs, X, n_obs, start_X)
        loss, hists = scan_fwd(spec, leaves, arrays, weight, h0, train, u,
                               seed, want_hists=True)
        ctx.spec, ctx.train, ctx.weight = spec, train, weight
        ctx.n_leaves = len(leaves)
        ctx.save_for_backward(times, dts, obs, X, n_obs, start_X, u, seed,
                              *hists, *leaves)
        return loss

    @staticmethod
    def backward(ctx, dloss):
        saved = ctx.saved_tensors
        arrays = saved[:6]
        u, seed = saved[6], saved[7]
        hists = saved[8:11]
        leaves = saved[11:]
        grads, dh0 = scan_bwd(ctx.spec, leaves, arrays, ctx.weight,
                              ctx.train, hists, dloss, u, seed)
        return (None,) * 11 + (dh0,) + tuple(grads)


def _require_supported(cfg):
    if not supported(cfg):
        raise NotImplementedError(
            "config outside the fused kernels' scope (masked / use_rnn: "
            "ROADMAP.md Queue 1 item 4); use models.njode.forward")


def make_fused_loss_fn(cfg, mask_mode: str = "prng", u_override=None):
    """Return ``loss_fn(model, batch, weight, generator, train)``: the
    training loss through :class:`FusedNJODELoss`, differentiable in the
    model's parameters (the t=0 encoder runs in plain torch).

    Draws from ``generator`` in the order ``njode.forward`` does: first the
    t=0 encoder keep-masks, then the scan's masks ('input': a
    ``[K,S,B,Wmax]`` Bernoulli draw; 'prng': one int64 Philox seed that
    stays on the device). So in 'input' mode the kernel path and
    ``njode.forward`` given the same generator state use the same masks.

    :param u_override: 'input' mode only: keep-masks ``[K,S,B,Wmax]`` used
        instead of the draw (replays another mask stream, e.g. the prng
        one, through the input path)."""
    _require_supported(cfg)
    spec = Spec(cfg, mask_mode)

    def loss_fn(model, batch, weight, generator, train):
        K, B = batch.obs.shape
        dev = batch.start_X.device
        dropping = train and spec.rate > 0.0 and spec.S > 0
        u = seed = None
        enc_masks = None
        if dropping:
            keep = 1.0 - spec.rate
            u0 = torch.rand((max(spec.n_enc, 1), B, spec.w_max),
                            generator=generator, device=dev) < keep
            enc_masks = [u0[i] for i in range(spec.n_enc)]
            if mask_mode == "input":
                if u_override is not None:
                    u = torch.as_tensor(u_override, device=dev)
                else:
                    u = torch.rand((K, spec.S, B, spec.w_max),
                                   generator=generator, device=dev) < keep
                u = u.to(torch.int8).contiguous()
            else:
                seed = torch.randint(0, 2 ** 62, (1,), generator=generator,
                                     device=dev, dtype=torch.int64)
        h0 = model.encoder_map(batch.start_X, None, enc_masks)
        return FusedNJODELoss.apply(
            spec, train, float(weight), u, seed, batch.times, batch.dt,
            batch.obs, batch.X, batch.n_obs_ot, batch.start_X, h0,
            *flat_leaves(model))

    return loss_fn


def make_fused_eval_fn(cfg):
    """Return ``eval_fn(model, batch, weight)``: the eval loss through the
    history-free forward (K3 on CUDA, its plain version on CPU) at any
    batch size."""
    _require_supported(cfg)
    spec = Spec(cfg, "input")

    def eval_fn(model, batch, weight):
        with torch.no_grad():
            h0 = model.encoder_map(batch.start_X)
            arrays = (batch.times, batch.dt, batch.obs, batch.X,
                      batch.n_obs_ot, batch.start_X)
            loss, _ = scan_fwd(spec, [p.detach() for p in
                                      flat_leaves(model)],
                               arrays, float(weight), h0, False,
                               want_hists=False)
        return loss

    return eval_fn
