"""The GRU-ODE-Bayes training scan as hand-written CUDA kernels, with plain
versions.

The port's counterpart of ``njode_tpu/ops/fused_gob.py``. The forward (K5,
``gob_scan_fwd``) runs the whole K-step scan over the state ``(h, mean,
var)`` in one kernel launch (``csrc/fused_gob.cu``) and stores only the
step-entry carries ``h``, ``m``, ``v``; the eval loss is K5 without
histories or dropout. The backward (K6, ``gob_scan_bwd``) runs in three
stages per chunk of steps, all enqueued by one C call:

(a) ``remat``: every (step, row group) of the chunk at once re-runs the
    forward step from the stored carries and writes the activations the
    backward reads into a device workspace;
(b) ``chain``: the sequential reverse walk, which computes only the carry
    gradients ``(dh, dm, dv)`` and writes every delta a weight gradient
    needs into the workspace;
(c) ``wgrad``: a fixed-order reduction over all (step, row) pairs of
    ``x^T d`` for every weight (``Sum d`` for a bias), split over the rows
    into partial rows that ``reduce_partials`` sums.

The ``p_model`` dropout keep-masks (K7, three slots ``[ode-midpoint,
ode-final, post-jump]`` of ``[B, p_hidden]`` per step) come from the Philox
generator the NJODE kernels use (``csrc/philox.cuh``, 'prng' mode) or from
an int8 tensor ('input' mode). :class:`FusedGOBLoss` wraps the kernels as a
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
the CUDA source; ``gob_scan_bwd_staged_plain`` is that hand-derived BPTT in
plain torch, stage by stage, in the kernels' workspace layout.

Kernel scope (``supported``, as the JAX kernel's): euler or midpoint, the
minimal or full GRU-ODE field, impute on or off, logvar or abs-var, the
discretized cell, bias on or off, dropout in both mask modes, at any
widths: where one row's buffers overflow one CTA's shared memory (p_hidden
4,000), the kernels keep the widest of them in a slab of device memory
that each CTA owns (the device-memory form, :meth:`Spec.acts_for`; the
same bits as the shared form where both fit). dopri5 runs the eager
forward, as in the JAX package.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from njode_tpu_torch.models.gru_ode_bayes import (LOG_LIK_C, OBS_NOISE_STD,
                                                  propagation_mode)
from njode_tpu_torch.ops import fused_scan as fs
from njode_tpu_torch.ops.fused_scan import _check, _is_cuda, _ptr

ROW_CHOICES = (1, 2, 4, 8, 16)   # rows per CTA (csrc/fused_gob.cu instances)
N_SM = 132                       # streaming multiprocessors of an H100 SXM
# 256-thread CTAs of K5 an SM runs at once: its 80-98 registers a thread
# (ptxas, sm_90a) leave room for two or three
CTAS_PER_SM = 2
MAX_LEAVES = 40
MAX_SAVE = 48                    # workspace buffers a step saves (stage a)
MAX_DLT = 32                     # workspace deltas a step writes (stage b)
# the dynamic shared memory a CTA may take: the card's limit less the
# call's configuration and leaf pointers, which each kernel copies into
# static shared memory (2,140 bytes; CALL_BYTES rounds up)
CALL_BYTES = 2304
SMEM_LIMIT = fs.SMEM_LIMIT - CALL_BYTES
# K6's workspace: the chunk of steps is as long as keeps the workspace
# under this many bytes (32 MiB: the chunk stays in the 50 MB L2 between
# its three stages); the carry gradients pass from chunk to chunk
WS_BUDGET = 32 << 20
WG_TILE = 32                     # stage (c): output tile [32, 32] of a leaf
# the device-memory form of the activations (csrc/fused_gob.cu SLAB_BIT):
# a buffer whose offset carries this bit lies in the CTA's slab of device
# memory; the width classes that go there, fewest first, the widest first
SLAB_BIT = 1 << 28
SLAB_ORDER = (("P",), ("P", "DP"), ("P", "DP", "H"),
              ("P", "DP", "H", "D", "1"))
ACTS = ("shared", "global")

# launches per kernel; a wrapper adds one where it launches its kernel.
# K6 counts each of its stages per chunk: 'gob_bwd_remat' (a),
# 'gob_scan_bwd' (b, the chain), 'gob_bwd_wgrad' (c). 'gob_philox_keep'
# (K7: the mask words K5 and K6's stage (a) fill as they run; stage (b)
# reads the saved activations instead) counts their 'prng'-mode
# launches; 'gob_masks' counts the stand-alone mask dump (tests, timing).
# The loss and gradient partials are summed by the NJODE library's
# reduce_partials (counted in fused_scan.LAUNCHES).
LAUNCHES = {"gob_scan_fwd": 0, "gob_scan_eval": 0, "gob_bwd_remat": 0,
            "gob_scan_bwd": 0, "gob_bwd_wgrad": 0, "gob_philox_keep": 0,
            "gob_masks": 0}


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def supported(cfg) -> bool:
    """Whether the CUDA kernels cover the given GOBConfig: the JAX kernel's
    rule (euler or midpoint; dopri5 runs eagerly, as in the JAX package),
    at any widths (those whose buffers of one row overflow one CTA's
    shared memory in the device-memory form, ``Spec.acts_for``). The
    trainers route a config outside to the eager
    ``gru_ode_bayes.forward``."""
    return (cfg.solver in ("euler", "midpoint")
            and Spec(cfg).fits(1))


# shared-memory buffers of one CTA, per batch row: (name, width). The
# forward kernels (K5, stage a) hold the first part once; the chain (stage
# b) holds it twice (the step it works on and the next one, which cp.async
# brings in meanwhile) and the second part after them.
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
    ("dh", "H"), ("dm", "D"), ("dv", "D"), ("dh1", "H"), ("dm1", "D"),
    ("dv1", "D"), ("dm2", "D"), ("dv2", "D"), ("dp2", "P"),
    ("og0", "H"), ("og1", "H"), ("og2", "H"), ("og3", "H"), ("dx", "DP"),
    ("dfm", "D"), ("dff", "D"), ("dfe", "D"), ("dp1", "P"),
    ("pg0", "H"), ("pg1", "H"), ("pg2", "H"), ("pg3", "H"),
    ("e1a0", "H"), ("e1a1", "H"), ("e1a2", "H"),
    ("e2a0", "H"), ("e2a1", "H"), ("e2a2", "H"),
    ("dp0", "P"), ("dmk", "D"), ("dvk", "D"), ("df", "H"), ("dhf", "H"),
    ("dkk", "H"))
BUFS = tuple(n for n, _ in _FWD_BUFS + _BWD_BUFS)
# what stage (a) writes to the workspace: every forward buffer but the
# per-row loss terms
SAVED = tuple(n for n, _ in _FWD_BUFS if n not in ("lrow", "nll"))
_WIDTH = dict(_FWD_BUFS + _BWD_BUFS)

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
    'prng' (Philox inside the kernels, keyed by a per-call seed).

    Rows per CTA (:meth:`rows_for`): ``rows`` forces R (tests, A/B);
    otherwise the rule takes, among the R of ``ROW_CHOICES`` whose buffers
    fit one CTA's shared memory (the chain's layout for the training
    kernels, the forward's for the eval form), the fewest with
    ``ceil(B / R) <= CTAS_PER_SM * N_SM`` CTAs (all resident at once),
    else the most that fit (the card A/B, PERF.md: one row at the
    training batches, 8 at the eval's B = 2,000). It depends only on (cfg,
    B), so K5 and K6's stage (a) take the same R and give the same bits.

    Activations (:meth:`acts_for`): ``acts`` forces 'shared' (every
    per-row buffer in shared memory) or 'global' (the device-memory form:
    the buffers of the width classes ``slab_classes`` in a slab of device
    memory that each CTA owns, one row a CTA; the hook of the card check
    that holds the two forms bit for bit); otherwise the rule takes
    'shared' where the chain's buffers of one row fit one CTA's shared
    memory, else 'global', for every kernel of the config. The bits are the
    same either way.

    Weights in shared memory (:meth:`stage_weights`): ``weights`` forces
    'shared' or 'global' (the hook of the card test that holds the two
    bit for bit, and of ab_scan_kernels.py's A/B); otherwise K5 and the
    chain stage every leaf in shared memory when they fit beside the
    kernel's activations at R and the batch takes at most one CTA an SM
    (``ceil(B / R) <= N_SM``: a CTA that holds the weights holds most of
    its SM's shared memory). The bits are the same either way.

    Threads a CTA (:meth:`threads_for`): 512 where the batch takes at
    most one CTA an SM and the rule leaves the weights in device memory
    (more lanes a product keep more loads from L2 in flight), else 256
    (the card A/B, PERF.md: 512 ran hidden 100 23 % faster, hidden 50 and
    the climate arm, whose weights sit in shared memory, 3-12 % slower).
    A product's lanes depend on it, so K5, stage (a) and the chain of one
    call take the same count, whatever ``weights`` forces."""

    def __init__(self, cfg, mask_mode: str = "prng", rows=None,
                 weights=None, acts=None):
        if mask_mode not in ("input", "prng"):
            raise ValueError(f"unknown mask_mode {mask_mode!r}")
        if rows is not None and rows not in ROW_CHOICES:
            raise ValueError(f"rows must be one of {ROW_CHOICES}")
        if weights not in (None, "shared", "global"):
            raise ValueError(f"unknown weights {weights!r}")
        if acts not in (None,) + ACTS:
            raise ValueError(f"unknown acts {acts!r}")
        if acts == "global" and rows not in (None, 1):
            raise ValueError("the device-memory form runs one row a CTA")
        self.cfg = cfg
        self.forced_weights = weights
        self._acts = acts             # forced, or the rule's once known
        self.mask_mode = mask_mode
        self.forced_rows = rows
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
        self._build_workspace()
        self._progs = {}
        self._cfgs = {}

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

    # -- K6's workspace and stage (c)'s program ---------------------------

    def wgrad_jobs(self):
        """Stage (c)'s terms, in the order it sums them per leaf: (leaf,
        x buffer or None for a bias, delta buffer); the leaf's gradient is
        ``Sum_(k,b) x^T d`` over every (step, row) of the workspace."""
        sl, jobs = self.slots, []

        def job(slot, i, x, d):
            if sl[slot][i] >= 0:
                jobs.append((sl[slot][i], x, d))

        def p_model(x, a, dp, dmh, dvh):
            job("pm", 0, x, dp)
            job("pm", 1, None, dp)
            job("pm", 2, a, dmh)
            job("pm", 3, None, dmh)
            job("pm", 4, a, dvh)
            job("pm", 5, None, dvh)

        def field(mi, vi, hin, Fc, Fd, e):
            # full: a0 = da_u (Whh on r*h), a1 = da_z, a2 = da_r;
            # minimal: a0 = da_n (Whn on z*h), a1 = da_z
            if self.full:
                job("fh", 2, Fd, e + "a0")
                job("fh", 1, hin, e + "a1")
                job("fh", 0, hin, e + "a2")
                das = (e + "a2", e + "a1", e + "a0")
            else:
                job("fh", 1, Fc, e + "a0")
                job("fh", 0, hin, e + "a1")
                das = (e + "a1", e + "a0")
            if self.impute:
                for k, da in enumerate(das):
                    job("fxm", k, mi, da)
                    job("fxv", k, vi, da)
                    job("fxb", k, None, da)

        p_model("h2", "a2", "dp2", "dm2", "dv2")
        dgi, dgh = ("og0", "og1", "og2"), ("og0", "og1", "og3")
        for k in range(3):
            job("ih", k, "gin", dgi[k])
            job("hh", k, "h1", dgh[k])
            job("bih", k, None, dgi[k])
            job("bhh", k, None, dgh[k])
        for f, x in enumerate(("X", "m1", "ft2", "err")):
            job("wp", f, x, "dx")
        job("bp", 0, None, "dx")
        p_model("h1p", "a1", "dp1", "dm1", "dv1")
        if self.prop == 2:
            pgi, pgh = ("pg0", "pg1", "pg2"), ("pg0", "pg1", "pg3")
            for k in range(3):
                if self.impute:
                    job("fxm", k, "m", pgi[k])
                    job("fxv", k, "v", pgi[k])
                job("fh", k, "h", pgh[k])
                job("fxb", k, None, pgi[k])
                job("fhb", k, None, pgh[k])
        else:
            field("m", "v", "h", "f1c", "f1d", "e1")
            if self.prop == 1:
                field("mk", "vk", "kk", "f2c", "f2d", "e2")
                if self.impute:
                    p_model("kk", "ak", "dp0", "dmk", "dvk")
        order = sorted(range(len(jobs)), key=lambda i: (jobs[i][0], i))
        return [jobs[i] for i in order]

    def _build_workspace(self):
        """The workspace of one (step, row): every buffer of ``SAVED``,
        then the deltas stage (c) reads, each with its flag 'propagation'
        (zero on a dt == 0 padding step, where no propagation runs). A
        chunk of Kc steps holds each buffer as one [Kc * B, width]
        matrix, row ``(k - k0) * B + b``; ``ws_off`` is its offset in
        floats per (step, row)."""
        jobs = self.wgrad_jobs() if self.prop >= 0 else []
        used = {d for _, _, d in jobs}
        prop = {"dm1", "dv1", "dp1", "pg0", "pg1", "pg2", "pg3", "e1a0",
                "e1a1", "e1a2", "e2a0", "e2a1", "e2a2", "dp0", "dmk", "dvk"}
        self.deltas = tuple((n, n in prop) for n, _ in _BWD_BUFS
                            if n in used)
        self.ws_off, n = {}, 0
        for name in SAVED + tuple(d for d, _ in self.deltas):
            self.ws_off[name] = n
            n += self.width(name)
        self.n_ws = n
        assert len(SAVED) <= MAX_SAVE and len(self.deltas) <= MAX_DLT

    def width(self, name):
        w = _WIDTH[name]
        return {"H": self.H, "D": self.D, "P": self.P, "DP": self.DP,
                "1": 1}[w]

    def bwd_chunk(self, K: int, B: int) -> int:
        """Steps per chunk of K6: as many as keep the workspace within
        ``WS_BUDGET``."""
        return max(1, min(K, WS_BUDGET // (4 * B * self.n_ws)))

    def wgrad_tiles(self):
        """Stage (c)'s output tiles: (leaf, i0, j0, first job, job count),
        one per [WG_TILE, WG_TILE] block of every leaf, and its jobs."""
        jobs = self.wgrad_jobs()
        tiles = []
        for leaf, (a, b) in enumerate(self.leaf_shapes):
            mine = [i for i, j in enumerate(jobs) if j[0] == leaf]
            first = mine[0] if mine else 0
            for i0 in range(0, a, WG_TILE):
                for j0 in range(0, b, WG_TILE):
                    tiles.append((leaf, i0, j0, first, len(mine)))
        return tiles, jobs

    def wgrad_splits(self, rows: int) -> int:
        """Partial rows of stage (c) over ``rows`` (step, row) pairs of a
        chunk: enough CTAs for two a SM, at least 256 pairs each. It
        depends on (cfg, K, B) only, not on the rows per CTA."""
        n_tiles = len(self.wgrad_tiles()[0])
        return max(1, min(-(-2 * N_SM // n_tiles), rows // 256))

    def wgrad_program(self, device):
        """Stage (c)'s program on ``device``: int32 tiles [n, 7] (leaf
        offset, in, out, i0, j0, first job, job count) and jobs [n, 4] (x
        workspace offset or -1 for a bias, its width, delta offset,
        width)."""
        key = str(device)
        if key not in self._progs:
            tiles, jobs = self.wgrad_tiles()
            t = [(self.leaf_off[lf], self.leaf_shapes[lf][0],
                  self.leaf_shapes[lf][1], i0, j0, f, n)
                 for lf, i0, j0, f, n in tiles]
            j = [(-1 if x is None else self.ws_off[x],
                  1 if x is None else self.width(x), self.ws_off[d],
                  self.width(d)) for _, x, d in jobs]
            self._progs[key] = (
                torch.tensor(t, dtype=torch.int32, device=device),
                torch.tensor(j, dtype=torch.int32, device=device))
        return self._progs[key]

    # -- rows per CTA --------------------------------------------------------

    @property
    def thresh(self) -> int:
        return min(int((1.0 - self.rate) * 2.0 ** 32), 2 ** 32 - 1)

    def dropping(self, train: bool) -> bool:
        return bool(train) and self.rate > 0.0

    @property
    def nw(self) -> int:
        """Mask words of a row and slot: 32 columns a word."""
        return -(-self.P // 32)

    def mask_words(self, R: int) -> int:
        """32-bit words of the dropout masks of K5 and stage (a) at R rows
        (after their forward buffers, or after the weights where K5 stages
        them): one step's three slots, 0 without dropout."""
        return R * 3 * self.nw if self.rate > 0.0 else 0

    def _layout(self, R, slab):
        """Offsets of every per-row buffer at R rows, the buffers of the
        width classes ``slab`` in the slab (offsets with ``SLAB_BIT``), the
        rest in shared memory: the forward buffers first, the chain's after
        its two copies of them, in each of the two; returns (offsets,
        shared floats of the forward part and in all, slab floats of the
        forward part and in all)."""
        off, n, q = {}, 0, 0
        for name, w in _FWD_BUFS:
            size = (R * self.width(name) + 3) // 4 * 4   # 16-byte aligned
            if w in slab:
                off[name], q = SLAB_BIT | q, q + size
            else:
                off[name], n = n, n + size
        n_fwd, q_fwd = n, q
        n, q = 2 * n_fwd, 2 * q_fwd
        for name, w in _BWD_BUFS:
            size = (R * self.width(name) + 3) // 4 * 4
            if w in slab:
                off[name], q = SLAB_BIT | q, q + size
            else:
                off[name], n = n, n + size
        return off, n_fwd, n, q_fwd, q

    def layout(self, R: int, ga: bool = False):
        """Float offsets of every buffer of one CTA at R rows (the forward
        buffers from 0, the chain's after its two copies of them), the
        shared-memory floats the forward kernels use (K5 and stage (a)
        take ``mask_words`` more after them) and the chain's total. With
        ``ga`` (the device-memory form) the buffers of ``slab_classes`` lie
        in the CTA's slab (:meth:`slab_floats`): their offsets carry
        ``SLAB_BIT``."""
        return self._layout(R, self.slab_classes if ga else ())[:3]

    def slab_floats(self):
        """Floats of one CTA's slab in the device-memory form (one row a
        CTA): the forward part (K5, stage (a)) and the chain's (two copies
        of it and its own buffers)."""
        return self._layout(1, self.slab_classes)[3:]

    @functools.cached_property
    def slab_classes(self):
        """The width classes the device-memory form keeps in the slab: the
        fewest of ``SLAB_ORDER`` with which the rest of the chain's buffers
        of one row fit one CTA's shared memory."""
        for slab in SLAB_ORDER:
            _, n_fwd, total, _, _ = self._layout(1, slab)
            if 4 * max(total, n_fwd + self.mask_words(1)) <= SMEM_LIMIT:
                return slab
        return SLAB_ORDER[-1]

    def acts_for(self) -> str:
        """The activations' form of every kernel of the config (K5, its
        eval form, K6's stages): the forced one, else 'shared' where the
        chain's buffers of one row fit one CTA's shared memory, else
        'global'. One form a config: the eval form takes the training
        form's, though its forward buffers alone may fit."""
        if self._acts is None:
            self._acts = ("shared" if self._smem(1, True, False)
                          <= SMEM_LIMIT else "global")
        return self._acts

    def _smem(self, R, bwd, ga):
        _, n_fwd, total = self.layout(R, ga)
        return 4 * (total if bwd else n_fwd + self.mask_words(R))

    def smem_bytes(self, R: int, bwd: bool = True, acts=None) -> int:
        """Shared memory of one CTA at R rows in the form ``acts``, by
        default that of :meth:`acts_for`."""
        return self._smem(R, bwd, (acts or self.acts_for()) == "global")

    def fits(self, R: int, bwd: bool = True) -> bool:
        if self.acts_for() == "global" and R != 1:
            return False
        return self.smem_bytes(R, bwd) <= SMEM_LIMIT

    def rows_for(self, B: int, bwd: bool = True):
        """Rows per CTA at batch B (the rule in the class docstring; one in
        the device-memory form), or None where not even one row fits."""
        if self.forced_rows is not None:
            return self.forced_rows
        fit = [R for R in ROW_CHOICES if self.fits(R, bwd)]
        if not fit:
            return None
        for R in fit:
            if -(-B // R) <= CTAS_PER_SM * N_SM:
                return R
        return fit[-1]

    def threads_for(self, B: int, bwd: bool = True) -> int:
        """Threads a CTA at batch B (the rule in the class docstring)."""
        one_an_sm = -(-B // self.rows_for(B, bwd)) <= N_SM
        staged = self._stage_rule(B, bwd, chain=bwd)
        return 512 if one_an_sm and not staged else 256

    def stage_weights(self, B: int, bwd: bool = True, chain: bool = False):
        """Whether K5 (``chain`` False: its forward layout) or the chain
        stages the weights in shared memory at batch B (the rule in the
        class docstring); forced 'shared' where they do not fit raises."""
        if self.forced_weights == "shared":
            if not self._weights_fit(B, bwd, chain):
                raise ValueError("the weights do not fit shared memory at "
                                 f"{self.rows_for(B, bwd)} rows")
            return True
        if self.forced_weights == "global":
            return False
        return self._stage_rule(B, bwd, chain)

    def _weights_fit(self, B, bwd, chain):
        R = self.rows_for(B, bwd)
        _, n_fwd, total = self.layout(R, self.acts_for() == "global")
        return 4 * ((total if chain else n_fwd + self.mask_words(R))
                    + (self.n_params + 3) // 4 * 4) <= SMEM_LIMIT

    def _stage_rule(self, B, bwd, chain):
        return (self._weights_fit(B, bwd, chain)
                and -(-B // self.rows_for(B, bwd)) <= N_SM)

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
# plain version of K6's three stages (the hand-derived BPTT the CUDA source
# runs, in its workspace layout)
# ---------------------------------------------------------------------------

def _keep_scale(spec, us, slot, s):
    """Dropout's backward on a p_model hidden gradient: s / keep where kept,
    0 where dropped (the identity without masks)."""
    if us is None:
        return s
    return torch.where(us[slot], s / (1.0 - spec.rate), torch.zeros_like(s))


def _pm_fwd_bufs(spec, w, x, us, slot):
    """p_model with its saved buffers: (pre, a, mean head, var head)."""
    W0, b0, Wm, bm, Wv, bv = w["pm"]
    pre = _lin(x, W0, b0)
    a = torch.relu(pre)
    if us is not None:
        a = torch.where(us[slot], a / (1.0 - spec.rate), torch.zeros_like(a))
    return pre, a, _lin(a, Wm, bm), _lin(a, Wv, bv)


def _gate_in(spec, w, k, mi, vi):
    """The input part of a field or cell gate: mi Wxm_k + vi Wxv_k (impute)
    plus its bias where the configuration has one."""
    s = 0.0
    if spec.impute:
        s = mi @ w["fxm"][k] + vi @ w["fxv"][k]
    if w["fxb"][k] is not None:
        s = s + w["fxb"][k]
    return s


def _field_bufs(spec, w, mi, vi, hin):
    """One field evaluation: (F0, F1, F2, F3, f) as the kernel saves them
    (full: r, z, u, r*h; minimal: z, n, z*h, unused)."""
    fh = w["fh"]
    if spec.full:
        r = torch.sigmoid(_gate_in(spec, w, 0, mi, vi) + hin @ fh[0])
        z = torch.sigmoid(_gate_in(spec, w, 1, mi, vi) + hin @ fh[1])
        rh = r * hin
        u = torch.tanh(_gate_in(spec, w, 2, mi, vi) + rh @ fh[2])
        return r, z, u, rh, (1.0 - z) * (u - hin)
    z = torch.sigmoid(_gate_in(spec, w, 0, mi, vi) + hin @ fh[0])
    zh = z * hin
    n = torch.tanh(_gate_in(spec, w, 1, mi, vi) + zh @ fh[1])
    return z, n, zh, torch.zeros_like(hin), (1.0 - z) * (n - hin)


def _step_bufs_plain(spec, w, h, m, v, dt, obs, X, M, us):
    """Stage (a) of one step: every buffer of ``SAVED`` for all B rows
    (the kernel's step_fwd; buffers a padding step does not compute are
    0)."""
    B, D, H = h.shape[0], spec.D, spec.H
    z_h = torch.zeros_like(h)
    z_d = torch.zeros_like(m)
    z_p = h.new_zeros((B, spec.P))
    o = obs[:, None]
    s = dict(h=h, m=m, v=v, X=X, M=M, obs=o)
    for n in ("f1a", "f1b", "f1c", "f1d", "fo", "kk", "f2a", "f2b", "f2c",
              "f2d", "h1p", "gt"):
        s[n] = z_h
    for n in ("mk", "vk", "m1p", "v1p"):
        s[n] = z_d
    for n in ("prek", "ak", "pre1", "a1"):
        s[n] = z_p
    if dt > 0:
        if spec.prop == 2:
            gh = [_lin(h, w["fh"][k], w["fhb"][k]) for k in range(3)]
            gi = [_gate_in(spec, w, k, m, v) for k in range(3)]
            r = torch.sigmoid(gi[0] + gh[0])
            z = torch.sigmoid(gi[1] + gh[1])
            n = torch.tanh(gi[2] + r * gh[2])
            s.update(f1a=r, f1b=z, f1c=n, f1d=gh[2])
            s["h1p"] = (1.0 - z) * n + z * h
        else:
            F = _field_bufs(spec, w, m, v, h)
            s.update(f1a=F[0], f1b=F[1], f1c=F[2], f1d=F[3], fo=F[4])
            if spec.prop == 1:
                kk = h + dt * 0.5 * F[4]
                s["kk"] = kk
                mk = vk = z_d
                if spec.impute:
                    s["prek"], s["ak"], mk, vk = _pm_fwd_bufs(spec, w, kk,
                                                             us, 0)
                    s["mk"], s["vk"] = mk, vk
                F = _field_bufs(spec, w, mk, vk, kk)
                s.update(f2a=F[0], f2b=F[1], f2c=F[2], f2d=F[3], fo=F[4])
            s["h1p"] = h + dt * F[4]
        s["pre1"], s["a1"], s["m1p"], s["v1p"] = _pm_fwd_bufs(
            spec, w, s["h1p"], us, 1)
        h1, m1, v1 = s["h1p"], s["m1p"], s["v1p"]
    else:
        h1, m1, v1 = h, m, v
    s.update(h1=h1, m1=m1, v1=v1)
    if spec.logvar:
        err = (X - m1) / torch.exp(0.5 * v1)
        ft2 = v1
    else:
        ft2 = torch.abs(v1) + 1e-6
        err = (X - m1) / torch.sqrt(ft2)
    wp = w["wp"]
    pre = X @ wp[0] + m1 @ wp[1] + ft2 @ wp[2] + err @ wp[3] + w["bp"][0]
    gin = torch.relu(pre) * (M @ expander(D, spec.prep, device=M.device))
    gh = [_lin(h1, w["hh"][k], w["bhh"][k]) for k in range(3)]
    gi = [_lin(gin, w["ih"][k], w["bih"][k]) for k in range(3)]
    r = torch.sigmoid(gi[0] + gh[0])
    z = torch.sigmoid(gi[1] + gh[1])
    n = torch.tanh(gi[2] + r * gh[2])
    h2 = o * ((1.0 - z) * n + z * h1) + (1.0 - o) * h1
    pre2, a2, m2p, v2p = _pm_fwd_bufs(spec, w, h2, us, 2)
    s.update(err=err, ft2=ft2, pre=pre, gin=gin, ga=r, gb=z, gc=n, gd=gh[2],
             gt=gi[2], h2=h2, pre2=pre2, a2=a2, m2p=m2p, v2p=v2p,
             m2=o * m2p + (1.0 - o) * m1, v2=o * v2p + (1.0 - o) * v1)
    return s


def _pm_bwd_dp(spec, w, pre, dmh, dvh, us, slot):
    """The p_model hidden delta: relu'(pre) * dropout^T (dm Wm^T + dv
    Wv^T)."""
    _, _, Wm, _, Wv, _ = w["pm"]
    s = _keep_scale(spec, us, slot, dmh @ Wm.t() + dvh @ Wv.t())
    return torch.where(pre > 0, s, torch.zeros_like(s))


def _field_bwd_plain(spec, w, mi, vi, hin, F, df, e, dl):
    """Backward of one field evaluation for its gradient df: writes the
    deltas e+'a0'.. into ``dl``; returns (d/d hin, d/d mi, d/d vi)."""
    fh = w["fh"]
    if spec.full:
        r, z, u = F[0], F[1], F[2]
        a1 = -df * (u - hin)
        dhf = -df * (1.0 - z)
        a0 = df * (1.0 - z) * (1.0 - u * u)
        drh = a0 @ fh[2].t()
        dhf = dhf + drh * r
        a2 = drh * hin * r * (1.0 - r)
        a1 = a1 * z * (1.0 - z)
        dhf = dhf + (a1 @ fh[1].t() + a2 @ fh[0].t())
        das = (a2, a1, a0)
        dl.update({e + "a0": a0, e + "a1": a1, e + "a2": a2})
    else:
        z, n = F[0], F[1]
        a1 = -df * (n - hin)
        dhf = -df * (1.0 - z)
        a0 = df * (1.0 - z) * (1.0 - n * n)
        dzh = a0 @ fh[1].t()
        dz = a1 + dzh * hin
        dhf = dhf + dzh * z
        a1 = dz * z * (1.0 - z)
        dhf = dhf + a1 @ fh[0].t()
        das = (a1, a0)
        dl.update({e + "a0": a0, e + "a1": a1})
    if not spec.impute:
        return dhf, None, None
    dmo = sum(da @ w["fxm"][k].t() for k, da in enumerate(das))
    dvo = sum(da @ w["fxv"][k].t() for k, da in enumerate(das))
    return dhf, dmo, dvo


def _chain_step_plain(spec, w, a, dh, dm, dv, dt, dloss, us):
    """Stage (b) of one step from its saved buffers ``a`` and the carry
    gradients wrt its outputs: returns (dh, dm, dv wrt its entry carries,
    the deltas of ``spec.deltas`` by name; propagation deltas 0 on a
    padding step)."""
    D = spec.D
    o, M, X = a["obs"], a["M"], a["X"]
    dl = {}
    sc = dloss * spec.mixing * o * M
    dklm = sc * (a["m2"] - X) * 10000.0
    v2 = a["v2"]
    if spec.logvar:
        dklv = sc * (-0.5 + torch.exp(v2) / 2e-4)
    else:
        dklv = sc * torch.sign(v2) * (-0.5 / (torch.abs(v2) + 1e-5)
                                      + 5000.0)
    gm, gv = dm + dklm, dv + dklv
    dl["dm2"], dl["dv2"] = o * gm, o * gv
    dm1, dv1 = (1.0 - o) * gm, (1.0 - o) * gv
    dl["dp2"] = _pm_bwd_dp(spec, w, a["pre2"], dl["dm2"], dl["dv2"], us, 2)
    g = dl["dp2"] @ w["pm"][0].t() + dh
    dj = o * g
    r, z, n, ghn, h1 = a["ga"], a["gb"], a["gc"], a["gd"], a["h1"]
    da_z = dj * (h1 - n) * z * (1.0 - z)
    da_n = dj * (1.0 - z) * (1.0 - n * n)
    og = (da_n * ghn * r * (1.0 - r), da_z, da_n, da_n * r)
    dl.update(og0=og[0], og1=og[1], og2=og[2], og3=og[3])
    dh1 = (1.0 - o) * g + dj * z
    hh, ih = w["hh"], w["ih"]
    dh1 = dh1 + (og[0] @ hh[0].t() + og[1] @ hh[1].t() + og[3] @ hh[2].t())
    Mexp = M @ expander(D, spec.prep, device=M.device)
    dx = (og[0] @ ih[0].t() + og[1] @ ih[1].t() + og[2] @ ih[2].t()) * Mexp
    dl["dx"] = dx = torch.where(a["pre"] > 0, dx, torch.zeros_like(dx))
    wp = w["wp"]
    dfm, dff, dfe = dx @ wp[1].t(), dx @ wp[2].t(), dx @ wp[3].t()
    sc = dloss * o * M
    e, v1 = a["err"], a["v1"]
    if spec.logvar:
        sigma = torch.exp(0.5 * v1)
        dm1 = dm1 + (-sc * e / sigma - dfe / sigma + dfm)
        dv1 = dv1 + (sc * 0.5 * (1.0 - e * e) - 0.5 * dfe * e + dff)
    else:
        ft2 = a["ft2"]
        sq, sg = torch.sqrt(ft2), torch.sign(v1)
        dm1 = dm1 + (-sc * e / sq - dfe / sq + dfm)
        dv1 = dv1 + (sg * sc * 0.5 * (1.0 - e * e) / ft2
                     + sg * (-0.5 * dfe * e / ft2 + dff))
    dl["dm1"], dl["dv1"] = dm1, dv1
    if not dt > 0:                  # padding step: the carries pass through
        for name, prop in spec.deltas:
            if prop:
                dl[name] = dh.new_zeros((dh.shape[0], spec.width(name)))
        return dh1, dm1, dv1, dl
    dl["dp1"] = _pm_bwd_dp(spec, w, a["pre1"], dm1, dv1, us, 1)
    dh1 = dh1 + dl["dp1"] @ w["pm"][0].t()
    h, m, v = a["h"], a["m"], a["v"]
    dm = dv = None
    if spec.prop == 2:
        r, z, n, ghn = a["f1a"], a["f1b"], a["f1c"], a["f1d"]
        da_z = dh1 * (h - n) * z * (1.0 - z)
        da_n = dh1 * (1.0 - z) * (1.0 - n * n)
        pg = (da_n * ghn * r * (1.0 - r), da_z, da_n, da_n * r)
        dl.update(pg0=pg[0], pg1=pg[1], pg2=pg[2], pg3=pg[3])
        fh = w["fh"]
        dh = dh1 * z + (pg[0] @ fh[0].t() + pg[1] @ fh[1].t()
                        + pg[3] @ fh[2].t())
        if spec.impute:
            dm = sum(pg[k] @ w["fxm"][k].t() for k in range(3))
            dv = sum(pg[k] @ w["fxv"][k].t() for k in range(3))
    elif spec.prop == 0:
        F1 = (a["f1a"], a["f1b"], a["f1c"], a["f1d"])
        dhf, dm, dv = _field_bwd_plain(spec, w, m, v, h, F1, dt * dh1,
                                       "e1", dl)
        dh = dh1 + dhf
    else:
        F2 = (a["f2a"], a["f2b"], a["f2c"], a["f2d"])
        dkk, dmk, dvk = _field_bwd_plain(spec, w, a["mk"], a["vk"],
                                         a["kk"], F2, dt * dh1, "e2", dl)
        if spec.impute:
            dl["dmk"], dl["dvk"] = dmk, dvk
            dl["dp0"] = _pm_bwd_dp(spec, w, a["prek"], dmk, dvk, us, 0)
            dkk = dkk + dl["dp0"] @ w["pm"][0].t()
        F1 = (a["f1a"], a["f1b"], a["f1c"], a["f1d"])
        dhf, dm, dv = _field_bwd_plain(spec, w, m, v, h, F1,
                                       dt * 0.5 * dkk, "e1", dl)
        dh = dh1 + dkk + dhf
    if dm is None:
        dm, dv = torch.zeros_like(m), torch.zeros_like(v)
    return dh, dm, dv, dl


def ws_view(spec, ws, KBc, name):
    """Buffer ``name`` of a flat K6 workspace of KBc (step, row) pairs: the
    ``[KBc, width]`` matrix at float ``ws_off[name] * KBc``."""
    o, w = spec.ws_off[name], spec.width(name)
    return ws[o * KBc:(o + w) * KBc].view(KBc, w)


def gob_scan_bwd_staged_plain(spec, leaves, arrays, train, hists, dloss,
                              u=None, seed=None, chunk=None,
                              want_ws=False):
    """Plain K6 as the kernels stage it: per chunk of steps (``chunk``, by
    default ``spec.bwd_chunk``), last chunk first, (a) every step's saved
    buffers from the stored carries, (b) the reverse chain writing its
    deltas, (c) the weight gradients as one product per stage-(c) job over
    the chunk's workspace. Returns (grads in leaf order, dh0, dm0, dv0),
    and with ``want_ws`` the workspace as the first chunk left it (flat,
    the kernels' layout: :func:`ws_view` reads one buffer of it)."""
    times, dts, obs, X, M = arrays
    hh, mh, vh = hists
    K, B = obs.shape
    w = spec.weights(list(leaves))
    seed_i = _seed_int(seed)
    Kc = chunk or spec.bwd_chunk(K, B)
    dloss = float(dloss)
    jobs = spec.wgrad_jobs()
    grads = [torch.zeros_like(p) for p in leaves]
    dh, dm, dv = (torch.zeros_like(x[0]) for x in hists)
    ws = None
    with torch.no_grad():
        for k0 in reversed(range(0, K, Kc)):
            k1 = min(K, k0 + Kc)
            ws = torch.zeros((Kc * B * spec.n_ws,), dtype=hh.dtype,
                             device=hh.device)

            def put(name, kl, t):
                ws_view(spec, ws, Kc * B, name)[kl * B:(kl + 1) * B] = t

            saved = {}
            for k in range(k0, k1):
                us = _step_masks_plain(spec, k, train, u, seed_i, B,
                                       hh.device)
                saved[k] = (_step_bufs_plain(spec, w, hh[k], mh[k], vh[k],
                                             float(dts[k]), obs[k], X[k],
                                             M[k], us), us)
                for name in SAVED:
                    put(name, k - k0, saved[k][0][name])
            for k in reversed(range(k0, k1)):
                a, us = saved.pop(k)
                dh, dm, dv, dl = _chain_step_plain(
                    spec, w, a, dh, dm, dv, float(dts[k]), dloss, us)
                for name, _ in spec.deltas:
                    put(name, k - k0, dl[name])
            n = (k1 - k0) * B
            for leaf, x, d in jobs:
                dmat = ws_view(spec, ws, Kc * B, d)[:n]
                if x is None:
                    g = dmat.sum(0, keepdim=True)
                else:
                    g = ws_view(spec, ws, Kc * B, x)[:n].t() @ dmat
                grads[leaf] = grads[leaf] + g
    out = (grads, dh, dm, dv)
    return out + (ws,) if want_ws else out


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
        + [(n, ctypes.c_int) for n in ("rows", "fwd_floats", "smem_floats",
                                       "n_ws", "n_save", "n_dlt", "wsm",
                                       "o_w", "threads", "o_mw", "n_mw",
                                       "nw", "lg_nw", "ga", "slab_fwd",
                                       "slab_floats")]
        + [("leaf_off", ctypes.c_int * (MAX_LEAVES + 1))]
        + [(n, ctypes.c_int * k) for n, k in _SLOTS]
        + [(n, ctypes.c_int * MAX_SAVE) for n in ("save_sm", "save_ws",
                                                  "save_w")]
        + [(n, ctypes.c_int * MAX_DLT) for n in ("dlt_sm", "dlt_ws", "dlt_w",
                                                 "dlt_prop")]
        + [("o_" + n, ctypes.c_int) for n in BUFS])


def make_cfg(spec: Spec, K: int, B: int, train: bool, bwd: bool = True,
             chain: bool = False):
    """The kernels' configuration for one call (host memory, kept by the
    spec per shape: the callers only read it); its rows per CTA are
    ``spec.rows_for(B, bwd)``, its activations in the form of
    ``spec.acts_for()``, and K5 (``chain`` False) or the chain stages
    the weights as ``spec.stage_weights`` says, after the kernel's
    activations in shared memory."""
    key = (K, B, spec.dropping(train), bwd, chain)
    if key not in spec._cfgs:
        spec._cfgs[key] = _make_cfg(spec, K, B, train, bwd, chain)
    return spec._cfgs[key]


def _make_cfg(spec, K, B, train, bwd, chain):
    R = spec.rows_for(B, bwd)
    ga = spec.acts_for() == "global"
    off, n_fwd, total = spec.layout(R, ga)
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
    c.rows, c.fwd_floats, c.smem_floats = R, n_fwd, total
    c.n_ws, c.n_save, c.n_dlt = spec.n_ws, len(SAVED), len(spec.deltas)
    c.wsm = int(spec.stage_weights(B, bwd, chain))
    c.o_w = total if chain else n_fwd
    # the mask words past the weights K5 stages, else past the forward
    # buffers (stage (a) takes them from the chain's configuration)
    c.o_mw = (n_fwd + (spec.n_params + 3) // 4 * 4 if c.wsm and not chain
              else n_fwd)
    c.n_mw, c.nw = spec.mask_words(R), spec.nw
    c.lg_nw = (spec.nw - 1).bit_length()
    c.threads = spec.threads_for(B, bwd)
    c.ga = int(ga)
    c.slab_fwd, c.slab_floats = spec.slab_floats() if ga else (0, 0)
    for i, o in enumerate(spec.leaf_off):
        c.leaf_off[i] = o
    for n, idx in spec.slots.items():
        arr = getattr(c, n)
        for i, j in enumerate(idx):
            arr[i] = j
    for i, n in enumerate(SAVED):
        c.save_sm[i], c.save_ws[i], c.save_w[i] = \
            off[n], spec.ws_off[n], spec.width(n)
    for i, (n, prop) in enumerate(spec.deltas):
        c.dlt_sm[i], c.dlt_ws[i], c.dlt_w[i] = \
            off[n], spec.ws_off[n], spec.width(n)
        c.dlt_prop[i] = int(prop)
    for n in BUFS:
        setattr(c, "o_" + n, off[n])
    return c


def _check_inputs(spec, leaves, arrays, train, u, seed, bwd=True):
    if spec.cfg.solver not in ("euler", "midpoint"):
        raise NotImplementedError(
            "config outside the GOB kernels' scope (solver "
            f"{spec.cfg.solver!r}: euler and midpoint only; dopri5 runs "
            "the eager models.gru_ode_bayes.forward)")
    times, dts, obs, X, M = arrays
    K, B = obs.shape
    R = spec.rows_for(B, bwd)
    if R is None or not spec.fits(R, bwd):
        raise ValueError(f"{R} rows per CTA ({spec.acts_for()} "
                         f"activations) need {spec.smem_bytes(R or 1, bwd)} "
                         f"bytes of shared memory, more than {SMEM_LIMIT}")
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
    """Launch K5 (``want_hists``: the training form, at the rows of the
    training rule) or its eval form (the forward layout's rule) and reduce
    the per-CTA losses."""
    from njode_tpu_torch.ops import _build

    K, B = _check_inputs(spec, leaves, arrays, train, u, seed,
                         bwd=want_hists)
    if not want_hists and train:
        raise ValueError("the history-free kernel is the eval forward")
    _check("h0", h0, (B, spec.H))
    _check("m0", m0, (B, spec.D))
    _check("v0", v0, (B, spec.D))
    lib = _build.lib("fused_gob")
    times, dts, obs, X, M = arrays
    dev = h0.device
    cfg = make_cfg(spec, K, B, train, bwd=want_hists)
    n_cta = -(-B // cfg.rows)
    loss_part = torch.empty((n_cta,), dtype=torch.float32, device=dev)
    if want_hists:
        hists = (torch.empty((K, B, spec.H), device=dev),
                 torch.empty((K, B, spec.D), device=dev),
                 torch.empty((K, B, spec.D), device=dev))
    else:
        hists = (None, None, None)
    slab = (torch.empty((n_cta * cfg.slab_fwd,), device=dev) if cfg.ga
            else None)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.gob_scan_fwd(
            ctypes.addressof(cfg), _leaf_ptrs(leaves), _ptr(dts), _ptr(obs),
            _ptr(X), _ptr(M), _ptr(u), _ptr(seed), _ptr(h0), _ptr(m0),
            _ptr(v0), _ptr(loss_part), *(_ptr(t) for t in hists),
            int(want_hists), _ptr(slab), stream)
    _raise_rc(lib, rc, "gob_scan_fwd")
    LAUNCHES["gob_scan_fwd" if want_hists else "gob_scan_eval"] += 1
    if cfg.mode == 2:
        LAUNCHES["gob_philox_keep"] += 1
    loss = fs._reduce(loss_part.view(n_cta, 1), 1.0)
    return loss.reshape(()), (hists if want_hists else None)


def gob_scan_bwd_cuda(spec, leaves, arrays, train, hists, dloss, u=None,
                      seed=None, chunk=None, want_ws=False):
    """Launch K6: for each chunk of ``chunk`` steps (default
    ``spec.bwd_chunk``), last first, its stages (a) remat, (b) chain and
    (c) wgrad, enqueued by one C call; then reduce stage (c)'s partial
    rows. Returns (grads as views of one flat buffer, in leaf order and
    shape, dh0, dm0, dv0), and with ``want_ws`` the workspace as the first
    chunk left it (flat, :func:`ws_view`; for tests)."""
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
    Kc = chunk or spec.bwd_chunk(K, B)
    n_chunks = -(-K // Kc)
    n_split = spec.wgrad_splits(Kc * B)
    tiles, jobs = spec.wgrad_program(dev)
    ws = torch.empty((Kc * B * spec.n_ws,), device=dev)
    partials = torch.empty((n_split, spec.n_params), device=dev)
    dh0 = torch.empty((B, spec.H), device=dev)
    dm0 = torch.empty((B, spec.D), device=dev)
    dv0 = torch.empty((B, spec.D), device=dev)
    cfg = make_cfg(spec, K, B, train, chain=True)
    slab = None
    if cfg.ga:          # stage (a)'s slabs, then the chain's, in one buffer
        nb = -(-B // cfg.rows)
        slab = torch.empty((max(nb * Kc * cfg.slab_fwd,
                                nb * cfg.slab_floats),), device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        rc = lib.gob_scan_bwd(
            ctypes.addressof(cfg), _leaf_ptrs(leaves), _ptr(dts), _ptr(obs),
            _ptr(X), _ptr(M), _ptr(u), _ptr(seed), _ptr(hh), _ptr(mh),
            _ptr(vh), _ptr(dloss), _ptr(ws), Kc, _ptr(tiles),
            int(tiles.shape[0]), _ptr(jobs), n_split, _ptr(partials),
            _ptr(dh0), _ptr(dm0), _ptr(dv0), _ptr(slab), stream)
    _raise_rc(lib, rc, "gob_scan_bwd")
    for key in ("gob_bwd_remat", "gob_scan_bwd", "gob_bwd_wgrad"):
        LAUNCHES[key] += n_chunks
    if cfg.mode == 2:
        LAUNCHES["gob_philox_keep"] += n_chunks
    flat = fs._reduce(partials, 1.0)
    grads = [flat[a:b].view(s) for a, b, s in
             zip(spec.leaf_off[:-1], spec.leaf_off[1:], spec.leaf_shapes)]
    out = (grads, dh0, dm0, dv0)
    return out + (ws,) if want_ws else out


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
            f"{cfg.solver!r}: euler and midpoint only, as the JAX kernel's "
            "rule); use models.gru_ode_bayes.forward")


def make_fused_loss_fn(cfg, mask_mode: str = "prng", u_override=None,
                       mesh=None):
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
        one, through the input path).
    :param mesh: a ``parallel.sharding.Mesh``: as in
        ``fused_scan.make_fused_loss_fn`` (the global masks drawn on every
        rank and sliced, one 'prng' seed a rank, the kernels at ``B / n``
        rows), except that the loss is a sum over observations: rank r
        returns the sum over its rows, and ``parallel.sharding.
        allreduce_grads(..., 'sum', loss)`` makes loss and gradients the
        global batch's (the JAX package's ``psum``)."""
    from njode_tpu_torch.models import gru_ode_bayes as gob
    from njode_tpu_torch.parallel import sharding

    _require_supported(cfg)
    spec = Spec(cfg, mask_mode)
    sharding.check_mesh(mesh, "fused kernel sharding")
    n_seeds = 1 if mesh is None else mesh.size

    def loss_fn(model, batch, generator, train):
        K, B = batch.obs.shape
        if mesh is not None:
            sharding.check_divisible(B, mesh)
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
                seed = torch.randint(0, 2 ** 62, (n_seeds,),
                                     generator=generator, device=dev,
                                     dtype=torch.int64)
        if mesh is not None:
            batch = sharding.shard_batch(batch, mesh)
            if dropping:
                u0c = sharding.shard_rows(u0c, mesh)
                u0p = sharding.shard_rows(u0p, mesh)
            if u is not None:
                u = sharding.shard_rows(u, mesh, 2)
            if seed is not None:
                seed = seed[mesh.rank:mesh.rank + 1]
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


def make_fused_eval_fn(cfg, mesh=None):
    """Return ``eval_fn(model, batch)``: the eval loss through K5's
    history-free form (its plain version on CPU) at any batch size; with a
    ``mesh`` each rank runs it on its block of the global ``batch``'s rows
    and the blocks' sums are summed over the ranks."""
    from njode_tpu_torch.models import gru_ode_bayes as gob
    from njode_tpu_torch.parallel import sharding

    _require_supported(cfg)
    spec = Spec(cfg, "input")
    sharding.check_mesh(mesh, "fused kernel sharding")

    def local(model, batch):
        with torch.no_grad():
            h0 = gob.mlp2(model.covariates_map, batch.start_X, 0.0)
            p0 = gob.mlp2(model.p_model, h0, 0.0)
            arrays = (batch.times, batch.dt, batch.obs, batch.X, batch.M)
            loss, _ = gob_scan_fwd(
                spec, flat_leaves(model, spec), arrays, h0.contiguous(),
                p0[:, :spec.D].contiguous(), p0[:, spec.D:].contiguous(),
                False, want_hists=False)
        return loss

    def eval_fn(model, batch):
        if mesh is None:
            return local(model, batch)
        return sharding.all_reduce(
            local(model, sharding.shard_batch(batch, mesh)), mesh)

    return eval_fn
