"""The NJODE training scan as hand-written CUDA kernels, with plain versions.

The port's counterpart of ``njode_tpu/ops/fused_scan.py``. The whole K-step
scan runs in one kernel launch (``csrc/fused_scan.cu``): the forward
(K1, ``njode_scan_fwd``) stores only the step-entry carries ``h``,
``last_X``, ``tau``; the backward (K2, ``njode_scan_bwd``, one C call)
runs three stages a chunk of steps, last chunk first: (a) re-runs every
step of the chunk at once from those carries into a workspace of
per-(step, row) records (``Spec.ws_fields``), (b) walks the chunk
backwards for the carries' gradients, writing the gradient of every
Linear's output to the records, (c) sums every weight gradient as d^T x
over the records of each stretch of steps; the eval
forward (K3) is K1 without histories or dropout; the dropout keep-masks
(K4) come from a counter-based Philox inside the kernels ('prng' mode) or
from an int8 tensor ('input' mode). :class:`FusedNJODELoss` wraps the
kernels as a ``torch.autograd.Function``; the t=0 encoder stays outside in
plain torch, its gradient composes through the ``dh0`` the Function
returns.

Every kernel has a plain PyTorch version here (``scan_fwd_plain``,
``scan_bwd_plain``, ``philox_keep_plain``, ``reduce_partials_plain``; K2's
stages ``scan_bwd_staged_plain``). The wrappers take the plain version
only for tensors on the CPU; for CUDA tensors they launch the kernel or
raise. ``scan_bwd_plain`` takes its gradients from ``torch.autograd`` over
a re-run of each step in one walk, so it is independent of the
hand-derived BPTT in the CUDA source; ``scan_bwd_staged_plain`` does the
same stage by stage and writes the workspace the kernels write.

Kernel scope (``supported``): masked (``output_size == input_size``) or
unmasked (``output_size`` and ``input_size`` equal, or one of them 1: the
loss is the eager forward's, whose ``M = ones_like(X)`` broadcasts against
``y [B, O]``, so both terms sum over max(D, O) coordinates and the
gradient sums back over the broadcast axis; such a config runs in the
global plan alone), the encoder jump or the GRU jump
(``use_rnn``), euler, standard or easy loss, tanh/relu MLPs of any depth,
residual cases 0/1/2, ``input_current_t`` on or off, with or without bias,
fp32, and the activations of at least one batch row within the shared
memory of one CTA. The masked branch imputes the
unobserved coordinates from the pre-jump readout, so its two readouts run
one after the other (pre-jump, encoder on ``[tanh X_imp, M]``, post-jump)
instead of as one stacked chain, and ``last_X`` records the post-jump
prediction.

The GRU jump replaces the encoder at observed rows, masked or not:
``h' = GRUCell(tanh X, tanh h1)`` on the raw observation, in torch's gate
order r, z, n (gate g at row offset ``g*H`` of ``weight_ih [3H, D]`` and
``weight_hh [3H, H]``): ``n = tanh(gi_n + r * gh_n)`` with ``b_hh_n`` inside
``gh_n``, so ``b_hh_n``'s gradient is ``r * da_n``, not ``da_n``. Both
readouts then run as one stacked chain even when masked; a masked config
keeps its M-weighted loss and ``last_X = y``. The encoder runs only at t=0,
outside the kernels (its dropout slots stay in S, unused in the scan). The
kernels save ``(r, z, n, gh_n)`` per row and unit (region ``gru``) and the
backward's gate gradients (``dG``), regions the layout holds only with
``use_rnn``.

Plans (``Spec.plan``, ``Spec.rows``, ``Spec.rows_for``; the counterpart of
the JAX kernel's ``_select_plan``). 'resident': every weight in the shared
memory of each CTA (K2's chain also two io sets of a step's forward
values, no weight gradients); taken wherever it fits at
some R of 16, 8, 4, 2, 1 (``Spec.rows``: the most that fit). A launch at
batch B takes ``Spec.rows_for(B, bwd)`` rows a CTA: the fewest at which
every CTA of the launch is resident on the card at once (``CTAS_PER_SM``
a SM at most, fewer where the kernel's own shared memory allows fewer),
so one row a CTA at the training batches (B = 50-200) and 16 at the
eval's B = 4,000. K1/K3's layout holds no backward regions. K2's stage
(a) runs the forward layout at ``Spec.remat_rows`` rows a CTA.
'global': the weights stay in one packed buffer in device memory (each
leaf at a 16-byte boundary, ``Spec.pack_off``) and K2's chain re-runs
each step itself (no stage (a)), so only the activations of R rows sit
in shared memory, R the largest that fits (the 160- to 400-wide arms),
and the shared memory left over
holds a ring of two weight tiles that the kernels fill in the background
(``Spec.tile_program`` lists a step's tiles in the order the kernels use
them). Both plans sum in the same order, so at one R they give the same
bits. ``plan=(name, R)`` forces a plan, for the tests.

K1/K3 at one row a CTA (the resident plan's training batches) take the
role walk where ``Spec.role_program`` gives the config one (``Spec.roles``:
unmasked configs; else the item loop): every thread's role in each phase
of a step (its group: a net's Linear, or a last layer fused with what
reads it; its stacked row and output) resolved on the host, each net's
items from a warp boundary, the stacked readout and the loss terms of step
k in step k + 1's phases, the carries in the last phase (3 phases a step
on the main path, 4 with the GRU jump). Its CTAs take 128 threads where a
member launch overflows a wave (``Spec.fwd_threads``), four an SM; the
arithmetic and so the bits are the item loop's.

The per-layer description of the nets (each Linear's widths, activation,
offsets and where its activations are saved) and the leaves' offsets and
device addresses travel in a layer table in device memory
(``layer_table``; ``_LayerRec`` mirrors a record), not in the kernels'
parameter block, so a net's depth has no cap but the shared memory its
activations, mask words and records take, which ``Spec.layout`` counts.
Each CTA copies the records into shared memory at entry. The table is
built once per spec, device and leaf addresses and uploaded from pinned
memory on the launch's stream; a trainer, whose Adam updates the leaves
in place, uploads it once.

The wrappers' C calls enqueue ``reduce_partials`` themselves, right after
K1/K3 (the per-CTA losses) and K2 (stage (c)'s per-stretch gradient
rows), and count it in ``LAUNCHES``; a K2 call counts once in
``LAUNCHES`` and its stages, a launch a chunk each, in
``STAGE_LAUNCHES``.

A member axis (the grouped ensembles; the JAX kernel under ``jax.vmap``):
``njode_scan_fwd_members`` / ``njode_scan_bwd_members`` launch K1/K2 once
for E members of one config, grid ``(ceil(B/R), E)``, each CTA offsetting
its member's pointers at entry (leaves, packed weights, batch, masks,
seed, histories, workspace, partial rows); the member ``reduce_partials``
gives ``loss [E]`` and ``grads [E, n_params]``. A launch keeps the solo
rows rule at B, and K2's stage (c) sums in an order no chunk length
changes, so each member's bits are its solo launch's.
:class:`FusedNJODEMembersLoss` and :func:`make_fused_members_loss_fn` wrap
them; the member plain versions run the solo ones a member at a time.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch
import torch.nn.functional as F

from njode_tpu_torch.models import mlp
from njode_tpu_torch.models.losses import step_loss
from njode_tpu_torch.models.njode import dropout_slots, net_widths

MAX_ROWS = 16             # batch rows per CTA (csrc/fused_scan.cu MAX_ROWS)
ROW_CHOICES = (16, 8, 4, 2, 1)
N_SM = 132                # SMs of the H100 SXM
SM_SMEM = 233472          # shared memory of one SM (228 KB)
CTA_RESERVED = 1024       # shared memory the card reserves for each CTA
# CTAs of the resident kernels an SM holds at most: their
# __launch_bounds__(NTHREADS, CTAS_PER_SM) keeps a thread within the
# registers that many CTAs of 256 threads leave (csrc/fused_scan.cu)
CTAS_PER_SM = 2
PLANS = ("resident", "global")
LAYER_INTS = 8            # ints of a layer's record (csrc/fused_scan.cu)
# K1's kernel parameters after ScanCfg: the layer table and 16 pointers;
# K2's chain's: 19 pointers and 5 ints (n_fld after its 17th pointer, then
# two pointers and k0, k1, Kc, first)
KERNEL_PTRS = 17
CHAIN_PTRS, CHAIN_INTS = 19, 5
# K2's workspace: a chunk of steps is as long as keeps the workspace of a
# launch (all its members) under this many bytes, a multiple of the
# stretch of stage (c), ceil(WG_ROWS / B) steps, whose sums are the
# partial rows; WG_TILE: stage (c)'s output tile [32, 32] of a leaf
WS_BUDGET = 32 << 20
WG_ROWS = 512
WG_TILE = 32
SMEM_LIMIT = 232448       # bytes of shared memory one CTA may use (H100)
# the global plan's weight ring (csrc/fused_scan.cu): rows a thread sums,
# items a thread carries across tiles, threads a CTA, ints a tile
RB, MAXI, NTHREADS, TILE_INTS = 4, 4, 256, 8
# K1's role walk at one row a CTA (csrc/fused_scan.cu role_scan_fwd,
# Spec.role_program): phases of a step at most, groups of a phase (fewer
# than), ints of a group, virtual threads of a phase at most (256 or 512), the
# group kinds and the offsets a group's addresses take each step (none,
# the step's io set, the readout state of the step before, of the step)
RPH_MAX, RG_MAX, RGI, RV_MAX = 16, 6, 16, 512
# ints of the role walk's head in the layer table (csrc/fused_scan.cu
# RoleCfg, Spec.role_head), before its program
RHEAD = 8
RK = {k: i + 1 for i, k in enumerate(
    ("hid", "ej", "eu", "gru", "rol", "car", "acc", "fill"))}
RM_NONE, RM_IO, RM_PREV, RM_CUR = 0, 1, 2, 3
# when a group runs: the step's own recurrence, the readout of the step
# before, the loss sum of the step two before (csrc/fused_scan.cu RLAG)
RW = {"rec": 0, "prev": 1, "acc": 2}

# launches per kernel; a wrapper adds one where it launches its kernel.
# K1-K3 count each branch and plan apart ('_rnn': the GRU jump; '_global':
# the global plan's instantiations), and K1/K2 over a member axis apart
# ('_members': one launch for the E members of a group). 'philox_keep'
# (K4: the mask words K1/K2 fill as they run) counts their 'prng'-mode
# launches; 'philox_masks' counts the stand-alone mask dump used by tests
# and timing.
LAUNCHES = {k + rnn + plan: 0
            for k in ("njode_scan_fwd", "njode_scan_eval", "njode_scan_bwd",
                      "njode_scan_fwd_members", "njode_scan_bwd_members")
            for rnn in ("", "_rnn") for plan in ("", "_global")}
LAUNCHES.update(philox_keep=0, reduce_partials=0, philox_masks=0,
                philox_keep_members=0, reduce_partials_members=0)
# the rows per CTA of each K1-K3 launch: (LAUNCHES key, B, R) -> launches
LAUNCH_ROWS = {}
# K2's stages, which its C call launches once a chunk each (a K2 call
# counts once in LAUNCHES): stage (a), the forward re-run (the resident
# plan alone), stage (b), the chain, and stage (c), the weight gradients
STAGE_LAUNCHES = {"njode_bwd_remat": 0, "njode_bwd_chain": 0,
                  "njode_bwd_wgrad": 0}


def reset_launch_counts():
    for d in (LAUNCHES, STAGE_LAUNCHES):
        for k in d:
            d[k] = 0
    LAUNCH_ROWS.clear()


# ---------------------------------------------------------------------------
# static spec
# ---------------------------------------------------------------------------

class Spec:
    """Static kernel specification derived from an NJODEConfig.

    ``mask_mode``: 'input' (int8 keep-masks [K,S,B,Wmax] drawn outside) or
    'prng' (Philox inside the kernels, keyed by a per-call seed).
    ``plan``: None (the rule: 'resident' where K2's layout fits at some of
    16, 8, 4, 2, 1 rows, ``rows`` the most that fit and each launch at
    ``rows_for(B)``; else 'global' at the most rows that fit; 'global'
    alone where ``output_size != input_size``) or a forced ``(name,
    rows)``, which every launch takes; ``self.plan`` is None when neither
    plan fits. For the tests, a subclass whose ``_role_groups`` returns
    None keeps K1/K3 at one row a CTA in the item loop, and ``_threads``
    (set after construction: 128 or 256) forces the threads a CTA of
    every K1/K3 launch in the role walk (``fwd_threads``)."""

    def __init__(self, cfg, mask_mode: str = "prng", plan=None):
        if mask_mode not in ("input", "prng"):
            raise ValueError(f"unknown mask_mode {mask_mode!r}")
        self.cfg = cfg
        self.mask_mode = mask_mode
        self.D, self.H, self.O = cfg.input_size, cfg.hidden_size, \
            cfg.output_size
        self.ict = bool(cfg.input_current_t)
        self.masked = bool(cfg.masked)
        self.use_rnn = bool(cfg.use_rnn)
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
        # weight [out, in] then bias [out]; then, with use_rnn, the GRU's
        # weight_ih [3H, D], weight_hh [3H, H] (and bias_ih, bias_hh [3H])
        self.leaf_shapes = []
        for ws in (self.ode_w, self.enc_w, self.ro_w):
            for a, b in zip(ws[:-1], ws[1:]):
                self.leaf_shapes.append((b, a))
                if self.bias:
                    self.leaf_shapes.append((b,))
        self.gru_leaf0 = len(self.leaf_shapes)
        if self.use_rnn:
            H3 = 3 * self.H
            self.leaf_shapes += [(H3, self.D), (H3, self.H)]
            if self.bias:
                self.leaf_shapes += [(H3,), (H3,)]
        # each weight's bias leaf (an MLP's the leaf after it, the GRU's
        # two leaves after its two weights)
        self.bias_of = {}
        if self.bias:
            for i in range(self.gru_leaf0):
                if len(self.leaf_shapes[i]) == 2:
                    self.bias_of[i] = i + 1
            if self.use_rnn:
                g = self.gru_leaf0
                self.bias_of.update({g: g + 2, g + 1: g + 3})
        self.leaf_off = [0]
        for s in self.leaf_shapes:
            n = 1
            for d in s:
                n *= d
            self.leaf_off.append(self.leaf_off[-1] + n)
        self.n_params = self.leaf_off[-1]
        # the global plan's packed weights: each leaf at a 16-byte boundary
        self.pack_off = [0]
        for a, b in zip(self.leaf_off[:-1], self.leaf_off[1:]):
            self.pack_off.append(self.pack_off[-1] + (b - a + 3) // 4 * 4)
        self.buf_w = max(self.ode_w + self.enc_w + self.ro_w)
        # the layer table (layer_table): a record a Linear, the ODE net's,
        # the encoder's, then the readout's (its first at lay0[net]), the
        # leaves' offsets at tab_leaves, their addresses at tab_ptrs (an
        # even int: 8-byte aligned), tab_ints ints in all
        n_lin = [len(ws) - 1 for ws in (self.ode_w, self.enc_w, self.ro_w)]
        self.lay0 = {"ode": 0, "enc": n_lin[0], "ro": n_lin[0] + n_lin[1]}
        self.n_rec = sum(n_lin)
        self.tab_leaves = LAYER_INTS * self.n_rec
        self._cfgs, self._progs, self._tabs = {}, {}, {}
        self._head = None
        self._build_ws()
        self.forced = plan is not None
        self.plan, self.rows = self._choose_plan(plan)
        # K1's role walk (role_program), its program after the leaves'
        # offsets in the layer table, at tab_roles
        self.roles = self._role_groups()
        self.rp_ints = self._rp_ints()
        if self.roles is not None and not self._roles_fit():
            self.roles, self.rp_ints = None, 0
        self.tab_roles = self.tab_leaves + len(self.leaf_off)
        self._threads = None
        n_roles = RHEAD + self.rp_ints if self.roles is not None else 0
        self.tab_ptrs = -(-(self.tab_roles + n_roles) // 2) * 2
        self.tab_ints = self.tab_ptrs + 2 * len(self.leaf_shapes)

    def fits(self, plan: str, R: int) -> bool:
        """Whether K1-K3 fit one CTA at R rows in ``plan`` (resident: K1's
        layout and K2's chain's)."""
        off, n = self.layout(R, plan)
        if plan == "resident":
            n = max(n, self.layout(R, plan, False)[1])
        return 4 * n <= SMEM_LIMIT and (
            plan != "global"
            or self._ring_stage(off["ring"]) >= self._ring_need()[0])

    def _choose_plan(self, plan):
        # the resident kernels compute the loss of D == O alone (their code
        # stays the loss of the main path's configs); the global plan
        # broadcasts it where O != D
        plans = PLANS if self.O == self.D else ("global",)
        if plan is not None:
            name, R = plan
            if name not in PLANS or R not in ROW_CHOICES:
                raise ValueError(f"unknown plan {plan!r}")
            if name not in plans:
                raise ValueError(f"plan {plan!r}: output_size != input_size "
                                 "runs in the global plan alone")
            if not self.fits(name, R):
                raise ValueError(f"plan {plan!r} overflows one CTA's shared "
                                 "memory")
            return name, R
        for name in plans:
            for R in ROW_CHOICES:
                if self.fits(name, R):
                    return name, R
        return None, None

    def ctas_per_sm(self, R: int, bwd: bool = True) -> int:
        """CTAs of the resident K2 (``bwd``) or K1/K3 at R rows that one SM
        holds at once: as many as its shared memory takes, at most
        ``CTAS_PER_SM``."""
        n = 4 * self.layout(R, "resident", bwd)[1] + CTA_RESERVED
        return min(CTAS_PER_SM, SM_SMEM // n)

    def rows_for(self, B: int, bwd: bool = True) -> int:
        """Rows per CTA of K2 (``bwd``) or K1/K3 at batch B: a forced plan's
        rows; in the resident plan the fewest of 1, 2, 4, 8, 16 (up to
        ``rows``) at which the launch's ceil(B / R) CTAs are all resident
        at once on the card's ``N_SM`` SMs, or ``rows`` where none is; in
        the global plan (one CTA an SM) K2 at ``rows``, and K1/K3 at the
        fewest rows at which a solo launch's ceil(B / R) CTAs are all
        resident at once, but at least two where no net is wider than a
        CTA's ``NTHREADS`` threads, and at ``rows`` where that pick is
        more than a quarter of ``rows``. Each part is what the H100
        measured (``ab_scan_kernels.py ROOT TAG grows``, every rows that
        fit at widths 160, 320, 400 at B = 20-200 and at PhysioNet 200 at
        B = 50): the rule takes the fastest rows of all 13 arms. Width 160
        and PhysioNet 200 ran 1.5x faster at two rows than at one; widths
        320 and 400 at B <= 100 1.1-1.7x faster at one than at two; width
        400 at B = 200 13 % faster at four than at two. A member launch
        takes one member's rows, so each member sums in its solo launch's
        order and gives its bits; its E ceil(B / R) CTAs may then take
        more than one wave. A row's sums and so the histories keep their
        bits at any rows."""
        if self.forced:
            return self.rows
        if self.plan == "global":
            if bwd:
                return self.rows
            R = next((R for R in reversed(ROW_CHOICES) if -(-B // R) <= N_SM),
                     self.rows)
            if self.buf_w <= NTHREADS:
                R = max(R, 2)
            return R if 4 * R <= self.rows else self.rows
        if self.plan != "resident":
            return self.rows
        for R in reversed(ROW_CHOICES):
            if R > self.rows:
                break
            if -(-B // R) <= self.ctas_per_sm(R, bwd) * N_SM:
                return R
        return self.rows

    @property
    def thresh(self) -> int:
        return min(int((1.0 - self.rate) * 2.0 ** 32), 2 ** 32 - 1)

    def split(self, flat):
        """Per-MLP lists of (W, b) from the flat leaf list, and the GRU's
        ``(weight_ih, weight_hh, bias_ih, bias_hh)`` (None without
        use_rnn; the biases None without bias)."""
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
        gru = None
        if self.use_rnn:
            gru = tuple(flat[i:i + 4]) if self.bias else (
                flat[i], flat[i + 1], None, None)
        out.append(gru)
        return out

    def layout(self, R: int = MAX_ROWS, plan: str = "resident",
               bwd: bool = True, roles: bool = False):
        """Float offsets of every shared-memory region of one CTA with
        ``R`` rows, and the total. ``tX`` holds the encoder's input
        (``tanh X``, or ``[tanh X_imp, M]`` when masked); ``M`` and ``Xi``
        (``X_imp``) are empty unless masked. The readout's saved
        activations hold one stacked pass of 2R rows, or, when masked
        without use_rnn, the pre-jump pass of R rows at ``s_ro`` and the
        post-jump one at ``s_ro2``. With use_rnn, ``tX`` holds the GRU's
        input ``tanh X`` (R x D), ``in_ro[0:R*H]`` its ``tanh h1``, and
        ``gru`` the saved r, z, n, gh_n (4 x R x H), ``dG`` the backward's
        da_r, da_z, da_n, dgh_n per row (R x 4H).

        'global' (one layout for K1-K3): the activations, the layer
        records ``lay``, then the weight ring in what they leave.
        'resident', K1/K3 (``bwd`` False; K2's stage (a) at its own rows):
        the weights ``w``, then two sets of the step's inputs and carries
        (``io``: t and dt at ``tdt``, ``h``, ``lx``, ``tau``, ``X``,
        ``obs``, ``M``, and the ODE's and the jump's inputs ``in_ode``,
        ``tX``; the second set ``io2 - io`` floats after the first), so one
        step fills the other set while it reads its own; then the step's
        forward values, ``le`` the loss's error terms of each row and
        output, which the readout's last phase writes. 'resident', K2's
        chain (``bwd``): the weights, then two io sets that each hold a
        step's inputs and every forward value the chain reads (stage (a)'s
        fields, the mask words among them; no carries), the chain reading
        one while the next step's copies fill the other, then the backward
        regions.

        Both plans hold ``mw``, the dropout masks as bits
        (``mask_words``): two sets in the resident plan (a step's, and
        the next one's being filled, or one in each io set of the chain),
        one in the global plan (filled at the end of each step; in the
        masked branch without the GRU jump inside ``dB``, whose second
        half its backward never uses), none without dropout; the resident
        plan ends with the layer records ``lay`` (``LAYER_INTS`` ints a
        Linear), after every region the kernels' phases read.

        ``roles`` (K1/K3 at one row a CTA in the role walk,
        ``role_program``): the step's forward values also hold the
        readout's inputs of X (``rX``) and obs (``robs``) and the obs its
        loss term is weighed by (``lo``), and, as the readout runs in the
        step after its own, a second copy of them all, ``rs2``
        (``rs_stride`` floats after the first); three sets
        of mask words (a step's, the step before's, the next one's); the
        role program ``rp``."""
        R2 = 2 * R
        D, H, O, P = self.D, self.H, self.O, self.n_params
        DM = D if self.masked else 0
        off, n = {}, 0

        def take(name, size):
            nonlocal n
            off[name] = n
            n += (size + 3) // 4 * 4        # 16-byte aligned regions

        def saves():
            for name, ws, rows in (("s_ode", self.ode_w, R),
                                   ("s_enc", self.enc_w, R),
                                   ("s_ro", self.ro_w, R2)):
                take(name, 2 * rows * sum(ws[1:-1]))
            off["s_ro2"] = off["s_ro"] + 2 * R * sum(self.ro_w[1:-1])

        def fwd_values(*extra):
            for name, size in (("h1", R * H), ("h2", R * H),
                               ("in_ro", R2 * H), ("ro", R2 * O),
                               ("le", R2 * O)) + extra:
                take(name, size)
            saves()

        def bwd_regions(*extra):
            for name, size in (("dA", R2 * self.buf_w),
                               ("dB", R2 * self.buf_w), ("dh", R * H),
                               ("dlx", R * D), ("dtau", R)) + extra + (
                                  ("dst", R2 * O), ("dh1", R * H),
                                  ("dhe", R * H), ("df", R * H),
                                  ("dlxc", R * D), ("dtauc", R)):
                take(name, size)

        if plan == "global":
            for name, size in (("h", R * H), ("lx", R * D), ("tau", R),
                               ("X", R * D), ("obs", R), ("nobs", R),
                               ("lrow", R), ("h1", R * H), ("h2", R * H),
                               ("in_ode", R * self.ode_w[0]),
                               ("tX", R * self.enc_w[0]),
                               ("in_ro", R2 * H), ("f", R * H),
                               ("enc", R * H), ("ro", R2 * O),
                               ("M", R * DM), ("Xi", R * DM)):
                take(name, size)
            saves()
            bwd_regions(("rs", 2 * R))
            if self.use_rnn:
                take("gru", 4 * R * H)
                take("dG", 4 * R * H)
                take("gsc", 6 * R * H)
            if (self.masked and not self.use_rnn
                    and self.mask_words(R) <= R * self.buf_w):
                # the masked branch's backward passes run over R rows, so
                # the second half of dB (2R rows for a stacked readout) is
                # free all step: the mask words live there and the ring
                # keeps its stages
                off["mw"] = off["dB"] + R * self.buf_w
            else:
                take("mw", self.mask_words(R))
            take("lay", LAYER_INTS * self.n_rec)
            take("ring", 2 * max(self._ring_stage(n), 0))
            return off, n
        take("w", P)
        c = 0 if bwd else 1             # the chain keeps no carries
        off["io"] = n
        for name, size in (("tdt", 2), ("h", c * R * H), ("lx", c * R * D),
                           ("tau", c * R), ("X", R * D), ("obs", R),
                           ("M", R * DM), ("in_ode", c * R * self.ode_w[0]),
                           ("tX", c * R * self.enc_w[0])):
            take(name, size)
        if bwd:
            # the forward fields as the record holds them, R rows a field
            fb = n
            take("fwd", R * self.n_fwd)
            w0 = self.ws_off
            first = {"in_ode": ("in_ode",), "tX": ("tX",),
                     "in_ro": ("in_ro", 0), "h1": ("h1",), "h2": ("h2",),
                     "ro": ("ro", 0), "le": ("le", 0), "gru": ("gru", 0),
                     "mw": ("mw",), "s_ode": ("pre", "ode", 0, 0),
                     "s_enc": ("pre", "enc", 0, 0),
                     "s_ro": ("pre", "ro", 0, 0),
                     "s_ro2": ("pre", "ro", 0, 1)}
            for name, field in first.items():
                if name != "gru" or self.use_rnn:
                    off[name] = fb + R * w0.get(field, 0)
        off["io2"] = n
        n += n - off["io"]
        if bwd:
            take("nobs", R)
            bwd_regions()
            if self.use_rnn:
                take("dG", 4 * R * H)
        else:
            take("nobs", R)
            take("lrow", R)
            if not roles:
                fwd_values(("Xi", R * DM))
            else:
                # the ODE net's and the encoder's saves, then the readout
                # state twice
                take("s_ode", 2 * R * sum(self.ode_w[1:-1]))
                take("s_enc", 2 * R * sum(self.enc_w[1:-1]))
                rs0 = n
                for name, size in (("h1", R * H), ("h2", R * H),
                                   ("in_ro", R2 * H), ("le", R2 * O),
                                   ("rX", R * D), ("robs", R), ("lo", R),
                                   ("s_ro", 2 * R2 * sum(self.ro_w[1:-1]))):
                    take(name, size)
                off["s_ro2"] = off["s_ro"] + 2 * R * sum(self.ro_w[1:-1])
                off["rs2"] = n
                n += n - rs0
            if self.use_rnn:
                take("gru", 4 * R * H)
            take("mw", (3 if roles else 2) * self.mask_words(R))
            if roles:
                take("rp", self.rp_ints)
        take("lay", LAYER_INTS * self.n_rec)
        return off, n

    @property
    def nw(self) -> int:
        """Mask words of a row and slot: 32 columns a word."""
        return -(-self.w_max // 32)

    def mask_words(self, R: int) -> int:
        """32-bit words of one step's dropout masks at R rows (every slot
        at ``nw`` words a row), 0 without dropout."""
        if not (self.rate > 0.0 and self.S > 0):
            return 0
        return R * self.S * self.nw

    def ring_ops(self, R: int):
        """The weight products of one step in the global plan, in the
        order the kernels run them: the forward's (K1-K3, ``step_forward``)
        and K2's backward's. Each ``(dx, key, wo, wi, rows, bias)``: W
        [wo, wi] at packed offset ``key``, its bias at ``bias`` (-1: none,
        or a dx product), y = W x (``dx`` False) or dx = W^T d, over
        ``rows`` batch rows."""
        po, i, nets = self.pack_off, 0, []
        for ws in (self.ode_w, self.enc_w, self.ro_w):
            layers = []
            for wi, wo in zip(ws[:-1], ws[1:]):
                key, i = po[i], i + 1
                bias = -1
                if self.bias:
                    bias, i = po[i], i + 1
                layers.append((key, bias, wo, wi))
            nets.append(layers)
        ode, enc, ro = nets

        def fwd(net, rows):
            return [(False, k, wo, wi, rows, b) for k, b, wo, wi in net]

        def bwd(net, rows, want_dx):
            return [(True, k, wo, wi, rows, -1)
                    for l, (k, _, wo, wi) in reversed(list(enumerate(net)))
                    if l > 0 or want_dx]

        H3 = 3 * self.H
        f = fwd(ode, R)
        if self.masked and not self.use_rnn:
            f += fwd(ro, R) + fwd(enc, R) + fwd(ro, R)
            b = bwd(ro, R, True) + bwd(enc, R, True) + bwd(ro, R, True)
        else:
            g = self.gru_leaf0
            if self.use_rnn:
                bih, bhh = (po[g + 2], po[g + 3]) if self.bias else (-1, -1)
                f += [(False, po[g], H3, self.D, R, bih),
                      (False, po[g + 1], H3, self.H, R, bhh)]
                jump = [(True, po[g + 1], H3, self.H, R, -1)]
            else:
                f += fwd(enc, R)
                jump = bwd(enc, R, False)
            f += fwd(ro, 2 * R)
            b = bwd(ro, 2 * R, True) + jump
        return f, b + bwd(ode, R, True)

    def _ring_need(self):
        """Floats a ring stage needs at least (one column of every forward
        product with its bias, one row of every dx product) and for every
        product whole."""
        least = whole = 0
        for dx, _, wo, wi, _, _ in sum(self.ring_ops(1), []):
            n_o, n_s = (wi, wo) if dx else (wo, wi)
            least = max(least, n_o if dx else 2 * n_o)
            whole = max(whole, n_o * n_s if dx else n_o * (n_s + 1))
        return least, whole

    def _ring_stage(self, used: int) -> int:
        """Floats of each of the ring's two stages when ``used`` floats of
        shared memory hold the rest: every product whole if that fits,
        else what is left, a multiple of 4 either way."""
        whole = (self._ring_need()[1] + 3) // 4 * 4
        return min(whole, (SMEM_LIMIT // 4 - used) // 2 // 4 * 4)

    def tile_program(self, R=None):
        """The global plan's ring tiles of one step at R rows a CTA
        (default ``rows``), ``TILE_INTS`` ints each (csrc/fused_scan.cu
        ``Ring``), and how many belong to the forward and to K2's
        backward. A forward product takes column blocks of W (as many
        columns as fit beside the bias, a multiple of 4 where it splits,
        for 16-byte copies), a dx product row blocks; a split product is
        walked once per ``MAXI * NTHREADS`` of its (row block, output)
        items."""
        R = R or self.rows
        if R not in self._progs:
            stage = self._ring_stage(self.layout(R, "global")[0]["ring"])
            lists = []
            for ops in self.ring_ops(R):
                tiles = []
                for op in ops:
                    tiles += self._op_tiles(op, stage)
                lists.append(tiles)
            self._progs[R] = (sum(lists[0] + lists[1], []), len(lists[0]),
                              len(lists[1]), stage)
        return self._progs[R]

    @staticmethod
    def _op_tiles(op, stage):
        dx, key, wo, wi, rows, bias = op
        n_o, n_s = (wi, wo) if dx else (wo, wi)
        T = min(n_s, stage // n_o if dx else (stage - n_o) // n_o)
        if not dx and 4 <= T < n_s:
            T -= T % 4
        tiles = []
        for s0 in range(0, n_s, T):
            ns = min(T, n_s - s0)
            last = int(s0 + ns == n_s)
            if dx:
                tiles.append([key + s0 * wi, ns, wi, wi, last | 2, -1, key,
                              0])
            else:
                tiles.append([key + s0, wo, wi, ns, last,
                              bias if last else -1, key, 0])
        if len(tiles) > 1:
            items = -(-rows // RB) * n_o
            tiles *= -(-items // (MAXI * NTHREADS))
        return tiles

    @property
    def smem_bytes(self) -> int:
        """Shared memory of one CTA in this spec's plan (the resident
        plan's at 16 rows when none fits)."""
        if self.plan is None:
            return 4 * self.layout()[1]
        return 4 * self.layout(self.rows, self.plan)[1]

    def table_head(self):
        """The layer table's first ``tab_ptrs`` ints, those the config
        alone decides: a record (``_LayerRec``) a Linear, then the leaves'
        offsets in the flat parameters, then K1's role walk's head and
        program (none without the role walk), then a zero where the
        addresses need an even start."""
        if self._head is None:
            out, leaf = [], 0
            for net, ws, acts in (("ode", self.ode_w, self.ode_a),
                                  ("enc", self.enc_w, self.enc_a),
                                  ("ro", self.ro_w, self.ro_a)):
                for l in range(len(ws) - 1):
                    relu = int(l < len(acts) and acts[l] == "relu")
                    w_off, pw_off = self.leaf_off[leaf], self.pack_off[leaf]
                    leaf += 1
                    b_off = -1
                    if self.bias:
                        b_off, leaf = self.leaf_off[leaf], leaf + 1
                    dlt = self.ws_off.get(("d", net, l, 0), -1)
                    out += [ws[l], ws[l + 1], relu, w_off, b_off, pw_off,
                            sum(ws[1:l + 1]), dlt]
            out += self.leaf_off
            if self.roles is not None:
                out += self.role_head() + self.role_program()
            out += [0] * (self.tab_ptrs - len(out))
            self._head = torch.tensor(out, dtype=torch.int32)
        return self._head


    # -- K2's staged workspace ------------------------------------------------

    def _nets(self):
        """The nets K2 walks, with their widths and stacked halves: the
        ODE net, the encoder (not with the GRU jump: it runs at t = 0
        only), the readout (two halves: the pre-jump pass, y_bj, and the
        post-jump one, y; stacked or, masked, one after the other)."""
        out = [("ode", self.ode_w, (0,))]
        if not self.use_rnn:
            out.append(("enc", self.enc_w, (0,)))
        return out + [("ro", self.ro_w, (0, 1))]

    def _build_ws(self):
        """K2's workspace record of one (step, row): its fields in order,
        ``(name, width, kind)``, at ``ws_off[name]``, ``rec`` floats in
        all (a multiple of 4). kind 'x': a forward value that stage (c)
        reads, a Linear's input (the nets' inputs, the hidden layers'
        post-dropout activations); 'f': a forward value only the resident
        chain reads (h1, h2, the readouts' outputs before their residuals
        ``ro``, the loss's error terms ``le``, the pre-activations, the
        GRU's saved gates, the mask words ``mw``); 'd': a delta the chain
        writes, the gradient of a Linear's output (``("d", net, l,
        half)``) or of the GRU's gate sums (``dgi`` of W_ih x + b_ih,
        ``dgh`` of W_hh h_t + b_hh). Stage (a) writes the 'x' and 'f'
        fields (the resident plan); the global plan's chain, which re-runs
        its steps itself, the 'x' fields. The forward fields come first,
        each kernel region's fields together in its order (the stacked
        readout's layer: both halves' pre-activations, then their
        activations; the masked branch's two readout passes one after the
        other), so the resident chain's io set holds them as the record
        does, a field's R rows where the record has one (``layout``)."""
        H, D, O = self.H, self.D, self.O
        self.tX_w = D if self.use_rnn or not self.masked else 2 * D
        f = [(("in_ode",), self.ode_w[0], "x"), (("tX",), self.tX_w, "x")]
        f += [(("in_ro", h), H, "x") for h in (0, 1)]
        f += [(("h1",), H, "f"), (("h2",), H, "f")]
        f += [((n, h), O, "f") for n in ("ro", "le") for h in (0, 1)]
        for net, ws, halves in self._nets():
            hidden = range(len(ws) - 2)
            if len(halves) == 1 or (self.masked and not self.use_rnn):
                order = [(l, h, k) for h in halves for l in hidden
                         for k in ("pre", "act")]
            else:                                   # the stacked readout
                order = [(l, h, k) for l in hidden for k in ("pre", "act")
                         for h in halves]
            f += [((k, net, l, h), ws[l + 1], "f" if k == "pre" else "x")
                  for l, h, k in order]
        if self.use_rnn:
            f += [(("gru", q), H, "f") for q in range(4)]
        if self.mask_words(1):
            f.append((("mw",), self.S * self.nw, "f"))
        for net, ws, halves in self._nets():
            for l in range(len(ws) - 1):
                f += [(("d", net, l, h), ws[l + 1], "d") for h in halves]
        if self.use_rnn:
            f += [(("dgi",), 3 * H, "d"), (("dgh",), 3 * H, "d")]
        self.ws_fields = f
        self.ws_off, n = {}, 0
        for name, w, _ in f:
            self.ws_off[name] = n
            n += w
        self.n_fwd = sum(w for _, w, k in f if k != "d")
        self.rec = -(-n // 4) * 4

    def _field_at(self, name, off, R):
        """(offset, floats between rows) of a forward field in the shared
        memory of a layout ``off`` at R rows."""
        H, O, k = self.H, self.O, name[0]
        if k == "in_ode":
            return off["in_ode"], self.ode_w[0]
        if k == "tX":
            return off["tX"], self.tX_w
        if k in ("h1", "h2"):
            return off[k], H
        if k in ("in_ro", "gru"):
            return off[k] + name[1] * R * H, H
        if k in ("ro", "le"):
            return off[k] + name[1] * R * O, O
        if k == "mw":
            return off["mw"], self.S * self.nw
        _, net, l, h = name
        ws = {"ode": self.ode_w, "enc": self.enc_w, "ro": self.ro_w}[net]
        w, below = ws[l + 1], sum(ws[1:l + 1])
        if net == "ro" and self.masked and not self.use_rnn:
            base, rows, ho = off["s_ro2" if h else "s_ro"], R, 0
        elif net == "ro":
            base, rows, ho = off["s_ro"], 2 * R, h * R * w
        else:
            base, rows, ho = off["s_" + net], R, 0
        return base + 2 * rows * below + (rows * w if k == "act" else 0) \
            + ho, w

    def ws_fields_of(self, kind: str):
        """The names of the fields that stage (a) ('a'), the resident
        chain ('b') or the global plan's chain ('x') copies."""
        kinds = "x" if kind == "x" else "xf"
        return [n for n, _, k in self.ws_fields if k in kinds]

    def ws_program(self, kind: str, R: int, device=None):
        """The copy program of stage (a) ('a', the forward layout at R
        rows), of the resident chain ('b', its layout at R rows: io set
        0) or of the global plan's chain ('x'): 3 ints a float of the
        fields it copies, the float's index in the record, its offset in
        shared memory (row 0) and the floats between rows there
        (csrc/fused_scan.cu put_fields / get_fields); an int32 tensor [n,
        3] on ``device``, or the list."""
        key = ("ws", kind, R, str(device))
        if key not in self._progs:
            off = (self.layout(R, "global")[0] if kind == "x" else
                   self.layout(R, "resident", kind == "b")[0])
            widths = dict((n, w) for n, w, _ in self.ws_fields)
            prog = []
            for name in self.ws_fields_of(kind):
                so, ss = self._field_at(name, off, R)
                ro = self.ws_off[name]
                prog += [[ro + j, so + j, ss] for j in range(widths[name])]
            if device is None:
                return prog
            self._progs[key] = torch.tensor(prog, dtype=torch.int32,
                                            device=device).reshape(-1, 3)
        return self._progs[key]

    def wgrad_jobs(self):
        """Stage (c)'s terms in leaf order, ``(leaf, x field or None for a
        bias, delta field)``: the leaf's gradient is the sum of ``d^T x``
        (a bias: of d) over every (step, row) record. The readout's two
        halves are two jobs on one leaf; the encoder's leaves have none
        with the GRU jump (their gradient stays zero)."""
        jobs, leaf = [], 0
        inputs = {"ode": ("in_ode",), "enc": ("tX",)}
        walked = {net for net, _, _ in self._nets()}
        for net, ws in (("ode", self.ode_w), ("enc", self.enc_w),
                        ("ro", self.ro_w)):
            halves = (0, 1) if net == "ro" else (0,)
            for l in range(len(ws) - 1):
                for with_x in ((True, False) if self.bias else (True,)):
                    for h in halves if net in walked else ():
                        x = (inputs.get(net, ("in_ro", h)) if l == 0
                             else ("act", net, l - 1, h))
                        jobs.append((leaf, x if with_x else None,
                                     ("d", net, l, h)))
                    leaf += 1
        if self.use_rnn:
            g = self.gru_leaf0
            jobs += [(g, ("tX",), ("dgi",)), (g + 1, ("in_ro", 0), ("dgh",))]
            if self.bias:
                jobs += [(g + 2, None, ("dgi",)), (g + 3, None, ("dgh",))]
        return jobs

    def wgrad_program(self, device):
        """Stage (c)'s program on ``device``: int32 tiles [n, 8] (the
        weight leaf's offset, its columns ``in`` and rows ``out``, the
        tile's first row j0 and column i0 of the leaf, its first job and
        job count, its bias leaf's offset or -1; a tile a [WG_TILE,
        WG_TILE] block of a weight and its bias, the bias the weight's
        column ``in`` with x a column of ones, so a bias has no tile of
        its own) and jobs [n, 2] (the record offsets of x and of d: the
        weight's jobs; its bias's are the same deltas)."""
        key = ("wgrad", str(device))
        if key not in self._progs:
            jobs = [j for j in self.wgrad_jobs() if j[1] is not None]
            tiles = []
            for leaf, shape in enumerate(self.leaf_shapes):
                if len(shape) == 1:             # a bias: its weight's tile
                    continue
                out, inp = shape
                boff = (self.leaf_off[self.bias_of[leaf]]
                        if leaf in self.bias_of else -1)
                mine = [i for i, j in enumerate(jobs) if j[0] == leaf]
                for j0 in range(0, out, WG_TILE):
                    for i0 in range(0, inp + (boff >= 0), WG_TILE):
                        tiles.append((self.leaf_off[leaf], inp, out, j0, i0,
                                      mine[0] if mine else 0, len(mine),
                                      boff))
            j = [(self.ws_off[x], self.ws_off[d]) for _, x, d in jobs] \
                or [(0, 0)]
            self._progs[key] = (
                torch.tensor(tiles, dtype=torch.int32, device=device),
                torch.tensor(j, dtype=torch.int32, device=device))
        return self._progs[key]

    def wgrad_steps(self, B: int) -> int:
        """Stage (c)'s stretch: the steps whose (step, row) records one of
        its partial rows sums, ceil(WG_ROWS / B). It depends on B alone,
        so the sums' order depends neither on the rows per CTA, nor on the
        plan, nor on the chunk, nor on a member axis."""
        return max(1, -(-WG_ROWS // B))

    def bwd_chunk(self, K: int, B: int, E: int = 1, chunk=None,
                  stretch=None) -> int:
        """Steps per chunk of K2 (a multiple of the stretch, at most the
        stretches that cover K): ``chunk`` rounded up to one, or as many as
        keep the workspace of E members within ``WS_BUDGET``, at least a
        stretch."""
        Ks = stretch or self.wgrad_steps(B)
        if chunk:
            Kc = -(-chunk // Ks) * Ks
        else:
            Kc = max(Ks, WS_BUDGET // (4 * E * B * self.rec) // Ks * Ks)
        return min(Kc, -(-K // Ks) * Ks)

    def chain_threads(self, R: int, n_cta: int) -> int:
        """Threads of a CTA of K2's chain launch of ``n_cta`` CTAs at R
        rows: 128 in the resident plan at one row where the launch
        overflows ``CTAS_PER_SM`` CTAs an SM and the shared memory holds
        more (a member launch: the kernel's registers hold four of 128
        threads an SM; one row's phases hold few items), else
        ``NTHREADS``. The arithmetic does not depend on it."""
        if self.plan == "resident" and R == 1 and \
                n_cta > CTAS_PER_SM * N_SM:
            n = 4 * self.layout(1, "resident")[1] + CTA_RESERVED
            if SM_SMEM // n > CTAS_PER_SM:
                return 128
        return NTHREADS

    def remat_rows(self) -> int:
        """Rows a CTA of K2's stage (a) re-runs at once: the most of 16,
        8, 4, 2, 1 at which the forward layout fits (its (step, row) pairs
        are independent, so the bits do not depend on it)."""
        for R in ROW_CHOICES:
            if 4 * self.layout(R, "resident", False)[1] <= SMEM_LIMIT:
                return R
        return 1

    # -- K1's role walk -------------------------------------------------------

    def _role_groups(self):
        """K1/K3's step at one row a CTA as the role walk runs it
        (csrc/fused_scan.cu ``role_scan_fwd``), or None where the item
        loop keeps it: ``(V, phases)``, each phase a list of groups
        ``(kind, when, net, l, rs)`` (``rs``: the copy of the readout state
        its addresses take, ``RM_*``; a fill group's ``l`` its lanes).

        Unmasked (the encoder or the GRU jump) no carry reads the readout
        (last_X takes the observation), so the stacked readout of step k
        runs in step k + 1's phases beside the ODE net and the jump
        (``when`` 'prev', on the other copy of the readout state), and the
        loss terms of step k are summed into the row's loss in step k +
        2's last phase (the kernel's ``RLAG``): the phases are the ODE
        net's and the encoder's hidden layers side by side (aligned at
        their ends), then their last layers with the Euler step, the jump
        and the carries; with the GRU jump the ODE net's hidden layers,
        its last layer with the Euler step, then the GRU with the
        carries. Each group starts
        at a warp boundary of the phase's ``V`` virtual threads (256 or
        512); the mask words of the next step fill the lanes of the phase
        with the most left. Masked configs keep the item loop: their
        post-jump prediction is the next last_X, so the readouts stay on
        the recurrence, and the role walk of their 12 phases ran 5 % slower
        on the H100 than the item loop's 13 (PERF.md §6)."""
        if self.O != self.D or self.plan is None or self.masked:
            return None
        Lo, Le, Lr = (len(ws) - 1 for ws in
                      (self.ode_w, self.enc_w, self.ro_w))
        if self.use_rnn:
            ph = [[("hid", "rec", "ode", l, RM_NONE)] for l in range(Lo - 1)]
            ph += [[("eu", "rec", "ode", Lo - 1, RM_CUR)],
                   [("gru", "rec", None, 0, RM_CUR)]]
        else:
            hm = max(Lo, Le) - 1
            ph = [[] for _ in range(hm + 1)]
            for net, L in (("ode", Lo), ("enc", Le)):
                for l in range(L - 1):
                    ph[hm - L + 1 + l].append(("hid", "rec", net, l, RM_NONE))
            ph[hm].append(("ej", "rec", None, 0, RM_CUR))
        if len(ph) < 2 or Lr > len(ph):
            return None
        for l in range(Lr - 1):
            ph[l].append(("hid", "prev", "ros", l, RM_PREV))
        ph[Lr - 1].append(("rol", "prev", "ros", Lr - 1, RM_PREV))
        ph[-1] += [("car", "rec", None, 0, RM_CUR),
                   ("acc", "acc", None, 0, RM_CUR)]
        lanes = [sum(-(-self._role_items(g) // 32) * 32 for g in p)
                 for p in ph]
        if (len(ph) > RPH_MAX or max(lanes) > RV_MAX
                or max(len(p) for p in ph) >= RG_MAX):
            return None
        V = 256 if max(lanes) <= 256 else RV_MAX
        if self.rate > 0.0 and self.S > 0:
            i = max(range(len(ph)), key=lambda i: (V - lanes[i], i))
            if V - lanes[i] < 32:
                return None
            ph[i].append(("fill", "rec", None, V - lanes[i], RM_NONE))
        return V, ph

    def _role_items(self, g):
        """The virtual threads a role group takes (one row a CTA)."""
        kind, _, net, l, _ = g
        if kind == "hid":
            ws = {"ode": self.ode_w, "enc": self.enc_w, "ros": self.ro_w}
            return (2 if net == "ros" else 1) * ws[net][l + 1]
        return {"ej": self.H, "eu": self.H, "gru": self.H, "rol": self.O,
                "car": 1 + 2 * self.D, "acc": 1, "fill": l}[kind]

    @property
    def role_rg(self) -> int:
        """Groups of a phase's table in the role program: the most of any
        phase's."""
        return max(len(p) for p in self.roles[1])

    def _rp_ints(self) -> int:
        """Ints of the role program: a group table and a role word (16
        bits) a virtual thread, per phase."""
        if self.roles is None:
            return 0
        V, ph = self.roles
        return len(ph) * (self.role_rg * RGI + V // 2)

    def _roles_fit(self) -> bool:
        """Whether K1's role layout at one row fits one CTA and keeps as
        many CTAs an SM as the item loop's."""
        if self.plan != "resident" or not self.fits("resident", 1):
            return False
        n = 4 * self.layout(1, "resident", False, True)[1]
        return n <= SMEM_LIMIT and min(
            CTAS_PER_SM, SM_SMEM // (n + CTA_RESERVED)) >= \
            self.ctas_per_sm(1, False)

    def _lin_at(self, net: str, l: int):
        """(weight offset, bias offset or -1, relu) of Linear l of a net
        in the flat parameters (the stacked readout: the readout's)."""
        net = "ro" if net == "ros" else net
        leaf = 0
        for name, ws, acts in (("ode", self.ode_w, self.ode_a),
                               ("enc", self.enc_w, self.enc_a),
                               ("ro", self.ro_w, self.ro_a)):
            for k in range(len(ws) - 1):
                if (name, k) == (net, l):
                    b = self.leaf_off[leaf + 1] if self.bias else -1
                    return (self.leaf_off[leaf], b,
                            int(k < len(acts) and acts[k] == "relu"))
                leaf += 2 if self.bias else 1
        raise KeyError((net, l))

    def role_head(self):
        """The role walk's head in the layer table (csrc/fused_scan.cu
        ``RoleCfg``, ``RHEAD`` ints before its program): phases of a step,
        virtual threads of a phase, groups of a phase's table, the floats
        between the readout state's two copies, and the offsets of the
        readout's X and obs, of the obs its loss term takes and of the
        program's copy (region ``rp``) in the one-row role layout."""
        V, ph = self.roles
        off = self.layout(1, "resident", False, True)[0]
        return [len(ph), V, self.role_rg, off["rs2"] - off["h1"], off["rX"],
                off["robs"], off["lo"], off["rp"]]

    def role_program(self):
        """K1's role program (csrc/fused_scan.cu ``role_scan_fwd``), the
        ints it copies into region ``rp``: for each phase ``role_rg``
        groups of ``RGI`` ints (kind, when | x's copy << 2 | the outputs'
        << 4 | B's x's << 6, then Linear A's input, weight, bias (-1: none),
        widths in and out, saved pre-activation and activation, relu,
        dropout slot and the stacked rows' slot jump, then Linear B's
        input, weight, bias and width in; fill: its lanes at 5), then a
        role word a virtual thread, two an int: its group + 1 (0: none),
        its stacked row << 3 and its output (or item) << 4, every address
        resolved on the host, so the walk neither divides nor reads a
        layer record."""
        V, ph = self.roles
        RG = self.role_rg
        off = self.layout(1, "resident", False, True)[0]
        ws_of = {"ode": self.ode_w, "enc": self.enc_w, "ros": self.ro_w}
        base = {"ode": "s_ode", "enc": "s_enc", "ros": "s_ro"}
        slot0 = {"ode": self.s_ode, "enc": self.s_enc, "ros": self.s_r1}

        def lin(net, l, rs):
            """(x, x's copy, w, b, in, out, pre, act, relu, the outputs'
            copy) of Linear l."""
            ws = ws_of[net]
            rows = 2 if net == "ros" else 1
            sm_mode = rs if net == "ros" else RM_NONE
            if l == 0:
                x, xm = {"ode": (off["in_ode"], RM_IO),
                         "enc": (off["tX"], RM_IO),
                         "ros": (off["in_ro"], rs)}[net]
            else:
                x = (off[base[net]] + 2 * rows * sum(ws[1:l])
                     + rows * ws[l])
                xm = sm_mode
            w, b, relu = self._lin_at(net, l)
            pre = off[base[net]] + 2 * rows * sum(ws[1:l + 1])
            return (x, xm, off["w"] + w, off["w"] + b if b >= 0 else -1,
                    ws[l], ws[l + 1], pre, pre + rows * ws[l + 1], relu,
                    sm_mode)

        groups, roles = [], []
        for p in ph:
            gt = [0] * (RG * RGI)
            rw = [0] * V
            first = 0
            for gi, g in enumerate(p):
                kind, when, net, l, rs = g
                q = gt[gi * RGI:(gi + 1) * RGI]
                q[0] = RK[kind]
                xm = om = bxm = rs
                if kind == "hid":
                    x, xm, w, b, i, o, pre, act, relu, om = lin(net, l, rs)
                    q[2:12] = [x, w, b, i, o, pre, act, relu,
                               slot0[net] + l,
                               len(ws_of[net]) - 2 if net == "ros" else 0]
                elif kind in ("ej", "eu", "rol"):
                    if kind == "ej":
                        a = lin("ode", len(self.ode_w) - 2, rs)
                        bb = lin("enc", len(self.enc_w) - 2, rs)
                        q[12:16] = [bb[0], bb[2], bb[3], bb[4]]
                        bxm = bb[1]
                    else:
                        a = lin(net, l, rs)
                    q[2:7] = [a[0], a[2], a[3], a[4], a[5]]
                    xm = a[1]
                elif kind == "fill":
                    q[5] = l
                q[1] = RW[when] | xm << 2 | om << 4 | bxm << 6
                gt[gi * RGI:(gi + 1) * RGI] = q
                n = self._role_items(g)
                out = self.ro_w[l + 1] if (kind, net) == ("hid", "ros") \
                    else 0
                for i in range(n):
                    r, j = (i // out, i % out) if out else (0, i)
                    if j >= 1 << 12:
                        raise ValueError("role output index overflows")
                    rw[first + i] = (gi + 1) | r << 3 | j << 4
                first += -(-n // 32) * 32
            groups += gt
            roles += [rw[v] | rw[v + 1] << 16 for v in range(0, V, 2)]
        # the role words as int32 (two 16-bit words an int)
        roles = [w - (1 << 32) if w >= 1 << 31 else w for w in roles]
        prog = groups + roles
        assert len(prog) == self.rp_ints
        return prog

    def k1_phases(self, R: int):
        """(walk, phases) of a K1/K3 step of the resident plan at R rows
        a CTA: the role walk's phases ('roles', one row a CTA where the
        spec has a role program) or the item loop's ('items': the hidden
        layers, the last layers fused with what reads them, the carries;
        ``res_scan_fwd``); None in the global plan."""
        if self.plan != "resident":
            return None
        if R == 1 and self.roles is not None:
            return "roles", len(self.roles[1])
        Lo, Le, Lr = (len(ws) - 1 for ws in
                      (self.ode_w, self.enc_w, self.ro_w))
        if self.masked and not self.use_rnn:
            return "items", Lo + Le + 2 * Lr + 1
        if self.use_rnn:
            return "items", Lo + Lr + 2
        return "items", max(Lo, Le) + Lr + 1

    def fwd_threads(self, R: int, n_cta: int) -> int:
        """Threads of a CTA of a K1/K3 launch of ``n_cta`` CTAs at R rows:
        128 in the role walk where the launch overflows ``CTAS_PER_SM``
        CTAs an SM and the shared memory holds four (a member launch; the
        kernel's registers hold four CTAs of 128 threads an SM), else
        ``NTHREADS``. The walk's virtual threads, and so its arithmetic,
        do not depend on it."""
        if self.roles is None or self.plan != "resident" or R != 1:
            return NTHREADS
        if self._threads:
            if self._threads not in (128, NTHREADS):
                raise ValueError(f"threads {self._threads!r}: 128 or "
                                 f"{NTHREADS}")
            return self._threads
        if n_cta > CTAS_PER_SM * N_SM:
            n = 4 * self.layout(1, "resident", False, True)[1]
            if SM_SMEM // (n + CTA_RESERVED) >= 2 * CTAS_PER_SM:
                return 128
        return NTHREADS


def supported(cfg) -> bool:
    """Whether the CUDA kernels cover the given NJODEConfig (the shared
    memory of one CTA is counted on the layout of its own branch and of
    the plan that ``Spec`` chooses)."""
    D, O = cfg.input_size, cfg.output_size
    if not (cfg.solver == "euler"
            and cfg.which_loss in ("standard", "easy")
            and cfg.ode_nn is not None and cfg.readout_nn is not None
            and cfg.enc_nn is not None
            # masked: O == D (the JAX rule); unmasked, the loss broadcasts
            # X [B, D] against y [B, O], so one of them is 1 where they
            # differ (elsewhere the JAX forward and kernel fail to trace)
            and (O == D or (not cfg.masked and min(D, O) == 1))
            and getattr(cfg, "compute_dtype", "float32") == "float32"):
        return False
    nets = (cfg.ode_nn, cfg.enc_nn, cfg.readout_nn)
    if any(a not in ("tanh", "relu") for nn_desc in nets
           for _, a in nn_desc):
        return False
    return Spec(cfg).plan is not None


def flat_leaves(model):
    """The model's parameters in the kernels' leaf order (no copies)."""
    out = []
    for seq in (model.ode_f.f, model.encoder_map.ffnn,
                model.readout_map.ffnn):
        for lin in mlp.linears(seq):
            out.append(lin.weight)
            if lin.bias is not None:
                out.append(lin.bias)
    if model.cfg.use_rnn:
        gru = model.obs_c.gru_d
        out += [gru.weight_ih, gru.weight_hh]
        if gru.bias:
            out += [gru.bias_ih, gru.bias_hh]
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

def _mlp_plain(layers, acts, x, masks, rate, rec=None):
    """The MLP's output; ``rec`` (a list) gets each Linear's (input,
    output)."""
    w, b = layers[0]
    y = F.linear(x, w, b)
    if rec is not None:
        rec.append((x, y))
    keep = 1.0 - rate
    for i, name in enumerate(acts):
        y = mlp.act_fn(name, y)
        if masks is not None:
            y = torch.where(masks[i][:, :y.shape[-1]], y / keep,
                            torch.zeros_like(y))
        w, b = layers[i + 1]
        a = y
        y = F.linear(y, w, b)
        if rec is not None:
            rec.append((a, y))
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


def _gru_plain(gru, x, h, rec=None):
    """torch's GRUCell (gate order r, z, n) from its four leaves; ``rec``
    (a dict) gets the gate sums gi, gh and the saved gates r, z, n, gh_n."""
    w_ih, w_hh, b_ih, b_hh = gru
    gi = F.linear(x, w_ih, b_ih)
    gh = F.linear(h, w_hh, b_hh)
    gi_r, gi_z, gi_n = gi.chunk(3, dim=-1)
    gh_r, gh_z, gh_n = gh.chunk(3, dim=-1)
    r = torch.sigmoid(gi_r + gh_r)
    z = torch.sigmoid(gi_z + gh_z)
    n = torch.tanh(gi_n + r * gh_n)
    if rec is not None:
        rec.update(gi=gi, gh=gh, gru=(r, z, n, gh_n))
    return (1.0 - z) * n + z * h


def _step_plain(spec, nets, h, last_X, tau, t, dt, obs, X, M, us, rec=None):
    """One step of the NJODE recursion (the stacked readouts after the
    encoder or GRU jump, or the masked imputation branch); returns (h2,
    last_X', tau', y, y_bj). ``rec`` (a dict) gets the step's values by
    K2's workspace names (``Spec.ws_fields``): the nets' inputs, h1, h2,
    each net's Linears' (input, output) under 'ode', 'enc' and 'ro' (the
    masked branch's readouts under 'ro' and 'ro2'), and the GRU's."""
    ws_ode, ws_enc, ws_ro, gru = nets
    rec = {} if rec is None else rec

    def sl(a, n):
        return None if us is None or n == 0 else us[a:a + n]

    def readout(hh, masks, key):
        rec[key] = []
        return mlp.residual_apply(spec.ro_case, spec.ro_mult, hh,
                                  _mlp_plain(ws_ro, spec.ro_a,
                                             torch.tanh(hh), masks,
                                             spec.rate, rec[key]))

    tdiff = (t - dt) - tau
    feats = [torch.tanh(last_X), torch.tanh(h), tau, tdiff]
    if spec.ict:
        feats.append(tau + tdiff)
    rec["ode"] = []
    f = _mlp_plain(ws_ode, spec.ode_a, torch.cat(feats, dim=-1),
                   sl(spec.s_ode, spec.n_ode), spec.rate, rec["ode"])
    h1 = h + dt * f
    obs_c = obs[:, None]
    u_enc = sl(spec.s_enc, spec.n_enc)
    rec["enc"] = []
    if spec.masked and not spec.use_rnn:
        # the pre-jump readout imputes the unobserved coordinates
        y_bj = readout(h1, sl(spec.s_r1, spec.n_ro), "ro")
        X_imp = X * M + (1.0 - M) * y_bj
        enc_o = _mlp_plain(ws_enc, spec.enc_a,
                           torch.cat([torch.tanh(X_imp), M], dim=-1),
                           u_enc, spec.rate, rec["enc"])
        h_enc = mlp.residual_apply(spec.enc_case, spec.enc_mult, X_imp,
                                   enc_o)
        h2 = obs_c * h_enc + (1.0 - obs_c) * h1
        y = readout(h2, sl(spec.s_r2, spec.n_ro), "ro2")
    else:
        if spec.use_rnn:
            # the GRU jump on the raw observation, masked or not
            h_enc = _gru_plain(gru, torch.tanh(X), torch.tanh(h1), rec)
        else:
            enc_o = _mlp_plain(ws_enc, spec.enc_a, torch.tanh(X), u_enc,
                               spec.rate, rec["enc"])
            h_enc = mlp.residual_apply(spec.enc_case, spec.enc_mult, X,
                                       enc_o)
        h2 = obs_c * h_enc + (1.0 - obs_c) * h1
        u_r = None
        if us is not None and spec.n_ro:
            u_r = [torch.cat([a, b], dim=0) for a, b in
                   zip(sl(spec.s_r1, spec.n_ro), sl(spec.s_r2, spec.n_ro))]
        y2 = readout(torch.cat([h1, h2], dim=0), u_r, "ro")
        B = h.shape[0]
        y_bj, y = y2[:B], y2[B:]
    rec.update(h1=h1, h2=h2, y=y, y_bj=y_bj)
    # a masked config records the post-jump prediction as last_X
    new_last = y if spec.masked else X
    last_X2 = torch.where(obs_c > 0, new_last, last_X)
    tau2 = torch.where(obs_c > 0, t.expand_as(tau), tau)
    return h2, last_X2, tau2, y, y_bj


def unpack_arrays(spec, arrays):
    """``(times, dts, obs, X, n_obs, start_X, M)`` from the batch arrays
    ``(times, dts, obs, X, n_obs, start_X[, M])``; ``M [K,B,D]`` is
    required by a masked spec and ignored (None) otherwise."""
    times, dts, obs, X, n_obs, start_X = arrays[:6]
    M = arrays[6] if len(arrays) > 6 else None
    if spec.masked and M is None:
        raise ValueError("a masked config needs the mask M [K,B,D]")
    return times, dts, obs, X, n_obs, start_X, (M if spec.masked else None)


def _step_loss_plain(spec, k, X, y, y_bj, obs, n_obs, B, weight, M):
    return step_loss("easy" if spec.easy else "standard", X=X[k], Y=y,
                     Y_bj=y_bj, obs=obs[k], n_obs_ot=n_obs, batch_size=B,
                     weight=weight, M=None if M is None else M[k])


def _seed_int(seed):
    return None if seed is None else int(seed.reshape(-1)[0])


def scan_fwd_plain(spec, leaves, arrays, weight, h0, train, u=None,
                   seed=None, want_hists=True):
    """Plain K1/K3: returns (loss, (h_hist [K,B,H], lastX_hist [K,B,D],
    tau_hist [K,B,1]) or None)."""
    times, dts, obs, X, n_obs, start_X, M = unpack_arrays(spec, arrays)
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
        h, lx2, tau, y, y_bj = _step_plain(
            spec, nets, h, lx, tau, times[k], dts[k], obs[k], X[k],
            None if M is None else M[k], us)
        loss = loss + _step_loss_plain(spec, k, X, y, y_bj, obs, n_obs, B,
                                       weight, M)
        lx = lx2
    return loss, (tuple(torch.stack(v) for v in hists) if want_hists
                  else None)


def scan_steps_plain(spec, leaves, arrays, weight, hists, train, u=None,
                     seed=None):
    """Plain K1 step by step: each step starts from the step-entry carry
    stored in ``hists`` (K1's histories) instead of the previous step's
    output. Returns (the loss, the carries each step gives: h [K,B,H],
    last_X [K,B,D], tau [K,B,1]; step k's against ``hists[k + 1]``).

    Where the dynamics amplify rounding (a residual encoder and readout
    over thousands of jumps), two free-running scans that sum in different
    orders part ways, the plain version among them; this checks each step
    of the kernel's own trajectory instead."""
    times, dts, obs, X, n_obs, start_X, M = unpack_arrays(spec, arrays)
    hh, lxh, tauh = hists
    K, B = obs.shape
    nets = spec.split(list(leaves))
    seed_i = _seed_int(seed)
    loss = torch.zeros((), dtype=torch.float32, device=hh.device)
    outs = ([], [], [])
    with torch.no_grad():
        for k in range(K):
            us = _step_masks_plain(spec, k, train, u, seed_i, B, hh.device)
            h, lx2, tau, y, y_bj = _step_plain(
                spec, nets, hh[k], lxh[k], tauh[k], times[k], dts[k], obs[k],
                X[k], None if M is None else M[k], us)
            loss = loss + _step_loss_plain(spec, k, X, y, y_bj, obs, n_obs,
                                           B, weight, M)
            for lst, v in zip(outs, (h, lx2, tau)):
                lst.append(v)
    return loss, tuple(torch.stack(v) for v in outs)


def scan_bwd_plain(spec, leaves, arrays, weight, train, hists, dloss,
                   u=None, seed=None):
    """Plain K2: the reverse walk over the stored carries, each step re-run
    under autograd. Returns (grads in leaf order, dh0)."""
    times, dts, obs, X, n_obs, start_X, M = unpack_arrays(spec, arrays)
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
            h2, lx2, tau2, y, y_bj = _step_plain(
                spec, nets, h, lx, tau, times[k], dts[k], obs[k], X[k],
                None if M is None else M[k], us)
            lk = _step_loss_plain(spec, k, X, y, y_bj, obs, n_obs, B, weight,
                                  M)
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


def ws_view(spec, ws, name):
    """Field ``name`` (``Spec.ws_fields``) of K2's workspace records ``ws
    [..., rec]``: a view ``[..., width]``."""
    o = spec.ws_off[name]
    w = dict((n, w) for n, w, _ in spec.ws_fields)[name]
    return ws[..., o:o + w]


def _half(t, h, B, stacked):
    return t[h * B:(h + 1) * B] if stacked else t


def _step_fields_plain(spec, rec, X, M, B):
    """A step's forward fields of K2's records (stage (a)'s, but the mask
    words), ``{name: [B, width]}``, from ``_step_plain``'s ``rec``."""
    out = {("in_ode",): rec["ode"][0][0],
           ("tX",): rec["enc"][0][0] if rec["enc"] else torch.tanh(X),
           ("h1",): rec["h1"], ("h2",): rec["h2"]}
    stacked = "ro2" not in rec          # else two readout passes
    ro = {0: rec["ro"], 1: rec.get("ro2", rec["ro"])}
    for h in (0, 1):
        out[("in_ro", h)] = _half(ro[h][0][0], h, B, stacked)
        out[("ro", h)] = _half(ro[h][-1][1], h, B, stacked)
    if spec.D == spec.O:
        m = M if spec.masked else torch.ones_like(X)
        x, y, yb = X, rec["y"], rec["y_bj"]
        out[("le", 0)] = m * (x - y) ** 2
        out[("le", 1)] = m * (yb - (x if spec.easy else y)) ** 2
    for net, ws, halves in spec._nets():
        for l in range(len(ws) - 2):
            for h in halves:
                r = ro[h] if net == "ro" else rec[net]
                cut = net == "ro" and stacked
                out[("pre", net, l, h)] = _half(r[l][1], h, B, cut)
                out[("act", net, l, h)] = _half(r[l + 1][0], h, B, cut)
    if spec.use_rnn:
        for q in range(4):
            out[("gru", q)] = rec["gru"][q]
    return out


def _step_deltas(spec, rec, B):
    """The tensors whose gradients are a step's deltas (``Spec.ws_fields``
    kind 'd'): [(name, tensor, (half, stacked))]."""
    stacked = "ro2" not in rec
    out = []
    for net, ws, halves in spec._nets():
        for l in range(len(ws) - 1):
            for h in halves:
                r = rec["ro2"] if net == "ro" and h and not stacked else \
                    rec[net]
                out.append((("d", net, l, h), r[l][1],
                            h if net == "ro" and stacked else None))
    if spec.use_rnn:
        out += [(("dgi",), rec["gi"], None), (("dgh",), rec["gh"], None)]
    return out


def scan_bwd_staged_plain(spec, leaves, arrays, weight, train, hists, dloss,
                          u=None, seed=None, chunk=None, stretch=None,
                          want_ws=False, timer=None):
    """Plain K2 as the kernels stage it: per chunk of steps
    (``Spec.bwd_chunk``), last chunk first, (a) every step's forward
    fields from the stored carries into the chunk's workspace records
    ``[Kc * B, rec]`` (``Spec.ws_fields``; the mask words stay zero), (b)
    the reverse chain, each step re-run under autograd from its stored
    carries for the carries' gradients and the gradient of every Linear's
    output (and of the GRU's gate sums), which it writes to the records,
    (c) per stretch of ``Spec.wgrad_steps`` steps, every leaf's gradient
    as ``d^T x`` (a bias: the sum of d) over the stretch's records, job by
    job, then the stretches summed in order. Returns (grads in leaf order,
    dh0), and with ``want_ws`` the workspace as the first chunk left
    it. ``timer(stage, fn)``, where given, runs each chunk's stage ``fn``
    ('remat', 'chain', 'wgrad'), so a caller can time the stages."""
    times, dts, obs, X, n_obs, start_X, M = unpack_arrays(spec, arrays)
    hh, lxh, tauh = hists
    K, B = obs.shape
    # the leaves require grad so that every Linear's output is in the graph
    nets = spec.split([p.detach().requires_grad_(True) for p in leaves])
    seed_i = _seed_int(seed)
    Ks = stretch or spec.wgrad_steps(B)
    Kc = spec.bwd_chunk(K, B, 1, chunk, Ks)
    jobs = spec.wgrad_jobs()
    parts = {}
    dh = torch.zeros_like(hh[0])
    dlx = torch.zeros_like(lxh[0])
    dtau = torch.zeros_like(tauh[0])
    ws = None
    run = timer or (lambda stage, fn: fn())

    def step(k, rec, carries=None):
        us = _step_masks_plain(spec, k, train, u, seed_i, B, hh.device)
        h, lx, tau = carries or (hh[k], lxh[k], tauh[k])
        out = _step_plain(spec, nets, h, lx, tau, times[k], dts[k], obs[k],
                          X[k], None if M is None else M[k], us, rec)
        return out + (_step_loss_plain(spec, k, X, out[3], out[4], obs,
                                       n_obs, B, weight, M),)

    for k0 in reversed(range(0, K, Kc)):
        k1 = min(K, k0 + Kc)
        ws = torch.zeros((Kc * B, spec.rec), dtype=hh.dtype,
                         device=hh.device)

        def put(name, k, t):
            ws_view(spec, ws[(k - k0) * B:(k - k0 + 1) * B], name)[:] = t

        @torch.no_grad()
        def remat():                                       # stage (a)
            for k in range(k0, k1):
                rec = {}
                step(k, rec)
                for name, t in _step_fields_plain(
                        spec, rec, X[k], None if M is None else M[k],
                        B).items():
                    put(name, k, t)

        def chain():                                       # stage (b)
            nonlocal dh, dlx, dtau
            for k in reversed(range(k0, k1)):
                with torch.enable_grad():
                    carries = tuple(t[k].detach().requires_grad_(True)
                                    for t in (hh, lxh, tauh))
                    rec = {}
                    h2, lx2, tau2, _, _, lk = step(k, rec, carries)
                    obj = (lk * dloss + (h2 * dh).sum() + (lx2 * dlx).sum()
                           + (tau2 * dtau).sum())
                    zs = _step_deltas(spec, rec, B)
                    g = torch.autograd.grad(obj, list(carries)
                                            + [t for _, t, _ in zs],
                                            allow_unused=True)
                dh, dlx, dtau = (torch.zeros_like(v) if gv is None else gv
                                 for v, gv in zip(carries, g[:3]))
                for (name, t, h), gz in zip(zs, g[3:]):
                    gz = torch.zeros_like(t) if gz is None else gz
                    put(name, k, gz if h is None else gz[h * B:(h + 1) * B])

        @torch.no_grad()
        def wgrad():                                       # stage (c)
            for s0 in range(k0, k1, Ks):
                r = ws[(s0 - k0) * B:(min(s0 + Ks, k1) - k0) * B]
                part = [torch.zeros_like(p) for p in leaves]
                for leaf, x, d in jobs:
                    dm = ws_view(spec, r, d)
                    part[leaf] = part[leaf] + (
                        dm.sum(0) if x is None
                        else dm.t() @ ws_view(spec, r, x))
                parts[s0 // Ks] = part

        run("remat", remat)
        run("chain", chain)
        run("wgrad", wgrad)
    grads = [torch.zeros_like(p) for p in leaves]
    for p in sorted(parts):
        grads = [a + b for a, b in zip(grads, parts[p])]
    out = (grads, dh.detach())
    return out + (ws,) if want_ws else out


def scan_bwd_members_staged_plain(spec, leaves, arrays, weight, train,
                                  hists, dloss, u=None, seed=None,
                                  chunk=None, stretch=None, want_ws=False):
    """Plain member K2 as the kernels stage it:
    ``scan_bwd_staged_plain`` of each member (cotangent ``dloss[e]``),
    stacked (with ``want_ws``, each member's workspace at its solo chunk
    length)."""
    outs = []
    dloss = dloss.reshape(-1)
    for e in range(hists[0].shape[0]):
        lv, arr, ue, se = _member_plain(spec, leaves, arrays, u, seed, e)
        outs.append(scan_bwd_staged_plain(
            spec, lv, arr, weight, train, tuple(h[e] for h in hists),
            dloss[e], ue, se, chunk, stretch, want_ws))
    grads = [torch.stack(v) for v in zip(*(o[0] for o in outs))]
    out = (grads, torch.stack([o[1] for o in outs]))
    return out + (torch.stack([o[2] for o in outs]),) if want_ws else out


def reduce_partials_plain(partials, scale=1.0):
    """``scale * (((0 + P[0]) + P[1]) + ...)``: the rows summed in
    ascending order, the order the kernel keeps (fp32 adds, so the kernel
    gives these bits)."""
    s = torch.zeros_like(partials[0])
    for q in range(partials.shape[0]):
        s = s + partials[q]
    return s * scale


# ---------------------------------------------------------------------------
# CUDA wrappers
# ---------------------------------------------------------------------------

class _LayerRec(ctypes.Structure):
    """Field-for-field mirror of ``struct LayerRec`` (a record of the
    layer table, ``Spec.table_head``)."""
    _fields_ = [(n, ctypes.c_int) for n in (
        "w_in", "w_out", "act", "w_off", "b_off", "pw_off", "save", "dlt")]


class _MLPDesc(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int) for n in (
        "n_lin", "w_in", "lay", "slot0", "save_off", "dhalf")]


_LAYOUT_FIELDS = ("w", "h", "lx", "tau", "X", "obs", "nobs", "lrow",
                  "h1", "h2", "in_ode", "tX", "in_ro", "f", "enc", "ro",
                  "dA", "dB", "dh", "dlx", "dtau", "rs", "dst", "dh1", "dhe",
                  "df", "dlxc", "dtauc", "M", "Xi", "gru", "dG", "gsc",
                  "ring", "tdt", "le", "mw", "lay")


class _ScanCfg(ctypes.Structure):
    """Field-for-field mirror of ``struct ScanCfg`` in csrc/fused_scan.cu."""
    _fields_ = ([(n, ctypes.c_int) for n in (
        "K", "B", "D", "H", "O", "S", "Wmax", "n_params", "n_leaves",
        "enc_case", "enc_mult", "ro_case", "ro_mult", "easy", "ict",
        "mode", "masked", "use_rnn")]
        + [("thresh", ctypes.c_uint32), ("keep", ctypes.c_float),
           ("weight", ctypes.c_float)]
        + [(n, ctypes.c_int) for n in ("rows", "plan", "buf_w",
                                       "smem_floats", "gru_wih", "gru_whh",
                                       "gru_bih", "gru_bhh", "gru_pwih",
                                       "gru_pwhh", "n_tiles_fwd",
                                       "n_tiles_bwd", "stage", "io_stride",
                                       "wg_stride", "n_rec", "tab_leaves",
                                       "tab_ptrs", "rec", "dlt_gru")]
        + [("o_" + n, ctypes.c_int) for n in _LAYOUT_FIELDS]
        + [(n, ctypes.c_int) for n in ("nw", "lg_nw", "skip0", "skip1")]
        + [("ode", _MLPDesc), ("enc", _MLPDesc), ("ro", _MLPDesc),
           ("ro2", _MLPDesc)])


class _FwdCfg(_ScanCfg):
    """Mirror of ``struct FwdCfg``: K1/K3's call, ``ScanCfg`` (the fields
    it inherits, which alone the kernels take) then what only the host
    reads: the threads of a CTA and whether the launch takes the role
    walk."""
    _fields_ = [("threads", ctypes.c_int), ("roles", ctypes.c_int)]


class _K2Work(ctypes.Structure):
    """Field-for-field mirror of ``struct K2Work`` in csrc/fused_scan.cu:
    K2's staged plan beyond its config (stage (a)'s config, the
    workspace, the carries between chunks, the field programs, stage
    (c)'s tiles and jobs, the chunk and stretch lengths)."""
    _fields_ = ([("a", _ScanCfg)]
                + [(n, ctypes.c_void_p) for n in (
                    "ws", "carry", "fa", "fb", "tiles", "jobs")]
                + [(n, ctypes.c_int) for n in (
                    "n_fa", "n_fb", "n_tiles", "Kc", "Ks", "threads")])


def param_bytes() -> int:
    """Bytes of the larger parameter block of K1 and K2's chain:
    ``ScanCfg`` by value, then K1's layer table's address and 16 other
    pointers (``KERNEL_PTRS``), K2's chain's 19 pointers and 5 ints
    (``CHAIN_PTRS``, ``CHAIN_INTS``; n_fld padded to 8 bytes before the
    pointers after it)."""
    cfg = -(-ctypes.sizeof(_ScanCfg) // 8) * 8
    return cfg + max(8 * KERNEL_PTRS,
                     8 * CHAIN_PTRS + 8 + 4 * (CHAIN_INTS - 1))


def make_cfg(spec: Spec, K: int, B: int, train: bool, weight: float,
             bwd: bool = True, rows=None, E: int = 1):
    """The configuration of one call of K2's chain (``bwd``) or K1/K3
    (host memory), in the spec's plan at ``spec.rows_for(B, bwd)`` rows
    (``rows``: K2's stage (a), the forward layout at those rows); the
    global plan has no ``w`` region, the resident plan no ``ring``/``gsc``
    regions and no tiles (and K1/K3's no backward regions), and a config
    without use_rnn no ``gru``/``dG`` regions and no GRU leaves (their
    offsets are -1). K1/K3's call is a ``_FwdCfg``: at one row a CTA it
    takes the role walk where the spec has one (``Spec.roles``; its
    layout, and its program in the layer table), a launch of E members
    ``Spec.fwd_threads`` threads a CTA. Kept on the spec per call shape,
    so a step builds it once."""
    key = (K, B, bool(train), float(weight), bool(bwd), rows, E)
    if key not in spec._cfgs:
        spec._cfgs[key] = _make_cfg(spec, K, B, train, weight, bwd, rows, E)
    return spec._cfgs[key]


def _make_cfg(spec, K, B, train, weight, bwd, rows=None, E=1):
    R = rows or spec.rows_for(B, bwd)
    roles = (not bwd and rows is None and R == 1
             and spec.plan == "resident" and spec.roles is not None)
    off, total = spec.layout(R, spec.plan, bwd, roles)
    # K1/K3's call (FwdCfg); K2's chain and its stage (a) take ScanCfg
    c = _FwdCfg() if not bwd and rows is None else _ScanCfg()
    c.K, c.B, c.D, c.H, c.O = K, B, spec.D, spec.H, spec.O
    c.S, c.Wmax, c.n_params = spec.S, spec.w_max, spec.n_params
    c.n_leaves = len(spec.leaf_shapes)
    c.enc_case, c.enc_mult = spec.enc_case, spec.enc_mult
    c.ro_case, c.ro_mult = spec.ro_case, spec.ro_mult
    c.easy, c.ict = int(spec.easy), int(spec.ict)
    dropping = train and spec.rate > 0.0 and spec.S > 0
    c.mode = 0 if not dropping else (1 if spec.mask_mode == "input" else 2)
    c.masked = int(spec.masked)
    c.use_rnn = int(spec.use_rnn)
    gru_offs, gru_pack = [-1] * 4, [-1] * 4
    for i in range(len(spec.leaf_shapes) - spec.gru_leaf0):
        gru_offs[i] = spec.leaf_off[spec.gru_leaf0 + i]
        gru_pack[i] = spec.pack_off[spec.gru_leaf0 + i]
    c.gru_wih, c.gru_whh, c.gru_bih, c.gru_bhh = gru_offs
    c.gru_pwih, c.gru_pwhh = gru_pack[:2]
    if spec.plan == "global":
        _, c.n_tiles_fwd, c.n_tiles_bwd, c.stage = spec.tile_program(R)
    c.thresh = spec.thresh
    c.keep = 1.0 - spec.rate
    c.weight = float(weight)
    c.rows, c.plan = R, PLANS.index(spec.plan)
    c.io_stride = off["io2"] - off["io"] if "io" in off else 0
    c.wg_stride = spec.pack_off[-1]
    c.buf_w, c.smem_floats = spec.buf_w, total
    c.n_rec, c.tab_leaves, c.tab_ptrs = (spec.n_rec, spec.tab_leaves,
                                         spec.tab_ptrs)
    c.rec = spec.rec
    c.dlt_gru = spec.ws_off.get(("dgi",), -1)
    for n in _LAYOUT_FIELDS:
        setattr(c, "o_" + n, off.get(n, -1))
    c.nw, c.lg_nw = spec.nw, (spec.nw - 1).bit_length()
    # the encoder's slots draw nothing with the GRU jump (it runs at t=0
    # only, outside the kernels)
    c.skip0 = c.skip1 = spec.s_enc
    if spec.use_rnn:
        c.skip1 = spec.s_enc + spec.n_enc
    for desc, net, ws, slot0, save in (
            (c.ode, "ode", spec.ode_w, spec.s_ode, "s_ode"),
            (c.enc, "enc", spec.enc_w, spec.s_enc, "s_enc"),
            (c.ro, "ro", spec.ro_w, spec.s_r1, "s_ro")):
        desc.n_lin, desc.w_in = len(ws) - 1, ws[0]
        desc.lay = spec.lay0[net]
        desc.slot0 = slot0
        desc.save_off = off[save]
    # the masked branch's post-jump readout: the same weights and layer
    # records, its own dropout slots and saved activations
    c.ro2 = c.ro
    c.ro2.slot0 = spec.s_r2
    c.ro2.save_off = off["s_ro2"]
    c.ro2.dhalf = 1
    if isinstance(c, _FwdCfg):
        c.roles = int(roles)
        c.threads = spec.fwd_threads(R, E * -(-B // R))
    return c


def _is_cuda(t) -> bool:
    """Which route a tensor (or a device: the trainers' choice) takes: True
    for CUDA (kernel), False for the CPU (plain version); any other device
    raises."""
    dev = t if isinstance(t, torch.device) else t.device
    if dev.type == "cuda":
        return True
    if dev.type == "cpu":
        return False
    raise RuntimeError(f"fused scan kernels: unsupported device {dev}")


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


def packed_weights(spec, leaves):
    """The leaves packed into one flat buffer, leaf i at ``pack_off[i]``
    (a 16-byte boundary; zeros between), the weights the global plan's
    ring copies from; None in the resident plan (its kernels copy each
    leaf into shared memory)."""
    if spec.plan != "global":
        return None
    parts = []
    for p, a, b in zip(leaves, spec.pack_off[:-1], spec.pack_off[1:]):
        parts.append(p.reshape(-1))
        if b - a > p.numel():
            parts.append(p.new_zeros(b - a - p.numel()))
    return torch.cat(parts)


def packed_weights_members(spec, leaves):
    """``packed_weights`` of E members at once: the leaves stacked
    ``[E, ...]`` packed into ``[E, pack_off[-1]]`` (member e's row its
    packed buffer); None in the resident plan."""
    if spec.plan != "global":
        return None
    E = leaves[0].shape[0]
    parts = []
    for p, a, b in zip(leaves, spec.pack_off[:-1], spec.pack_off[1:]):
        p = p.reshape(E, -1)
        parts.append(p)
        if b - a > p.shape[1]:
            parts.append(p.new_zeros((E, b - a - p.shape[1])))
    return torch.cat(parts, dim=1)


def _program(spec, dev, R=None):
    """The ring's tile program at R rows a CTA (default ``spec.rows``) on
    ``dev`` (global plan), else None."""
    if spec.plan != "global":
        return None
    R = R or spec.rows
    prog = spec._progs.get(("dev", dev, R))
    if prog is None:
        prog = torch.tensor(spec.tile_program(R)[0], dtype=torch.int32,
                            device=dev)
        spec._progs[("dev", dev, R)] = prog
    return prog


def layer_table(spec, leaves):
    """The kernels' layer table for ``leaves`` (solo, or stacked ``[E,
    ...]`` for a member-axis launch), an int32 tensor of ``tab_ints`` on
    their device: ``Spec.table_head``, then each leaf's address as 8
    bytes. Kept on the spec per device with the addresses it holds; a new
    one is built only when a leaf's ``data_ptr`` changes, on CUDA copied
    from pinned host memory on the current stream (no host wait), so a
    trainer, whose optimizer updates the leaves in place, uploads it once."""
    ptrs = tuple(p.data_ptr() for p in leaves)
    dev = leaves[0].device
    hit = spec._tabs.get(dev)
    if hit is not None and hit[0] == ptrs:
        return hit[1]
    cuda = dev.type == "cuda"
    host = torch.empty((spec.tab_ints,), dtype=torch.int32, pin_memory=cuda)
    host[:spec.tab_ptrs] = spec.table_head()
    host[spec.tab_ptrs:].view(torch.int64).copy_(
        torch.tensor(ptrs, dtype=torch.int64))
    tab = host
    if cuda:
        tab = torch.empty((spec.tab_ints,), dtype=torch.int32, device=dev)
        tab.copy_(host, non_blocking=True)
    spec._tabs[dev] = (ptrs, tab)
    return tab


def _lib():
    from njode_tpu_torch.ops import _build
    return _build.lib("fused_scan")


def _on(dev):
    """The device context a launch needs: none when ``dev`` is current."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


def _launch_key(spec):
    """The ``LAUNCHES`` suffix of the spec's branch and plan."""
    return ("_rnn" if spec.use_rnn else "") + (
        "_global" if spec.plan == "global" else "")


def _count(key, B, R):
    LAUNCHES[key] += 1
    LAUNCH_ROWS[(key, B, R)] = LAUNCH_ROWS.get((key, B, R), 0) + 1


def _raise_rc(lib, rc, what):
    if rc:
        raise RuntimeError(f"{what} failed: "
                           f"{lib.njode_error_string(rc).decode()} ({rc})")


def _check_inputs(spec, leaves, arrays, train, u, seed):
    _require_supported(spec.cfg)
    times, dts, obs, X, n_obs, start_X, M = unpack_arrays(spec, arrays)
    K, B = obs.shape
    for name, t, shp in (("times", times, (K,)), ("dts", dts, (K,)),
                         ("obs", obs, (K, B)), ("X", X, (K, B, spec.D)),
                         ("n_obs", n_obs, (B,)),
                         ("start_X", start_X, (B, spec.D))):
        _check(name, t, shp)
    if spec.masked:
        _check("M", M, (K, B, spec.D))
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


def k1_probe():
    """What K1's last launch (CTA 0, member 0) wrote of itself: its walk
    ('items', 'roles' or 'global'), the threads of its CTA and the phases
    its middle step ended (counted in the role walk, else None). Waits
    for the card first."""
    lib = _lib()
    torch.cuda.synchronize()
    out = (ctypes.c_int * 3)()
    _raise_rc(lib, lib.njode_k1_probe(out), "njode_k1_probe")
    return {"walk": ("items", "roles", "global")[out[0]],
            "threads": out[1],
            "phases_per_step": out[2] if out[2] >= 0 else None}


def scan_fwd_cuda(spec, leaves, arrays, weight, h0, train, u=None,
                  seed=None, want_hists=True):
    """Launch K1 (``want_hists``) or K3 and, in the same C call, the
    reduction of the per-CTA losses."""
    K, B = _check_inputs(spec, leaves, arrays, train, u, seed)
    if not want_hists and train:
        raise ValueError("the history-free kernel is the eval forward")
    _check("h0", h0, (B, spec.H))
    lib = _lib()
    times, dts, obs, X, n_obs, start_X, M = unpack_arrays(spec, arrays)
    dev = h0.device
    cfg = make_cfg(spec, K, B, train, weight, bwd=False)
    n_cta = -(-B // cfg.rows)
    loss_part = torch.empty((n_cta,), dtype=torch.float32, device=dev)
    loss = torch.empty((), dtype=torch.float32, device=dev)
    if want_hists:
        hists = (torch.empty((K, B, spec.H), device=dev),
                 torch.empty((K, B, spec.D), device=dev),
                 torch.empty((K, B, 1), device=dev))
    else:
        hists = (None, None, None)
    tab = layer_table(spec, leaves)
    wg = packed_weights(spec, leaves)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with _on(dev):
        rc = lib.njode_scan_fwd(
            ctypes.addressof(cfg), _ptr(tab), _ptr(wg),
            _ptr(_program(spec, dev, cfg.rows)), _ptr(times), _ptr(dts),
            _ptr(obs), _ptr(X), _ptr(M), _ptr(u), _ptr(seed), _ptr(n_obs),
            _ptr(h0), _ptr(start_X), _ptr(loss_part), _ptr(loss),
            *(_ptr(t) for t in hists), int(want_hists), 1.0 / B, stream)
    _raise_rc(lib, rc, "njode_scan_fwd")
    _count(("njode_scan_fwd" if want_hists else "njode_scan_eval")
           + _launch_key(spec), B, cfg.rows)
    LAUNCHES["reduce_partials"] += 1
    if cfg.mode == 2:
        LAUNCHES["philox_keep"] += 1
    return loss, (hists if want_hists else None)


def _k2_work(spec, K, B, E, train, weight, dev, chunk=None, stretch=None):
    """K2's staged plan of a call (``_K2Work``), its buffers and its stage
    (c) partial rows: (config, work, (ws [E, Kc * B, rec], carry [E, B,
    D + 1], partials [E, ceil(K / Ks), n_params], the programs), chunks).
    The tensors must stay referenced until the C call returns."""
    cfg = make_cfg(spec, K, B, train, weight)
    Ks = stretch or spec.wgrad_steps(B)
    Kc = spec.bwd_chunk(K, B, E, chunk, Ks)
    w = _K2Work()
    keep = []
    if spec.plan == "resident":
        Ra = spec.remat_rows()
        w.a = make_cfg(spec, K, B, train, weight, bwd=False, rows=Ra)
        fa = spec.ws_program("a", Ra, dev)
        w.fa, w.n_fa = fa.data_ptr(), fa.shape[0]
        keep.append(fa)
    fb = spec.ws_program("b" if spec.plan == "resident" else "x", cfg.rows,
                         dev)
    tiles, jobs = spec.wgrad_program(dev)
    ws = torch.empty((E, Kc * B, spec.rec), device=dev)
    carry = torch.empty((E, B, spec.D + 1), device=dev)
    partials = torch.empty((E, -(-K // Ks), spec.n_params), device=dev)
    w.ws, w.carry = ws.data_ptr(), carry.data_ptr()
    w.fb, w.n_fb = fb.data_ptr(), fb.shape[0]
    w.tiles, w.jobs, w.n_tiles = (tiles.data_ptr(), jobs.data_ptr(),
                                  tiles.shape[0])
    w.Kc, w.Ks = Kc, Ks
    w.threads = spec.chain_threads(cfg.rows, E * -(-B // cfg.rows))
    keep += [fb, tiles, jobs, ws, carry, partials]
    return cfg, w, keep, -(-K // Kc)


def _count_stages(spec, chunks):
    if spec.plan == "resident":
        STAGE_LAUNCHES["njode_bwd_remat"] += chunks
    STAGE_LAUNCHES["njode_bwd_chain"] += chunks
    STAGE_LAUNCHES["njode_bwd_wgrad"] += chunks


def scan_bwd_cuda(spec, leaves, arrays, weight, train, hists, dloss,
                  u=None, seed=None, chunk=None, stretch=None,
                  want_ws=False):
    """Launch K2 (for each chunk of steps, last first, its stages (a)
    forward re-run, (b) chain and (c) weight gradients) and, in the same C
    call, the reduction of stage (c)'s partial rows; returns (grads as
    views of one flat buffer, in leaf order and layout, dh0), and with
    ``want_ws`` the workspace [Kc * B, rec] as the first chunk left it
    (``chunk`` / ``stretch``: ``Spec.bwd_chunk``'s; tests and checks)."""
    K, B = _check_inputs(spec, leaves, arrays, train, u, seed)
    hh, lxh, tauh = hists
    _check("h_hist", hh, (K, B, spec.H))
    _check("lastX_hist", lxh, (K, B, spec.D))
    _check("tau_hist", tauh, (K, B, 1))
    dloss = dloss.reshape(1).to(torch.float32).contiguous()
    _check("dloss", dloss, (1,))
    lib = _lib()
    times, dts, obs, X, n_obs, start_X, M = unpack_arrays(spec, arrays)
    dev = hh.device
    cfg, work, keep, chunks = _k2_work(spec, K, B, 1, train, weight, dev,
                                       chunk, stretch)
    partials = keep[-1]
    flat = torch.empty((spec.n_params,), device=dev)
    dh0 = torch.empty((B, spec.H), device=dev)
    tab = layer_table(spec, leaves)
    wg = packed_weights(spec, leaves)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with _on(dev):
        rc = lib.njode_scan_bwd(
            ctypes.addressof(cfg), ctypes.addressof(work), _ptr(tab),
            _ptr(wg), _ptr(_program(spec, dev)), _ptr(times), _ptr(dts),
            _ptr(obs), _ptr(X), _ptr(M), _ptr(u), _ptr(seed), _ptr(n_obs),
            _ptr(hh), _ptr(lxh), _ptr(tauh), _ptr(dloss), _ptr(partials),
            _ptr(flat), _ptr(dh0), stream)
    _raise_rc(lib, rc, "njode_scan_bwd")
    _count("njode_scan_bwd" + _launch_key(spec), B, cfg.rows)
    _count_stages(spec, chunks)
    LAUNCHES["reduce_partials"] += 1
    if cfg.mode == 2:
        LAUNCHES["philox_keep"] += 1
    grads = [flat[a:b].view(s) for a, b, s in
             zip(spec.leaf_off[:-1], spec.leaf_off[1:], spec.leaf_shapes)]
    return (grads, dh0) + ((keep[-3][0],) if want_ws else ())


def reduce_partials_cuda(partials, scale=1.0):
    """Sum ``partials [n_parts, n]`` (contiguous) over its rows in a fixed
    order."""
    if partials.device.type != "cuda" or partials.dtype != torch.float32:
        raise ValueError("partials must be a CUDA float32 tensor")
    if partials.dim() != 2 or not partials.is_contiguous():
        raise ValueError("partials must be a contiguous [n_parts, n]")
    return _reduce(partials, scale)


def _reduce(partials, scale=1.0):
    """reduce_partials on a buffer its caller made (no checks)."""
    lib = _lib()
    n_parts, n = partials.shape
    dev = partials.device
    out = torch.empty((n,), dtype=torch.float32, device=dev)
    with _on(dev):
        rc = lib.njode_reduce_partials(
            _ptr(partials), n_parts, n, float(scale), _ptr(out),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_rc(lib, rc, "njode_reduce_partials")
    LAUNCHES["reduce_partials"] += 1
    return out


def philox_masks_cuda(seed, K: int, S: int, B: int, w_max: int,
                      thresh: int):
    """All K4 keep-masks of K steps, ``[K, S, B, Wmax]`` int8, drawn by
    the kernels' Philox (the masks 'prng' mode uses; for tests and
    timing)."""
    _check("seed", seed, (1,), torch.int64)
    lib = _lib()
    out = torch.empty((K, S, B, w_max), dtype=torch.int8, device=seed.device)
    stream = torch.cuda.current_stream(seed.device).cuda_stream
    with _on(seed.device):
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
# K1/K2 over a member axis (the E members of a grouped ensemble)
# ---------------------------------------------------------------------------
#
# Member layout: every leaf ``[E, *leaf_shape]``; ``obs [E,K,B]``, ``X`` and
# ``M [E,K,B,D]``, ``n_obs [E,B]``, ``start_X [E,B,D]``, ``h0 [E,B,H]``, the
# histories ``[E,K,B,*]``, ``u [E,K,S,B,Wmax]`` ('input'), ``seed [E]``
# ('prng'); ``times`` and ``dts [K]`` shared (a group trains on one grid).
# A launch takes ``Spec.rows_for(B)`` rows a CTA as a solo launch does, so
# member e sums in a solo launch's order and gives its bits.

def member_arrays(arrays, e):
    """Member e's batch arrays of member-layout ``arrays``."""
    return tuple(a if i < 2 or a is None else a[e]
                 for i, a in enumerate(arrays))


def _check_member_inputs(spec, leaves, arrays, train, u, seed):
    _require_supported(spec.cfg)
    times, dts, obs, X, n_obs, start_X, M = unpack_arrays(spec, arrays)
    if obs.dim() != 3:
        raise ValueError("obs must be [E, K, B] in the member layout")
    E, K, B = obs.shape
    for name, t, shp in (("times", times, (K,)), ("dts", dts, (K,)),
                         ("obs", obs, (E, K, B)),
                         ("X", X, (E, K, B, spec.D)),
                         ("n_obs", n_obs, (E, B)),
                         ("start_X", start_X, (E, B, spec.D))):
        _check(name, t, shp)
    if spec.masked:
        _check("M", M, (E, K, B, spec.D))
    if len(leaves) != len(spec.leaf_shapes):
        raise ValueError("wrong number of parameter leaves")
    for i, (p, s) in enumerate(zip(leaves, spec.leaf_shapes)):
        _check(f"leaf {i}", p, (E,) + tuple(s))
    if train and spec.rate > 0.0 and spec.S > 0:
        if spec.mask_mode == "input":
            _check("u", u, (E, K, spec.S, B, spec.w_max), torch.int8)
        else:
            _check("seed", seed, (E,), torch.int64)
    return E, K, B


def scan_fwd_members_cuda(spec, leaves, arrays, weight, h0, train, u=None,
                          seed=None):
    """Launch K1 for E members at once (grid ``(ceil(B/R), E)``) and, in
    the same C call, the member reduction of the per-CTA losses; returns
    (loss [E], histories [E,K,B,*])."""
    E, K, B = _check_member_inputs(spec, leaves, arrays, train, u, seed)
    _check("h0", h0, (E, B, spec.H))
    lib = _lib()
    times, dts, obs, X, n_obs, start_X, M = unpack_arrays(spec, arrays)
    dev = h0.device
    cfg = make_cfg(spec, K, B, train, weight, bwd=False, E=E)
    n_cta = -(-B // cfg.rows)
    loss_part = torch.empty((E, n_cta), dtype=torch.float32, device=dev)
    loss = torch.empty((E,), dtype=torch.float32, device=dev)
    hists = (torch.empty((E, K, B, spec.H), device=dev),
             torch.empty((E, K, B, spec.D), device=dev),
             torch.empty((E, K, B, 1), device=dev))
    tab = layer_table(spec, leaves)
    wg = packed_weights_members(spec, leaves)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with _on(dev):
        rc = lib.njode_scan_fwd_members(
            ctypes.addressof(cfg), E, _ptr(tab), _ptr(wg),
            _ptr(_program(spec, dev, cfg.rows)), _ptr(times), _ptr(dts),
            _ptr(obs), _ptr(X), _ptr(M), _ptr(u), _ptr(seed), _ptr(n_obs),
            _ptr(h0), _ptr(start_X), _ptr(loss_part), _ptr(loss),
            *(_ptr(t) for t in hists), 1, 1.0 / B, stream)
    _raise_rc(lib, rc, "njode_scan_fwd_members")
    _count("njode_scan_fwd_members" + _launch_key(spec), B, cfg.rows)
    LAUNCHES["reduce_partials_members"] += 1
    if cfg.mode == 2:
        LAUNCHES["philox_keep_members"] += 1
    return loss, hists


def scan_bwd_members_cuda(spec, leaves, arrays, weight, train, hists, dloss,
                          u=None, seed=None, chunk=None, stretch=None,
                          want_ws=False):
    """Launch K2 for E members at once (each stage a chunk one launch of
    grid (..., E)) and, in the same C call, the member reduction of stage
    (c)'s partial rows; returns (grads [E, *leaf] as views of one [E,
    n_params] buffer, in leaf order, dh0 [E,B,H]), and with ``want_ws``
    the workspace [E, Kc * B, rec]. ``dloss [E]``: each member's loss
    cotangent. The chunk may be shorter than a solo call's (the workspace
    of all members within ``WS_BUDGET``); the bits are a solo call's."""
    E, K, B = _check_member_inputs(spec, leaves, arrays, train, u, seed)
    hh, lxh, tauh = hists
    _check("h_hist", hh, (E, K, B, spec.H))
    _check("lastX_hist", lxh, (E, K, B, spec.D))
    _check("tau_hist", tauh, (E, K, B, 1))
    dloss = dloss.reshape(-1).to(torch.float32).contiguous()
    _check("dloss", dloss, (E,))
    lib = _lib()
    times, dts, obs, X, n_obs, start_X, M = unpack_arrays(spec, arrays)
    dev = hh.device
    cfg, work, keep, chunks = _k2_work(spec, K, B, E, train, weight, dev,
                                       chunk, stretch)
    partials = keep[-1]
    P = spec.n_params
    flat = torch.empty((E, P), device=dev)
    dh0 = torch.empty((E, B, spec.H), device=dev)
    tab = layer_table(spec, leaves)
    wg = packed_weights_members(spec, leaves)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with _on(dev):
        rc = lib.njode_scan_bwd_members(
            ctypes.addressof(cfg), E, ctypes.addressof(work), _ptr(tab),
            _ptr(wg), _ptr(_program(spec, dev)), _ptr(times), _ptr(dts),
            _ptr(obs), _ptr(X), _ptr(M), _ptr(u), _ptr(seed), _ptr(n_obs),
            _ptr(hh), _ptr(lxh), _ptr(tauh), _ptr(dloss), _ptr(partials),
            _ptr(flat), _ptr(dh0), stream)
    _raise_rc(lib, rc, "njode_scan_bwd_members")
    _count("njode_scan_bwd_members" + _launch_key(spec), B, cfg.rows)
    _count_stages(spec, chunks)
    LAUNCHES["reduce_partials_members"] += 1
    if cfg.mode == 2:
        LAUNCHES["philox_keep_members"] += 1
    grads = [flat[:, a:b].view((E,) + tuple(s)) for a, b, s in
             zip(spec.leaf_off[:-1], spec.leaf_off[1:], spec.leaf_shapes)]
    return (grads, dh0) + ((keep[-3],) if want_ws else ())


def _member_plain(spec, leaves, arrays, u, seed, e):
    return ([p[e] for p in leaves], member_arrays(arrays, e),
            None if u is None else u[e],
            None if seed is None else seed[e:e + 1])


def scan_fwd_members_plain(spec, leaves, arrays, weight, h0, train, u=None,
                           seed=None):
    """Plain member K1: ``scan_fwd_plain`` of each member, stacked."""
    losses, hists = [], []
    for e in range(h0.shape[0]):
        lv, arr, ue, se = _member_plain(spec, leaves, arrays, u, seed, e)
        loss, h = scan_fwd_plain(spec, lv, arr, weight, h0[e], train, ue, se)
        losses.append(loss)
        hists.append(h)
    return torch.stack(losses), tuple(torch.stack(v) for v in zip(*hists))


def scan_bwd_members_plain(spec, leaves, arrays, weight, train, hists,
                           dloss, u=None, seed=None):
    """Plain member K2: ``scan_bwd_plain`` of each member (cotangent
    ``dloss[e]``), stacked."""
    grads, dh0 = [], []
    dloss = dloss.reshape(-1)
    for e in range(hists[0].shape[0]):
        lv, arr, ue, se = _member_plain(spec, leaves, arrays, u, seed, e)
        g, d = scan_bwd_plain(spec, lv, arr, weight, train,
                              tuple(h[e] for h in hists), dloss[e], ue, se)
        grads.append(g)
        dh0.append(d)
    return [torch.stack(v) for v in zip(*grads)], torch.stack(dh0)


def reduce_partials_members_cuda(partials, scale=1.0):
    """Sum each member's rows of ``partials [E, n_parts, n]`` (contiguous)
    in a fixed order, one launch for all members: ``[E, n]``."""
    if partials.device.type != "cuda" or partials.dtype != torch.float32:
        raise ValueError("partials must be a CUDA float32 tensor")
    if partials.dim() != 3 or not partials.is_contiguous():
        raise ValueError("partials must be a contiguous [E, n_parts, n]")
    lib = _lib()
    E, n_parts, n = partials.shape
    dev = partials.device
    out = torch.empty((E, n), dtype=torch.float32, device=dev)
    with _on(dev):
        rc = lib.njode_reduce_partials_members(
            _ptr(partials), E, n_parts, n, float(scale), _ptr(out),
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_rc(lib, rc, "njode_reduce_partials_members")
    LAUNCHES["reduce_partials_members"] += 1
    return out


def reduce_partials_members_plain(partials, scale=1.0):
    """``reduce_partials_plain`` of each member, stacked."""
    return torch.stack([reduce_partials_plain(p, scale) for p in partials])


def scan_fwd_members(spec, leaves, arrays, weight, h0, train, u=None,
                     seed=None):
    """Member K1 on CUDA tensors, the plain version on CPU tensors."""
    if _is_cuda(h0):
        return scan_fwd_members_cuda(spec, leaves, arrays, weight, h0, train,
                                     u, seed)
    with torch.no_grad():
        return scan_fwd_members_plain(spec, leaves, arrays, weight, h0,
                                      train, u, seed)


def scan_bwd_members(spec, leaves, arrays, weight, train, hists, dloss,
                     u=None, seed=None):
    """Member K2 on CUDA tensors, the plain version on CPU tensors."""
    if _is_cuda(hists[0]):
        return scan_bwd_members_cuda(spec, leaves, arrays, weight, train,
                                     hists, dloss, u, seed)
    return scan_bwd_members_plain(spec, leaves, arrays, weight, train, hists,
                                  dloss, u, seed)


# ---------------------------------------------------------------------------
# autograd
# ---------------------------------------------------------------------------

class FusedNJODELoss(torch.autograd.Function):
    """Loss of the NJODE scan from the t=0 hidden state ``h0``; the
    backward is K2 (CUDA) or its plain version (CPU). Differentiable in
    ``h0`` and the parameter leaves; the batch arrays (``M [K,B,D]`` for a
    masked spec, else None) are data."""

    @staticmethod
    def forward(ctx, spec, train, weight, u, seed, times, dts, obs, X,
                n_obs, start_X, M, h0, *leaves):
        arrays = (times, dts, obs, X, n_obs, start_X, M)
        loss, hists = scan_fwd(spec, leaves, arrays, weight, h0, train, u,
                               seed, want_hists=True)
        ctx.spec, ctx.train, ctx.weight = spec, train, weight
        ctx.save_for_backward(times, dts, obs, X, n_obs, start_X, M, u, seed,
                              *hists, *leaves)
        return loss

    @staticmethod
    def backward(ctx, dloss):
        saved = ctx.saved_tensors
        arrays = saved[:7]
        u, seed = saved[7], saved[8]
        hists = saved[9:12]
        leaves = saved[12:]
        grads, dh0 = scan_bwd(ctx.spec, leaves, arrays, ctx.weight,
                              ctx.train, hists, dloss, u, seed)
        return (None,) * 12 + (dh0,) + tuple(grads)


class FusedNJODEMembersLoss(torch.autograd.Function):
    """The losses ``[E]`` of E members of one config in one member-axis
    launch (K1), from their t=0 states ``h0 [E,B,H]`` and stacked leaves
    ``[E, ...]`` (the member layout above); the backward is the member K2
    (CUDA) or its plain version (CPU), given each member's cotangent."""

    @staticmethod
    def forward(ctx, spec, train, weight, u, seed, times, dts, obs, X,
                n_obs, start_X, M, h0, *leaves):
        arrays = (times, dts, obs, X, n_obs, start_X, M)
        loss, hists = scan_fwd_members(spec, leaves, arrays, weight, h0,
                                       train, u, seed)
        ctx.spec, ctx.train, ctx.weight = spec, train, weight
        ctx.save_for_backward(times, dts, obs, X, n_obs, start_X, M, u, seed,
                              *hists, *leaves)
        return loss

    @staticmethod
    def backward(ctx, dloss):
        saved = ctx.saved_tensors
        grads, dh0 = scan_bwd_members(ctx.spec, saved[12:], saved[:7],
                                      ctx.weight, ctx.train, saved[9:12],
                                      dloss, saved[7], saved[8])
        return (None,) * 12 + (dh0,) + tuple(grads)


def _require_supported(cfg):
    if not supported(cfg):
        raise NotImplementedError(
            "config outside the fused kernels' scope (output_size != "
            "input_size when masked, or with neither of them 1; a solver "
            "other than euler, a loss other than standard or easy, an MLP "
            "that is missing or not tanh/relu, a compute_dtype other than "
            "float32, or activations of one row beyond one CTA's shared "
            "memory); use models.njode.forward")


def t0_state(model, batch, enc_masks=None):
    """The t=0 encoder output ``h0``; a masked encoder gets the zero mask,
    as ``njode.forward`` gives it."""
    zero_mask = (torch.zeros_like(batch.start_X) if model.cfg.masked
                 else None)
    return model.encoder_map(batch.start_X, zero_mask, enc_masks)


def batch_arrays(batch):
    """The kernels' batch arrays of a GridBatch (M included)."""
    return (batch.times, batch.dt, batch.obs, batch.X, batch.n_obs_ot,
            batch.start_X, batch.M.contiguous())


def _draw(spec, batch, generator, train, u_override=None, n_seeds=1):
    """The dropout draws of one training step, in ``njode.forward``'s
    order: the t=0 encoder's keep-masks, then the scan's ('input': a
    ``[K,S,B,Wmax]`` int8 tensor, or ``u_override``; 'prng': ``n_seeds``
    int64 Philox seeds, one a shard of a mesh, that stay on the device).
    Returns (encoder masks, u, seed), None where nothing is drawn."""
    K, B = batch.obs.shape
    dev = batch.start_X.device
    if not (train and spec.rate > 0.0 and spec.S > 0):
        return None, None, None
    u = seed = None
    keep = 1.0 - spec.rate
    u0 = torch.rand((max(spec.n_enc, 1), B, spec.w_max),
                    generator=generator, device=dev) < keep
    enc_masks = [u0[i] for i in range(spec.n_enc)]
    if spec.mask_mode == "input":
        if u_override is not None:
            u = torch.as_tensor(u_override, device=dev)
        else:
            u = torch.rand((K, spec.S, B, spec.w_max),
                           generator=generator, device=dev) < keep
        u = u.to(torch.int8).contiguous()
    else:
        seed = torch.randint(0, 2 ** 62, (n_seeds,), generator=generator,
                             device=dev, dtype=torch.int64)
    return enc_masks, u, seed


def make_fused_loss_fn(cfg, mask_mode: str = "prng", u_override=None,
                       plan=None, mesh=None):
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
        one, through the input path).
    :param plan: a forced ``(name, rows)`` kernel plan (see ``Spec``).
    :param mesh: a ``parallel.sharding.Mesh``: ``batch`` is the global
        batch, whose rows the mesh size must divide, and every rank draws
        the global masks from a generator in the same state ('prng': one
        seed a rank, rank r taking seed r; a mesh of one draws exactly
        what no mesh draws), then keeps its own rows and runs the kernels
        at ``B / n`` rows. The loss returned is this rank's, a mean over
        its rows: ``parallel.sharding.allreduce_grads(..., 'mean',
        loss)`` after the backward makes loss and gradients the global
        batch's (the JAX package's ``pmean`` under ``shard_map``)."""
    from njode_tpu_torch.parallel import sharding

    _require_supported(cfg)
    spec = Spec(cfg, mask_mode, plan)
    sharding.check_mesh(mesh, "fused kernel sharding")
    n_seeds = 1 if mesh is None else mesh.size

    def loss_fn(model, batch, weight, generator, train):
        if mesh is not None:
            sharding.check_divisible(batch.start_X.shape[0], mesh)
        enc_masks, u, seed = _draw(spec, batch, generator, train, u_override,
                                   n_seeds)
        if mesh is not None:
            batch = sharding.shard_batch(batch, mesh)
            if enc_masks is not None:
                enc_masks = [sharding.shard_rows(m, mesh) for m in enc_masks]
            if u is not None:
                u = sharding.shard_rows(u, mesh, 2)
            if seed is not None:
                seed = seed[mesh.rank:mesh.rank + 1]
        h0 = t0_state(model, batch, enc_masks)
        M = batch.M.contiguous() if spec.masked else None
        return FusedNJODELoss.apply(
            spec, train, float(weight), u, seed, batch.times, batch.dt,
            batch.obs, batch.X, batch.n_obs_ot, batch.start_X, M, h0,
            *flat_leaves(model))

    return loss_fn


def make_fused_members_loss_fn(cfg, mask_mode: str = "prng", plan=None):
    """Return ``loss_fn(models, batches, weight, generators, train)``: the
    training losses ``[E]`` of E models of one config, each on its own
    batch (one grid: the batches share ``times``/``dt`` and ``B``), through
    :class:`FusedNJODEMembersLoss`: one member-axis launch of K1 (and of K2
    in the backward) for all members. Member e draws from
    ``generators[e]`` exactly what ``make_fused_loss_fn`` draws, in the
    same order, and its t=0 encoder runs on its own; so each member's loss
    and gradients are a solo step's, bit for bit on the card (the same
    rows a CTA). The leaves are stacked differentiably (``torch.stack``),
    so the gradients reach each model's own parameters."""
    _require_supported(cfg)
    spec = Spec(cfg, mask_mode, plan)

    def loss_fn(models, batches, weight, generators, train):
        us, seeds, h0s = [], [], []
        for model, batch, gen in zip(models, batches, generators):
            enc_masks, u, seed = _draw(spec, batch, gen, train)
            h0s.append(t0_state(model, batch, enc_masks))
            us.append(u)
            seeds.append(seed)
        u = torch.stack(us) if us[0] is not None else None
        seed = torch.cat(seeds) if seeds[0] is not None else None
        b0 = batches[0]

        def stack(field):
            return torch.stack([getattr(b, field) for b in batches])

        M = (torch.stack([b.M.contiguous() for b in batches])
             if spec.masked else None)
        leaves = [torch.stack(ls) for ls in
                  zip(*(flat_leaves(m) for m in models))]
        return FusedNJODEMembersLoss.apply(
            spec, train, float(weight), u, seed, b0.times, b0.dt,
            stack("obs"), stack("X"), stack("n_obs_ot"), stack("start_X"),
            M, torch.stack(h0s), *leaves)

    return loss_fn


def make_fused_eval_fn(cfg, plan=None, mesh=None):
    """Return ``eval_fn(model, batch, weight)``: the eval loss through the
    history-free forward (K3 on CUDA, its plain version on CPU) at any
    batch size (``plan``: a forced kernel plan, see ``Spec``). With a
    ``mesh`` each rank runs K3 on its block of the global ``batch``'s rows
    and the blocks' losses are combined into the global batch mean
    (``parallel.sharding.batch_mean``), the same on every rank."""
    from njode_tpu_torch.parallel import sharding

    _require_supported(cfg)
    spec = Spec(cfg, "input", plan)
    sharding.check_mesh(mesh, "fused kernel sharding")

    def eval_fn(model, batch, weight):
        B = batch.start_X.shape[0]
        if mesh is not None:
            batch = sharding.shard_batch(batch, mesh)
        with torch.no_grad():
            h0 = t0_state(model, batch)
            loss, _ = scan_fwd(spec, [p.detach() for p in
                                      flat_leaves(model)],
                               batch_arrays(batch), float(weight), h0, False,
                               want_hists=False)
        return loss if mesh is None else sharding.batch_mean(loss, mesh, B)

    return eval_fn
