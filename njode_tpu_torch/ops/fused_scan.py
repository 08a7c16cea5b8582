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
memory of each CTA (and, in K2, every gradient); taken wherever it fits at
some R of 16, 8, 4, 2, 1 (``Spec.rows``: the most that fit). A launch at
batch B takes ``Spec.rows_for(B, bwd)`` rows a CTA: the fewest at which
every CTA of the launch is resident on the card at once (``CTAS_PER_SM``
a SM at most, fewer where the kernel's own shared memory allows fewer),
so one row a CTA at the training batches (B = 50-200) and 16 at the
eval's B = 4,000. K1/K3's layout holds no gradient or backward regions.
'global': the weights stay in one packed buffer in device memory (each
leaf at a 16-byte boundary, ``Spec.pack_off``) and K2 adds its gradients
into the CTA's partial row in place, so only the activations of R rows sit
in shared memory, R the largest that fits (the 200- and 400-wide arms,
the GRU jump at PhysioNet's widths), and the shared memory left over
holds a ring of two weight tiles that the kernels fill in the background
(``Spec.tile_program`` lists a step's tiles in the order the kernels use
them). Both plans sum in the same order, so at one R they give the same
bits. ``plan=(name, R)`` forces a plan, for the tests.

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
K1/K3 (the per-CTA losses) and K2 (the per-CTA gradient rows), and count
it in ``LAUNCHES``.

A member axis (the grouped ensembles; the JAX kernel under ``jax.vmap``):
``njode_scan_fwd_members`` / ``njode_scan_bwd_members`` launch K1/K2 once
for E members of one config, grid ``(ceil(B/R), E)``, each CTA offsetting
its member's pointers at entry (leaves, packed weights, batch, masks,
seed, histories, partial rows); the member ``reduce_partials`` gives
``loss [E]`` and ``grads [E, n_params]``. A launch keeps the solo rows rule
at B, so each member's bits are its solo launch's.
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
# K1/K2's kernel parameters after ScanCfg: the layer table and 16 pointers
KERNEL_PTRS = 17
SMEM_LIMIT = 232448       # bytes of shared memory one CTA may use (H100)
# the global plan's weight ring (csrc/fused_scan.cu): rows a thread sums,
# items a thread carries across tiles, threads a CTA, ints a tile
RB, MAXI, NTHREADS, TILE_INTS = 4, 4, 256, 8

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


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0
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
    plan fits."""

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
        self.tab_ptrs = -(-(self.tab_leaves + len(self.leaf_off)) // 2) * 2
        self.tab_ints = self.tab_ptrs + 2 * len(self.leaf_shapes)
        self._cfgs, self._progs, self._tabs = {}, {}, {}
        self._head = None
        self.forced = plan is not None
        self.plan, self.rows = self._choose_plan(plan)

    def fits(self, plan: str, R: int) -> bool:
        """Whether K1-K3 fit one CTA at R rows in ``plan`` (resident: K2's
        layout, the larger)."""
        off, n = self.layout(R, plan)
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
        rows, the global plan's ``rows``, else the fewest of 1, 2, 4, 8,
        16 (up to ``rows``) at which the launch's ceil(B / R) CTAs are all
        resident at once on the card's ``N_SM`` SMs, or ``rows`` where
        none is."""
        if self.forced or self.plan != "resident":
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
               bwd: bool = True):
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
        'resident': the weights ``w``,
        then (K2, ``bwd``) their gradients ``g``, then two sets of the
        step's inputs and carries (``io``: t and dt at ``tdt``, ``h``,
        ``lx``, ``tau``, ``X``, ``obs``, ``M``, and the ODE's and the
        jump's inputs ``in_ode``, ``tX``; the second set ``io2 - io``
        floats after the first), so one step fills the other set while it
        reads its own; ``le`` the loss's error terms of each row and
        output, which the readout's last phase writes; the backward
        regions only in K2's layout.

        Both plans hold ``mw``, the dropout masks as bits
        (``mask_words``): two sets in the resident plan (a step's, and
        the next one's being filled), one in the global plan (filled at
        the end of each step; in the masked branch without the GRU jump
        inside ``dB``, whose second half its backward never uses), none
        without dropout; the resident plan ends with the layer records
        ``lay`` (``LAYER_INTS`` ints a Linear), after every region the
        kernels' phases read."""
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
            for name, size in (("dA", R2 * self.buf_w),
                               ("dB", R2 * self.buf_w), ("dh", R * H),
                               ("dlx", R * D), ("dtau", R), ("rs", 2 * R),
                               ("dst", R2 * O), ("dh1", R * H),
                               ("dhe", R * H), ("df", R * H),
                               ("dlxc", R * D), ("dtauc", R)):
                take(name, size)
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
        if bwd:
            take("g", P)
        off["io"] = n
        for name, size in (("tdt", 2), ("h", R * H), ("lx", R * D),
                           ("tau", R), ("X", R * D), ("obs", R),
                           ("M", R * DM), ("in_ode", R * self.ode_w[0]),
                           ("tX", R * self.enc_w[0])):
            take(name, size)
        off["io2"] = n
        n += n - off["io"]
        for name, size in (("nobs", R), ("lrow", R), ("h1", R * H),
                           ("h2", R * H), ("in_ro", R2 * H), ("ro", R2 * O),
                           ("le", R2 * O), ("Xi", R * DM)):
            take(name, size)
        saves()
        if bwd:
            for name, size in (("dA", R2 * self.buf_w),
                               ("dB", R2 * self.buf_w), ("dh", R * H),
                               ("dlx", R * D), ("dtau", R), ("dst", R2 * O),
                               ("dh1", R * H), ("dhe", R * H), ("df", R * H),
                               ("dlxc", R * D), ("dtauc", R)):
                take(name, size)
        if self.use_rnn:
            take("gru", 4 * R * H)
            if bwd:
                take("dG", 4 * R * H)
        take("mw", 2 * self.mask_words(R))
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

    def tile_program(self):
        """The global plan's ring tiles of one step, ``TILE_INTS`` ints
        each (csrc/fused_scan.cu ``Ring``), and how many belong to the
        forward and to K2's backward. A forward product takes column
        blocks of W (as many columns as fit beside the bias, a multiple of
        4 where it splits, for 16-byte copies), a dx product row blocks; a
        split product is walked once per ``MAXI * NTHREADS`` of its (row
        block, output) items."""
        R = self.rows
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
        offsets in the flat parameters, then a zero where the addresses
        need an even start."""
        if self._head is None:
            out, leaf = [], 0
            for ws, acts in ((self.ode_w, self.ode_a),
                             (self.enc_w, self.enc_a),
                             (self.ro_w, self.ro_a)):
                for l in range(len(ws) - 1):
                    relu = int(l < len(acts) and acts[l] == "relu")
                    w_off, pw_off = self.leaf_off[leaf], self.pack_off[leaf]
                    leaf += 1
                    b_off = -1
                    if self.bias:
                        b_off, leaf = self.leaf_off[leaf], leaf + 1
                    out += [ws[l], ws[l + 1], relu, w_off, b_off, pw_off,
                            sum(ws[1:l + 1]), 0]
            out += self.leaf_off
            out += [0] * (self.tab_ptrs - len(out))
            self._head = torch.tensor(out, dtype=torch.int32)
        return self._head


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


def _gru_plain(gru, x, h):
    """torch's GRUCell (gate order r, z, n) from its four leaves."""
    w_ih, w_hh, b_ih, b_hh = gru
    gi_r, gi_z, gi_n = F.linear(x, w_ih, b_ih).chunk(3, dim=-1)
    gh_r, gh_z, gh_n = F.linear(h, w_hh, b_hh).chunk(3, dim=-1)
    r = torch.sigmoid(gi_r + gh_r)
    z = torch.sigmoid(gi_z + gh_z)
    n = torch.tanh(gi_n + r * gh_n)
    return (1.0 - z) * n + z * h


def _step_plain(spec, nets, h, last_X, tau, t, dt, obs, X, M, us):
    """One step of the NJODE recursion (the stacked readouts after the
    encoder or GRU jump, or the masked imputation branch); returns (h2,
    last_X', tau', y, y_bj)."""
    ws_ode, ws_enc, ws_ro, gru = nets

    def sl(a, n):
        return None if us is None or n == 0 else us[a:a + n]

    def readout(hh, masks):
        return mlp.residual_apply(spec.ro_case, spec.ro_mult, hh,
                                  _mlp_plain(ws_ro, spec.ro_a,
                                             torch.tanh(hh), masks,
                                             spec.rate))

    tdiff = (t - dt) - tau
    feats = [torch.tanh(last_X), torch.tanh(h), tau, tdiff]
    if spec.ict:
        feats.append(tau + tdiff)
    f = _mlp_plain(ws_ode, spec.ode_a, torch.cat(feats, dim=-1),
                   sl(spec.s_ode, spec.n_ode), spec.rate)
    h1 = h + dt * f
    obs_c = obs[:, None]
    u_enc = sl(spec.s_enc, spec.n_enc)
    if spec.masked and not spec.use_rnn:
        # the pre-jump readout imputes the unobserved coordinates
        y_bj = readout(h1, sl(spec.s_r1, spec.n_ro))
        X_imp = X * M + (1.0 - M) * y_bj
        enc_o = _mlp_plain(ws_enc, spec.enc_a,
                           torch.cat([torch.tanh(X_imp), M], dim=-1),
                           u_enc, spec.rate)
        h_enc = mlp.residual_apply(spec.enc_case, spec.enc_mult, X_imp,
                                   enc_o)
        h2 = obs_c * h_enc + (1.0 - obs_c) * h1
        y = readout(h2, sl(spec.s_r2, spec.n_ro))
    else:
        if spec.use_rnn:
            # the GRU jump on the raw observation, masked or not
            h_enc = _gru_plain(gru, torch.tanh(X), torch.tanh(h1))
        else:
            enc_o = _mlp_plain(ws_enc, spec.enc_a, torch.tanh(X), u_enc,
                               spec.rate)
            h_enc = mlp.residual_apply(spec.enc_case, spec.enc_mult, X,
                                       enc_o)
        h2 = obs_c * h_enc + (1.0 - obs_c) * h1
        u_r = None
        if us is not None and spec.n_ro:
            u_r = [torch.cat([a, b], dim=0) for a, b in
                   zip(sl(spec.s_r1, spec.n_ro), sl(spec.s_r2, spec.n_ro))]
        y2 = readout(torch.cat([h1, h2], dim=0), u_r)
        B = h.shape[0]
        y_bj, y = y2[:B], y2[B:]
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
        "w_in", "w_out", "act", "w_off", "b_off", "pw_off", "save", "pad")]


class _MLPDesc(ctypes.Structure):
    _fields_ = [(n, ctypes.c_int) for n in (
        "n_lin", "w_in", "lay", "slot0", "save_off")]


_LAYOUT_FIELDS = ("w", "g", "h", "lx", "tau", "X", "obs", "nobs", "lrow",
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
                                       "tab_ptrs")]
        + [("o_" + n, ctypes.c_int) for n in _LAYOUT_FIELDS]
        + [(n, ctypes.c_int) for n in ("nw", "lg_nw", "skip0", "skip1")]
        + [("ode", _MLPDesc), ("enc", _MLPDesc), ("ro", _MLPDesc),
           ("ro2", _MLPDesc)])


def param_bytes() -> int:
    """Bytes of K1/K2's parameter block: ``ScanCfg`` by value, then the
    layer table's address and the other pointers (``KERNEL_PTRS`` in all,
    8-byte aligned)."""
    return -(-ctypes.sizeof(_ScanCfg) // 8) * 8 + 8 * KERNEL_PTRS


def make_cfg(spec: Spec, K: int, B: int, train: bool, weight: float,
             bwd: bool = True):
    """The configuration of one call of K2 (``bwd``) or K1/K3 (host
    memory), in the spec's plan at ``spec.rows_for(B, bwd)`` rows; the
    global plan has no ``w``/``g`` regions, the resident plan no
    ``ring``/``gsc`` regions and no tiles (and K1/K3's no ``g`` or
    backward regions), and a config without use_rnn no ``gru``/``dG``
    regions and no GRU leaves (their offsets are -1). Kept on the spec per
    call shape, so a step builds it once."""
    key = (K, B, bool(train), float(weight), bool(bwd))
    if key not in spec._cfgs:
        spec._cfgs[key] = _make_cfg(spec, K, B, train, weight, bwd)
    return spec._cfgs[key]


def _make_cfg(spec, K, B, train, weight, bwd):
    R = spec.rows_for(B, bwd)
    off, total = spec.layout(R, spec.plan, bwd)
    c = _ScanCfg()
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
        _, c.n_tiles_fwd, c.n_tiles_bwd, c.stage = spec.tile_program()
    c.thresh = spec.thresh
    c.keep = 1.0 - spec.rate
    c.weight = float(weight)
    c.rows, c.plan = R, PLANS.index(spec.plan)
    c.io_stride = off["io2"] - off["io"] if "io" in off else 0
    c.wg_stride = spec.pack_off[-1]
    c.buf_w, c.smem_floats = spec.buf_w, total
    c.n_rec, c.tab_leaves, c.tab_ptrs = (spec.n_rec, spec.tab_leaves,
                                         spec.tab_ptrs)
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


def _program(spec, dev):
    """The ring's tile program on ``dev`` (global plan), else None."""
    if spec.plan != "global":
        return None
    prog = spec._progs.get(("dev", dev))
    if prog is None:
        prog = torch.tensor(spec.tile_program()[0], dtype=torch.int32,
                            device=dev)
        spec._progs[("dev", dev)] = prog
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
            _ptr(_program(spec, dev)), _ptr(times), _ptr(dts), _ptr(obs),
            _ptr(X), _ptr(M), _ptr(u), _ptr(seed), _ptr(n_obs), _ptr(h0),
            _ptr(start_X), _ptr(loss_part), _ptr(loss),
            *(_ptr(t) for t in hists), int(want_hists), 1.0 / B, stream)
    _raise_rc(lib, rc, "njode_scan_fwd")
    _count(("njode_scan_fwd" if want_hists else "njode_scan_eval")
           + _launch_key(spec), B, cfg.rows)
    LAUNCHES["reduce_partials"] += 1
    if cfg.mode == 2:
        LAUNCHES["philox_keep"] += 1
    return loss, (hists if want_hists else None)


def scan_bwd_cuda(spec, leaves, arrays, weight, train, hists, dloss,
                  u=None, seed=None):
    """Launch K2 and, in the same C call, the reduction of its per-CTA
    gradient rows; returns (grads as views of one flat buffer, in leaf
    order and layout, dh0)."""
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
    cfg = make_cfg(spec, K, B, train, weight)
    n_cta = -(-B // cfg.rows)
    partials = torch.empty((n_cta, spec.n_params), device=dev)
    flat = torch.empty((spec.n_params,), device=dev)
    dh0 = torch.empty((B, spec.H), device=dev)
    tab = layer_table(spec, leaves)
    wg = packed_weights(spec, leaves)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with _on(dev):
        rc = lib.njode_scan_bwd(
            ctypes.addressof(cfg), _ptr(tab), _ptr(wg),
            _ptr(_program(spec, dev)), _ptr(times), _ptr(dts), _ptr(obs),
            _ptr(X), _ptr(M), _ptr(u), _ptr(seed), _ptr(n_obs), _ptr(hh),
            _ptr(lxh), _ptr(tauh), _ptr(dloss), _ptr(partials), _ptr(flat),
            _ptr(dh0), stream)
    _raise_rc(lib, rc, "njode_scan_bwd")
    _count("njode_scan_bwd" + _launch_key(spec), B, cfg.rows)
    LAUNCHES["reduce_partials"] += 1
    if cfg.mode == 2:
        LAUNCHES["philox_keep"] += 1
    grads = [flat[a:b].view(s) for a, b, s in
             zip(spec.leaf_off[:-1], spec.leaf_off[1:], spec.leaf_shapes)]
    return grads, dh0


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
    cfg = make_cfg(spec, K, B, train, weight, bwd=False)
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
            _ptr(_program(spec, dev)), _ptr(times), _ptr(dts), _ptr(obs),
            _ptr(X), _ptr(M), _ptr(u), _ptr(seed), _ptr(n_obs), _ptr(h0),
            _ptr(start_X), _ptr(loss_part), _ptr(loss),
            *(_ptr(t) for t in hists), 1, 1.0 / B, stream)
    _raise_rc(lib, rc, "njode_scan_fwd_members")
    _count("njode_scan_fwd_members" + _launch_key(spec), B, cfg.rows)
    LAUNCHES["reduce_partials_members"] += 1
    if cfg.mode == 2:
        LAUNCHES["philox_keep_members"] += 1
    return loss, hists


def scan_bwd_members_cuda(spec, leaves, arrays, weight, train, hists, dloss,
                          u=None, seed=None):
    """Launch K2 for E members at once and, in the same C call, the member
    reduction of its per-CTA gradient rows; returns (grads [E, *leaf] as
    views of one [E, n_params] buffer, in leaf order, dh0 [E,B,H]).
    ``dloss [E]``: each member's loss cotangent."""
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
    cfg = make_cfg(spec, K, B, train, weight)
    n_cta = -(-B // cfg.rows)
    P = spec.n_params
    partials = torch.empty((E, n_cta, P), device=dev)
    flat = torch.empty((E, P), device=dev)
    dh0 = torch.empty((E, B, spec.H), device=dev)
    tab = layer_table(spec, leaves)
    wg = packed_weights_members(spec, leaves)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with _on(dev):
        rc = lib.njode_scan_bwd_members(
            ctypes.addressof(cfg), E, _ptr(tab), _ptr(wg),
            _ptr(_program(spec, dev)), _ptr(times), _ptr(dts), _ptr(obs),
            _ptr(X), _ptr(M), _ptr(u), _ptr(seed), _ptr(n_obs), _ptr(hh),
            _ptr(lxh), _ptr(tauh), _ptr(dloss), _ptr(partials), _ptr(flat),
            _ptr(dh0), stream)
    _raise_rc(lib, rc, "njode_scan_bwd_members")
    _count("njode_scan_bwd_members" + _launch_key(spec), B, cfg.rows)
    LAUNCHES["reduce_partials_members"] += 1
    if cfg.mode == 2:
        LAUNCHES["philox_keep_members"] += 1
    grads = [flat[:, a:b].view((E,) + tuple(s)) for a, b, s in
             zip(spec.leaf_off[:-1], spec.leaf_off[1:], spec.leaf_shapes)]
    return grads, dh0


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
