"""The GRU-ODE-Bayes CUDA kernels of ops/csrc/fused_gob.cu (K5, K6, K7)
against their plain versions, on the card, over the 13 configurations the
kernels cover (minimal and full field, impute on and off, logvar and
abs-var, euler and midpoint, the discretized cell, bias on and off,
dropout), the published width hidden 100, batches that are no multiple of
the rows per CTA (B = 17-48), ``dt==0`` padding steps, partial coordinate
masks (D = 2), the climate arm's unequal widths (D = 5, p_hidden 25,
prep_hidden 10, impute off) and both mask modes; each at the rows the rule
takes, and forced to 1, 2, 4 and 8 rows per CTA; K6's stages (remat,
chain, wgrad) against their plain version ``gob_scan_bwd_staged_plain``
(the workspace buffer by buffer), chunked and whole; the two wide
configurations that fit one CTA only at few rows (D = 1 at widths 200,
D = 41 at widths 50); and the device-memory form of the activations, bit
for bit the shared form at one row (the published hidden 50, the
midpoint and climate variants) and taken by the rule at p_hidden 4,000.

The kernels have no CPU build, so every test here skips without a CUDA
card. This file imports neither jax nor the JAX package; run it on the card
without the suite's conftest (which imports jax):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_fused_gob_card.py

Tolerances: loss rtol 1e-5 / atol 1e-6; the carry histories and gradients
rtol 2e-4 with an atol of 2e-5 scaled by the largest |value| (at least 1):
the GOB loss is a sum over observations with 1/var and 1/s2^2 = 1e4 factors,
so gradients reach the thousands, and the kernel sums its products serially
where the plain version goes through cuBLAS. The abs-var variants start
with the var head's bias raised by 1: near |var| = 0 their loss amplifies
rounding a thousandfold, which is conditioning, not kernel arithmetic.
"""

import numpy as np
import pytest
import torch

from njode_tpu_torch.data import grid
from njode_tpu_torch.models import gru_ode_bayes as gob
from njode_tpu_torch.ops import fused_gob as fg

LOSS_TOL = dict(rtol=1e-5, atol=1e-6)

# (id, config overrides, D, hidden, B, K, pad)
VARIANTS = [
    ("minimal", dict(), 2, 9, 17, 20, 2),
    ("impute", dict(impute=True), 2, 9, 24, 20, 2),
    ("full", dict(full_gru_ode=True), 2, 9, 17, 20, 2),
    ("full_impute", dict(full_gru_ode=True, impute=True), 2, 9, 33, 20, 2),
    ("absvar_impute", dict(logvar=False, impute=True), 2, 9, 17, 20, 2),
    ("mid_impute", dict(solver="midpoint", impute=True), 2, 9, 21, 20, 2),
    ("mid", dict(solver="midpoint"), 2, 9, 17, 20, 2),
    ("mid_full_impute_drop", dict(solver="midpoint", full_gru_ode=True,
                                  impute=True, dropout_rate=0.1),
     2, 9, 48, 20, 2),
    ("disc_impute", dict(discretized=True, impute=True), 2, 9, 17, 20, 2),
    ("disc", dict(discretized=True), 2, 9, 19, 20, 2),
    ("impute_drop", dict(impute=True, dropout_rate=0.1), 2, 9, 17, 20, 2),
    ("full_absvar", dict(full_gru_ode=True, logvar=False), 2, 9, 17, 20, 2),
    ("nobias_impute", dict(bias=False, impute=True), 2, 9, 17, 20, 2),
    ("published_h100", dict(full_gru_ode=True, impute=True, mixing=0.5,
                            dropout_rate=0.1), 1, 100, 37, 30, 3),
    ("published_h100_auto", dict(full_gru_ode=True, dropout_rate=0.1),
     1, 100, 20, 30, 0),
    # the climate arm (experiments/configs.py climate_cross_validation):
    # unequal widths at D = 5, impute off, dropout 0.2
    ("climate", dict(full_gru_ode=True, impute=False, p_hidden=25,
                     prep_hidden=10, cov_hidden=50, mixing=1e-4,
                     dropout_rate=0.2), 5, 50, 37, 30, 3),
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _tol(ref):
    return dict(rtol=2e-4, atol=2e-5 * max(1.0, float(ref.abs().max())))


def _setup(variant, dev, seed=0, rows=None):
    _, kw, D, Hd, B, K, pad = variant
    args = dict(input_size=D, hidden_size=Hd, p_hidden=Hd if Hd > 9 else 7,
                prep_hidden=Hd if Hd > 9 else 5, cov_size=D,
                cov_hidden=Hd if Hd > 9 else 6, mixing=1e-2)
    args.update(kw)
    cfg = gob.GOBConfig(**args)
    assert fg.supported(cfg)
    model = gob.GOB(cfg, generator=torch.Generator().manual_seed(seed))
    if not cfg.logvar:
        # keep |var| away from 0: at (X - m)^2 / (|var| + 1e-6) the abs-var
        # loss amplifies rounding a thousandfold, and the comparison would
        # measure that conditioning instead of the kernels' arithmetic
        with torch.no_grad():
            model.p_model[3].bias[D:] += 1.0
    model.to(dev)
    rs = np.random.RandomState(seed)
    paths = rs.lognormal(0.0, 0.3, size=(B, D, K + 1))
    observed = (rs.random((B, K + 1)) < 0.3).astype(np.int64)
    b = grid.recompute_n_obs(grid.batch_from_paths(paths, observed, 1.0 / K))
    m = (rs.random(b.M.shape) < 0.7).astype(np.float32)
    m[..., 0] = 1.0
    M = m * b.obs[:, :, None]
    f32 = np.float32
    b = b._replace(
        times=np.concatenate([b.times, np.ones(pad)]).astype(f32),
        dt=np.concatenate([b.dt, np.zeros(pad)]).astype(f32),
        obs=np.concatenate([b.obs, np.zeros((pad, B))]).astype(f32),
        X=np.concatenate([b.X * M, np.zeros((pad, B, D))]).astype(f32),
        M=np.concatenate([M, np.zeros((pad, B, D))]).astype(f32))
    batch = grid.to_torch(b, dev)
    arrays = (batch.times, batch.dt, batch.obs, batch.X, batch.M)
    spec = fg.Spec(cfg, rows=rows)
    leaves = [p.detach() for p in fg.flat_leaves(model, spec)]
    with torch.no_grad():
        h0 = gob.mlp2(model.covariates_map, batch.start_X, 0.0)
        p0 = gob.mlp2(model.p_model, h0, 0.0)
    m0, v0 = p0[:, :D].contiguous(), p0[:, D:].contiguous()
    return cfg, model, batch, arrays, leaves, (h0, m0, v0)


def _close(name, a, b, tol):
    torch.testing.assert_close(a, b, msg=lambda m: f"{name}: {m}", **tol)


def _masks(spec, mode, K, B, dev):
    gen = torch.Generator(device=dev).manual_seed(1)
    if mode == "input":
        return (torch.rand((K, 3, B, spec.P), generator=gen,
                           device=dev) < 0.9).to(torch.int8), None
    return None, torch.randint(0, 2 ** 62, (1,), generator=gen, device=dev,
                               dtype=torch.int64)


def _check_fwd_bwd(dev, cfg, arrays, leaves, h0, m0, v0, mode, rows=None,
                   weights=None, acts=None, chunk=None):
    spec = fg.Spec(cfg, mode, rows=rows, weights=weights, acts=acts)
    K, B = arrays[2].shape
    u, seed = _masks(spec, mode, K, B, dev)
    lk, hk = fg.gob_scan_fwd_cuda(spec, leaves, arrays, h0, m0, v0, True, u,
                                  seed)
    lk2, hk2 = fg.gob_scan_fwd_cuda(spec, leaves, arrays, h0, m0, v0, True,
                                    u, seed)
    lp, hp = fg.gob_scan_fwd_plain(spec, leaves, arrays, h0, m0, v0, True,
                                   u, seed)
    assert torch.equal(lk, lk2)
    _close("loss", lk, lp, LOSS_TOL)
    for n, a, a2, p in zip(("h", "m", "v"), hk, hk2, hp):
        assert torch.equal(a, a2), n
        _close(n, a, p, _tol(p))
    dloss = torch.tensor(1.3, device=dev)
    out = fg.gob_scan_bwd_cuda(spec, leaves, arrays, True, hk, dloss, u,
                               seed, chunk)
    out2 = fg.gob_scan_bwd_cuda(spec, leaves, arrays, True, hk, dloss, u,
                                seed, chunk)
    ref = fg.gob_scan_bwd_plain(spec, leaves, arrays, True, hk, dloss, u,
                                seed)
    gk, gk2, gp = out[0], out2[0], ref[0]
    tol = _tol(torch.cat([g.reshape(-1) for g in gp]))
    for i, (a, a2, p) in enumerate(zip(gk, gk2, gp)):
        assert torch.equal(a, a2), i
        _close(f"grad {i}", a, p, tol)
    for n, a, a2, p in zip(("dh0", "dm0", "dv0"), out[1:], out2[1:],
                           ref[1:]):
        assert torch.equal(a, a2), n
        _close(n, a, p, _tol(p))
    es = fg.Spec(cfg, "input", rows=rows, weights=weights, acts=acts)
    le = [fg.gob_scan_fwd_cuda(es, leaves, arrays, h0, m0, v0, False,
                               want_hists=False)[0] for _ in range(2)]
    lep, _ = fg.gob_scan_fwd_plain(es, leaves, arrays, h0, m0, v0, False,
                                   want_hists=False)
    assert torch.equal(le[0], le[1])
    _close("eval loss", le[0], lep, LOSS_TOL)


@pytest.mark.parametrize("mode", ["input", "prng"])
@pytest.mark.parametrize("variant", VARIANTS, ids=[v[0] for v in VARIANTS])
def test_fwd_bwd_kernels_match_plain(card, variant, mode):
    """K5 (loss, histories), K6 (leaf grads, dh0, dm0, dv0) and K5's eval
    form against the plain versions at the rows the rule takes, in both
    mask modes, and twice bit for bit."""
    cfg, _, _, arrays, leaves, (h0, m0, v0) = _setup(variant, card)
    _check_fwd_bwd(card, cfg, arrays, leaves, h0, m0, v0, mode)


FORCED = [v for v in VARIANTS if v[0] in (
    "impute_drop", "mid_full_impute_drop", "disc_impute", "full_absvar",
    "climate")]


@pytest.mark.parametrize("rows", [1, 2, 4, 8])
@pytest.mark.parametrize("variant", FORCED, ids=[v[0] for v in FORCED])
def test_forced_rows_match_plain(card, variant, rows):
    """The same checks with the rows per CTA forced (batches of 17-48 rows:
    a ragged last CTA at every R but 1), 'prng' masks."""
    cfg, _, _, arrays, leaves, (h0, m0, v0) = _setup(variant, card,
                                                     rows=rows)
    _check_fwd_bwd(card, cfg, arrays, leaves, h0, m0, v0, "prng", rows)


@pytest.mark.parametrize("rows", [1, 4])
@pytest.mark.parametrize("variant", [VARIANTS[7], VARIANTS[8], VARIANTS[15]],
                         ids=["mid_full_impute_drop", "disc_impute",
                              "climate"])
def test_stages_match_staged_plain(card, variant, rows):
    """K6's stages against their plain version on the kernel's own
    histories: stage (a)'s saved buffers and stage (b)'s deltas in the
    workspace (one chunk of all K steps), buffer by buffer, and stage
    (c)'s gradients; then K split into chunks of 7 steps against the whole
    (launch counts: 3 stages a chunk)."""
    cfg, _, _, arrays, leaves, (h0, m0, v0) = _setup(variant, card)
    spec = fg.Spec(cfg, "input", rows=rows)
    K, B = arrays[2].shape
    u, _ = _masks(spec, "input", K, B, card)
    _, hk = fg.gob_scan_fwd_cuda(spec, leaves, arrays, h0, m0, v0, True, u)
    dloss = torch.tensor(1.3, device=card)
    got = fg.gob_scan_bwd_cuda(spec, leaves, arrays, True, hk, dloss, u,
                               chunk=K, want_ws=True)
    ref = fg.gob_scan_bwd_staged_plain(spec, leaves, arrays, True, hk,
                                       dloss, u, chunk=K, want_ws=True)
    for name in fg.SAVED + tuple(d for d, _ in spec.deltas):
        a = fg.ws_view(spec, got[4], K * B, name)
        p = fg.ws_view(spec, ref[4], K * B, name)
        _close(f"workspace {name}", a, p, _tol(p))
    tol = _tol(torch.cat([g.reshape(-1) for g in ref[0]]))
    for i, (a, p) in enumerate(zip(got[0], ref[0])):
        _close(f"grad {i}", a, p, tol)
    for n, a, p in zip(("dh0", "dm0", "dv0"), got[1:4], ref[1:4]):
        _close(n, a, p, _tol(p))
    before = dict(fg.LAUNCHES)
    chunked = fg.gob_scan_bwd_cuda(spec, leaves, arrays, True, hk, dloss, u,
                                   chunk=7)
    n_chunks = -(-K // 7)
    for key in ("gob_bwd_remat", "gob_scan_bwd", "gob_bwd_wgrad"):
        assert fg.LAUNCHES[key] - before[key] == n_chunks, key
    for i, (a, p) in enumerate(zip(chunked[0], got[0])):
        _close(f"chunked grad {i}", a, p, tol)
    for n, a, p in zip(("dh0", "dm0", "dv0"), chunked[1:], got[1:4]):
        _close(f"chunked {n}", a, p, _tol(p))


@pytest.mark.parametrize("mode", ["input", "prng"])
@pytest.mark.parametrize("variant", [VARIANTS[7], VARIANTS[15]],
                         ids=["mid_full_impute_drop", "climate"])
def test_staged_weights_give_the_same_bits(card, variant, mode):
    """K5, K5's eval form and K6 with every weight staged in shared memory
    and read through L1/L2 give the same bits (the arithmetic is the same;
    only where the loads come from differs), and the global form holds the
    plain versions too."""
    cfg, _, _, arrays, leaves, (h0, m0, v0) = _setup(variant, card)
    K, B = arrays[2].shape
    out = []
    for w in ("shared", "global"):
        spec = fg.Spec(cfg, mode, weights=w)
        assert spec.stage_weights(B, chain=True) == (w == "shared")
        u, seed = _masks(spec, mode, K, B, card)
        lk, hk = fg.gob_scan_fwd_cuda(spec, leaves, arrays, h0, m0, v0, True,
                                      u, seed)
        g = fg.gob_scan_bwd_cuda(spec, leaves, arrays, True, hk,
                                 torch.tensor(1.3, device=card), u, seed)
        le, _ = fg.gob_scan_fwd_cuda(fg.Spec(cfg, "input", weights=w), leaves,
                                     arrays, h0, m0, v0, False,
                                     want_hists=False)
        out.append([lk, *hk, *g[0], *g[1:], le])
    for i, (a, c) in enumerate(zip(*out)):
        assert torch.equal(a, c), i
    _check_fwd_bwd(card, cfg, arrays, leaves, h0, m0, v0, mode,
                   weights="global")


# the widths a CTA of 8 rows cannot hold: D = 1 at widths 200, D = 41 at
# widths 50
WIDE = [
    ("d1_w200", dict(full_gru_ode=True, impute=True, mixing=1e-4,
                     dropout_rate=0.1), 1, 200, 20, 30, 2),
    ("d41_w50", dict(full_gru_ode=True, impute=True, mixing=1e-4,
                     dropout_rate=0.1), 41, 50, 20, 30, 2),
]


@pytest.mark.parametrize("mode", ["input", "prng"])
@pytest.mark.parametrize("variant", WIDE, ids=[v[0] for v in WIDE])
def test_wide_configs_run_through_the_kernels(card, variant, mode):
    """The two wide configurations are ``supported`` now and run through
    the kernels at the rule's rows (and forced to 2): K5, K6 and the eval
    form against the plain versions, bit for bit twice; FusedGOBLoss moves
    the launch counters."""
    cfg, model, batch, arrays, leaves, (h0, m0, v0) = _setup(variant, card)
    assert fg.supported(cfg)
    _check_fwd_bwd(card, cfg, arrays, leaves, h0, m0, v0, mode)
    _check_fwd_bwd(card, cfg, arrays, leaves, h0, m0, v0, mode, rows=2)
    before = dict(fg.LAUNCHES)
    loss = fg.make_fused_loss_fn(cfg, mode)(
        model, batch, torch.Generator(device=card).manual_seed(0), True)
    loss.backward()
    assert fg.LAUNCHES["gob_scan_fwd"] == before["gob_scan_fwd"] + 1
    assert fg.LAUNCHES["gob_scan_bwd"] > before["gob_scan_bwd"]


@pytest.mark.parametrize("variant", VARIANTS, ids=[v[0] for v in VARIANTS])
def test_eval_kernel_matches_plain(card, variant):
    """K5's eval form (no histories, no dropout) against the plain
    forward."""
    cfg, _, _, arrays, leaves, (h0, m0, v0) = _setup(variant, card)
    spec = fg.Spec(cfg, "input")
    lk, none = fg.gob_scan_fwd_cuda(spec, leaves, arrays, h0, m0, v0, False,
                                    want_hists=False)
    lp, _ = fg.gob_scan_fwd_plain(spec, leaves, arrays, h0, m0, v0, False,
                                  want_hists=False)
    assert none is None
    _close("eval loss", lk, lp, LOSS_TOL)


def test_fused_loss_on_card_matches_cpu(card):
    """FusedGOBLoss through the kernels on the card and through the plain
    versions on the CPU, same weights, same Philox seed: the same loss and
    parameter gradients."""
    variant = VARIANTS[7]
    out = []
    for dev in (card, torch.device("cpu")):
        cfg, model, batch, arrays, _, _ = _setup(variant, dev)
        spec = fg.Spec(cfg, "prng")
        seed = torch.tensor([123456789012345], dtype=torch.int64, device=dev)
        h0 = gob.mlp2(model.covariates_map, batch.start_X, 0.0)
        p0 = gob.mlp2(model.p_model, h0, 0.0)
        loss = fg.FusedGOBLoss.apply(
            spec, True, None, seed, *arrays, h0,
            p0[:, :spec.D].contiguous(), p0[:, spec.D:].contiguous(),
            *fg.flat_leaves(model, spec))
        loss.backward()
        out.append((loss.detach().cpu(),
                    [p.grad.cpu() for p in model.parameters()
                     if p.grad is not None]))
    (lc, gc), (lp, gp) = out
    _close("loss", lc, lp, LOSS_TOL)
    for i, (a, b) in enumerate(zip(gc, gp)):
        _close(f"grad {i}", a, b, _tol(b))


@pytest.mark.parametrize("B,P", [(20, 50), (37, 13), (16, 4), (21, 7),
                                 (13, 32), (9, 33), (100, 25)])
def test_gob_masks_match_plain(card, B, P):
    """K7's draw, written out, equals the plain Philox (slots 0-2) at
    widths that are no multiple of 4 (a partial quad, one and two words)
    and at ragged batches."""
    seed = torch.tensor([2 ** 40 + 17], dtype=torch.int64, device=card)
    thresh = min(int(0.9 * 2.0 ** 32), 2 ** 32 - 1)
    got = fg.gob_masks_cuda(seed, 6, B, P, thresh)
    want = fg.gob_masks_plain(int(seed), torch.arange(6, device=card), B, P,
                              thresh, card)
    assert torch.equal(got.bool(), want)


def test_gob_masks_match_plain_over_many_rows(card):
    """K7's draw at the climate GOB arm's grid (K = 2,004, B = 100, P =
    25): more rows than the grid holds at once, so each thread strides
    over rows (the (row, slot, step) it draws for advanced with
    carries)."""
    seed = torch.tensor([2 ** 40 + 17], dtype=torch.int64, device=card)
    thresh = min(int(0.8 * 2.0 ** 32), 2 ** 32 - 1)
    got = fg.gob_masks_cuda(seed, 2004, 100, 25, thresh)
    for k0 in range(0, 2004, 500):
        ks = torch.arange(k0, min(2004, k0 + 500), device=card)
        want = fg.gob_masks_plain(int(seed), ks, 100, 25, thresh, card)
        assert torch.equal(got[k0:k0 + len(ks)].bool(), want), k0


PRNG_INPUT = [v for v in VARIANTS if v[0] in (
    "impute_drop", "mid_full_impute_drop", "published_h100", "climate")]


@pytest.mark.parametrize("rows", [None, 2, 4], ids=["rule", "R2", "R4"])
@pytest.mark.parametrize("variant", PRNG_INPUT,
                         ids=[v[0] for v in PRNG_INPUT])
def test_prng_mode_equals_input_mode_on_its_masks(card, variant, rows):
    """K5 and K6 in 'prng' mode (the mask words K5 and stage (a) fill;
    stage (b) reads the saved activations) give the bits of 'input' mode
    fed with the masks that gob_masks_cuda writes out for the same seed."""
    cfg, _, _, arrays, leaves, (h0, m0, v0) = _setup(variant, card,
                                                     rows=rows)
    sp = fg.Spec(cfg, "prng", rows=rows)
    si = fg.Spec(cfg, "input", rows=rows)
    assert sp.rate > 0
    K, B = arrays[2].shape
    seed = torch.tensor([2 ** 41 + 5], dtype=torch.int64, device=card)
    u = fg.gob_masks_cuda(seed, K, B, sp.P, sp.thresh)
    dloss = torch.tensor(1.3, device=card)
    out = []
    for spec, uu, ss in ((sp, None, seed), (si, u, None)):
        lk, hk = fg.gob_scan_fwd_cuda(spec, leaves, arrays, h0, m0, v0, True,
                                      uu, ss)
        g = fg.gob_scan_bwd_cuda(spec, leaves, arrays, True, hk, dloss, uu,
                                 ss)
        out.append((lk, *hk, *g[0], *g[1:]))
    for i, (a, b) in enumerate(zip(*out)):
        assert torch.equal(a, b), i


def test_wrappers_reject_bad_inputs(card):
    cfg, _, _, arrays, leaves, (h0, m0, v0) = _setup(VARIANTS[10], card)
    spec = fg.Spec(cfg, "prng")
    with pytest.raises(ValueError, match="seed"):
        fg.gob_scan_fwd_cuda(spec, leaves, arrays, h0, m0, v0, True)
    with pytest.raises(ValueError, match="h0"):
        fg.gob_scan_fwd_cuda(spec, leaves, arrays, h0.double(), m0, v0,
                             False, want_hists=False)
    with pytest.raises(ValueError, match="contiguous"):
        fg.gob_scan_fwd_cuda(spec, leaves, arrays, h0.t().contiguous().t(),
                             m0, v0, False, want_hists=False)
    with pytest.warns(UserWarning):
        mid = gob.GOBConfig(1, 9, 7, 5, solver="dopri5", impute=True)
    with pytest.raises(NotImplementedError):
        fg.gob_scan_fwd_cuda(fg.Spec(mid), leaves, arrays, h0, m0, v0,
                             False, want_hists=False)


# the published hidden 50 (impute, full field, dropout 0.1) and the width
# of one row beyond one CTA's shared memory (p_hidden 4,000)
H50 = ("published_h50", dict(full_gru_ode=True, impute=True, mixing=1e-4,
                             dropout_rate=0.1), 1, 50, 20, 30, 2)
P4000 = ("p_hidden_4000", dict(full_gru_ode=True, impute=True, p_hidden=4000,
                               prep_hidden=10, cov_hidden=10, mixing=1e-4,
                               dropout_rate=0.1), 1, 10, 20, 30, 2)


@pytest.mark.parametrize("mode", ["input", "prng"])
@pytest.mark.parametrize("variant", [H50, VARIANTS[7], VARIANTS[15]],
                         ids=["published_h50", "mid_full_impute_drop",
                              "climate"])
def test_device_memory_form_gives_the_same_bits(card, variant, mode):
    """K5, its eval form and K6 with the activations' P-wide buffers in
    each CTA's slab of device memory (``acts='global'``, one row a CTA)
    give the bits of the shared form at one row, and hold the plain
    versions."""
    cfg, _, _, arrays, leaves, (h0, m0, v0) = _setup(variant, card)
    K, B = arrays[2].shape
    out = []
    for acts in ("shared", "global"):
        spec = fg.Spec(cfg, mode, rows=1, acts=acts)
        assert spec.acts_for() == acts
        u, seed = _masks(spec, mode, K, B, card)
        lk, hk = fg.gob_scan_fwd_cuda(spec, leaves, arrays, h0, m0, v0, True,
                                      u, seed)
        g = fg.gob_scan_bwd_cuda(spec, leaves, arrays, True, hk,
                                 torch.tensor(1.3, device=card), u, seed)
        le, _ = fg.gob_scan_fwd_cuda(
            fg.Spec(cfg, "input", rows=1, acts=acts), leaves, arrays, h0,
            m0, v0, False, want_hists=False)
        out.append([lk, *hk, *g[0], *g[1:], le])
    for i, (a, c) in enumerate(zip(*out)):
        assert torch.equal(a, c), i
    _check_fwd_bwd(card, cfg, arrays, leaves, h0, m0, v0, mode, rows=1,
                   acts="global")


@pytest.mark.parametrize("mode", ["input", "prng"])
def test_p_hidden_4000_runs_in_the_device_memory_form(card, mode):
    """p_hidden 4,000 at hidden 10 (one row's buffers overflow one CTA's
    shared memory): the rule takes the device-memory form; K5, K6 (in the
    rule's chunks and in chunks of 7 steps, the carry gradients passed
    between them) and the eval form hold the plain versions, twice bit for
    bit; FusedGOBLoss moves the launch counters."""
    cfg, model, batch, arrays, leaves, (h0, m0, v0) = _setup(P4000, card)
    spec = fg.Spec(cfg)
    assert spec.acts_for() == "global" and spec.rows_for(20) == 1
    _check_fwd_bwd(card, cfg, arrays, leaves, h0, m0, v0, mode)
    _check_fwd_bwd(card, cfg, arrays, leaves, h0, m0, v0, mode, chunk=7)
    before = dict(fg.LAUNCHES)
    loss = fg.make_fused_loss_fn(cfg, mode)(
        model, batch, torch.Generator(device=card).manual_seed(0), True)
    loss.backward()
    n_chunks = -(-arrays[2].shape[0] // spec.bwd_chunk(*arrays[2].shape))
    assert fg.LAUNCHES["gob_scan_fwd"] == before["gob_scan_fwd"] + 1
    assert fg.LAUNCHES["gob_scan_bwd"] == before["gob_scan_bwd"] + n_chunks
