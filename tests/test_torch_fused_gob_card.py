"""The GRU-ODE-Bayes CUDA kernels of ops/csrc/fused_gob.cu (K5, K6, K7)
against their plain versions, on the card, over the 13 configurations the
kernels cover (minimal and full field, impute on and off, logvar and
abs-var, euler and midpoint, the discretized cell, bias on and off,
dropout), the published width hidden 100, batches that are no multiple of
the rows per CTA (B = 17-48), ``dt==0`` padding steps, partial coordinate
masks (D = 2) and both mask modes.

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


def _setup(variant, dev, seed=0):
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
    spec = fg.Spec(cfg)
    leaves = [p.detach() for p in fg.flat_leaves(model, spec)]
    with torch.no_grad():
        h0 = gob.mlp2(model.covariates_map, batch.start_X, 0.0)
        p0 = gob.mlp2(model.p_model, h0, 0.0)
    m0, v0 = p0[:, :D].contiguous(), p0[:, D:].contiguous()
    return cfg, model, batch, arrays, leaves, (h0, m0, v0)


def _close(name, a, b, tol):
    torch.testing.assert_close(a, b, msg=lambda m: f"{name}: {m}", **tol)


@pytest.mark.parametrize("mode", ["input", "prng"])
@pytest.mark.parametrize("variant", VARIANTS, ids=[v[0] for v in VARIANTS])
def test_fwd_bwd_kernels_match_plain(card, variant, mode):
    """K5 (loss, histories) and K6 (leaf grads, dh0, dm0, dv0) against the
    plain versions, in both mask modes, and twice bit for bit."""
    cfg, _, _, arrays, leaves, (h0, m0, v0) = _setup(variant, card)
    spec = fg.Spec(cfg, mode)
    K, B = arrays[2].shape
    gen = torch.Generator(device=card).manual_seed(1)
    u = seed = None
    if mode == "input":
        u = (torch.rand((K, 3, B, spec.P), generator=gen,
                        device=card) < 0.9).to(torch.int8)
    else:
        seed = torch.randint(0, 2 ** 62, (1,), generator=gen, device=card,
                             dtype=torch.int64)
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
    dloss = torch.tensor(1.3, device=card)
    out = fg.gob_scan_bwd_cuda(spec, leaves, arrays, True, hk, dloss, u,
                               seed)
    out2 = fg.gob_scan_bwd_cuda(spec, leaves, arrays, True, hk, dloss, u,
                                seed)
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


@pytest.mark.parametrize("B,P", [(20, 50), (37, 13), (16, 4)])
def test_gob_masks_match_plain(card, B, P):
    """K7's draw, written out, equals the plain Philox (slots 0-2) at
    widths that are no multiple of 4 and at ragged batches."""
    seed = torch.tensor([2 ** 40 + 17], dtype=torch.int64, device=card)
    thresh = min(int(0.9 * 2.0 ** 32), 2 ** 32 - 1)
    got = fg.gob_masks_cuda(seed, 6, B, P, thresh)
    want = fg.gob_masks_plain(int(seed), torch.arange(6, device=card), B, P,
                              thresh, card)
    assert torch.equal(got.bool(), want)


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
