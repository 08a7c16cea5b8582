"""The CUDA kernels of ops/csrc/fused_scan.cu against their plain versions,
on the card, over the configurations ``supported`` admits beyond the main
path: easy loss, ``input_current_t``, relu, deeper and narrower MLPs
(up to 101 linears), an unmasked output of another width than
the input, residual cases 0 and 2, no bias, a batch that is no multiple of
the rows per CTA, and ``dt==0`` padding steps; and the masked branch (the climate
model family): the masked cases of tests/test_fused_scan.py with partial
coordinate masks, ragged batches, trailing ``dt==0`` padding, a leading
``dt==0`` step that carries t=0 observations, the climate widths, and one
grid of K = 2004 steps (the climate grid); the GRU jump (``use_rnn``),
unmasked and masked, with and without bias; and every one of these cases
again in the global plan (weights in device memory, staged through the
ring in shared memory, gradients added into the CTA's partial row) at 16,
4 and 1 rows per CTA, bit for bit what the resident plan gives at the same
rows (the rows rule takes one a CTA at these batches);
the global plan at the PhysioNet 200 and climate 400 arms' widths; and
``reduce_partials`` at three arms' partial shapes, bit for bit its plain
version.

The kernels have no CPU build, so every test here skips without a CUDA
card. This file imports neither jax nor the JAX package; run it on the card
without the suite's conftest (which imports jax):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_fused_scan_card.py

Tolerances are those the Pallas kernel is held to (loss rtol 1e-5 / atol
1e-6, gradients rtol 2e-4 / atol 2e-5); the carry histories take the
gradient tolerance, since the kernel sums each product serially and the
plain version through cuBLAS, and the difference grows over the steps. At
K = 2004 each history and each gradient leaf takes an atol scaled by its
own largest |value| (``LONG_TOL``; chip_smoke.py states the same and says
why).
"""

import numpy as np
import pytest
import torch

from njode_tpu_torch.data import grid
from njode_tpu_torch.models.njode import NJODE, NJODEConfig
from njode_tpu_torch.ops import fused_scan as fs

LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)
T2 = ((24, "tanh"), (24, "tanh"))

# (id, D, H, B, K, pad, config overrides)
VARIANTS = [
    ("main", 1, 10, 48, 30, 0, dict(ode_nn=((50, "tanh"), (50, "tanh")),
                                    readout_nn=((50, "tanh"), (50, "tanh")),
                                    enc_nn=((50, "tanh"), (50, "tanh")))),
    ("easy_ict", 2, 10, 40, 25, 0, dict(which_loss="easy",
                                        input_current_t=True)),
    ("relu_deep", 1, 8, 37, 20, 0, dict(
        ode_nn=((16, "relu"), (12, "tanh"), (20, "relu")),
        readout_nn=((9, "relu"),), enc_nn=((30, "tanh"), (7, "relu")))),
    ("residual_case0_nobias", 2, 10, 33, 20, 0, dict(residual_enc_dec=False,
                                                      bias=False)),
    ("residual_case2", 4, 2, 21, 20, 0, dict()),
    ("padding", 1, 10, 17, 20, 4, dict()),
    ("rnn_main", 1, 10, 48, 30, 0, dict(
        use_rnn=True, ode_nn=((50, "tanh"), (50, "tanh")),
        readout_nn=((50, "tanh"), (50, "tanh")),
        enc_nn=((50, "tanh"), (50, "tanh")))),
    ("rnn_nobias_easy_ict_padding", 2, 10, 37, 20, 3, dict(
        use_rnn=True, bias=False, which_loss="easy", input_current_t=True)),
    # the full scope: an unmasked output of another width than the input
    # (the global plan), and nets of 9 to 101 linears (all three nets of
    # 33 in one)
    ("out1_D2", 2, 10, 40, 25, 0, dict(output_size=1)),
    ("out2_D1_rnn", 1, 10, 37, 20, 0, dict(output_size=2, use_rnn=True)),
    ("easy_out1_D3", 3, 12, 29, 20, 2, dict(output_size=1,
                                            which_loss="easy")),
    ("deep9", 1, 10, 48, 20, 0, dict(ode_nn=((24, "tanh"),) * 8)),
    ("deep16", 2, 10, 33, 20, 2, dict(ode_nn=((12, "tanh"),) * 15,
                                      readout_nn=((10, "relu"),) * 11)),
    ("deep33", 1, 8, 33, 20, 0, dict(ode_nn=((6, "tanh"),) * 32,
                                     enc_nn=((5, "relu"),) * 32,
                                     readout_nn=((6, "tanh"),) * 32)),
    ("deep101", 2, 8, 29, 20, 2,
     dict(ode_nn=((6, "tanh"), (5, "relu")) * 50)),
]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _setup(D, H, B, K, pad, kw, dev, seed=0):
    args = dict(input_size=D, hidden_size=H, output_size=D, ode_nn=T2,
                readout_nn=T2, enc_nn=T2, dropout_rate=0.1)
    args.update(kw)
    cfg = NJODEConfig(**args)
    assert fs.supported(cfg)
    torch.manual_seed(seed)
    model = NJODE(cfg).to(dev)
    rs = np.random.RandomState(seed)
    paths = rs.lognormal(0.0, 0.3, size=(B, D, K + 1))
    observed = (rs.random((B, K + 1)) < 0.3).astype(np.int64)
    b = grid.recompute_n_obs(grid.batch_from_paths(paths, observed, 1.0 / K))
    if pad:
        b = b._replace(
            times=np.concatenate([b.times, np.ones(pad, np.float32)]),
            dt=np.concatenate([b.dt, np.zeros(pad, np.float32)]),
            obs=np.concatenate([b.obs, np.zeros((pad, B), np.float32)]),
            X=np.concatenate([b.X, np.zeros((pad, B, D), np.float32)]),
            M=np.concatenate([b.M, np.zeros((pad, B, D), np.float32)]))
    batch = grid.to_torch(b, dev)
    arrays = (batch.times, batch.dt, batch.obs, batch.X, batch.n_obs_ot,
              batch.start_X)
    leaves = [p.detach() for p in fs.flat_leaves(model)]
    with torch.no_grad():
        h0 = model.encoder_map(batch.start_X)
    return cfg, model, batch, arrays, leaves, h0


def _close(name, a, b, tol):
    torch.testing.assert_close(a, b, msg=lambda m: f"{name}: {m}", **tol)


@pytest.mark.parametrize("mode", ["input", "prng"])
@pytest.mark.parametrize("variant", VARIANTS, ids=[v[0] for v in VARIANTS])
def test_fwd_bwd_kernels_match_plain(card, variant, mode):
    """K1 (loss, histories) and K2 (leaf grads, dh0) against the plain
    versions, in both mask modes, and twice bit for bit."""
    _, D, H, B, K, pad, kw = variant
    cfg, _, _, arrays, leaves, h0 = _setup(D, H, B, K, pad, kw, card)
    spec = fs.Spec(cfg, mode)
    gen = torch.Generator(device=card).manual_seed(1)
    K_all = arrays[2].shape[0]
    u = seed = None
    if mode == "input":
        u = (torch.rand((K_all, spec.S, B, spec.w_max), generator=gen,
                        device=card) < 0.9).to(torch.int8)
    else:
        seed = torch.randint(0, 2 ** 62, (1,), generator=gen, device=card,
                             dtype=torch.int64)
    lk, hk = fs.scan_fwd_cuda(spec, leaves, arrays, 0.6, h0, True, u, seed)
    lk2, hk2 = fs.scan_fwd_cuda(spec, leaves, arrays, 0.6, h0, True, u, seed)
    lp, hp = fs.scan_fwd_plain(spec, leaves, arrays, 0.6, h0, True, u, seed)
    assert torch.equal(lk, lk2)
    _close("loss", lk, lp, LOSS_TOL)
    for n, a, a2, p in zip(("h", "lastX", "tau"), hk, hk2, hp):
        assert torch.equal(a, a2), n
        _close(n, a, p, GRAD_TOL)
    dloss = torch.tensor(1.3, device=card)
    gk, dk = fs.scan_bwd_cuda(spec, leaves, arrays, 0.6, True, hk, dloss, u,
                              seed)
    gk2, dk2 = fs.scan_bwd_cuda(spec, leaves, arrays, 0.6, True, hk, dloss,
                                u, seed)
    gp, dp = fs.scan_bwd_plain(spec, leaves, arrays, 0.6, True, hk, dloss, u,
                               seed)
    assert torch.equal(dk, dk2)
    _close("dh0", dk, dp, GRAD_TOL)
    for i, (a, a2, p) in enumerate(zip(gk, gk2, gp)):
        assert torch.equal(a, a2), i
        _close(f"grad {i}", a, p, GRAD_TOL)


@pytest.mark.parametrize("variant", VARIANTS, ids=[v[0] for v in VARIANTS])
def test_eval_kernel_matches_plain(card, variant):
    """K3 (no histories, no dropout) against the plain forward."""
    _, D, H, B, K, pad, kw = variant
    cfg, _, _, arrays, leaves, h0 = _setup(D, H, B, K, pad, kw, card)
    spec = fs.Spec(cfg, "input")
    lk, none = fs.scan_fwd_cuda(spec, leaves, arrays, 0.6, h0, False,
                                want_hists=False)
    lp, _ = fs.scan_fwd_plain(spec, leaves, arrays, 0.6, h0, False,
                              want_hists=False)
    assert none is None
    _close("eval loss", lk, lp, LOSS_TOL)


def test_fused_loss_on_card_matches_cpu(card):
    """FusedNJODELoss through the kernels on the card and through the plain
    versions on the CPU, same weights, same Philox seed: the same loss and
    parameter gradients."""
    _, D, H, B, K, pad, kw = VARIANTS[1]
    out = []
    for dev in (card, torch.device("cpu")):
        cfg, model, batch, _, _, _ = _setup(D, H, B, K, pad, kw, dev)
        spec = fs.Spec(cfg, "prng")
        seed = torch.tensor([123456789012345], dtype=torch.int64, device=dev)
        h0 = model.encoder_map(batch.start_X)
        loss = fs.FusedNJODELoss.apply(
            spec, True, 0.6, None, seed, batch.times, batch.dt, batch.obs,
            batch.X, batch.n_obs_ot, batch.start_X, None, h0,
            *fs.flat_leaves(model))
        loss.backward()
        out.append((loss.detach().cpu(),
                    [p.grad.cpu() for p in model.parameters()]))
    (lc, gc), (lp, gp) = out
    _close("loss", lc, lp, LOSS_TOL)
    for i, (a, b) in enumerate(zip(gc, gp)):
        _close(f"grad {i}", a, b, GRAD_TOL)


@pytest.mark.parametrize("S,B,W", [(8, 200, 50), (3, 37, 13), (5, 16, 4),
                                   (3, 21, 7), (5, 13, 32), (7, 9, 33),
                                   (8, 50, 400)])
def test_philox_masks_match_plain(card, S, B, W):
    """K4's draw, written out, equals the plain Philox at widths that are
    no multiple of 4 (a partial quad, one, two and thirteen words) and at
    ragged batches."""
    seed = torch.tensor([2 ** 40 + 17], dtype=torch.int64, device=card)
    thresh = min(int(0.9 * 2.0 ** 32), 2 ** 32 - 1)
    got = fs.philox_masks_cuda(seed, 6, S, B, W, thresh)
    want = fs.philox_keep_plain(int(seed), torch.arange(6, device=card), S,
                                B, W, thresh, card)
    assert torch.equal(got.bool(), want)


@pytest.mark.parametrize("K,S,B,W", [(100, 8, 200, 50), (3006, 8, 50, 50)],
                         ids=["main_path", "physionet_50"])
def test_philox_masks_match_plain_over_many_rows(card, K, S, B, W):
    """K4's draw at the main path's shape and the PhysioNet 50 arm's grid:
    more rows than the grid holds at once, so each thread strides over
    rows (the (row, slot, step) it draws for advanced with carries)."""
    seed = torch.tensor([2 ** 40 + 17], dtype=torch.int64, device=card)
    thresh = min(int(0.9 * 2.0 ** 32), 2 ** 32 - 1)
    got = fs.philox_masks_cuda(seed, K, S, B, W, thresh)
    for k0 in range(0, K, 500):
        ks = torch.arange(k0, min(K, k0 + 500), device=card)
        want = fs.philox_keep_plain(int(seed), ks, S, B, W, thresh, card)
        assert torch.equal(got[k0:k0 + len(ks)].bool(), want), k0


def test_wrappers_reject_bad_inputs(card):
    cfg, _, _, arrays, leaves, h0 = _setup(1, 10, 16, 10, 0, {}, card)
    spec = fs.Spec(cfg, "prng")
    with pytest.raises(ValueError, match="seed"):
        fs.scan_fwd_cuda(spec, leaves, arrays, 0.6, h0, True, None, None)
    with pytest.raises(ValueError, match="h0"):
        fs.scan_fwd_cuda(spec, leaves, arrays, 0.6, h0.double(), False,
                         want_hists=False)
    with pytest.raises(ValueError, match="contiguous"):
        fs.scan_fwd_cuda(spec, leaves, arrays, 0.6, h0.t().contiguous().t(),
                         False, want_hists=False)


# K = 2004: the loss keeps its tolerance; the histories and gradients,
# sums over up to 2004 fp32 steps, take rtol 2e-4 and an atol of 2e-5
# scaled by the largest |value| (None below), as chip_smoke.py states


def _scaled(ref):
    return dict(rtol=2e-4, atol=2e-5 * max(1.0, float(ref.abs().max())))


LONG_TOL = dict(loss=LOSS_TOL, hist=None, grad=None)

# (id, D, H, B, K, trailing pad, leading t=0 step, config overrides)
MASKED_VARIANTS = [
    ("masked", 3, 12, 48, 30, 0, False, dict(dropout_rate=0.0)),
    ("masked_easy", 3, 12, 40, 25, 0, False, dict(which_loss="easy")),
    ("masked_no_residual", 3, 12, 33, 20, 0, False,
     dict(residual_enc_dec=False)),
    ("masked_dropout_ragged", 3, 12, 17, 20, 0, False, dict()),
    ("masked_ict", 3, 12, 21, 20, 0, False, dict(input_current_t=True)),
    ("masked_padding", 3, 12, 19, 20, 4, False, dict()),
    ("masked_t0_step", 3, 12, 29, 20, 2, True, dict(input_current_t=True)),
    ("masked_climate_widths", 5, 10, 37, 30, 0, False,
     dict(ode_nn=((50, "tanh"), (50, "tanh")),
          readout_nn=((50, "tanh"), (50, "tanh")),
          enc_nn=((50, "tanh"), (50, "tanh")))),
    ("masked_rnn_t0_step", 3, 12, 29, 20, 2, True,
     dict(use_rnn=True, input_current_t=True)),
    ("masked_rnn_nobias_climate_widths", 5, 10, 37, 30, 0, False,
     dict(use_rnn=True, bias=False, ode_nn=((50, "tanh"), (50, "tanh")),
          readout_nn=((50, "tanh"), (50, "tanh")),
          enc_nn=((50, "tanh"), (50, "tanh")))),
    ("masked_deep33", 3, 12, 21, 20, 0, False,
     dict(ode_nn=((6, "tanh"),) * 32, readout_nn=((5, "tanh"),) * 32)),
    ("masked_rnn_deep17", 3, 12, 29, 20, 0, False,
     dict(use_rnn=True, ode_nn=((8, "relu"),) * 16)),
]


def _masked_setup(D, H, B, K, pad, lead0, kw, dev, seed=0):
    """A masked model and a batch with partial coordinate masks (X zero
    where unobserved), ``pad`` trailing dt==0 steps and, with ``lead0``, a
    leading dt==0 step at t=0 that carries observations."""
    args = dict(input_size=D, hidden_size=H, output_size=D, ode_nn=T2,
                readout_nn=T2, enc_nn=T2, dropout_rate=0.1, masked=True)
    args.update(kw)
    cfg = NJODEConfig(**args)
    assert fs.supported(cfg)
    torch.manual_seed(seed)
    model = NJODE(cfg).to(dev)
    rs = np.random.RandomState(seed)
    f32 = np.float32
    obs = (rs.random((K, B)) < 0.3).astype(f32)
    m = (rs.random((K, B, D)) < 0.6).astype(f32)
    m[..., 0] = 1.0
    M = m * obs[:, :, None]
    X = rs.normal(size=(K, B, D)).astype(f32) * M
    times = np.arange(1, K + 1, dtype=f32) / K
    dt = np.full(K, 1.0 / K, f32)
    if lead0:
        times = np.concatenate([[0.0], times]).astype(f32)
        dt = np.concatenate([[0.0], dt]).astype(f32)
        obs = np.concatenate([np.ones((1, B), f32), obs])
        M = np.concatenate([np.ones((1, B, D), f32), M])
        X = np.concatenate([rs.normal(size=(1, B, D)).astype(f32), X])
    if pad:
        times = np.concatenate([times, np.full(pad, times[-1], f32)])
        dt = np.concatenate([dt, np.zeros(pad, f32)])
        obs = np.concatenate([obs, np.zeros((pad, B), f32)])
        M = np.concatenate([M, np.zeros((pad, B, D), f32)])
        X = np.concatenate([X, np.zeros((pad, B, D), f32)])
    b = grid.GridBatch(times, dt, obs, X, M, np.zeros((B, D), f32),
                       obs.sum(axis=0))
    batch = grid.to_torch(b, dev)
    arrays = fs.batch_arrays(batch)
    leaves = [p.detach() for p in fs.flat_leaves(model)]
    with torch.no_grad():
        h0 = fs.t0_state(model, batch)
    return cfg, model, batch, arrays, leaves, h0


def _check_masked(card, cfg, arrays, leaves, h0, mode, tol, plan=None):
    """K1 and K2 twice bit for bit and against the plain versions, and K3
    against the plain eval forward, in ``plan`` (None: the spec's own);
    returns the largest errors and, under "bits", every kernel output."""
    spec = fs.Spec(cfg, mode, plan)
    K, B = arrays[2].shape
    gen = torch.Generator(device=card).manual_seed(1)
    u = seed = None
    if spec.rate > 0 and mode == "input":
        u = (torch.rand((K, spec.S, B, spec.w_max), generator=gen,
                        device=card) < 0.9).to(torch.int8)
    elif spec.rate > 0:
        seed = torch.randint(0, 2 ** 62, (1,), generator=gen, device=card,
                             dtype=torch.int64)
    lk, hk = fs.scan_fwd_cuda(spec, leaves, arrays, 0.6, h0, True, u, seed)
    lk2, hk2 = fs.scan_fwd_cuda(spec, leaves, arrays, 0.6, h0, True, u, seed)
    lp, hp = fs.scan_fwd_plain(spec, leaves, arrays, 0.6, h0, True, u, seed)
    assert torch.equal(lk, lk2)
    _close("loss", lk, lp, tol["loss"])
    errs = {"loss": float((lk - lp).abs())}
    for n, a, a2, p in zip(("h", "lastX", "tau"), hk, hk2, hp):
        assert torch.equal(a, a2), n
        _close(n, a, p, tol["hist"] or _scaled(p))
    errs["hist"] = max(float((a - p).abs().max()) for a, p in zip(hk, hp))
    dloss = torch.tensor(1.3, device=card)
    gk, dk = fs.scan_bwd_cuda(spec, leaves, arrays, 0.6, True, hk, dloss, u,
                              seed)
    gk2, dk2 = fs.scan_bwd_cuda(spec, leaves, arrays, 0.6, True, hk, dloss,
                                u, seed)
    gp, dp = fs.scan_bwd_plain(spec, leaves, arrays, 0.6, True, hk, dloss, u,
                               seed)
    assert torch.equal(dk, dk2)
    _close("dh0", dk, dp, tol["grad"] or _scaled(dp))
    for i, (a, a2, p) in enumerate(zip(gk, gk2, gp)):
        assert torch.equal(a, a2), i
        _close(f"grad {i}", a, p, tol["grad"] or _scaled(p))
    errs["grad"] = max(float((a - p).abs().max()) for a, p in zip(gk, gp))
    errs["grad_rel"] = max(float((a - p).abs().max() / p.abs().max())
                           for a, p in zip(gk, gp))
    spec3 = fs.Spec(cfg, "input", plan)
    l3 = fs.scan_fwd_cuda(spec3, leaves, arrays, 0.6, h0, False,
                          want_hists=False)[0]
    l3b = fs.scan_fwd_cuda(spec3, leaves, arrays, 0.6, h0, False,
                           want_hists=False)[0]
    l3p, _ = fs.scan_fwd_plain(spec3, leaves, arrays, 0.6, h0, False,
                               want_hists=False)
    assert torch.equal(l3, l3b)
    _close("eval loss", l3, l3p, tol["loss"])
    errs["eval"] = float((l3 - l3p).abs())
    errs["bits"] = (lk, *hk, *gk, dk, l3)
    return errs


@pytest.mark.parametrize("mode", ["input", "prng"])
@pytest.mark.parametrize("variant", MASKED_VARIANTS,
                         ids=[v[0] for v in MASKED_VARIANTS])
def test_masked_kernels_match_plain(card, variant, mode):
    """The masked branch of K1, K2 and K3 against the plain versions, in
    both mask modes, each kernel twice bit for bit."""
    _, D, H, B, K, pad, lead0, kw = variant
    cfg, _, _, arrays, leaves, h0 = _masked_setup(D, H, B, K, pad, lead0, kw,
                                                  card)
    _check_masked(card, cfg, arrays, leaves, h0, mode,
                  dict(loss=LOSS_TOL, hist=GRAD_TOL, grad=GRAD_TOL))


def test_masked_kernels_climate_grid(card):
    """The climate widths over a grid of K = 2004 steps with 4 trailing
    dt==0 steps, 'prng' masks, against the plain versions at
    ``LONG_TOL``."""
    nn = ((50, "tanh"), (50, "tanh"))
    cfg, _, _, arrays, leaves, h0 = _masked_setup(
        5, 10, 20, 2000, 4, False,
        dict(ode_nn=nn, readout_nn=nn, enc_nn=nn), card)
    errs = _check_masked(card, cfg, arrays, leaves, h0, "prng", LONG_TOL)
    print("K=2004 errors:", {k: f"{v:.3e}" for k, v in errs.items()
                             if k != "bits"})


def test_masked_fused_loss_on_card_matches_cpu(card):
    """The masked training loss through ``make_fused_loss_fn`` on the card
    (the t=0 encoder with the zero mask and dropout, then the kernels)
    against the same composition through the plain versions on the CPU,
    given the encoder keep-masks and the Philox seed the wrapper drew: the
    same loss and parameter gradients."""
    _, D, H, B, K, pad, lead0, kw = MASKED_VARIANTS[6]
    cfg, model, batch, _, _, _ = _masked_setup(D, H, B, K, pad, lead0, kw,
                                               card)
    loss_fn = fs.make_fused_loss_fn(cfg, mask_mode="prng")
    loss = loss_fn(model, batch, 0.6,
                   torch.Generator(device=card).manual_seed(5), True)
    loss.backward()
    # the wrapper's draws, replayed from the same generator state
    spec = fs.Spec(cfg, "prng")
    gen = torch.Generator(device=card).manual_seed(5)
    u0 = torch.rand((spec.n_enc, B, spec.w_max), generator=gen,
                    device=card) < 1.0 - spec.rate
    seed = torch.randint(0, 2 ** 62, (1,), generator=gen, device=card,
                         dtype=torch.int64)
    assert spec.n_enc > 0 and not bool(u0.all())
    cpu = torch.device("cpu")
    _, model_c, batch_c, _, _, _ = _masked_setup(D, H, B, K, pad, lead0, kw,
                                                 cpu)
    h0 = fs.t0_state(model_c, batch_c, list(u0.to(cpu)))
    loss_c = fs.FusedNJODELoss.apply(
        spec, True, 0.6, None, seed.to(cpu), batch_c.times, batch_c.dt,
        batch_c.obs, batch_c.X, batch_c.n_obs_ot, batch_c.start_X,
        batch_c.M, h0, *fs.flat_leaves(model_c))
    loss_c.backward()
    _close("loss", loss.detach().cpu(), loss_c.detach(), LOSS_TOL)
    for i, (a, b) in enumerate(zip(model.parameters(),
                                   model_c.parameters())):
        _close(f"grad {i}", a.grad.cpu(), b.grad, GRAD_TOL)


GLOBAL_PLANS = [("global", 16), ("global", 4), ("global", 1)]


def _case(variant, dev):
    """``(cfg, arrays, leaves, h0)`` of a VARIANTS or MASKED_VARIANTS
    entry."""
    if len(variant) == 7:
        _, D, H, B, K, pad, kw = variant
        cfg, _, _, arrays, leaves, h0 = _setup(D, H, B, K, pad, kw, dev)
    else:
        _, D, H, B, K, pad, lead0, kw = variant
        cfg, _, _, arrays, leaves, h0 = _masked_setup(D, H, B, K, pad, lead0,
                                                      kw, dev)
    return cfg, arrays, leaves, h0


@pytest.mark.parametrize("plan", GLOBAL_PLANS,
                         ids=["global16", "global4", "global1"])
@pytest.mark.parametrize("mode", ["input", "prng"])
@pytest.mark.parametrize("variant", VARIANTS + MASKED_VARIANTS,
                         ids=[v[0] for v in VARIANTS + MASKED_VARIANTS])
def test_global_plan_matches_plain(card, variant, mode, plan):
    """K1, K2 and K3 in the global plan against the plain versions, in both
    mask modes, each kernel twice bit for bit; at one R the global plan
    sums in the resident plan's order, so every output is the same bits
    as the resident plan's forced at the same rows (at 1, the rule's;
    where the resident plan does not fit those rows, both at the most it
    fits: the loss's sum over a CTA's rows depends on the rows a CTA). An
    output of another width than the input has the global plan alone."""
    cfg, arrays, leaves, h0 = _case(variant, card)
    spec = fs.Spec(cfg)
    both = cfg.output_size == cfg.input_size
    assert spec.plan == ("resident" if both else "global")
    tol = dict(loss=LOSS_TOL, hist=GRAD_TOL, grad=GRAD_TOL)
    got = _check_masked(card, cfg, arrays, leaves, h0, mode, tol, plan)
    if not both:
        return
    if not spec.fits("resident", plan[1]):
        got = _check_masked(card, cfg, arrays, leaves, h0, mode, tol,
                            ("global", spec.rows))
    ref = _check_masked(card, cfg, arrays, leaves, h0, mode, tol,
                        ("resident", min(plan[1], spec.rows)))
    for i, (a, b) in enumerate(zip(got["bits"], ref["bits"])):
        assert torch.equal(a, b), i
    if plan[1] == 1:
        assert spec.rows_for(arrays[2].shape[1]) == 1


# the published arms the global plan takes at fewer rows (PhysioNet 200:
# D = H = 41, width 200, 8 rows; climate 400: D 5, H 50, width 400, 4
# rows), on a short grid: each product split into several ring tiles
WIDE_ARMS = [("physionet_200", 41, 41, 200, 8), ("climate_400", 5, 50, 400, 4)]


@pytest.mark.parametrize("mode", ["input", "prng"])
@pytest.mark.parametrize("arm", WIDE_ARMS, ids=[a[0] for a in WIDE_ARMS])
def test_global_plan_wide_arms(card, arm, mode):
    """K1, K2 and K3 of the global plan at the wide arms' widths against
    the plain versions, each kernel twice bit for bit."""
    _, D, H, width, rows = arm
    nn = ((width, "tanh"), (width, "tanh"))
    cfg, _, _, arrays, leaves, h0 = _masked_setup(
        D, H, 20, 12, 0, False, dict(ode_nn=nn, readout_nn=nn, enc_nn=nn),
        card)
    spec = fs.Spec(cfg)
    assert (spec.plan, spec.rows) == ("global", rows)
    assert spec.tile_program()[1] > 12          # split products
    _check_masked(card, cfg, arrays, leaves, h0, mode,
                  dict(loss=LOSS_TOL, hist=GRAD_TOL, grad=GRAD_TOL))


@pytest.mark.parametrize("shape", [(13, 10071), (4, 24423), (25, 571305)],
                         ids=["main_path", "phys50", "climate400"])
def test_reduce_partials_bit_equal(card, shape):
    """reduce_partials at the partials of the main path, the PhysioNet 50
    arm and the climate 400 arm: the plain version's bits, run after
    run."""
    n_parts, n = shape
    gen = torch.Generator(device=card).manual_seed(2)
    P = torch.randn((n_parts, n), generator=gen, device=card)
    got = fs.reduce_partials_cuda(P, 0.37)
    assert torch.equal(got, fs.reduce_partials_plain(P, 0.37))
    assert torch.equal(got, fs.reduce_partials_cuda(P, 0.37))


# (D, H, width, masked, use_rnn, batch): the resident arms at their
# published batches and the eval's
OCC_ARMS = [(1, 10, 50, False, False, 200), (1, 10, 50, False, False, 4000),
            (1, 10, 50, False, True, 200), (5, 10, 50, True, False, 100),
            (41, 41, 50, True, False, 50)]


@pytest.mark.parametrize("arm", OCC_ARMS,
                         ids=["main", "main_eval", "main_rnn", "climate",
                              "physionet_50"])
def test_rows_rule_against_occupancy(card, arm):
    """The CTAs an SM holds that ``Spec.rows_for`` counts, for K1, K3 and
    K2 at the rows it takes, are at most what
    cudaOccupancyMaxActiveBlocksPerMultiprocessor reports for the kernel
    the launch takes, so a launch the rule sees on one wave is on one."""
    import ctypes

    D, H, width, masked, use_rnn, B = arm
    nn = ((width, "tanh"), (width, "tanh"))
    cfg = NJODEConfig(D, H, D, nn, nn, nn, dropout_rate=0.1, masked=masked,
                      use_rnn=use_rnn)
    spec = fs.Spec(cfg)
    lib = fs._lib()
    for kind, bwd, train in ((0, False, True), (1, False, False),
                             (2, True, True)):
        c = fs.make_cfg(spec, 100, B, train, 0.5, bwd=bwd)
        n = ctypes.c_int(0)
        assert lib.njode_scan_occupancy(ctypes.addressof(c), kind,
                                        ctypes.byref(n)) == 0
        assert n.value >= spec.ctas_per_sm(c.rows, bwd) >= 1, (kind, n)
        if -(-B // c.rows) <= spec.ctas_per_sm(c.rows, bwd) * fs.N_SM:
            assert -(-B // c.rows) <= n.value * fs.N_SM


PRNG_INPUT = ([v for v in VARIANTS if v[0] in ("main", "relu_deep",
                                              "rnn_main")]
              + [v for v in MASKED_VARIANTS if v[0] in (
                  "masked_dropout_ragged", "masked_climate_widths",
                  "masked_rnn_t0_step")])


@pytest.mark.parametrize("plan", [None, ("resident", 16), ("global", 16),
                                  ("global", 1)],
                         ids=["rule", "resident16", "global16", "global1"])
@pytest.mark.parametrize("variant", PRNG_INPUT,
                         ids=[v[0] for v in PRNG_INPUT])
def test_prng_mode_equals_input_mode_on_its_masks(card, variant, plan):
    """K1 and K2 in 'prng' mode (the mask words each kernel fills as it
    runs) give the bits of 'input' mode fed with the masks that
    philox_masks_cuda writes out for the same seed: unmasked and masked,
    the encoder and the GRU jump, nets of unequal widths, both plans."""
    cfg, arrays, leaves, h0 = _case(variant, card)
    sp, si = fs.Spec(cfg, "prng", plan), fs.Spec(cfg, "input", plan)
    assert sp.rate > 0
    K, B = arrays[2].shape
    seed = torch.tensor([2 ** 41 + 5], dtype=torch.int64, device=card)
    u = fs.philox_masks_cuda(seed, K, sp.S, B, sp.w_max, sp.thresh)
    dloss = torch.tensor(1.3, device=card)
    out = []
    for spec, uu, ss in ((sp, None, seed), (si, u, None)):
        lk, hk = fs.scan_fwd_cuda(spec, leaves, arrays, 0.6, h0, True, uu,
                                  ss)
        gk, dk = fs.scan_bwd_cuda(spec, leaves, arrays, 0.6, True, hk, dloss,
                                  uu, ss)
        out.append((lk, *hk, *gk, dk))
    for i, (a, b) in enumerate(zip(*out)):
        assert torch.equal(a, b), i
