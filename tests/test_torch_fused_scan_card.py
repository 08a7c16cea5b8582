"""The CUDA kernels of ops/csrc/fused_scan.cu against their plain versions,
on the card, over the configurations ``supported`` admits beyond the main
path: easy loss, ``input_current_t``, relu, deeper and narrower MLPs,
residual cases 0 and 2, no bias, a batch that is no multiple of the rows
per CTA, and ``dt==0`` padding steps.

The kernels have no CPU build, so every test here skips without a CUDA
card. This file imports neither jax nor the JAX package; run it on the card
without the suite's conftest (which imports jax):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_fused_scan_card.py

Tolerances are those the Pallas kernel is held to (loss rtol 1e-5 / atol
1e-6, gradients rtol 2e-4 / atol 2e-5); the carry histories take the
gradient tolerance, since the kernel sums each product serially and the
plain version through cuBLAS, and the difference grows over the steps.
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
            batch.X, batch.n_obs_ot, batch.start_X, h0,
            *fs.flat_leaves(model))
        loss.backward()
        out.append((loss.detach().cpu(),
                    [p.grad.cpu() for p in model.parameters()]))
    (lc, gc), (lp, gp) = out
    _close("loss", lc, lp, LOSS_TOL)
    for i, (a, b) in enumerate(zip(gc, gp)):
        _close(f"grad {i}", a, b, GRAD_TOL)


@pytest.mark.parametrize("S,B,W", [(8, 200, 50), (3, 37, 13), (5, 16, 4)])
def test_philox_masks_match_plain(card, S, B, W):
    """K4's draw, written out, equals the plain Philox at widths that are
    no multiple of 4 and at ragged batches."""
    seed = torch.tensor([2 ** 40 + 17], dtype=torch.int64, device=card)
    thresh = min(int(0.9 * 2.0 ** 32), 2 ** 32 - 1)
    got = fs.philox_masks_cuda(seed, 6, S, B, W, thresh)
    want = fs.philox_keep_plain(int(seed), torch.arange(6, device=card), S,
                                B, W, thresh, card)
    assert torch.equal(got.bool(), want)


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
