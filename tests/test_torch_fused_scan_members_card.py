"""K1 and K2 over a member axis (ops/csrc/fused_scan.cu
``njode_scan_fwd_members`` / ``njode_scan_bwd_members``: the E members of
a grouped ensemble in one launch of grid (ceil(B/R), E)) on the card: over
the cases of tests/test_torch_fused_scan_card.py (unmasked and masked,
encoder and GRU jump, in the rule's plan and forced into the global plan),
each member's loss, histories, gradients and dh0 bit for bit those of its
own solo launch at the same rows, and within the North-star tolerances of
the member plain version; the member ``reduce_partials`` bit for bit its
plain version; ``make_fused_members_loss_fn`` giving each model the loss
and gradients of ``make_fused_loss_fn`` with the same generator.

The kernels have no CPU build, so every test here skips without a CUDA
card. This file imports neither jax nor the JAX package; run it on the card
without the suite's conftest (which imports jax):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_fused_scan_members_card.py
"""

import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import test_torch_fused_scan_card as C  # noqa: E402

from njode_tpu_torch.ops import fused_scan as fs  # noqa: E402

E = 3
CASES = C.VARIANTS + C.MASKED_VARIANTS
PLANS = [None, ("global", 16), ("global", 1)]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU build")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _members(variant, dev):
    """E members of one case, each its own weights and batch (seeds 0..E-1;
    one grid), in the member layout, and each member's solo inputs."""
    solo = []
    for e in range(E):
        if len(variant) == 7:
            _, D, H, B, K, pad, kw = variant
            cfg, _, batch, _, leaves, h0 = C._setup(D, H, B, K, pad, kw, dev,
                                                    seed=e)
        else:
            _, D, H, B, K, pad, lead0, kw = variant
            cfg, _, batch, _, leaves, h0 = C._masked_setup(
                D, H, B, K, pad, lead0, kw, dev, seed=e)
        solo.append((fs.batch_arrays(batch), leaves, h0))
    leaves = [torch.stack(ls) for ls in zip(*(s[1] for s in solo))]
    arrays = tuple(solo[0][0][i] if i < 2 else
                   torch.stack([s[0][i] for s in solo]).contiguous()
                   for i in range(7))
    h0 = torch.stack([s[2] for s in solo])
    return cfg, arrays, leaves, h0, solo


def _draws(spec, K, B, mode, dev):
    gen = torch.Generator(device=dev).manual_seed(1)
    if not spec.rate > 0:
        return None, None
    if mode == "input":
        return (torch.rand((E, K, spec.S, B, spec.w_max), generator=gen,
                           device=dev) < 0.9).to(torch.int8), None
    return None, torch.randint(0, 2 ** 62, (E,), generator=gen, device=dev,
                               dtype=torch.int64)


@pytest.mark.parametrize("plan", PLANS, ids=["rule", "global16", "global1"])
@pytest.mark.parametrize("mode", ["input", "prng"])
@pytest.mark.parametrize("variant", CASES, ids=[v[0] for v in CASES])
def test_members_match_solo_launches_and_plain(card, variant, mode, plan):
    cfg, arrays, leaves, h0, solo = _members(variant, card)
    spec = fs.Spec(cfg, mode, plan)
    E_, K, B = arrays[2].shape
    u, seed = _draws(spec, K, B, mode, card)
    fs.reset_launch_counts()
    lk, hk = fs.scan_fwd_members_cuda(spec, leaves, arrays, 0.6, h0, True,
                                      u, seed)
    dloss = torch.tensor([1.3, 0.7, 2.1], device=card)
    gk, dk = fs.scan_bwd_members_cuda(spec, leaves, arrays, 0.6, True, hk,
                                      dloss, u, seed)
    key = fs._launch_key(spec)
    assert fs.LAUNCHES["njode_scan_fwd_members" + key] == 1
    assert fs.LAUNCHES["njode_scan_bwd_members" + key] == 1
    assert fs.LAUNCHES["reduce_partials_members"] == 2
    # each member: its own solo launch's bits
    for e, (arr, lv, h0e) in enumerate(solo):
        ue = None if u is None else u[e].contiguous()
        se = None if seed is None else seed[e:e + 1]
        ls, hs = fs.scan_fwd_cuda(spec, lv, arr, 0.6, h0e, True, ue, se)
        gs, ds = fs.scan_bwd_cuda(spec, lv, arr, 0.6, True, hs, dloss[e],
                                  ue, se)
        assert torch.equal(lk[e], ls), e
        for n, a, b in zip(("h", "lastX", "tau"), hk, hs):
            assert torch.equal(a[e], b), (e, n)
        for i, (a, b) in enumerate(zip(gk, gs)):
            assert torch.equal(a[e], b), (e, i)
        assert torch.equal(dk[e], ds), e
    # against the member plain version
    long = K > 100
    lp, hp = fs.scan_fwd_members_plain(spec, leaves, arrays, 0.6, h0, True,
                                       u, seed)
    C._close("loss", lk, lp, C.LOSS_TOL)
    for n, a, p in zip(("h", "lastX", "tau"), hk, hp):
        C._close(n, a, p, C._scaled(p) if long else C.GRAD_TOL)
    gp, dp = fs.scan_bwd_members_plain(spec, leaves, arrays, 0.6, True, hk,
                                       dloss, u, seed)
    C._close("dh0", dk, dp, C.GRAD_TOL)
    for i, (a, p) in enumerate(zip(gk, gp)):
        C._close(f"grad {i}", a, p, C._scaled(p) if long else C.GRAD_TOL)


@pytest.mark.parametrize("shape", [(5, 13, 10071), (3, 4, 24423),
                                   (5, 100, 10071), (2, 25, 571305)],
                         ids=["main16", "phys16", "main1", "climate400"])
def test_reduce_partials_members_bit_equal(card, shape):
    gen = torch.Generator(device=card).manual_seed(7)
    P = torch.randn(shape, generator=gen, device=card)
    r1 = fs.reduce_partials_members_cuda(P)
    r2 = fs.reduce_partials_members_cuda(P)
    assert torch.equal(r1, r2)
    assert torch.equal(r1, fs.reduce_partials_members_plain(P))
    for e in range(shape[0]):
        assert torch.equal(r1[e], fs.reduce_partials_cuda(P[e]))


@pytest.mark.parametrize("mode", ["input", "prng"])
@pytest.mark.parametrize("variant", [C.VARIANTS[0], C.VARIANTS[6],
                                     C.MASKED_VARIANTS[3]],
                         ids=["main", "rnn_main", "masked_dropout_ragged"])
def test_members_loss_fn_equals_solo_loss_fn(card, variant, mode):
    """The group step's loss (one member-axis launch of K1 and of K2 for
    the E models) gives each model the loss and the gradients of a solo
    step through ``make_fused_loss_fn`` with the same generator seed, bit
    for bit."""
    from njode_tpu_torch.models.njode import NJODE

    def models_and_batches():
        out = []
        for e in range(E):
            if len(variant) == 7:
                _, D, H, B, K, pad, kw = variant
                cfg, _, batch, _, _, _ = C._setup(D, H, B, K, pad, kw, card,
                                                  seed=e)
            else:
                _, D, H, B, K, pad, lead0, kw = variant
                cfg, _, batch, _, _, _ = C._masked_setup(
                    D, H, B, K, pad, lead0, kw, card, seed=e)
            torch.manual_seed(100 + e)
            out.append((NJODE(cfg).to(card), batch))
        return cfg, out

    cfg, solo = models_and_batches()
    solo_fn = fs.make_fused_loss_fn(cfg, mode)
    losses = []
    for e, (model, batch) in enumerate(solo):
        gen = torch.Generator(device=card).manual_seed(50 + e)
        loss = solo_fn(model, batch, 0.6, gen, True)
        loss.backward()
        losses.append(loss.detach())
    _, group = models_and_batches()
    fn = fs.make_fused_members_loss_fn(cfg, mode)
    gens = [torch.Generator(device=card).manual_seed(50 + e)
            for e in range(E)]
    fs.reset_launch_counts()
    loss_e = fn([m for m, _ in group], [b for _, b in group], 0.6, gens,
                True)
    loss_e.sum().backward()
    key = fs._launch_key(fs.Spec(cfg))
    assert fs.LAUNCHES["njode_scan_fwd_members" + key] == 1
    assert fs.LAUNCHES["njode_scan_bwd_members" + key] == 1
    assert fs.LAUNCHES["njode_scan_fwd" + key] == 0
    for e in range(E):
        assert torch.equal(loss_e[e], losses[e]), e
        for a, b in zip(group[e][0].parameters(), solo[e][0].parameters()):
            assert torch.equal(a.grad, b.grad), e


def test_member_wrappers_reject_bad_inputs(card):
    cfg, arrays, leaves, h0, _ = _members(C.VARIANTS[0], card)
    spec = fs.Spec(cfg, "prng")
    _, K, B = arrays[2].shape
    seed = torch.zeros((E,), dtype=torch.int64, device=card)
    with pytest.raises(ValueError):        # a solo-shaped h0
        fs.scan_fwd_members_cuda(spec, leaves, arrays, 0.5, h0[0], True,
                                 None, seed)
    with pytest.raises(ValueError):        # one seed for three members
        fs.scan_fwd_members_cuda(spec, leaves, arrays, 0.5, h0, True, None,
                                 seed[:1])
    with pytest.raises(ValueError):        # a leaf of one member
        fs.scan_fwd_members_cuda(spec, [leaves[0][0]] + leaves[1:], arrays,
                                 0.5, h0, True, None, seed)
    with pytest.raises(ValueError):        # solo-layout arrays
        fs.scan_fwd_members_cuda(spec, leaves, tuple(
            a if i < 2 else a[0] for i, a in enumerate(arrays)), 0.5, h0,
            True, None, seed)
