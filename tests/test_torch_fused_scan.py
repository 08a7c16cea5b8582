"""The port's fused scan (ops/fused_scan.py) against the JAX package's Pallas
kernels in interpret mode and ``njode.forward`` + ``jax.grad``.

The CUDA kernels themselves run only on the card (``chip_smoke.py`` holds
each against its plain version there); here the plain versions K1-K4 are
held against the JAX reference, and the wrappers' routing is checked."""

import ctypes
import os
import re

import numpy as np
import pytest

import conftest  # noqa: F401

import jax
import jax.numpy as jnp
import torch

import torch_port_helpers as H
from njode_tpu.models import njode as jnjode
from njode_tpu.ops import fused_scan as jfs
from njode_tpu_torch.ops import fused_scan as fs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _pallas_reference(jcfg, params, b, u_keep, weight, train):
    """Loss, histories, leaf grads and dh0 of the interpret-mode Pallas
    kernels (JAX layout), with ``u_keep`` as the 'input'-mode masks."""
    spec = jfs._Spec(jcfg, "input")
    key = spec.key()
    jfs._SPECS[key] = spec
    K, B = b.obs.shape
    shapes = (K, K, 1, B, train)
    flat = jfs._flatten_params(params)
    jb = H.jbatch(b)
    arrays = (jb.times, jb.dt, jb.obs, jb.X, jnp.zeros((1, 1, 1)),
              jb.n_obs_ot, jb.start_X)
    u = (jnp.asarray(u_keep, jnp.int8) if u_keep is not None
         else jnp.zeros((1, 1, 1, 1), jnp.int8))
    h0 = jnjode._encoder_apply(params["encoder"], jcfg, jb.start_X, None,
                               None, False)
    w = jnp.float32(weight)
    seed = jnp.float32(0.0)
    loss, hists = jfs._fwd_impl(key, shapes, True, flat, arrays, w, u, seed,
                                h0)
    res = (flat, arrays, w, u, seed, hists)
    g = jfs._fused_bwd(key, shapes, True, res, jnp.float32(1.0))
    return loss, hists, g[0], g[-1]


@pytest.mark.parametrize("kw", [dict(), dict(which_loss="easy",
                                              input_current_t=True)],
                         ids=["main", "easy_ict"])
def test_plain_k1_k2_match_pallas_interpret(kw):
    """Plain K1 (loss + the three carry histories) and plain K2 (every
    leaf gradient + dh0) against ``_fwd_impl`` / ``_fused_bwd``."""
    jcfg, tcfg = H.configs(1, 10, dropout_rate=0.1, **kw)
    params, model = H.twin_models(jcfg, tcfg)
    b = H.make_np_batch(seed=3, D=1)
    K, B = b.obs.shape
    spec = fs.Spec(tcfg, "input")
    u_keep = np.random.RandomState(5).random(
        (K, spec.S, B, spec.w_max)) < 0.9
    loss_r, hists_r, g_r, dh0_r = _pallas_reference(jcfg, params, b, u_keep,
                                                    0.6, True)
    tb = H.tbatch(b)
    arrays = (tb.times, tb.dt, tb.obs, tb.X, tb.n_obs_ot, tb.start_X)
    leaves = [p.detach() for p in fs.flat_leaves(model)]
    with torch.no_grad():
        h0 = model.encoder_map(tb.start_X)
    u = torch.as_tensor(u_keep).to(torch.int8)
    loss, hists = fs.scan_fwd_plain(spec, leaves, arrays, 0.6, h0, True, u)
    np.testing.assert_allclose(float(loss), float(loss_r), **H.LOSS_TOL)
    for a, r in zip(hists, hists_r):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), **H.LOSS_TOL)
    grads, dh0 = fs.scan_bwd_plain(spec, leaves, arrays, 0.6, True, hists,
                                   torch.tensor(1.0), u)
    for gt, gr in zip(grads, g_r):
        gr = np.asarray(gr)
        gt = gt.numpy()
        gt = gt.T if gt.ndim == 2 else gt.reshape(gr.shape)
        np.testing.assert_allclose(gt, gr, **H.GRAD_TOL)
    np.testing.assert_allclose(dh0.numpy(), np.asarray(dh0_r), **H.GRAD_TOL)


@pytest.mark.parametrize("train", [False, True])
def test_fused_loss_function_matches_jax(train):
    """FusedNJODELoss end to end (the t=0 encoder outside, its gradient
    through dh0) against njode.forward + jax.grad with the same masks."""
    kw = dict(dropout_rate=0.1) if train else {}
    jcfg, tcfg = H.configs(1, 10, **kw)
    params, model = H.twin_models(jcfg, tcfg)
    b = H.make_np_batch(seed=3, D=1, pad=2)
    K, B = b.obs.shape
    rng = jax.random.PRNGKey(7)
    l_ref, g_ref = jax.value_and_grad(lambda p: jnjode.forward(
        p, jcfg, H.jbatch(b), weight=0.7, rng=rng, train=train)[1])(params)
    tb = H.tbatch(b)
    spec = fs.Spec(tcfg, "input")
    enc_masks = u = None
    if train:
        u0, uk = H.jax_drop_masks(jcfg, rng, K, B)
        enc_masks = [torch.as_tensor(u0[i]) for i in range(spec.n_enc)]
        u = torch.as_tensor(uk).to(torch.int8)
    h0 = model.encoder_map(tb.start_X, None, enc_masks)
    loss = fs.FusedNJODELoss.apply(
        spec, train, 0.7, u, None, tb.times, tb.dt, tb.obs, tb.X,
        tb.n_obs_ot, tb.start_X, h0, *fs.flat_leaves(model))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(l_ref),
                               **H.LOSS_TOL)
    np.testing.assert_allclose(H.flat(H.torch_grads_as_jax(model)),
                               H.flat(g_ref), **H.GRAD_TOL)


def test_plain_k3_matches_pallas_eval():
    jcfg, tcfg = H.configs(1, 10, dropout_rate=0.1)
    params, model = H.twin_models(jcfg, tcfg)
    b = H.make_np_batch(seed=2, D=1)
    ref = jfs.make_fused_eval_fn(jcfg, interpret=True)(
        params, H.jbatch(b), jnp.float32(0.7))
    got = fs.make_fused_eval_fn(tcfg)(model, H.tbatch(b), 0.7)
    np.testing.assert_allclose(float(got), float(ref), **H.LOSS_TOL)


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0),
     (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2,
     (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344),
     (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
])
def test_philox_known_answers(ctr, key, want):
    """Random123's known-answer vectors for Philox4x32-10."""
    c = [torch.tensor(x, dtype=torch.int64) for x in ctr]
    got = fs.philox4x32_10(*c, *key)
    assert tuple(int(x) for x in got) == want


def test_philox_keep_layout():
    """Masks depend on (seed, k, slot, row, col) only: a sub-batch of rows
    sees the same masks, and the keep rate is ~1-rate."""
    thresh = min(int(0.9 * 2.0 ** 32), 2 ** 32 - 1)
    full = fs.philox_keep_plain(2 ** 40 + 17, 4, 8, 64, 50, thresh)
    steps = fs.philox_keep_plain(2 ** 40 + 17, torch.arange(6), 8, 64, 50,
                                 thresh)
    assert torch.equal(steps[4], full)
    assert torch.equal(fs.philox_keep_plain(2 ** 40 + 17, 4, 8, 16, 50,
                                            thresh), full[:, :16])
    assert abs(float(steps.float().mean()) - 0.9) < 0.01
    assert not torch.equal(steps[0], steps[1])


def test_prng_masks_replayed_through_input_mode():
    """The masks 'prng' mode draws, replayed through 'input' mode, give the
    identical loss and gradients: forward and backward draw the same
    masks (the port of test_fused_scan.test_prng_mask_mode_grad_proof)."""
    _, tcfg = H.configs(1, 10, dropout_rate=0.1)
    _, model = H.twin_models(*H.configs(1, 10, dropout_rate=0.1))
    b = H.tbatch(H.make_np_batch(seed=3, D=1))
    K, B = b.obs.shape
    spec = fs.Spec(tcfg, "prng")

    def run(fn):
        model.zero_grad()
        loss = fn(model, b, 0.5, torch.Generator().manual_seed(11), True)
        loss.backward()
        return float(loss.detach()), [p.grad.clone()
                                      for p in model.parameters()]

    l_p, g_p = run(fs.make_fused_loss_fn(tcfg, "prng"))
    gen = torch.Generator().manual_seed(11)      # the draws loss_fn made
    torch.rand((spec.n_enc, B, spec.w_max), generator=gen)
    seed = torch.randint(0, 2 ** 62, (1,), generator=gen, dtype=torch.int64)
    masks = fs.philox_keep_plain(int(seed), torch.arange(K), spec.S, B,
                                 spec.w_max, spec.thresh)
    l_i, g_i = run(fs.make_fused_loss_fn(tcfg, "input", u_override=masks))
    assert l_p == l_i
    for a, c in zip(g_p, g_i):
        torch.testing.assert_close(a, c, rtol=0, atol=0)
    # a different seed gives a different loss
    l_o, _ = run(fs.make_fused_loss_fn(
        tcfg, "input", u_override=fs.philox_keep_plain(
            int(seed) + 1, torch.arange(K), spec.S, B, spec.w_max,
            spec.thresh)))
    assert l_o != l_p


def test_input_mode_matches_eager_forward_with_same_generator():
    """'input' mode draws its masks in njode.forward's order, so both paths
    see the same masks from the same generator state."""
    _, tcfg = H.configs(1, 10, dropout_rate=0.1)
    _, model = H.twin_models(*H.configs(1, 10, dropout_rate=0.1))
    b = H.tbatch(H.make_np_batch(seed=3, D=1))
    from njode_tpu_torch.models import njode as tnjode
    l_f = fs.make_fused_loss_fn(tcfg, "input")(
        model, b, 0.5, torch.Generator().manual_seed(4), True)
    _, l_e = tnjode.forward(model, b, weight=0.5, train=True,
                            generator=torch.Generator().manual_seed(4))
    np.testing.assert_allclose(float(l_f.detach()), float(l_e.detach()),
                               **H.LOSS_TOL)


def test_cuda_route_raises_instead_of_falling_back(monkeypatch):
    """A tensor routed to the kernels (the device check mocked to say CUDA)
    never falls back to the plain version: the wrapper raises."""
    _, tcfg = H.configs(1, 10, dropout_rate=0.1)
    _, model = H.twin_models(*H.configs(1, 10, dropout_rate=0.1))
    b = H.tbatch(H.make_np_batch(seed=3, D=1))
    monkeypatch.setattr(fs, "_is_cuda", lambda t: True)

    def boom(*a, **k):
        raise AssertionError("plain version used for a CUDA tensor")

    monkeypatch.setattr(fs, "scan_fwd_plain", boom)
    monkeypatch.setattr(fs, "scan_bwd_plain", boom)
    before = dict(fs.LAUNCHES)
    for mode in ("prng", "input"):
        with pytest.raises((RuntimeError, ValueError)):
            fs.make_fused_loss_fn(tcfg, mode)(
                model, b, 0.5, torch.Generator().manual_seed(0), True)
    with pytest.raises((RuntimeError, ValueError)):
        fs.make_fused_eval_fn(tcfg)(model, b, 0.5)
    assert fs.LAUNCHES == before


def test_unsupported_configs_raise():
    for kw in (dict(masked=True), dict(use_rnn=True)):
        _, tcfg = H.configs(2, 10, **kw)
        assert not fs.supported(tcfg)
        with pytest.raises(NotImplementedError):
            fs.make_fused_loss_fn(tcfg)
    _, main = H.configs(1, 10, ode_nn=((50, "tanh"), (50, "tanh")),
                        readout_nn=((50, "tanh"), (50, "tanh")),
                        enc_nn=((50, "tanh"), (50, "tanh")),
                        dropout_rate=0.1)
    assert fs.supported(main)
    spec = fs.Spec(main)
    assert spec.n_params == 10071 and spec.S == 8 and spec.w_max == 50
    assert spec.smem_bytes <= fs.SMEM_LIMIT
    _, wide = H.configs(1, 10, ode_nn=((400, "tanh"), (400, "tanh")),
                        readout_nn=((400, "tanh"), (400, "tanh")),
                        enc_nn=((400, "tanh"), (400, "tanh")))
    assert not fs.supported(wide)       # weights alone overflow one CTA


def test_config_struct_mirrors_the_cuda_source():
    """``_ScanCfg`` / ``_MLPDesc`` list the fields of the C structs in
    csrc/fused_scan.cu in order, all 4 bytes wide."""
    with open(os.path.join(ROOT, "njode_tpu_torch", "ops", "csrc",
                           "fused_scan.cu")) as f:
        src = f.read()

    def c_fields(name):
        body = re.search(r"struct %s \{(.*?)\};" % name, src, re.S).group(1)
        body = re.sub(r"//[^\n]*", "", body)
        out = []
        for decl in body.split(";"):
            decl = decl.strip()
            if not decl:
                continue
            names = decl.split(None, 1)[1] if not decl.startswith(
                "unsigned") else decl.split(None, 2)[2]
            for n in names.split(","):
                out.append(re.sub(r"\[.*\]", "", n).strip())
        return out

    assert [f[0] for f in fs._MLPDesc._fields_] == c_fields("MLPDesc")
    assert [f[0] for f in fs._ScanCfg._fields_] == c_fields("ScanCfg")
    n_int = sum(ctypes.sizeof(t) for _, t in fs._ScanCfg._fields_)
    assert ctypes.sizeof(fs._ScanCfg) == n_int
    assert re.search(r"#define ROWS (\d+)", src).group(1) == str(fs.ROWS)
    assert re.search(r"#define MAX_LIN (\d+)", src).group(1) == \
        str(fs.MAX_LIN)
