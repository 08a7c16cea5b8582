"""The GRU-jump (``use_rnn``) branch of the port's fused scan
(ops/fused_scan.py) against the JAX package: the plain K1/K2 against the
Pallas kernels in interpret mode, the plain K3 against the Pallas eval,
``FusedNJODELoss`` against ``njode.forward`` + ``jax.grad``, the prng masks
replayed through 'input' mode, one epoch of the kernels' route against the
JAX ``train_epoch``, and the gates and routing. Unmasked, masked (D = 3,
partial coordinate masks) and without bias, at K <= 10, B = 8; loss to
rtol 1e-5 / atol 1e-6, histories and gradients to rtol 2e-4 / atol 2e-5.

The JAX kernel splits the GRU's weights by gate (twelve leaves, ``[in,
H]``); the port keeps torch's four (``weight_ih [3H, D]``, ``weight_hh
[3H, H]``, ``bias_ih``, ``bias_hh [3H]``, gate order r, z, n), so the
comparison concatenates JAX's gate leaves along the gate axis."""

import numpy as np
import pytest

import conftest  # noqa: F401

import jax
import jax.numpy as jnp
import torch

import torch_port_helpers as H
from njode_tpu.models import njode as jnjode
from njode_tpu.ops import fused_scan as jfs
from njode_tpu.training import steps as jsteps
from njode_tpu_torch.ops import fused_scan as fs
from njode_tpu_torch.training import steps as tsteps
from njode_tpu_torch.training.jax_compat import (jax_params_from_state_dict,
                                                 state_dict_from_jax_params)

CASES = [dict(dropout_rate=0.1), dict(masked=True, dropout_rate=0.1),
         dict(bias=False, which_loss="easy", input_current_t=True)]
IDS = ["rnn", "rnn_masked", "rnn_nobias_easy_ict"]


def _setup(kw, seed=3, pad=0):
    """Twin models with the GRU jump and a batch: D = 3 with partial
    coordinate masks when masked, else D = 2 with ``pad`` dt==0 steps."""
    masked = kw.get("masked", False)
    D = 3 if masked else 2
    jcfg, tcfg = H.configs(D, 12, use_rnn=True, **kw)
    params, model = H.twin_models(jcfg, tcfg)
    b = (H.make_masked_np_batch(seed=seed, B=8, D=3, steps=8) if masked
         else H.make_np_batch(seed=seed, B=8, D=2, steps=8, pad=pad))
    return jcfg, tcfg, params, model, b


def _pallas_reference(jcfg, params, b, u_keep, weight, train):
    """Loss, histories, leaf grads (JAX layout) and dh0 of the
    interpret-mode Pallas kernels, ``u_keep`` as the 'input'-mode masks."""
    spec = jfs._Spec(jcfg, "input")
    key = spec.key()
    jfs._SPECS[key] = spec
    K, B = b.obs.shape
    jb = H.jbatch(b)
    M = jb.M if jcfg.masked else jnp.zeros((1, 1, 1))
    arrays = (jb.times, jb.dt, jb.obs, jb.X, M, jb.n_obs_ot, jb.start_X)
    u = (jnp.asarray(u_keep, jnp.int8) if u_keep is not None
         else jnp.zeros((1, 1, 1, 1), jnp.int8))
    m0 = jnp.zeros_like(jb.start_X) if jcfg.masked else None
    h0 = jnjode._encoder_apply(params["encoder"], jcfg, jb.start_X, m0,
                               None, False)
    w = jnp.float32(weight)
    seed = jnp.float32(0.0)
    shapes = (K, K, 1, B, train)
    flat = jfs._flatten_params(params)
    loss, hists = jfs._fwd_impl(key, shapes, True, flat, arrays, w, u, seed,
                                h0)
    g = jfs._fused_bwd(key, shapes, True, (flat, arrays, w, u, seed, hists),
                       jnp.float32(1.0))
    return loss, hists, [np.asarray(x) for x in g[0]], g[-1]


def _as_torch_leaves(spec, g_jax):
    """The JAX kernel's leaf gradients in the port's leaf layout: each MLP
    weight transposed, each bias flattened, and the twelve gate-split GRU
    leaves joined into torch's four."""
    n = spec.gru_leaf0
    out = [g.T if len(s) == 2 else g.reshape(-1)
           for g, s in zip(g_jax[:n], spec.leaf_shapes)]
    gate = g_jax[n:]
    for i in range(0, len(gate), 3):
        cat = np.concatenate(gate[i:i + 3], axis=1)
        out.append(cat.T if i < 6 else cat.reshape(-1))
    return out


@pytest.mark.parametrize("kw", CASES, ids=IDS)
def test_plain_k1_k2_match_pallas_interpret(kw):
    """Plain K1 (loss + the three carry histories) and plain K2 (every
    leaf gradient + dh0) against ``_fwd_impl`` / ``_fused_bwd``."""
    jcfg, tcfg, params, model, b = _setup(kw)
    K, B = b.obs.shape
    spec = fs.Spec(tcfg, "input")
    train = spec.rate > 0
    u_keep = (np.random.RandomState(5).random((K, spec.S, B, spec.w_max))
              < 0.9) if train else None
    loss_r, hists_r, g_r, dh0_r = _pallas_reference(jcfg, params, b, u_keep,
                                                    0.6, train)
    tb = H.tbatch(b)
    arrays = fs.batch_arrays(tb)
    leaves = [p.detach() for p in fs.flat_leaves(model)]
    assert [tuple(p.shape) for p in leaves] == spec.leaf_shapes
    with torch.no_grad():
        h0 = fs.t0_state(model, tb)
    u = None if u_keep is None else torch.as_tensor(u_keep).to(torch.int8)
    loss, hists = fs.scan_fwd_plain(spec, leaves, arrays, 0.6, h0, train, u)
    np.testing.assert_allclose(float(loss), float(loss_r), **H.LOSS_TOL)
    for a, r in zip(hists, hists_r):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), **H.GRAD_TOL)
    grads, dh0 = fs.scan_bwd_plain(spec, leaves, arrays, 0.6, train, hists,
                                   torch.tensor(1.0), u)
    ref = _as_torch_leaves(spec, g_r)
    assert len(grads) == len(ref) == len(spec.leaf_shapes)
    for i, (gt, gr) in enumerate(zip(grads, ref)):
        np.testing.assert_allclose(gt.numpy(), gr, err_msg=f"leaf {i}",
                                   **H.GRAD_TOL)
    # the GRU leaves get gradient, the encoder's none inside the scan
    assert all(float(g.abs().max()) > 0 for g in grads[spec.gru_leaf0:])
    n_ode = 2 * (len(spec.ode_w) - 1) if spec.bias else len(spec.ode_w) - 1
    n_enc = 2 * (len(spec.enc_w) - 1) if spec.bias else len(spec.enc_w) - 1
    assert all(float(g.abs().max()) == 0
               for g in grads[n_ode:n_ode + n_enc])
    np.testing.assert_allclose(dh0.numpy(), np.asarray(dh0_r), **H.GRAD_TOL)


def test_plain_k3_matches_pallas_eval():
    jcfg, tcfg, params, model, b = _setup(CASES[1], seed=2)
    ref = jfs.make_fused_eval_fn(jcfg, interpret=True)(
        params, H.jbatch(b), jnp.float32(0.7))
    got = fs.make_fused_eval_fn(tcfg)(model, H.tbatch(b), 0.7)
    np.testing.assert_allclose(float(got), float(ref), **H.LOSS_TOL)


@pytest.mark.parametrize("kw,train", [(CASES[0], True), (CASES[1], True),
                                      (CASES[2], False)],
                         ids=["rnn_train_pad", "rnn_masked_train",
                              "rnn_nobias_eval"])
def test_fused_loss_function_matches_jax(kw, train):
    """``FusedNJODELoss`` end to end (the t=0 encoder outside, its
    gradient through dh0) against ``njode.forward`` + ``jax.grad`` with
    the same masks; the unmasked batch ends in two dt==0 padding steps."""
    jcfg, tcfg, params, model, b = _setup(kw, pad=2)
    K, B = b.obs.shape
    rng = jax.random.PRNGKey(7)
    l_ref, g_ref = jax.jit(jax.value_and_grad(lambda p: jnjode.forward(
        p, jcfg, H.jbatch(b), weight=0.7, rng=rng, train=train)[1]))(params)
    tb = H.tbatch(b)
    spec = fs.Spec(tcfg, "input")
    enc_masks = u = None
    if train:
        u0, uk = H.jax_drop_masks(jcfg, rng, K, B)
        enc_masks = [torch.as_tensor(u0[i]) for i in range(spec.n_enc)]
        u = torch.as_tensor(uk).to(torch.int8)
    h0 = fs.t0_state(model, tb, enc_masks)
    loss = fs.FusedNJODELoss.apply(
        spec, train, 0.7, u, None, tb.times, tb.dt, tb.obs, tb.X,
        tb.n_obs_ot, tb.start_X, tb.M if spec.masked else None, h0,
        *fs.flat_leaves(model))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(l_ref),
                               **H.LOSS_TOL)
    np.testing.assert_allclose(H.flat(H.torch_grads_as_jax(model)),
                               H.flat(g_ref), **H.GRAD_TOL)


def test_prng_masks_replayed_through_input_mode():
    """The masks 'prng' mode draws for a masked GRU-jump config, replayed
    through 'input' mode, give the identical loss and gradients (the
    readout slots keep their numbers; the encoder's stay in S, unused)."""
    _, tcfg, _, model, b = _setup(CASES[1])
    tb = H.tbatch(b)
    K, B = tb.obs.shape
    spec = fs.Spec(tcfg, "prng")

    def run(fn):
        model.zero_grad()
        loss = fn(model, tb, 0.5, torch.Generator().manual_seed(11), True)
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
    # the scan ignores the encoder's slots, not the readouts'
    enc_off = masks.clone()
    enc_off[:, spec.s_enc:spec.s_enc + spec.n_enc] = False
    l_e, _ = run(fs.make_fused_loss_fn(tcfg, "input", u_override=enc_off))
    ro_off = masks.clone()
    ro_off[:, spec.s_r1:spec.S] = True
    l_r, _ = run(fs.make_fused_loss_fn(tcfg, "input", u_override=ro_off))
    assert l_e == l_p and l_r != l_p


def test_train_epoch_matches_jax():
    """One epoch of Adam steps through the kernels' route
    (``FusedNJODELoss``, its plain versions on the CPU) from the same
    weights, at dropout 0: per-batch losses and final weights agree with
    the JAX ``train_epoch``."""
    jcfg, tcfg = H.configs(1, 10, use_rnn=True)
    params, model = H.twin_models(jcfg, tcfg, seed=3)
    rs = np.random.RandomState(4)
    N, K, B = 18, 10, 6
    paths = rs.lognormal(0.0, 0.3, size=(N, 1, K + 1)).astype(np.float32)
    obs = (rs.random((N, K + 1)) < 0.3).astype(np.float32)
    idx_mat = rs.permutation(N).reshape(-1, B).astype(np.int32)
    times = (np.arange(1, K + 1) / K).astype(np.float32)
    dts = np.full(K, 1.0 / K, np.float32)
    jopt = jsteps.make_optimizer(1e-3)
    jfns = jsteps.make_step_fns(jcfg, jopt, times, dts)
    params, _, jl = jfns["train_epoch"](
        params, jopt.init(params), jnp.asarray(paths), jnp.asarray(obs),
        jnp.asarray(idx_mat), jnp.float32(0.6), jax.random.PRNGKey(0))
    topt = tsteps.make_optimizer(model.parameters(), 1e-3)
    tfns = tsteps.make_step_fns(model, topt, torch.as_tensor(times),
                                torch.as_tensor(dts), use_kernels=True)
    tl = tfns["train_epoch"](torch.as_tensor(paths), torch.as_tensor(obs),
                             torch.as_tensor(idx_mat).long(), 0.6,
                             torch.Generator())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4)
    ref = state_dict_from_jax_params(jax.tree.map(np.asarray, params))
    got = model.state_dict()
    assert set(got) == set(ref) and "obs_c.gru_d.weight_hh" in got
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(), err_msg=k,
                                   rtol=1e-4, atol=1e-6)


def test_rnn_gates_layout_and_route(monkeypatch):
    """``supported`` admits the GRU jump at the main path, the climate
    small arm (resident plan, 16 rows) and the PhysioNet 50 arm (global
    plan), with and without bias; its layout adds the ``gru`` and ``dG``
    regions after the others, and its launches count under the '_rnn'
    keys; a CUDA-routed GRU-jump config never takes a plain version and
    launches nothing."""
    nn = ((50, "tanh"), (50, "tanh"))
    for D, hid, masked, plan, n_params, nbytes in (
            (1, 10, False, "resident", 10461, 164672),
            (5, 10, True, "resident", 11435, 178144),
            (41, 41, True, "global", 34755, 218336)):
        for bias in (True, False):
            _, cfg = H.configs(D, hid, ode_nn=nn, readout_nn=nn, enc_nn=nn,
                               dropout_rate=0.1, masked=masked,
                               use_rnn=True, bias=bias)
            assert fs.supported(cfg)
            spec = fs.Spec(cfg)
            assert (spec.plan, spec.rows) == (plan, 16)
            if bias:
                assert (spec.n_params, spec.smem_bytes) == (n_params, nbytes)
            _, base = H.configs(D, hid, ode_nn=nn, readout_nn=nn, enc_nn=nn,
                                dropout_rate=0.1, masked=masked, bias=bias)
            off, _ = spec.layout(16, "global")
            off0, _ = fs.Spec(base).layout(16, "global")
            # the other configs' regions stay; the GRU's follow their
            # activations, then (global plan) its gate sums, the mask
            # words (which the masked branch without the GRU keeps in a
            # backward buffer instead), the layer records and the ring
            ring0, mw0 = off0.pop("ring"), off0.pop("mw")
            lay0 = off0.pop("lay")
            a0 = lay0 if masked else mw0
            n_mw = (spec.mask_words(16) + 3) // 4 * 4
            assert {k: v for k, v in off.items() if k not in (
                "gru", "dG", "gsc", "mw", "lay", "ring")} == off0
            a1 = a0 + 224 * hid + n_mw
            assert (off["gru"], off["dG"], off["gsc"], off["mw"], off["lay"],
                    off["ring"]) == (a0, a0 + 64 * hid, a0 + 128 * hid,
                                     a0 + 224 * hid, a1,
                                     a1 + fs.LAYER_INTS * spec.n_rec)
            c = fs.make_cfg(spec, 20, 50, True, 0.5)
            i0 = spec.gru_leaf0
            assert (c.use_rnn, c.gru_wih, c.gru_whh) == (
                1, spec.leaf_off[i0], spec.leaf_off[i0 + 1])
            assert (c.gru_bih, c.gru_bhh) == (
                (spec.leaf_off[i0 + 2], spec.leaf_off[i0 + 3]) if bias
                else (-1, -1))
            assert fs._launch_key(spec) == "_rnn" + (
                "_global" if plan == "global" else "")
    c0 = fs.make_cfg(fs.Spec(base), 20, 50, True, 0.5)
    assert (c0.use_rnn, c0.gru_wih, c0.gru_bih, c0.o_gru, c0.o_dG) == (
        0, -1, -1, -1, -1)
    monkeypatch.setattr(fs, "_is_cuda", lambda t: True)

    def boom(*a, **k):
        raise AssertionError("plain version used for a CUDA tensor")

    monkeypatch.setattr(fs, "scan_fwd_plain", boom)
    monkeypatch.setattr(fs, "scan_bwd_plain", boom)
    before = dict(fs.LAUNCHES)
    for kw in CASES:
        _, tcfg, _, model, b = _setup(kw)
        tb = H.tbatch(b)
        for mode in ("prng", "input"):
            with pytest.raises((RuntimeError, ValueError)):
                fs.make_fused_loss_fn(tcfg, mode)(
                    model, tb, 0.5, torch.Generator().manual_seed(0), True)
        with pytest.raises((RuntimeError, ValueError)):
            fs.make_fused_eval_fn(tcfg)(model, tb, 0.5)
    assert fs.LAUNCHES == before


def test_masked_rnn_weights_carry_across():
    """``jax_compat`` carries a masked GRU-jump model both ways: the
    encoder's 2D-wide first layer and the GRU cell."""
    jcfg, tcfg = H.configs(5, 10, masked=True, use_rnn=True)
    params, model = H.twin_models(jcfg, tcfg)
    gru = model.obs_c.gru_d
    assert tuple(gru.weight_ih.shape) == (30, 5)
    np.testing.assert_array_equal(gru.weight_hh.detach().numpy().T,
                                  np.asarray(params["gru"]["w_hh"]))
    back = jax_params_from_state_dict(model.state_dict())
    np.testing.assert_array_equal(H.flat(back), H.flat(params))
    sd = state_dict_from_jax_params(back)
    assert all(torch.equal(sd[k], v) for k, v in model.state_dict().items())
