"""The masked branch of the port's fused scan (ops/fused_scan.py) against
the JAX package: the plain K1/K2 against the Pallas kernels in interpret
mode, ``FusedNJODELoss`` against ``njode.forward`` + ``jax.grad``, the plain
K3 against the Pallas eval, and the ``supported`` gates. The masked cases
of tests/test_fused_scan.py at K <= 30, B = 8, D = 3, with partial
coordinate masks; loss to rtol 1e-5 / atol 1e-6, gradients to rtol 2e-4 /
atol 2e-5."""

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
from njode_tpu_torch.training.jax_compat import (jax_params_from_state_dict,
                                                 state_dict_from_jax_params)

MASKED_CASES = [dict(), dict(which_loss="easy"),
                dict(residual_enc_dec=False), dict(dropout_rate=0.1),
                dict(input_current_t=True)]
IDS = ["masked", "easy", "no_residual", "dropout", "ict"]


def _setup(kw, seed=3, steps=10, lead0=False):
    jcfg, tcfg = H.configs(3, 12, masked=True, **kw)
    params, model = H.twin_models(jcfg, tcfg)
    b = H.make_masked_np_batch(seed=seed, B=8, D=3, steps=steps)
    if lead0:
        # a leading dt==0 step at t=0 that carries observations
        b = b._replace(times=np.concatenate([[0.0], b.times[:-1]]).astype(
            np.float32), dt=np.concatenate([[0.0], b.dt[1:]]).astype(
                np.float32))
    return jcfg, tcfg, params, model, b


def _pallas_reference(jcfg, params, b, u_keep, weight, train):
    """Loss, histories, leaf grads and dh0 of the interpret-mode Pallas
    kernels with the batch's mask M, ``u_keep`` as the 'input'-mode
    masks."""
    spec = jfs._Spec(jcfg, "input")
    key = spec.key()
    jfs._SPECS[key] = spec
    K, B = b.obs.shape
    shapes = (K, K, 1, B, train)
    flat = jfs._flatten_params(params)
    jb = H.jbatch(b)
    arrays = (jb.times, jb.dt, jb.obs, jb.X, jb.M, jb.n_obs_ot, jb.start_X)
    u = (jnp.asarray(u_keep, jnp.int8) if u_keep is not None
         else jnp.zeros((1, 1, 1, 1), jnp.int8))
    h0 = jnjode._encoder_apply(params["encoder"], jcfg, jb.start_X,
                               jnp.zeros_like(jb.start_X), None, False)
    w = jnp.float32(weight)
    seed = jnp.float32(0.0)
    loss, hists = jfs._fwd_impl(key, shapes, True, flat, arrays, w, u, seed,
                                h0)
    res = (flat, arrays, w, u, seed, hists)
    g = jfs._fused_bwd(key, shapes, True, res, jnp.float32(1.0))
    return loss, hists, g[0], g[-1]


@pytest.mark.parametrize("kw", MASKED_CASES, ids=IDS)
def test_plain_k1_k2_match_pallas_interpret(kw):
    """Plain K1 (loss + the carry histories) and plain K2 (every leaf
    gradient + dh0) of the masked branch against ``_fwd_impl`` /
    ``_fused_bwd`` with injected 'input'-mode masks."""
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
    with torch.no_grad():
        h0 = fs.t0_state(model, tb)
    u = None if u_keep is None else torch.as_tensor(u_keep).to(torch.int8)
    loss, hists = fs.scan_fwd_plain(spec, leaves, arrays, 0.6, h0, train, u)
    np.testing.assert_allclose(float(loss), float(loss_r), **H.LOSS_TOL)
    for a, r in zip(hists, hists_r):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), **H.LOSS_TOL)
    grads, dh0 = fs.scan_bwd_plain(spec, leaves, arrays, 0.6, train, hists,
                                   torch.tensor(1.0), u)
    for gt, gr in zip(grads, g_r):
        gr = np.asarray(gr)
        gt = gt.numpy()
        gt = gt.T if gt.ndim == 2 else gt.reshape(gr.shape)
        np.testing.assert_allclose(gt, gr, **H.GRAD_TOL)
    np.testing.assert_allclose(dh0.numpy(), np.asarray(dh0_r), **H.GRAD_TOL)


@pytest.mark.parametrize("kw", [dict(), dict(dropout_rate=0.1)],
                         ids=["masked", "dropout"])
def test_plain_steps_from_pallas_histories(kw):
    """``scan_steps_plain`` started at every step from the interpret-mode
    Pallas kernel's step-entry carries: each step's carry is the kernel's
    next one and the summed loss the kernel's (the step-by-step check of
    K1 on long grids, whose free-running scans part ways)."""
    jcfg, tcfg, params, model, b = _setup(kw)
    K, B = b.obs.shape
    spec = fs.Spec(tcfg, "input")
    train = spec.rate > 0
    u_keep = (np.random.RandomState(5).random((K, spec.S, B, spec.w_max))
              < 0.9) if train else None
    loss_r, hists_r, _, _ = _pallas_reference(jcfg, params, b, u_keep, 0.6,
                                              train)
    hists = tuple(torch.as_tensor(np.array(h)) for h in hists_r)
    u = None if u_keep is None else torch.as_tensor(u_keep).to(torch.int8)
    loss, nxt = fs.scan_steps_plain(
        spec, [p.detach() for p in fs.flat_leaves(model)],
        fs.batch_arrays(H.tbatch(b)), 0.6, hists, train, u)
    np.testing.assert_allclose(float(loss), float(loss_r), **H.LOSS_TOL)
    for a, r in zip(nxt, hists):
        assert a.shape == r.shape
        np.testing.assert_allclose(a[:-1].numpy(), r[1:].numpy(),
                                   **H.LOSS_TOL)


@pytest.mark.parametrize("kw,train,lead0", [
    (dict(), False, False), (dict(dropout_rate=0.1), True, False),
    (dict(dropout_rate=0.1, input_current_t=True), True, True)],
    ids=["eval_mode", "dropout", "ict_t0_step"])
def test_fused_loss_function_matches_jax(kw, train, lead0):
    """``make_fused_loss_fn`` end to end (the t=0 encoder with the zero
    mask outside the kernel, its gradient through dh0) against
    ``njode.forward`` + ``jax.grad`` with the same masks."""
    jcfg, tcfg, params, model, b = _setup(kw, lead0=lead0)
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
    h0 = fs.t0_state(model, tb, enc_masks)
    loss = fs.FusedNJODELoss.apply(
        spec, train, 0.7, u, None, tb.times, tb.dt, tb.obs, tb.X,
        tb.n_obs_ot, tb.start_X, tb.M, h0, *fs.flat_leaves(model))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(l_ref),
                               **H.LOSS_TOL)
    np.testing.assert_allclose(H.flat(H.torch_grads_as_jax(model)),
                               H.flat(g_ref), **H.GRAD_TOL)


def test_plain_k3_matches_pallas_eval():
    jcfg, tcfg, params, model, b = _setup(dict(dropout_rate=0.1), seed=2,
                                          steps=30)
    ref = jfs.make_fused_eval_fn(jcfg, interpret=True)(
        params, H.jbatch(b), jnp.float32(0.7))
    got = fs.make_fused_eval_fn(tcfg)(model, H.tbatch(b), 0.7)
    np.testing.assert_allclose(float(got), float(ref), **H.LOSS_TOL)


def test_masked_kernels_route_and_gates(monkeypatch):
    """``supported`` admits masked configs with output == input, those
    whose weights overflow one CTA among them, and the GRU jump, and
    rejects output != input with or without it; the shared memory of the
    masked layout is counted; a CUDA-routed masked config never takes the
    plain version."""
    nn = ((50, "tanh"), (50, "tanh"))
    _, climate = H.configs(5, 10, ode_nn=nn, readout_nn=nn, enc_nn=nn,
                           dropout_rate=0.1, masked=True)
    assert fs.supported(climate)
    spec = fs.Spec(climate)
    assert spec.n_params == 10925 and spec.smem_bytes == 177856
    assert spec.smem_bytes <= fs.SMEM_LIMIT
    _, unmasked = H.configs(5, 10, ode_nn=nn, readout_nn=nn, enc_nn=nn,
                            dropout_rate=0.1)
    assert fs.Spec(unmasked).smem_bytes < spec.smem_bytes
    for kw in (dict(output_size=2), dict(use_rnn=True, output_size=2)):
        _, cfg = H.configs(3, 12, masked=True, **kw)
        assert not fs.supported(cfg)
    _, cfg = H.configs(3, 12, masked=True, use_rnn=True)
    assert fs.supported(cfg)
    _, phys = H.configs(41, 41, ode_nn=nn, readout_nn=nn, enc_nn=nn,
                        masked=True)
    # too wide for the resident plan at 16 rows: the rule takes it at the
    # most rows that fit (8), before the global plan, and each launch at
    # the batch's rows (one a CTA at B = 50)
    assert fs.supported(phys)
    assert (fs.Spec(phys).plan, fs.Spec(phys).rows) == ("resident", 8)
    assert fs.Spec(phys).rows_for(50) == 1
    _, tcfg, _, model, b = _setup(dict(dropout_rate=0.1))
    tb = H.tbatch(b)
    with pytest.raises(ValueError, match="mask M"):
        fs.scan_fwd_plain(fs.Spec(tcfg), [], fs.batch_arrays(tb)[:6], 0.5,
                          torch.zeros(8, 12), False)
    monkeypatch.setattr(fs, "_is_cuda", lambda t: True)

    def boom(*a, **k):
        raise AssertionError("plain version used for a CUDA tensor")

    monkeypatch.setattr(fs, "scan_fwd_plain", boom)
    before = dict(fs.LAUNCHES)
    with pytest.raises((RuntimeError, ValueError)):
        fs.make_fused_loss_fn(tcfg, "prng")(
            model, tb, 0.5, torch.Generator().manual_seed(0), True)
    with pytest.raises((RuntimeError, ValueError)):
        fs.make_fused_eval_fn(tcfg)(model, tb, 0.5)
    assert fs.LAUNCHES == before


def test_masked_weights_carry_across():
    """``jax_compat`` carries the masked encoder's 2D-wide first layer
    both ways."""
    jcfg, tcfg = H.configs(5, 10, masked=True)
    params, model = H.twin_models(jcfg, tcfg)
    w = model.encoder_map.ffnn[0].weight
    assert tuple(w.shape) == (13, 10)
    np.testing.assert_array_equal(w.detach().numpy().T,
                                  np.asarray(params["encoder"][0]["w"]))
    back = jax_params_from_state_dict(model.state_dict())
    np.testing.assert_array_equal(H.flat(back), H.flat(params))
    sd = state_dict_from_jax_params(back)
    assert all(torch.equal(sd[k], v) for k, v in model.state_dict().items())
