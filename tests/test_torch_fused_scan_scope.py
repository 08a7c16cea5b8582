"""The NJODE scan kernels' full scope (ops/fused_scan.py): an unmasked
output of another width than the input (E3a) and MLPs of 9 to 101 linears
(E3b: no depth cap, the layers described by a table in device memory), the
plain versions K1-K3 against the JAX package, and ``supported`` against
the JAX rule and plan over a grid of configs.

E3a. The eager forward's loss (``losses.step_loss`` with ``M =
ones_like(X)``) broadcasts ``X [B, D]`` against ``y [B, O]``, so both terms
sum over max(D, O) coordinates; the JAX kernel's ``_loss_terms`` (no
``M``) sums the standard loss's ``(y_bj - y)^2`` over O coordinates only,
and its backward fails to trace at D = 2, O = 1 (it concatenates ``dy [B,
2]`` with ``dy_bj [B, 1]``), so the forward's loss is the only one the JAX
package trains with there. The port's kernels compute the forward's loss,
so a trainer's kernel route and its eager route give one objective: the
reference here is ``njode.forward`` (loss and ``jax.grad``), and the JAX
kernel in interpret mode where it agrees with the forward (O > D, or the
'easy' loss, whose second term reads X)."""

import types

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

# (id, D, O, config overrides)
E3A = [("D2_O1", 2, 1, dict()), ("D1_O2", 1, 2, dict()),
       ("D2_O1_rnn", 2, 1, dict(use_rnn=True)),
       ("D1_O2_rnn", 1, 2, dict(use_rnn=True)),
       ("D3_O1_easy", 3, 1, dict(which_loss="easy",
                                 residual_enc_dec=False))]
# (id, D, config overrides): 9 and 12 linears, then 17 and 33 (the GRU
# jump, the masked branch, all three nets deep)
E3B = [("ode9", 1, dict(ode_nn=((13, "tanh"),) * 8)),
       ("all12", 2, dict(ode_nn=((9, "tanh"), (7, "relu")) * 5 + (
           (8, "tanh"),), enc_nn=((6, "tanh"),) * 11,
           readout_nn=((5, "relu"),) * 11)),
       ("rnn_ro9", 1, dict(use_rnn=True, readout_nn=((11, "tanh"),) * 8)),
       ("masked_enc9", 2, dict(masked=True, enc_nn=((7, "tanh"),) * 8)),
       ("rnn_ode17", 1, dict(use_rnn=True, ode_nn=((6, "tanh"),) * 16)),
       ("masked_ro17", 2, dict(masked=True, readout_nn=(
           (5, "tanh"), (7, "relu")) * 8)),
       ("all33", 1, dict(ode_nn=((7, "tanh"),) * 32,
                         enc_nn=((5, "relu"),) * 32,
                         readout_nn=((6, "tanh"),) * 32))]


def _batch(D, masked):
    return (H.make_masked_np_batch(seed=3, D=D) if masked
            else H.make_np_batch(seed=3, D=D, pad=2))


def _port_loss_and_grads(tcfg, model, b, train, rng, jcfg):
    """FusedNJODELoss on the CPU (the plain versions) with the masks
    njode.forward draws from ``rng``; returns (loss, grads in JAX layout)."""
    K, B = b.obs.shape
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
        tb.n_obs_ot, tb.start_X, tb.M if tcfg.masked else None, h0,
        *fs.flat_leaves(model))
    loss.backward()
    return float(loss.detach()), H.flat(H.torch_grads_as_jax(model))


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("case", E3A, ids=[c[0] for c in E3A])
def test_output_width_matches_jax_kernel_loss(case, train):
    """The plain K1/K2 (and K3) against the JAX forward's loss and
    gradients; where O > D or the loss is 'easy' (the JAX kernel's loss is
    the forward's there) against the JAX kernel in interpret mode too, and
    where D > O in the standard loss the JAX kernel's loss differs (``test_output_width_quirk_of_the_jax_package``).
    The port plans such a config in the global plan alone."""
    _, D, O, kw = case
    kw = dict(kw, output_size=O, **(dict(dropout_rate=0.1) if train else {}))
    jcfg, tcfg = H.configs(D, 10, **kw)
    assert fs.supported(tcfg) and jfs.supported(jcfg)
    assert fs.Spec(tcfg).plan == "global"
    with pytest.raises(ValueError, match="global plan alone"):
        fs.Spec(tcfg, "prng", ("resident", 1))
    params, model = H.twin_models(jcfg, tcfg)
    b = _batch(D, False)
    rng = jax.random.PRNGKey(7)
    jb = H.jbatch(b)
    l_ref, g_ref = jax.value_and_grad(lambda p: jnjode.forward(
        p, jcfg, jb, weight=0.7, rng=rng, train=train)[1])(params)
    l_kern = jfs.make_fused_loss_fn(jcfg, interpret=True)(
        params, jb, jnp.float32(0.7), rng, train)
    if O > D or tcfg.which_loss == "easy":
        np.testing.assert_allclose(float(l_kern), float(l_ref),
                                   **H.LOSS_TOL)
    else:
        assert not np.isclose(float(l_kern), float(l_ref), rtol=1e-3)
    loss, grads = _port_loss_and_grads(tcfg, model, b, train, rng, jcfg)
    np.testing.assert_allclose(loss, float(l_ref), **H.LOSS_TOL)
    np.testing.assert_allclose(grads, H.flat(g_ref), **H.GRAD_TOL)
    # the eval forward (K3's plain version) gives the forward's loss too
    if not train:
        got = fs.make_fused_eval_fn(tcfg)(model, H.tbatch(b), 0.7)
        np.testing.assert_allclose(float(got), float(l_ref), **H.LOSS_TOL)


@pytest.mark.parametrize("case", E3A[:3], ids=[c[0] for c in E3A[:3]])
def test_trainer_routes_give_one_loss_at_another_output_width(case):
    """One trainer's kernel route (``make_step_fns(use_kernels=True)``:
    the kernels' plain versions on the CPU) and its eager route (the
    forward) on twin models: the same eval loss, the same first training
    loss and the same weights after two Adam steps (no dropout, so both
    routes see the same net)."""
    _, D, O, kw = case
    _trainer_routes_agree(D, dict(kw, output_size=O))


def test_trainer_routes_give_one_loss_at_17_linears():
    """The same at an ODE net of 17 linears with the GRU jump: the kernel
    route takes it (``supported``) and gives the eager route's losses and
    weights."""
    _, D, kw = next(c for c in E3B if c[0] == "rnn_ode17")
    assert fs.supported(H.configs(D, 10, **kw)[1])
    _trainer_routes_agree(D, kw)


def _trainer_routes_agree(D, kw):
    from njode_tpu_torch.training import steps

    jcfg, tcfg = H.configs(D, 10, **kw)
    _, m_kern = H.twin_models(jcfg, tcfg)
    _, m_eager = H.twin_models(jcfg, tcfg)
    rs = np.random.RandomState(5)
    K, N, B = 15, 16, 8
    paths = torch.as_tensor(rs.normal(size=(N, D, K + 1)).astype(np.float32))
    obs = torch.as_tensor((rs.random((N, K + 1)) < 0.4).astype(np.float32))
    obs[:, 0] = 1.0
    times = torch.arange(1, K + 1, dtype=torch.float32) * 0.1
    dts = torch.full((K,), 0.1)
    idx = torch.arange(B)
    got = []
    for model, kern in ((m_kern, True), (m_eager, False)):
        opt = steps.make_optimizer(model.parameters(), 1e-2)
        fns = steps.make_step_fns(model, opt, times, dts, use_kernels=kern)
        ev = float(fns["eval_loss"](paths, obs, idx, 0.7))
        gen = torch.Generator().manual_seed(0)
        l0 = float(fns["train_step"](paths, obs, idx, 0.7, gen))
        fns["train_step"](paths, obs, idx + B, 0.7, gen)
        got.append((ev, l0, H.flat([p.detach().numpy()
                                    for p in model.parameters()])))
    (e1, l1, p1), (e2, l2, p2) = got
    np.testing.assert_allclose(e1, e2, **H.LOSS_TOL)
    np.testing.assert_allclose(l1, l2, **H.LOSS_TOL)
    np.testing.assert_allclose(p1, p2, rtol=1e-4, atol=1e-6)


def test_output_width_quirk_of_the_jax_package():
    """At D = 2, O = 1 the JAX forward and the JAX kernel part (the
    standard loss's second term counts D times in the forward, once in the
    kernel), and the kernel's gradient fails to trace; at D = 1, O = 2
    they agree (ROADMAP.md Queue 3)."""
    got = {}
    for D, O in ((2, 1), (1, 2)):
        jcfg, _ = H.configs(D, 10, output_size=O)
        params = H.twin_models(*H.configs(D, 10, output_size=O))[0]
        jb = H.jbatch(_batch(D, False))
        rng = jax.random.PRNGKey(7)
        fwd = float(jnjode.forward(params, jcfg, jb, weight=0.7, rng=rng)[1])
        fused = jfs.make_fused_loss_fn(jcfg, interpret=True)
        kern = float(fused(params, jb, jnp.float32(0.7), rng, False))
        got[D] = (fwd, kern)
        if D == 2:
            with pytest.raises(TypeError, match="concatenate"):
                jax.grad(lambda p: fused(p, jb, jnp.float32(0.7), rng,
                                         False))(params)
    assert not np.isclose(got[2][0], got[2][1], rtol=1e-3)
    np.testing.assert_allclose(got[1][1], got[1][0], **H.LOSS_TOL)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("case", E3B, ids=[c[0] for c in E3B])
def test_deep_nets_match_jax(case, train):
    _, D, kw = case
    if train:
        kw = dict(kw, dropout_rate=0.1)
    jcfg, tcfg = H.configs(D, 10, **kw)
    assert fs.supported(tcfg) and jfs.supported(jcfg)
    assert max(len(n) + 1 for n in (tcfg.ode_nn, tcfg.enc_nn,
                                    tcfg.readout_nn)) > 8
    params, model = H.twin_models(jcfg, tcfg)
    b = _batch(D, tcfg.masked)
    rng = jax.random.PRNGKey(7)
    l_ref, g_ref = jax.value_and_grad(lambda p: jnjode.forward(
        p, jcfg, H.jbatch(b), weight=0.7, rng=rng, train=train)[1])(params)
    loss, grads = _port_loss_and_grads(tcfg, model, b, train, rng, jcfg)
    np.testing.assert_allclose(loss, float(l_ref), **H.LOSS_TOL)
    np.testing.assert_allclose(grads, H.flat(g_ref), **H.GRAD_TOL)
    spec = fs.Spec(tcfg)
    assert spec.S == spec.n_ode + spec.n_enc + 2 * spec.n_ro
    assert spec.smem_bytes <= fs.SMEM_LIMIT


def test_deep_net_plain_k1_matches_pallas_interpret():
    """12 linears: the plain K1 against the JAX kernel's forward in
    interpret mode (loss only; its K2 is covered by the XLA reference)."""
    _eval_matches_pallas_interpret("all12")


def test_17_linears_plain_k1_matches_pallas_interpret():
    """17 linears in the ODE net, the GRU jump: the same."""
    _eval_matches_pallas_interpret("rnn_ode17")


def _eval_matches_pallas_interpret(name):
    _, D, kw = next(c for c in E3B if c[0] == name)
    jcfg, tcfg = H.configs(D, 10, **kw)
    params, model = H.twin_models(jcfg, tcfg)
    b = _batch(D, False)
    ref = jfs.make_fused_eval_fn(jcfg, interpret=True)(
        params, H.jbatch(b), jnp.float32(0.7))
    got = fs.make_fused_eval_fn(tcfg)(model, H.tbatch(b), 0.7)
    np.testing.assert_allclose(float(got), float(ref), **H.LOSS_TOL)


# the grid: widths, hidden sizes and depths of the published arms and
# beyond, each with the JAX rule's plan at the main path's K and the
# climate one's
_WIDTHS = (10, 50, 200, 400, 1600)
_HIDDEN = (10, 50, 200)
_DEPTHS = (2, 8, 15, 16, 32, 64, 100)  # hidden layers: 3 to 101 linears


@pytest.mark.parametrize("D,O,masked,use_rnn", [
    (1, 1, False, False), (1, 2, False, False), (2, 1, False, True),
    (5, 5, True, False), (5, 5, False, True), (41, 41, True, True),
    (41, 1, False, False), (5, 5, False, False)])
def test_supported_agrees_with_the_jax_rule_and_plan(D, O, masked, use_rnn):
    """Every fp32 config that the JAX rule takes and plans at K = 100 or
    2,004 (B = 100) the port's ``supported`` takes, at every depth."""
    n = planned = 0
    for width in _WIDTHS:
        for hidden in _HIDDEN:
            for depth in _DEPTHS:
                nn = ((width, "tanh"),) * depth
                jcfg, tcfg = H.configs(D, hidden, output_size=O, ode_nn=nn,
                                       readout_nn=nn, enc_nn=nn,
                                       masked=masked, use_rnn=use_rnn,
                                       dropout_rate=0.1,
                                       residual_enc_dec=False)
                jplan = jfs.supported(jcfg) and any(
                    jfs._select_plan(jfs._Spec(jcfg, "input"), K, 100, True)
                    != (None, None) for K in (100, 2004))
                n += 1
                planned += bool(jplan)
                if jplan:
                    assert fs.supported(tcfg), (width, hidden, depth)
    assert planned > n // 4
