"""K1/K2 over a member axis (ops/fused_scan.py ``FusedNJODEMembersLoss``,
the member plain versions) against the JAX package: E members of one
config, each on its own weights and batch, against
``jax.vmap(jax.value_and_grad(njode.forward))`` at dropout 0 and with the
keep-masks ``njode.forward`` draws injected as 'input' masks (unmasked,
masked, the GRU jump, a forced global plan), and against the Pallas kernel
under ``jax.vmap`` (``make_fused_loss_fn(..., vmapped=True)``, interpret
mode); and the member form against E solo calls bit for bit."""

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

E, B, STEPS = 3, 8, 15
CASES = {
    "unmasked": dict(D=1, kw={}),
    "masked": dict(D=2, kw=dict(masked=True)),
    "rnn": dict(D=1, kw=dict(use_rnn=True)),
    "masked_rnn": dict(D=2, kw=dict(masked=True, use_rnn=True)),
}


def _members(case, rate):
    D, kw = CASES[case]["D"], CASES[case]["kw"]
    jcfg, tcfg = H.configs(D, 10, dropout_rate=rate, **kw)
    params, models, batches = [], [], []
    for e in range(E):
        p, m = H.twin_models(jcfg, tcfg, seed=20 + e)
        b = (H.make_masked_np_batch(seed=e, B=B, D=D, steps=STEPS)
             if kw.get("masked") else
             H.make_np_batch(seed=e, B=B, D=D, steps=STEPS))
        params.append(p)
        models.append(m)
        batches.append(b)
    return jcfg, tcfg, params, models, batches


def _jax_reference(jcfg, params, batches, rngs, weight=0.7):
    stack = lambda *xs: jnp.stack(xs)  # noqa: E731
    params_e = jax.tree.map(stack, *params)
    batch_e = jax.tree.map(stack, *[H.jbatch(b) for b in batches])

    def one(p, b, rng):
        return jnjode.forward(p, jcfg, b, weight=weight, rng=rng,
                              train=True)[1]

    return jax.vmap(jax.value_and_grad(one))(params_e, batch_e, rngs)


def _port_members(spec, models, batches, masks, weight=0.7):
    """The members' losses through FusedNJODEMembersLoss (the t=0 encoder
    per member, its masks ``masks[e][0]``, the scan's ``masks[e][1]``);
    backpropagates their sum."""
    tbs = [H.tbatch(b) for b in batches]
    h0s, us = [], []
    for m, tb, (u0, uk) in zip(models, tbs, masks):
        enc = None if u0 is None else [torch.as_tensor(u0[i])
                                       for i in range(spec.n_enc)]
        h0s.append(fs.t0_state(m, tb, enc))
        us.append(None if uk is None else torch.as_tensor(uk).to(torch.int8))
    u = torch.stack(us) if us[0] is not None else None

    def st(f):
        return torch.stack([getattr(tb, f) for tb in tbs])

    M = st("M") if spec.masked else None
    leaves = [torch.stack(ls) for ls in zip(*(fs.flat_leaves(m)
                                              for m in models))]
    loss = fs.FusedNJODEMembersLoss.apply(
        spec, True, weight, u, None, tbs[0].times, tbs[0].dt, st("obs"),
        st("X"), st("n_obs_ot"), st("start_X"), M, torch.stack(h0s),
        *leaves)
    loss.sum().backward()
    return loss.detach()


@pytest.mark.parametrize("case,rate,plan", [
    ("unmasked", 0.0, None), ("unmasked", 0.1, None),
    ("unmasked", 0.1, ("global", 2)), ("masked", 0.0, None),
    ("masked", 0.1, ("global", 4)), ("rnn", 0.1, None),
    ("masked_rnn", 0.1, None)],
    ids=["unmasked-rate0", "unmasked-masks", "unmasked-masks-global2",
         "masked-rate0", "masked-masks-global4", "rnn-masks",
         "masked_rnn-masks"])
def test_members_match_vmapped_jax_forward(case, rate, plan):
    jcfg, tcfg, params, models, batches = _members(case, rate)
    rngs = jnp.stack([jax.random.PRNGKey(100 + e) for e in range(E)])
    l_ref, g_ref = _jax_reference(jcfg, params, batches, rngs)
    spec = fs.Spec(tcfg, "input", plan)
    K = batches[0].obs.shape[0]
    masks = [H.jax_drop_masks(jcfg, rngs[e], K, B) if rate > 0
             else (None, None) for e in range(E)]
    loss = _port_members(spec, models, batches, masks)
    np.testing.assert_allclose(loss.numpy(), np.asarray(l_ref), **H.LOSS_TOL)
    for e, m in enumerate(models):
        want = jax.tree.map(lambda x: np.asarray(x[e]), g_ref)
        np.testing.assert_allclose(H.flat(H.torch_grads_as_jax(m)),
                                   H.flat(want), **H.GRAD_TOL)


@pytest.mark.parametrize("case", ["unmasked", "masked_rnn"])
def test_member_form_equals_solo_calls_bit_for_bit(case):
    """The member plain K1/K2 and FusedNJODEMembersLoss give each member
    the bits of its solo calls (histories, gradients, dh0; the gradients
    through the stacked leaves and the t=0 encoder)."""
    _, tcfg, _, models, batches = _members(case, 0.1)
    spec = fs.Spec(tcfg, "input")
    K = batches[0].obs.shape[0]
    gen = torch.Generator().manual_seed(3)
    us = [(torch.rand((K, spec.S, B, spec.w_max), generator=gen) < 0.9)
          .to(torch.int8) for _ in range(E)]
    tbs = [H.tbatch(b) for b in batches]
    arrays = [fs.batch_arrays(tb) for tb in tbs]
    leaves = [[p.detach() for p in fs.flat_leaves(m)] for m in models]
    with torch.no_grad():
        h0 = [fs.t0_state(m, tb) for m, tb in zip(models, tbs)]
    arr_e = tuple(arrays[0][i] if i < 2 else
                  torch.stack([a[i] for a in arrays]) for i in range(7))
    lv_e = [torch.stack(ls) for ls in zip(*leaves)]
    dloss = torch.tensor([1.0, 0.5, 2.0])
    l_e, h_e = fs.scan_fwd_members_plain(spec, lv_e, arr_e, 0.6,
                                         torch.stack(h0), True,
                                         torch.stack(us))
    g_e, d_e = fs.scan_bwd_members_plain(spec, lv_e, arr_e, 0.6, True, h_e,
                                         dloss, torch.stack(us))
    for e in range(E):
        l1, h1 = fs.scan_fwd_plain(spec, leaves[e], arrays[e], 0.6, h0[e],
                                   True, us[e])
        g1, d1 = fs.scan_bwd_plain(spec, leaves[e], arrays[e], 0.6, True, h1,
                                   dloss[e], us[e])
        assert torch.equal(l_e[e], l1)
        assert all(torch.equal(a[e], b) for a, b in zip(h_e, h1))
        assert all(torch.equal(a[e], b) for a, b in zip(g_e, g1))
        assert torch.equal(d_e[e], d1)
    # through autograd: the member loss function against the solo one
    solo_fn = fs.make_fused_loss_fn(tcfg, "prng")
    solo = []
    for e, (m, tb) in enumerate(zip(models, tbs)):
        m.zero_grad(set_to_none=True)
        loss = solo_fn(m, tb, 0.6, torch.Generator().manual_seed(e), True)
        loss.backward()
        solo.append((loss.detach(), [p.grad.clone() for p in
                                     m.parameters()]))
        m.zero_grad(set_to_none=True)
    loss_e = fs.make_fused_members_loss_fn(tcfg, "prng")(
        models, tbs, 0.6, [torch.Generator().manual_seed(e)
                           for e in range(E)], True)
    loss_e.sum().backward()
    for e, m in enumerate(models):
        assert torch.equal(loss_e[e], solo[e][0])
        assert all(torch.equal(p.grad, g) for p, g in zip(m.parameters(),
                                                          solo[e][1]))


@pytest.mark.kernel
def test_members_match_vmapped_pallas_interpret():
    """The member losses and gradients against the JAX Pallas kernel under
    ``jax.vmap`` ('input' masks, interpret mode), its member axis lifted
    into the kernel grid."""
    jcfg, tcfg, params, models, batches = _members("unmasked", 0.1)
    fn = jfs.make_fused_loss_fn(jcfg, interpret=True, vmapped=True,
                                mask_mode="input")
    rngs = jnp.stack([jax.random.PRNGKey(100 + e) for e in range(E)])
    stack = lambda *xs: jnp.stack(xs)  # noqa: E731
    params_e = jax.tree.map(stack, *params)
    batch_e = jax.tree.map(stack, *[H.jbatch(b) for b in batches])
    l_ref, g_ref = jax.vmap(jax.value_and_grad(
        lambda p, b, k: fn(p, b, 0.7, k, True)))(params_e, batch_e, rngs)
    K = batches[0].obs.shape[0]
    masks = [H.jax_drop_masks(jcfg, rngs[e], K, B) for e in range(E)]
    loss = _port_members(fs.Spec(tcfg, "input"), models, batches, masks)
    np.testing.assert_allclose(loss.numpy(), np.asarray(l_ref), **H.LOSS_TOL)
    for e, m in enumerate(models):
        want = jax.tree.map(lambda x: np.asarray(x[e]), g_ref)
        np.testing.assert_allclose(H.flat(H.torch_grads_as_jax(m)),
                                   H.flat(want), **H.GRAD_TOL)


def test_member_wrappers_route_cpu_to_plain_and_count_nothing():
    """On CPU tensors the member wrappers run the plain versions and launch
    (count) nothing; ``reduce_partials_members_plain`` sums each member's
    rows in ascending order."""
    _, tcfg, _, models, batches = _members("unmasked", 0.0)
    fs.reset_launch_counts()
    tbs = [H.tbatch(b) for b in batches]
    loss = fs.make_fused_members_loss_fn(tcfg)(models, tbs, 0.5,
                                               [None] * E, True)
    loss.sum().backward()
    assert loss.shape == (E,) and all(v == 0 for v in fs.LAUNCHES.values())
    P = torch.randn(E, 5, 7, generator=torch.Generator().manual_seed(1))
    r = fs.reduce_partials_members_plain(P)
    assert all(torch.equal(r[e], fs.reduce_partials_plain(P[e]))
               for e in range(E))
