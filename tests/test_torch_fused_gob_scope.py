"""The GRU-ODE-Bayes kernels' full scope (ops/fused_gob.py): widths whose
buffers of one row overflow one CTA's shared memory (p_hidden 4,000) run in
the device-memory form of the activations (E3c). The plain versions K5/K6
at those widths against ``gru_ode_bayes.forward`` + ``jax.grad``, the
staged plain K6 (the kernels' own BPTT) over several chunks, the form's
layout and its hook at the published hidden 50, and ``supported`` against
the JAX rule and plan over a grid of configs."""

import numpy as np
import pytest

import conftest  # noqa: F401

import jax
import torch

import torch_port_helpers as H
from njode_tpu.models import gru_ode_bayes as jgob
from njode_tpu.ops import fused_gob as jfg
from njode_tpu_torch.models import gru_ode_bayes as tgob
from njode_tpu_torch.ops import fused_gob as fg

# the width of ROADMAP's E3c: D = 1, hidden 10, p_hidden 4,000, prep 10
WIDE = dict(D=1, hidden_size=10, p_hidden=4000, prep_hidden=10,
            cov_hidden=10, full_gru_ode=True, impute=True, mixing=1e-4)


def _arrays(tb):
    return (tb.times, tb.dt, tb.obs, tb.X, tb.M)


def test_wide_config_takes_the_device_memory_form():
    _, tcfg = H.gob_configs(**WIDE)
    spec = fg.Spec(tcfg)
    assert fg.supported(tcfg)
    assert spec.smem_bytes(1, acts="shared") == 243760 > fg.SMEM_LIMIT
    # every kernel of the config in the device-memory form (the eval
    # form's forward buffers alone would fit shared memory)
    assert spec.acts_for() == "global"
    assert spec.smem_bytes(1, bwd=False, acts="shared") <= fg.SMEM_LIMIT
    assert spec.slab_classes == ("P",)
    assert spec.rows_for(20) == spec.rows_for(2000, bwd=False) == 1
    assert spec.smem_bytes(1) <= fg.SMEM_LIMIT
    off, n_fwd, total = spec.layout(1, ga=True)
    for name in fg.BUFS:
        in_slab = bool(off[name] & fg.SLAB_BIT)
        assert in_slab == (fg._WIDTH[name] == "P"), name
    slab_fwd, slab_all = spec.slab_floats()
    assert slab_fwd == 6 * 4000 and slab_all == 2 * slab_fwd + 3 * 4000
    c = fg.make_cfg(spec, 100, 20, True, chain=True)
    assert (c.ga, c.rows, c.slab_fwd, c.slab_floats) == (1, 1, slab_fwd,
                                                         slab_all)
    # K6's workspace per (step, row) grows with P: the chunks shorten
    assert spec.bwd_chunk(100, 20) < 100
    assert 4 * 20 * spec.n_ws * spec.bwd_chunk(100, 20) <= fg.WS_BUDGET


@pytest.mark.parametrize("kw", [dict(dropout_rate=0.1),
                                dict(solver="midpoint", bias=False)],
                         ids=["euler_drop", "midpoint_nobias"])
def test_wide_config_matches_jax_grad(kw):
    """FusedGOBLoss (its plain versions on the CPU) at p_hidden 4,000
    against ``gru_ode_bayes.forward`` + ``jax.grad`` with the masks JAX
    draws (B = 8, K = 15)."""
    jcfg, tcfg = H.gob_configs(**dict(WIDE, **kw))
    params, model = H.gob_twin_models(jcfg, tcfg, seed=3)
    b = H.make_gob_np_batch(seed=4, D=1, B=8, steps=13, pad=2)
    K, B = b.obs.shape
    assert (K, B) == (15, 8)
    rng = jax.random.PRNGKey(7)
    l_ref, g_ref = jax.value_and_grad(lambda p: jgob.forward(
        p, jcfg, H.jbatch(b), rng=rng, train=True)[1])(params)
    tb = H.tbatch(b)
    spec = fg.Spec(tcfg, "input")
    u0c = u0p = u = None
    rate = 0.0
    if tcfg.dropout_rate:
        u0c, u0p, uk = (torch.as_tensor(x) for x in
                        H.gob_jax_drop_masks(jcfg, rng, K, B))
        u = uk.to(torch.int8)
        rate = tcfg.dropout_rate
    h0 = tgob.mlp2(model.covariates_map, tb.start_X, rate, u0c)
    p0 = tgob.mlp2(model.p_model, h0, rate, u0p)
    loss = fg.FusedGOBLoss.apply(
        spec, True, u, None, *_arrays(tb), h0, p0[:, :1].contiguous(),
        p0[:, 1:].contiguous(), *fg.flat_leaves(model, spec))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(l_ref),
                               **H.LOSS_TOL)
    got = H.gob_torch_grads_as_jax(model)
    ref = H.flat({k: v for k, v in g_ref.items() if k != "class_model"})
    np.testing.assert_allclose(
        H.flat({k: v for k, v in got.items() if k != "class_model"}), ref,
        **H.gob_grad_tol(ref))
    with torch.no_grad():
        ev = fg.make_fused_eval_fn(tcfg)(model, tb)
    _, ev_ref = jgob.forward(params, jcfg, H.jbatch(b), train=False)
    np.testing.assert_allclose(float(ev), float(ev_ref), **H.LOSS_TOL)


@pytest.mark.parametrize("chunk", [None, 4])
def test_wide_config_staged_bwd_carries_across_chunks(chunk):
    """K6 as the kernels stage it (remat, chain, wgrad per chunk, the carry
    gradients passed from chunk to chunk) at p_hidden 4,000 against the
    autograd plain K6, with dropout ('prng' masks)."""
    _, tcfg = H.gob_configs(**dict(WIDE, dropout_rate=0.1))
    model = tgob.GOB(tcfg, generator=torch.Generator().manual_seed(2))
    b = H.tbatch(H.make_gob_np_batch(seed=5, D=1, B=8, steps=13, pad=2))
    spec = fg.Spec(tcfg, "prng")
    leaves = [p.detach() for p in fg.flat_leaves(model, spec)]
    seed = torch.tensor([987654321], dtype=torch.int64)
    with torch.no_grad():
        h0 = tgob.mlp2(model.covariates_map, b.start_X, 0.0)
        p0 = tgob.mlp2(model.p_model, h0, 0.0)
    _, hists = fg.gob_scan_fwd_plain(spec, leaves, _arrays(b), h0,
                                     p0[:, :1], p0[:, 1:], True, None, seed)
    ref = fg.gob_scan_bwd_plain(spec, leaves, _arrays(b), True, hists,
                                torch.tensor(1.3), None, seed)
    got = fg.gob_scan_bwd_staged_plain(spec, leaves, _arrays(b), True,
                                       hists, 1.3, None, seed, chunk=chunk)
    tol = H.gob_grad_tol(np.concatenate([g.numpy().ravel()
                                         for g in ref[0]]))
    for i, (a, r) in enumerate(zip(got[0], ref[0])):
        np.testing.assert_allclose(a.numpy(), r.numpy(), err_msg=f"leaf {i}",
                                   **tol)
    for a, r in zip(got[1:], ref[1:]):
        np.testing.assert_allclose(a.numpy(), r.numpy(),
                                   **H.gob_grad_tol(r.numpy()))


def test_forced_device_memory_form_at_hidden_50():
    """The hook: ``Spec(acts='global')`` at the published hidden 50 (where
    both forms fit) keeps the P-wide buffers in the slab and every other
    choice of the call as the shared form makes it (rows, threads, weights
    in shared memory, mask words), so the card can hold the two bit for
    bit."""
    _, cfg = H.gob_configs(D=1, hidden_size=50, p_hidden=50, prep_hidden=50,
                           cov_hidden=50, full_gru_ode=True, impute=True,
                           dropout_rate=0.1)
    shared, glob = fg.Spec(cfg), fg.Spec(cfg, acts="global")
    assert shared.acts_for() == "shared" and glob.acts_for() == "global"
    with pytest.raises(ValueError, match="one row"):
        fg.Spec(cfg, rows=2, acts="global")
    for bwd, chain, B in ((True, False, 20), (True, True, 20),
                          (False, False, 20)):
        a = fg.make_cfg(shared, 100, B, True, bwd=bwd, chain=chain)
        g = fg.make_cfg(glob, 100, B, True, bwd=bwd, chain=chain)
        assert (a.ga, g.ga) == (0, 1)
        for f in ("rows", "threads", "wsm", "n_mw", "nw", "n_ws"):
            assert getattr(a, f) == getattr(g, f), f
        assert g.smem_floats < a.smem_floats and g.slab_floats > 0
    off, _, _ = glob.layout(1, ga=True)
    assert off["a2"] & fg.SLAB_BIT and not off["h2"] & fg.SLAB_BIT


# the grid: D, hidden, p_hidden, prep of the published arms and beyond
_GRID = [(h, p, prep) for h in (10, 50, 100, 400)
         for p in (25, 50, 400, 4000) for prep in (10, 50)]


@pytest.mark.parametrize("D,solver", [
    (1, "euler"), (5, "euler"), (41, "euler"), (1, "midpoint"),
    (5, "midpoint"), (41, "midpoint"), (1, "dopri5")])
def test_supported_agrees_with_the_jax_rule_and_plan(D, solver):
    """Every config that the JAX rule (``supported``) takes and its
    ``_plan`` plans at K = 100 or 2,004 (B = 20) the port's ``supported``
    takes, p_hidden 4,000 among them; dopri5 both refuse."""
    n_planned = n_wide = 0
    for hidden, p_hidden, prep in _GRID:
        jcfg, tcfg = H.gob_configs(D=D, hidden_size=hidden,
                                   p_hidden=p_hidden, prep_hidden=prep,
                                   cov_hidden=hidden, full_gru_ode=True,
                                   impute=solver != "dopri5", solver=solver,
                                   dropout_rate=0.1)
        jplan = jfg.supported(jcfg) and any(
            jfg._plan(jfg._Spec(jcfg, "input"), K, 20, True) is not None
            for K in (100, 2004))
        n_planned += bool(jplan)
        if jplan:
            assert fg.supported(tcfg), (hidden, p_hidden, prep)
            n_wide += fg.Spec(tcfg).acts_for() == "global"
        assert fg.supported(tcfg) == (solver != "dopri5")
    assert (n_planned > 0) == (solver != "dopri5")
