"""K6's three stages (ops/fused_gob.py ``gob_scan_bwd_staged_plain``: the
hand-derived BPTT the CUDA kernels run, remat / chain / wgrad, in their
workspace layout) against the JAX package's Pallas K6 in interpret mode and
against the autograd plain version ``gob_scan_bwd_plain``; the rows-per-CTA
rule at the published configurations; and stage (c)'s program.

The CUDA stages themselves run only on the card
(tests/test_torch_fused_gob_card.py holds them against this plain version
there). Tolerances: gradients rtol 2e-4 / atol 2e-5 scaled by the largest
|g| (``torch_port_helpers.gob_grad_tol`` says why)."""

import numpy as np
import pytest

import conftest  # noqa: F401

import jax.numpy as jnp
import torch

import torch_port_helpers as H
from njode_tpu.models import gru_ode_bayes as jgob
from njode_tpu.ops import fused_gob as jfg
from njode_tpu_torch.models import gru_ode_bayes as tgob
from njode_tpu_torch.ops import fused_gob as fg

# (id, config): full and minimal field, impute on and off, logvar on and
# off, euler, midpoint and the discretized cell, dropout
STAGED = [
    ("full_impute_drop", dict(full_gru_ode=True, impute=True,
                              dropout_rate=0.1)),
    ("minimal_absvar_impute", dict(logvar=False, impute=True)),
    ("minimal_noimpute", dict()),
    ("mid_impute", dict(solver="midpoint", impute=True)),
    ("mid_full_noimpute_drop", dict(solver="midpoint", full_gru_ode=True,
                                    dropout_rate=0.1)),
    ("disc_impute", dict(discretized=True, impute=True)),
]


def _arrays(tb):
    return (tb.times, tb.dt, tb.obs, tb.X, tb.M)


def _setup(kw, seed=3):
    jcfg, tcfg = H.gob_configs(**kw)
    params, model = H.gob_twin_models(jcfg, tcfg)
    b = H.make_gob_np_batch(seed=seed)
    K, B = b.obs.shape
    u_keep = np.random.RandomState(5).random((K, 3, B, jcfg.p_hidden)) < 0.9
    jb = H.jbatch(b)
    h0 = jgob._mlp2(params["cov_map"], jb.start_X, 0.0, None, False,
                    final_act=jnp.tanh)
    p0 = jgob._mlp2(params["p_model"], h0, 0.0, None, False)
    D = jcfg.input_size
    st = tuple(np.asarray(x) for x in (h0, p0[:, :D], p0[:, D:]))
    return jcfg, tcfg, params, model, b, u_keep, st


def _torch_run(tcfg, model, b, u_keep, st):
    spec = fg.Spec(tcfg, "input")
    leaves = [p.detach() for p in fg.flat_leaves(model, spec)]
    tb = H.tbatch(b)
    u = (torch.as_tensor(u_keep).to(torch.int8) if tcfg.dropout_rate
         else None)
    _, hists = fg.gob_scan_fwd_plain(spec, leaves, _arrays(tb),
                                     *(torch.tensor(x) for x in st), True, u)
    return spec, leaves, _arrays(tb), hists, u


@pytest.mark.parametrize("kw", [c for _, c in STAGED],
                         ids=[i for i, _ in STAGED])
def test_staged_plain_matches_pallas_interpret_and_autograd(kw):
    """Every leaf gradient and d(h0, m0, v0) of the staged plain K6 against
    the interpret-mode ``_fused_bwd`` with the same 'input'-mode masks and
    against the autograd plain K6, on a batch with two dt == 0 padding
    steps."""
    jcfg, tcfg, params, model, b, u_keep, st = _setup(kw)
    K, B = b.obs.shape
    jspec = jfg._Spec(jcfg, "input")
    key = jspec.key()
    jfg._SPECS[key] = jspec
    u_j = (jnp.asarray(u_keep, jnp.int8) if jcfg.dropout_rate > 0
           else jnp.zeros((1, 1, 1, 1), jnp.int8))
    jb = H.jbatch(b)
    flat_j = jfg._flatten_params(params, jspec)
    arrays_j = (jb.times, jb.dt, jb.obs, jb.X, jb.M)
    shapes = (K, K, 1, B, True)
    seed_j = jnp.float32(0.0)
    _, hists_r = jfg._fwd_impl(key, shapes, True, flat_j, arrays_j, u_j,
                               seed_j, *(jnp.asarray(x) for x in st))
    g = jfg._fused_bwd(key, shapes, True,
                       (flat_j, arrays_j, u_j, seed_j, hists_r),
                       jnp.float32(1.3))
    g_r, d_r = g[0], g[-3:]
    spec, leaves, arrays, hists, u = _torch_run(tcfg, model, b, u_keep, st)
    got = fg.gob_scan_bwd_staged_plain(spec, leaves, arrays, True, hists,
                                       torch.tensor(1.3), u)
    auto = fg.gob_scan_bwd_plain(spec, leaves, arrays, True, hists,
                                 torch.tensor(1.3), u)
    tol = H.gob_grad_tol(np.concatenate([np.ravel(np.asarray(x))
                                         for x in g_r]))
    for i, (a, r, c) in enumerate(zip(got[0], g_r, auto[0])):
        np.testing.assert_allclose(a.numpy(), np.asarray(r),
                                   err_msg=f"leaf {i} vs JAX", **tol)
        np.testing.assert_allclose(a.numpy(), c.numpy(),
                                   err_msg=f"leaf {i} vs autograd", **tol)
    for n, a, r, c in zip(("dh0", "dm0", "dv0"), got[1:], d_r, auto[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), err_msg=n,
                                   **H.gob_grad_tol(r))
        np.testing.assert_allclose(a.numpy(), c.numpy(), err_msg=n,
                                   **H.gob_grad_tol(r))


@pytest.mark.parametrize("chunk", [1, 5, None], ids=["1", "5", "default"])
def test_staged_plain_chunks_agree(chunk):
    """K split into chunks (the carries passed from chunk to chunk, stage
    (c) adding chunk by chunk) gives the gradients of one chunk of all K
    steps; the default chunk at these shapes is one chunk, bit for bit."""
    kw = dict(solver="midpoint", full_gru_ode=True, impute=True,
              dropout_rate=0.1)
    _, tcfg, _, model, b, u_keep, st = _setup(kw)
    spec, leaves, arrays, hists, u = _torch_run(tcfg, model, b, u_keep, st)
    K, B = b.obs.shape
    one = fg.gob_scan_bwd_staged_plain(spec, leaves, arrays, True, hists,
                                       torch.tensor(1.3), u, chunk=K)
    got = fg.gob_scan_bwd_staged_plain(spec, leaves, arrays, True, hists,
                                       torch.tensor(1.3), u, chunk=chunk)
    if chunk is None:
        assert spec.bwd_chunk(K, B) == K
        for a, c in zip(got[0] + list(got[1:]), one[0] + list(one[1:])):
            assert torch.equal(a, c)
        return
    tol = H.gob_grad_tol(torch.cat([g.reshape(-1) for g in one[0]]))
    for i, (a, c) in enumerate(zip(got[0], one[0])):
        np.testing.assert_allclose(a.numpy(), c.numpy(), err_msg=f"leaf {i}",
                                   **tol)
    for a, c in zip(got[1:], one[1:]):
        np.testing.assert_allclose(a.numpy(), c.numpy(),
                                   **H.gob_grad_tol(c))


@pytest.mark.parametrize("kw", [STAGED[0][1], STAGED[3][1], STAGED[5][1]],
                         ids=["euler", "midpoint", "disc"])
def test_padding_steps_add_nothing(kw):
    """A dt == 0 padding step passes the carries through and adds nothing
    to any gradient: the workspace's propagation deltas are 0 there, and
    the staged gradients with the two padding steps equal those of the
    batch without them."""
    _, tcfg, _, model, b, u_keep, st = _setup(kw)
    spec, leaves, arrays, hists, u = _torch_run(tcfg, model, b, u_keep, st)
    K, B = b.obs.shape
    n_pad = int((b.dt == 0).sum())
    assert n_pad == 2 and (b.dt[-2:] == 0).all()
    full = fg.gob_scan_bwd_staged_plain(spec, leaves, arrays, True, hists,
                                        torch.tensor(1.3), u, want_ws=True)
    ws = full[4]
    for name, prop in spec.deltas:
        rows = fg.ws_view(spec, ws, K * B, name)[(K - n_pad) * B:]
        if prop:
            assert torch.count_nonzero(rows) == 0, name
    Kt = K - n_pad
    cut = tuple(a[:Kt] for a in arrays)
    hcut = tuple(x[:Kt] for x in hists)
    ucut = None if u is None else u[:Kt]
    short = fg.gob_scan_bwd_staged_plain(spec, leaves, cut, True, hcut,
                                         torch.tensor(1.3), ucut)
    tol = H.gob_grad_tol(torch.cat([g.reshape(-1) for g in short[0]]))
    for i, (a, c) in enumerate(zip(full[0], short[0])):
        np.testing.assert_allclose(a.numpy(), c.numpy(), err_msg=f"leaf {i}",
                                   **tol)
    for a, c in zip(full[1:4], short[1:]):
        np.testing.assert_allclose(a.numpy(), c.numpy(),
                                   **H.gob_grad_tol(c))


# the configurations of the rows rule: the published
# GOB grid's two widths, the climate arm, and the two widths that trained
# eagerly before one-row CTAs): (id, config, n_params, R at B = 20, R at
# B = 100, the eval form's R at B = 2,000, whether K5 and the chain stage
# the weights in shared memory at B = 20)
ROW_CONFIGS = [
    ("gob_h50", dict(input_size=1, hidden_size=50, p_hidden=50,
                     prep_hidden=50, cov_hidden=50, full_gru_ode=True,
                     impute=True), 26152, 1, 1, 8, True),
    ("gob_h100", dict(input_size=1, hidden_size=100, p_hidden=100,
                      prep_hidden=100, cov_hidden=100, full_gru_ode=True,
                      impute=True), 102302, 1, 1, 8, False),
    ("climate_gob", dict(input_size=5, hidden_size=50, p_hidden=25,
                         prep_hidden=10, cov_hidden=50, full_gru_ode=True,
                         impute=False), 25385, 1, 1, 8, True),
    ("d1_w200", dict(input_size=1, hidden_size=200, p_hidden=200,
                     prep_hidden=200, cov_hidden=200, full_gru_ode=True,
                     impute=True), 404602, 1, 1, 8, False),
    ("d41_w50", dict(input_size=41, hidden_size=50, p_hidden=50,
                     prep_hidden=50, cov_hidden=50, full_gru_ode=True,
                     impute=True), 680232, 1, 1, 8, False),
]


@pytest.mark.parametrize("row", ROW_CONFIGS, ids=[r[0] for r in ROW_CONFIGS])
def test_rows_rule_at_published_configs(row):
    """The rule takes the fewest rows that fit with every CTA resident at
    once (two of 256 threads an SM): one row at the training batches (20
    and 100) and eight at the eval form's B = 2,000. K5 and the chain
    stage the weights in shared memory where they fit beside the
    activations at one CTA an SM (hidden 50 and the climate arm; not
    hidden 100 or the wide ones, nor the eval's 250 CTAs). They take 512
    threads a CTA where the batch takes at most one CTA an SM and the
    weights stay in device memory (hidden 100, the wide ones), else 256,
    whatever ``weights`` forces. Every configuration of the table is supported (the
    two wide ones trained eagerly while a CTA owned 8 rows)."""
    _, kw, n_params, r20, r100, r_eval, staged = row
    cfg = tgob.GOBConfig(**kw)
    spec = fg.Spec(cfg)
    assert spec.n_params == n_params
    assert fg.supported(cfg)
    assert spec.rows_for(20) == r20 and spec.rows_for(100) == r100
    assert spec.rows_for(2000, bwd=False) == r_eval
    assert spec.stage_weights(20) == spec.stage_weights(20, chain=True) \
        == staged
    assert not spec.stage_weights(2000, bwd=False)
    assert fg.make_cfg(spec, 100, 20, True, chain=True).wsm == int(staged)
    assert not fg.Spec(cfg, weights="global").stage_weights(20)
    if staged:
        assert fg.Spec(cfg, weights="shared").stage_weights(2000, False)
    else:
        with pytest.raises(ValueError, match="shared memory"):
            fg.Spec(cfg, weights="shared").stage_weights(20, chain=True)
    for R in fg.ROW_CHOICES:
        assert spec.fits(R) == (spec.smem_bytes(R) <= fg.SMEM_LIMIT)
        assert spec.fits(R, False) == (spec.smem_bytes(R, False)
                                       <= fg.SMEM_LIMIT)
    assert spec.threads_for(20) == spec.threads_for(100) == \
        (256 if staged else 512)
    assert fg.Spec(cfg, weights="global").threads_for(20) == \
        spec.threads_for(20)
    assert spec.threads_for(2000, bwd=False) == 256
    assert fg.Spec(cfg, rows=8).rows_for(20) == 8
    assert fg.make_cfg(spec, 100, 20, True).rows == r20
    with pytest.raises(ValueError, match="rows"):
        fg.Spec(cfg, rows=3)


@pytest.mark.parametrize("kw", [c for _, c in STAGED],
                         ids=[i for i, _ in STAGED])
def test_wgrad_program_covers_every_leaf(kw):
    """Stage (c)'s jobs pair each leaf with an input of its row count (ones
    for a bias) and a delta of its column count, both in the workspace;
    its tiles cover every element of every leaf once; the workspace's
    buffers sit back to back."""
    _, tcfg = H.gob_configs(**kw)
    spec = fg.Spec(tcfg)
    tiles, jobs = spec.wgrad_tiles()
    deltas = {n for n, _ in spec.deltas}
    for leaf, x, d in jobs:
        a, c = spec.leaf_shapes[leaf]
        assert (1 if x is None else spec.width(x)) == a
        assert spec.width(d) == c and d in deltas
        assert x is None or x in fg.SAVED
    seen = np.zeros(spec.n_params, np.int64)
    for leaf, i0, j0, first, n in tiles:
        a, c = spec.leaf_shapes[leaf]
        assert [j[0] for j in jobs[first:first + n]] == [leaf] * n
        blk = np.zeros((a, c), np.int64)
        blk[i0:i0 + fg.WG_TILE, j0:j0 + fg.WG_TILE] = 1
        seen[spec.leaf_off[leaf]:spec.leaf_off[leaf + 1]] += blk.ravel()
    assert (seen == 1).all()
    off = 0
    for name in fg.SAVED + tuple(d for d, _ in spec.deltas):
        assert spec.ws_off[name] == off
        off += spec.width(name)
    assert off == spec.n_ws
    prog_t, prog_j = spec.wgrad_program("cpu")
    assert prog_t.shape == (len(tiles), 7) and prog_j.shape == (len(jobs), 4)
