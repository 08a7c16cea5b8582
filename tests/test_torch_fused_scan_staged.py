"""K2 in three stages (ops/fused_scan.py ``scan_bwd_staged_plain``, the
plain version of the CUDA C call's stages): (a) the forward re-run of every
(step, row) pair of a chunk into the workspace records, (b) the chain,
which writes the gradient of every Linear's output (and of the GRU's gate
sums) to the records, (c) the weight gradients as ``d^T x`` per stretch of
steps. Held against the JAX package (``njode.forward`` and ``jax.grad``,
solo and ``jax.vmap``-ed over E = 3 members) through the fused losses with
the staged plain version in place of the single-walk one, against the
single-walk plain K2, across chunk lengths that do not divide K (the same
bits at one stretch), and the workspace's programs against the layout
(every leaf's jobs, every field once, the layer table's delta offsets)."""

import numpy as np
import pytest

import conftest  # noqa: F401

import jax
import jax.numpy as jnp
import torch

import torch_port_helpers as H
from njode_tpu.models import njode as jnjode
from njode_tpu_torch.ops import fused_scan as fs
from test_torch_fused_scan_members import (_jax_reference, _members,
                                           _port_members)

# (id, D, config overrides): both jumps, masked or not, an output of
# another width than the input (the global plan alone), a 9-linear ODE net
CASES = [("unmasked", 1, dict()), ("masked", 2, dict(masked=True)),
         ("rnn", 2, dict(use_rnn=True)),
         ("masked_rnn", 2, dict(masked=True, use_rnn=True)),
         ("D2_O1", 2, dict(output_size=1)),
         ("ode9", 1, dict(ode_nn=((13, "tanh"),) * 8))]
# K = 16 steps: chunks of 5 (a multiple of the stretch, 2: 6) and 7 (8)
CHUNK, STRETCH = 5, 2


def _staged(monkeypatch, chunk=CHUNK, stretch=STRETCH):
    """Route the CPU K2 (solo and member) through the staged plain
    version."""
    solo, members = fs.scan_bwd_staged_plain, fs.scan_bwd_members_staged_plain
    monkeypatch.setattr(fs, "scan_bwd_plain", lambda *a: solo(
        *a, chunk=chunk, stretch=stretch))
    monkeypatch.setattr(fs, "scan_bwd_members_plain", lambda *a: members(
        *a, chunk=chunk, stretch=stretch))


def _batch(D, masked):
    return (H.make_masked_np_batch(seed=3, D=D) if masked
            else H.make_np_batch(seed=3, D=D, pad=2))


# the GRU jump's masked branch runs in the member case below
JAX_CASES = [c for c in CASES if c[0] != "masked_rnn"]


@pytest.mark.parametrize("case", JAX_CASES, ids=[c[0] for c in JAX_CASES])
def test_staged_k2_matches_jax(monkeypatch, case):
    """The loss and every gradient of FusedNJODELoss with K2's three
    stages in plain torch (chunks of 6 steps, stretches of 2) against
    ``jax.value_and_grad(njode.forward)``, the dropout masks the JAX
    forward draws fed in 'input' mode."""
    _, D, kw = case
    jcfg, tcfg = H.configs(D, 10, dropout_rate=0.1, **kw)
    params, model = H.twin_models(jcfg, tcfg)
    b = _batch(D, tcfg.masked)
    K, B = b.obs.shape
    rng = jax.random.PRNGKey(7)
    l_ref, g_ref = jax.value_and_grad(lambda p: jnjode.forward(
        p, jcfg, H.jbatch(b), weight=0.7, rng=rng, train=True)[1])(params)
    _staged(monkeypatch)
    spec = fs.Spec(tcfg, "input")
    assert -(-K // spec.bwd_chunk(K, B, 1, CHUNK, STRETCH)) > 1
    u0, uk = H.jax_drop_masks(jcfg, rng, K, B)
    tb = H.tbatch(b)
    h0 = fs.t0_state(model, tb, [torch.as_tensor(u0[i])
                                 for i in range(spec.n_enc)])
    loss = fs.FusedNJODELoss.apply(
        spec, True, 0.7, torch.as_tensor(uk).to(torch.int8), None,
        tb.times, tb.dt, tb.obs, tb.X, tb.n_obs_ot, tb.start_X,
        tb.M if tcfg.masked else None, h0, *fs.flat_leaves(model))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(l_ref),
                               **H.LOSS_TOL)
    np.testing.assert_allclose(H.flat(H.torch_grads_as_jax(model)),
                               H.flat(g_ref), **H.GRAD_TOL)


@pytest.mark.parametrize("case", ["masked_rnn"])
def test_staged_members_match_vmapped_jax(monkeypatch, case):
    """E = 3 members through FusedNJODEMembersLoss with the member K2's
    three stages in plain torch against ``jax.vmap`` of the JAX forward's
    value and gradient, each member's masks fed in 'input' mode."""
    jcfg, tcfg, params, models, batches = _members(case, 0.1)
    E = len(models)
    rngs = jnp.stack([jax.random.PRNGKey(100 + e) for e in range(E)])
    l_ref, g_ref = _jax_reference(jcfg, params, batches, rngs)
    _staged(monkeypatch)
    spec = fs.Spec(tcfg, "input")
    K, B = batches[0].obs.shape
    masks = [H.jax_drop_masks(jcfg, rngs[e], K, B) for e in range(E)]
    loss = _port_members(spec, models, batches, masks)
    np.testing.assert_allclose(loss.numpy(), np.asarray(l_ref), **H.LOSS_TOL)
    for e, m in enumerate(models):
        want = jax.tree.map(lambda x: np.asarray(x[e]), g_ref)
        np.testing.assert_allclose(H.flat(H.torch_grads_as_jax(m)),
                                   H.flat(want), **H.GRAD_TOL)


def _scan_inputs(case, seed=4):
    _, D, kw = case
    _, tcfg = H.configs(D, 10, dropout_rate=0.1, **kw)
    _, model = H.twin_models(*H.configs(D, 10, dropout_rate=0.1, **kw))
    tb = H.tbatch(_batch(D, tcfg.masked))
    spec = fs.Spec(tcfg, "prng")
    leaves = [p.detach() for p in fs.flat_leaves(model)]
    arrays = fs.batch_arrays(tb)
    with torch.no_grad():
        h0 = fs.t0_state(model, tb)
    seed = torch.tensor([seed * 7919 + 11], dtype=torch.int64)
    _, hists = fs.scan_fwd_plain(spec, leaves, arrays, 0.6, h0, True, None,
                                 seed)
    return spec, leaves, arrays, hists, seed


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_staged_equals_single_walk_at_any_chunk(case):
    """The staged plain K2's gradients and dh0 against the single-walk
    plain K2 ('prng' masks, cotangent 1.3): within fp32 rounding at the
    default chunk and stretch and at chunks of 6 and 8 steps (16 = 6 + 6 +
    4 = 8 + 8) over stretches of 2, and those two chunkings the same bits
    (the partial rows are the stretches' sums whatever the chunk)."""
    spec, leaves, arrays, hists, seed = _scan_inputs(case)
    dl = torch.tensor(1.3)
    g0, d0 = fs.scan_bwd_plain(spec, leaves, arrays, 0.6, True, hists, dl,
                               None, seed)
    runs = [fs.scan_bwd_staged_plain(spec, leaves, arrays, 0.6, True, hists,
                                     dl, None, seed, c, s)
            for c, s in ((None, None), (CHUNK, STRETCH), (7, STRETCH))]
    for g, d in runs:
        for a, b in zip(g + [d], g0 + [d0]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                       atol=1e-7)
    (ga, da), (gb, db) = runs[1:]
    assert all(torch.equal(a, b) for a, b in zip(ga + [da], gb + [db]))
    K, B = arrays[2].shape
    assert spec.bwd_chunk(K, B, 1, CHUNK, STRETCH) == 6
    assert spec.bwd_chunk(K, B, 1, 7, STRETCH) == 8


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_workspace_programs_cover_every_leaf_and_field(case):
    """The workspace record: every field once, back to back; stage (a)'s
    copy program (the forward layout at ``remat_rows``) and the resident
    chain's (its io set 0) every forward float of the record (the first
    floats, the deltas after them), each at its own place inside one
    CTA's layout, the global chain's the Linears' inputs alone; the layer
    table's ``dlt`` each Linear's delta field; stage (c)'s tiles cover
    every element of every leaf once, each leaf's jobs in leaf order (the
    readout's two halves two jobs, none for the encoder with the GRU
    jump); the chunk a multiple of the stretch."""
    _, D, kw = case
    _, tcfg = H.configs(D, 10, dropout_rate=0.1, **kw)
    spec = fs.Spec(tcfg, "prng")
    n = 0
    for name, w, kind in spec.ws_fields:
        assert spec.ws_off[name] == n and kind in "xfd"
        n += w
    assert spec.rec == -(-n // 4) * 4
    assert spec.n_fwd == sum(w for _, w, k in spec.ws_fields if k != "d")
    # the resident chain's io set holds the forward fields as the record
    # does, R rows a field (at one row the record's image)
    for R in (1, 2):
        off = spec.layout(R, "resident", True)[0]
        for name, w, kind in spec.ws_fields:
            if kind != "d":
                assert spec._field_at(name, off, R) == (
                    off["fwd"] + R * spec.ws_off[name], w)
    widths = dict((f[0], f[1]) for f in spec.ws_fields)
    for kind, R, plan, bwd in (("a", spec.remat_rows(), "resident", False),
                               ("b", 1, "resident", True),
                               ("x", 4, "global", True)):
        if plan == "resident" and spec.plan != "resident":
            continue
        prog = spec.ws_program(kind, R)
        names = spec.ws_fields_of(kind)
        assert len(prog) == sum(widths[n] for n in names)
        _, total = spec.layout(R, plan, bwd)
        floats = [spec.ws_off[n] + j for n in names
                  for j in range(widths[n])]
        assert [p[0] for p in prog] == floats
        for ro, so, ss in prog:
            assert 0 <= so and so + (R - 1) * ss < total
        if kind != "x":
            # every forward float of the record, the deltas after them
            assert floats == list(range(len(floats)))
            assert len({(so, ss) for _, so, ss in prog}) == len(prog)
        else:
            assert {n[0] for n in names} <= {"in_ode", "tX", "in_ro", "act"}
    head = spec.table_head()[:spec.tab_leaves].view(-1, fs.LAYER_INTS)
    rec = 0
    for net, ws in (("ode", spec.ode_w), ("enc", spec.enc_w),
                    ("ro", spec.ro_w)):
        for l in range(len(ws) - 1):
            assert int(head[rec, 7]) == spec.ws_off.get(("d", net, l, 0), -1)
            rec += 1
    jobs = spec.wgrad_jobs()
    assert [j[0] for j in jobs] == sorted(j[0] for j in jobs)
    per = 2 if spec.bias else 1            # a weight (and its bias) a Linear
    enc0 = per * (len(spec.ode_w) - 1)
    enc = range(enc0, enc0 + per * (len(spec.enc_w) - 1))
    for leaf in range(len(spec.leaf_shapes)):
        mine = [j for j in jobs if j[0] == leaf]
        if spec.use_rnn and leaf in enc:
            assert not mine
        else:
            assert mine and all(widths[d] == spec.leaf_shapes[leaf][0]
                                for _, _, d in mine)
    tiles, jobs_t = spec.wgrad_program("cpu")
    cover = torch.zeros(spec.n_params, dtype=torch.int64)
    for loff, inp, out, j0, i0, _, _, boff in tiles.tolist():
        jj = torch.arange(j0, min(j0 + fs.WG_TILE, out))
        ii = torch.arange(i0, min(i0 + fs.WG_TILE, inp))
        cover[loff + (jj[:, None] * inp + ii[None, :]).reshape(-1)] += 1
        if boff >= 0 and i0 <= inp < i0 + fs.WG_TILE:   # the bias column
            cover[boff + jj] += 1
    assert bool((cover == 1).all()) and jobs_t.shape[1] == 2
    assert len(spec.bias_of) == sum(len(s) == 1 for s in spec.leaf_shapes)
    for K, B, E in ((100, 200, 1), (100, 100, 5), (3006, 50, 5)):
        Ks = spec.wgrad_steps(B)
        Kc = spec.bwd_chunk(K, B, E)
        assert Kc % Ks == 0 and Kc <= -(-K // Ks) * Ks
        assert Kc == Ks or 4 * E * Kc * B * spec.rec <= fs.WS_BUDGET
