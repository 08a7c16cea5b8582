"""The port's fused GOB scan (ops/fused_gob.py) against the JAX package's
Pallas kernels in interpret mode and ``gru_ode_bayes.forward`` +
``jax.grad``.

The CUDA kernels themselves run only on the card (``chip_smoke.py`` and
``tests/test_torch_fused_gob_card.py`` hold each against its plain version
there); here the plain versions K5-K7 are held against the JAX reference,
and the wrappers' routing is checked. Tolerances: loss rtol 1e-5 / atol
1e-6, gradients rtol 2e-4 / atol 2e-5 scaled by the largest |g|
(``torch_port_helpers.gob_grad_tol`` says why)."""

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
from njode_tpu.models import gru_ode_bayes as jgob
from njode_tpu.ops import fused_gob as jfg
from njode_tpu.training import steps as jsteps
from njode_tpu_torch.data import datasets as tdatasets
from njode_tpu_torch.models import gru_ode_bayes as tgob
from njode_tpu_torch.ops import fused_gob as fg
from njode_tpu_torch.ops import fused_scan as fs
from njode_tpu_torch.training import steps as tsteps
from njode_tpu_torch.training import trainer as ttrainer
from njode_tpu_torch.training.jax_compat import \
    gob_state_dict_from_jax_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _arrays(tb):
    return (tb.times, tb.dt, tb.obs, tb.X, tb.M)


def _prologue_np(jcfg, params, b):
    """(h0, m0, v0) of the t=0 prologue without dropout (numpy)."""
    jb = H.jbatch(b)
    h0 = jgob._mlp2(params["cov_map"], jb.start_X, 0.0, None, False,
                    final_act=jnp.tanh)
    p0 = jgob._mlp2(params["p_model"], h0, 0.0, None, False)
    D = jcfg.input_size
    return (np.asarray(h0), np.asarray(p0[:, :D]), np.asarray(p0[:, D:]))


@pytest.mark.parametrize("kw", [
    dict(full_gru_ode=True, impute=True, dropout_rate=0.1),
    dict(solver="midpoint", logvar=False, impute=True, dropout_rate=0.1),
    dict(discretized=True, impute=True)],
    ids=["full_impute_drop", "mid_absvar_drop", "disc_impute"])
def test_plain_k5_k6_match_pallas_interpret(kw):
    """The flattener's leaves, plain K5 (loss + the three carry
    histories) and plain K6 (every leaf gradient, dh0, dm0, dv0) against
    the interpret-mode ``_fwd_impl`` / ``_fused_bwd``, with the same
    'input'-mode masks."""
    jcfg, tcfg = H.gob_configs(**kw)
    params, model = H.gob_twin_models(jcfg, tcfg)
    b = H.make_gob_np_batch(seed=3)
    K, B = b.obs.shape
    jspec = jfg._Spec(jcfg, "input")
    key = jspec.key()
    jfg._SPECS[key] = jspec
    train = True
    u_keep = np.random.RandomState(5).random((K, 3, B, jcfg.p_hidden)) < 0.9
    u_j = (jnp.asarray(u_keep, jnp.int8) if jcfg.dropout_rate > 0
           else jnp.zeros((1, 1, 1, 1), jnp.int8))
    h0, m0, v0 = _prologue_np(jcfg, params, b)
    jb = H.jbatch(b)
    flat_j = jfg._flatten_params(params, jspec)
    arrays_j = (jb.times, jb.dt, jb.obs, jb.X, jb.M)
    shapes = (K, K, 1, B, train)
    seed_j = jnp.float32(0.0)
    loss_r, hists_r = jfg._fwd_impl(key, shapes, True, flat_j, arrays_j,
                                    u_j, seed_j, jnp.asarray(h0),
                                    jnp.asarray(m0), jnp.asarray(v0))
    g = jfg._fused_bwd(key, shapes, True,
                       (flat_j, arrays_j, u_j, seed_j, hists_r),
                       jnp.float32(1.3))
    g_r, (dh0_r, dm0_r, dv0_r) = g[0], g[-3:]

    spec = fg.Spec(tcfg, "input")
    leaves = [p.detach() for p in fg.flat_leaves(model, spec)]
    assert len(leaves) == len(flat_j) == len(spec.leaf_shapes)
    for lt, lj, s in zip(leaves, flat_j, spec.leaf_shapes):
        assert tuple(lt.shape) == tuple(lj.shape) == s
        np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    tb = H.tbatch(b)
    u = torch.as_tensor(u_keep).to(torch.int8) if tcfg.dropout_rate else None
    loss, hists = fg.gob_scan_fwd_plain(
        spec, leaves, _arrays(tb), torch.tensor(h0), torch.tensor(m0),
        torch.tensor(v0), train, u)
    np.testing.assert_allclose(float(loss), float(loss_r), **H.LOSS_TOL)
    for a, r in zip(hists, hists_r):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-5,
                                   atol=1e-5)
    grads, dh0, dm0, dv0 = fg.gob_scan_bwd_plain(
        spec, leaves, _arrays(tb), train, hists, torch.tensor(1.3), u)
    tol = H.gob_grad_tol(np.concatenate([np.ravel(np.asarray(x))
                                         for x in g_r]))
    for i, (gt, gr) in enumerate(zip(grads, g_r)):
        np.testing.assert_allclose(gt.numpy(), np.asarray(gr),
                                   err_msg=f"leaf {i}", **tol)
    for a, r in ((dh0, dh0_r), (dm0, dm0_r), (dv0, dv0_r)):
        np.testing.assert_allclose(a.numpy(), np.asarray(r),
                                   **H.gob_grad_tol(r))


@pytest.mark.parametrize("kw", H.GOB_CONFIGS, ids=H.GOB_IDS)
def test_fused_loss_matches_jax_grad(kw):
    """FusedGOBLoss end to end (the t=0 prologue outside, its gradient
    through dh0/dm0/dv0) against ``gru_ode_bayes.forward`` + ``jax.grad``
    with the masks JAX draws, over the 13 configurations."""
    jcfg, tcfg = H.gob_configs(**kw)
    params, model = H.gob_twin_models(jcfg, tcfg)
    b = H.make_gob_np_batch(seed=3)
    K, B = b.obs.shape
    rng = jax.random.PRNGKey(7)
    train = True
    l_ref, g_ref = jax.value_and_grad(lambda p: jgob.forward(
        p, jcfg, H.jbatch(b), rng=rng, train=train)[1])(params)
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
        spec, train, u, None, *_arrays(tb), h0, p0[:, :spec.D].contiguous(),
        p0[:, spec.D:].contiguous(), *fg.flat_leaves(model, spec))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(l_ref),
                               **H.LOSS_TOL)
    got = H.gob_torch_grads_as_jax(model)
    ref = H.flat({k: v for k, v in g_ref.items() if k != "class_model"})
    np.testing.assert_allclose(
        H.flat({k: v for k, v in got.items() if k != "class_model"}), ref,
        **H.gob_grad_tol(ref))


def test_eval_fn_matches_jax_forward():
    """The eval loss (K5's history-free form, plain version here) against
    the JAX forward at train=False, as test_fused_gob.py holds the Pallas
    kernel at train=False."""
    jcfg, tcfg = H.gob_configs(full_gru_ode=True, impute=True,
                               dropout_rate=0.1)
    params, model = H.gob_twin_models(jcfg, tcfg)
    b = H.make_gob_np_batch(seed=6, B=9)
    _, ref = jgob.forward(params, jcfg, H.jbatch(b), train=False)
    got = fg.make_fused_eval_fn(tcfg)(model, H.tbatch(b))
    np.testing.assert_allclose(float(got), float(ref), **H.LOSS_TOL)


def test_gob_masks_are_the_njode_philox():
    """K7 is K4's Philox with slots 0-2: the same bits, and slot 0 is drawn
    whatever the solver."""
    thresh = min(int(0.9 * 2.0 ** 32), 2 ** 32 - 1)
    got = fg.gob_masks_plain(2 ** 40 + 17, torch.arange(5), 11, 7, thresh)
    want = fg.fs.philox_keep_plain(2 ** 40 + 17, torch.arange(5), 3, 11, 7,
                                   thresh)
    assert got.shape == (5, 3, 11, 7)
    assert torch.equal(got, want)
    assert abs(float(got.float().mean()) - 0.9) < 0.03


@pytest.mark.parametrize("kw", [dict(impute=True, dropout_rate=0.1),
                                dict(solver="midpoint", full_gru_ode=True,
                                     impute=True, dropout_rate=0.1)],
                         ids=["euler", "midpoint"])
def test_prng_masks_replayed_through_input_mode(kw):
    """The masks 'prng' mode draws, replayed through 'input' mode, give the
    identical loss and gradients: the forward and the backward draw the
    same masks."""
    _, tcfg = H.gob_configs(**kw)
    _, model = H.gob_twin_models(*H.gob_configs(**kw))
    b = H.tbatch(H.make_gob_np_batch(seed=3))
    K, B = b.obs.shape
    spec = fg.Spec(tcfg, "prng")

    def run(fn):
        model.zero_grad()
        loss = fn(model, b, torch.Generator().manual_seed(11), True)
        loss.backward()
        return float(loss.detach()), [p.grad.clone() if p.grad is not None
                                      else None for p in model.parameters()]

    l_p, g_p = run(fg.make_fused_loss_fn(tcfg, "prng"))
    gen = torch.Generator().manual_seed(11)      # the draws loss_fn made
    torch.rand((B, tcfg.cov_hidden), generator=gen)
    torch.rand((B, spec.P), generator=gen)
    seed = torch.randint(0, 2 ** 62, (1,), generator=gen, dtype=torch.int64)
    masks = fg.gob_masks_plain(int(seed), torch.arange(K), B, spec.P,
                               spec.thresh)
    l_i, g_i = run(fg.make_fused_loss_fn(tcfg, "input", u_override=masks))
    assert l_p == l_i
    for a, c in zip(g_p, g_i):
        if a is None:
            assert c is None
        else:
            torch.testing.assert_close(a, c, rtol=0, atol=0)
    l_o, _ = run(fg.make_fused_loss_fn(
        tcfg, "input", u_override=fg.gob_masks_plain(
            int(seed) + 1, torch.arange(K), B, spec.P, spec.thresh)))
    assert l_o != l_p


def test_input_mode_matches_eager_forward_with_same_generator():
    """'input' mode draws its masks in the eager forward's order, so both
    paths see the same masks from the same generator state."""
    kw = dict(full_gru_ode=True, impute=True, dropout_rate=0.1)
    _, tcfg = H.gob_configs(**kw)
    _, model = H.gob_twin_models(*H.gob_configs(**kw))
    b = H.tbatch(H.make_gob_np_batch(seed=3))
    l_f = fg.make_fused_loss_fn(tcfg, "input")(
        model, b, torch.Generator().manual_seed(4), True)
    _, l_e = tgob.forward(model, b, train=True,
                          generator=torch.Generator().manual_seed(4))
    np.testing.assert_allclose(float(l_f.detach()), float(l_e.detach()),
                               **H.LOSS_TOL)


def test_cuda_route_raises_instead_of_falling_back(monkeypatch):
    """A tensor routed to the kernels (the device check mocked to say CUDA)
    never falls back to the plain version: the wrapper raises."""
    kw = dict(full_gru_ode=True, impute=True, dropout_rate=0.1)
    _, tcfg = H.gob_configs(**kw)
    _, model = H.gob_twin_models(*H.gob_configs(**kw))
    b = H.tbatch(H.make_gob_np_batch(seed=3))
    monkeypatch.setattr(fg, "_is_cuda", lambda t: True)

    def boom(*a, **k):
        raise AssertionError("plain version used for a CUDA tensor")

    monkeypatch.setattr(fg, "gob_scan_fwd_plain", boom)
    monkeypatch.setattr(fg, "gob_scan_bwd_plain", boom)
    before = dict(fg.LAUNCHES)
    for mode in ("prng", "input"):
        with pytest.raises((RuntimeError, ValueError)):
            fg.make_fused_loss_fn(tcfg, mode)(
                model, b, torch.Generator().manual_seed(0), True)
    with pytest.raises((RuntimeError, ValueError)):
        fg.make_fused_eval_fn(tcfg)(model, b)
    assert fg.LAUNCHES == before


def test_unsupported_configs_raise():
    with pytest.warns(UserWarning):
        _, mid = H.gob_configs(solver="dopri5", impute=True)
    _, auto = H.gob_configs(solver="dopri5", impute=False)
    for cfg in (mid, auto):
        assert not fg.supported(cfg)
        with pytest.raises(NotImplementedError):
            fg.make_fused_loss_fn(cfg)
        with pytest.raises(NotImplementedError):
            fg.make_fused_eval_fn(cfg)
    # the published widths fit one CTA's shared memory at the rows the
    # rule takes; widths beyond one row run in the device-memory form; a
    # solver outside raises on the CUDA route instead of launching
    for hidden in (50, 100):
        _, pub = H.gob_configs(D=1, hidden_size=hidden, p_hidden=hidden,
                               prep_hidden=hidden, cov_hidden=hidden,
                               full_gru_ode=True, impute=True)
        assert fg.supported(pub)
        spec = fg.Spec(pub)
        assert spec.smem_bytes(spec.rows_for(20)) <= fg.SMEM_LIMIT
    _, wide = H.gob_configs(D=1, hidden_size=800, p_hidden=800,
                            prep_hidden=800, full_gru_ode=True, impute=True)
    spec = fg.Spec(wide)
    assert spec.smem_bytes(1, acts="shared") > fg.SMEM_LIMIT
    assert spec.acts_for() == "global" and spec.rows_for(20) == 1
    assert spec.smem_bytes(1) <= fg.SMEM_LIMIT and fg.supported(wide)
    with pytest.raises(NotImplementedError, match="dopri5"):
        fg._check_inputs(fg.Spec(auto), [], (None,) * 5, False, None, None)
    with pytest.raises(NotImplementedError, match="euler and midpoint"):
        fg.make_fused_loss_fn(auto)


def test_too_wide_config_trains_eagerly_on_the_cuda_route(monkeypatch,
                                                          tmp_path):
    """A GOB config outside ``supported``, the adaptive dopri5 (as in the
    JAX package), at widths whose buffers overflow one CTA's shared memory
    even at one row (D = 1, hidden 10, p_hidden 4,000: 243,760 B): the
    synthetic trainer on a CUDA device (the device check mocked to say
    CUDA) trains it through the eager ``gru_ode_bayes.forward``: no kernel
    wrapper and no plain version of one runs. That route's epoch
    (``make_step_fns(use_kernels=False)``) matches the JAX ``train_epoch``
    from the same weights."""
    kw = dict(D=1, hidden_size=10, p_hidden=4000, prep_hidden=10,
              cov_hidden=10, full_gru_ode=True, impute=False, mixing=1e-4,
              solver="dopri5")
    jcfg, tcfg = H.gob_configs(**kw)
    assert fg.Spec(tcfg).smem_bytes(1, acts="shared") == 243760 > \
        fg.SMEM_LIMIT
    assert not fg.supported(tcfg)
    monkeypatch.setattr(fs, "_is_cuda", lambda t: True)
    monkeypatch.setattr(fg, "_is_cuda", lambda t: True)

    def boom(*a, **k):
        raise AssertionError("the kernels' route taken for a config "
                             "outside them")

    for name in ("make_fused_loss_fn", "make_fused_eval_fn", "gob_scan_fwd",
                 "gob_scan_bwd", "gob_scan_fwd_plain", "gob_scan_bwd_plain"):
        monkeypatch.setattr(fg, name, boom)
    data = str(tmp_path / "data")
    hp = dict(tdatasets.hyperparam_default, nb_paths=30, nb_steps=6)
    tdatasets.create_dataset("BlackScholes", hp, seed=0, base_path=data,
                             device="cpu")
    before = dict(fg.LAUNCHES)
    assert ttrainer.train(
        epochs=1, batch_size=12, dropout_rate=0.1, dataset="BlackScholes",
        base_data_path=data, saved_models_path=str(tmp_path / "models"),
        evaluate=True, device="cpu", hidden_size=10,
        other_model="GRU_ODE_Bayes",
        **{"GRU_ODE_Bayes-impute": False, "GRU_ODE_Bayes-logvar": True,
           "GRU_ODE_Bayes-p_hidden": 4000, "GRU_ODE_Bayes-solver": "dopri5",
           "GRU_ODE_Bayes-mixing": 1e-4}) == 0
    assert fg.LAUNCHES == before

    params, model = H.gob_twin_models(jcfg, tcfg, seed=3)
    rs = np.random.RandomState(4)
    N, K, B = 12, 6, 6
    paths = rs.lognormal(0.0, 0.3, size=(N, 1, K + 1)).astype(np.float32)
    obs = (rs.random((N, K + 1)) < 0.4).astype(np.float32)
    idx_mat = rs.permutation(N).reshape(-1, B).astype(np.int32)
    times = (np.arange(1, K + 1) / K).astype(np.float32)
    dts = np.full(K, 1.0 / K, np.float32)
    jopt = jsteps.make_optimizer(1e-3)
    jfns = jgob.make_step_fns(jcfg, jopt, times, dts)
    params, _, jl = jfns["train_epoch"](
        params, jopt.init(params), jnp.asarray(paths), jnp.asarray(obs),
        jnp.asarray(idx_mat), jnp.float32(0.5), jax.random.PRNGKey(0))
    topt = tsteps.make_optimizer(model.parameters(), 1e-3)
    tfns = tgob.make_step_fns(model, topt, torch.as_tensor(times),
                              torch.as_tensor(dts),
                              use_kernels=fg.supported(tcfg))
    tl = tfns["train_epoch"](torch.as_tensor(paths), torch.as_tensor(obs),
                             torch.as_tensor(idx_mat).long(), 0.5,
                             torch.Generator())
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4)
    ref = gob_state_dict_from_jax_params(jax.tree.map(np.asarray, params))
    got = model.state_dict()
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), ref[k].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("kw", [
    dict(hidden_size=800, p_hidden=800, prep_hidden=800, cov_hidden=800),
    dict(hidden_size=10, p_hidden=4000, prep_hidden=10, cov_hidden=10)],
    ids=["widths800", "p_hidden4000"])
def test_too_wide_config_gradients_match_jax(kw):
    """Configs whose buffers of one row overflow one CTA's shared memory
    (D = 1, full field, impute, mixing 1e-4; every width 800, and p_hidden
    4,000; the kernels run them in the device-memory form): the eager
    forward's loss and every parameter gradient
    before an optimizer step match ``gru_ode_bayes.forward`` +
    ``jax.grad`` at the GOB gradient tolerance (``gob_grad_tol``). After
    an Adam epoch their parameters are not compared: Adam moves each
    weight by about its learning rate whatever the size of its gradient,
    so a near-zero gradient whose sign rounding decides sets it apart."""
    jcfg, tcfg = H.gob_configs(D=1, full_gru_ode=True, impute=True,
                               mixing=1e-4, **kw)
    assert fg.Spec(tcfg).smem_bytes(1, acts="shared") > fg.SMEM_LIMIT
    params, model = H.gob_twin_models(jcfg, tcfg, seed=3)
    b = H.make_gob_np_batch(seed=4, D=1, B=6, steps=6)
    l_ref, g_ref = jax.value_and_grad(lambda p: jgob.forward(
        p, jcfg, H.jbatch(b), rng=jax.random.PRNGKey(0), train=True)[1])(
            params)
    _, loss = tgob.forward(model, H.tbatch(b), train=True)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(l_ref),
                               **H.LOSS_TOL)
    gr = H.flat({k: v for k, v in g_ref.items() if k != "class_model"})
    got = H.gob_torch_grads_as_jax(model)
    np.testing.assert_allclose(
        H.flat({k: v for k, v in got.items() if k != "class_model"}), gr,
        **H.gob_grad_tol(gr))


def test_leaf_layout_sizes_at_published_widths():
    """The leaf count and the weights inside the kernels at H = 50 and
    H = 100 (impute, full field, bias, D = 1)."""
    for hidden, n in ((50, 26152), (100, 102302)):
        _, cfg = H.gob_configs(D=1, hidden_size=hidden, p_hidden=hidden,
                               prep_hidden=hidden, cov_hidden=hidden,
                               full_gru_ode=True, impute=True)
        spec = fg.Spec(cfg)
        assert spec.n_params == n
        assert len(spec.leaf_shapes) <= fg.MAX_LEAVES


def test_config_struct_mirrors_the_cuda_source():
    """``_GobCfg`` lists the fields of ``struct GobCfg`` in
    csrc/fused_gob.cu in order, all 4 bytes wide, with the same array
    lengths; the array bounds and the stage (c) tile agree, the source
    instantiates every R of ``ROW_CHOICES`` (and only those), and the
    shared memory kept for the call's configuration holds it."""
    with open(os.path.join(ROOT, "njode_tpu_torch", "ops", "csrc",
                           "fused_gob.cu")) as f:
        src = f.read()
    body = re.search(r"struct GobCfg \{(.*?)\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    fields = []
    for decl in body.split(";"):
        decl = decl.strip()
        if not decl:
            continue
        names = re.sub(r"^(unsigned int|int|float)\s+", "", decl)
        for n in names.split(","):
            n = n.strip()
            m = re.match(r"(\w+)\s*(\[(\w+(?:\s*\+\s*1)?)\])?", n)
            fields.append((m.group(1), m.group(3)))
    py = fg._GobCfg._fields_
    assert [f[0] for f in py] == [f[0] for f in fields]
    consts = {"MAX_LEAVES": fg.MAX_LEAVES, "MAX_LEAVES + 1":
              fg.MAX_LEAVES + 1, "MAX_SAVE": fg.MAX_SAVE,
              "MAX_DLT": fg.MAX_DLT}
    for (name, t), (_, dim) in zip(py, fields):
        if dim is None:
            assert ctypes.sizeof(t) == 4, name
        else:
            n = consts.get(dim, None) or int(dim)
            assert ctypes.sizeof(t) == 4 * n, name
    for name in ("MAX_LEAVES", "MAX_SAVE", "MAX_DLT", "WG_TILE"):
        assert re.search(rf"#define {name} (\d+)", src).group(1) == \
            str(getattr(fg, name)), name
    switch = re.search(r"#define GOB_FORM\(c_, CASE\)(.*?)default", src,
                       re.S).group(1)
    assert tuple(int(r) for r in re.findall(r"case (\d+):", switch)) == \
        fg.ROW_CHOICES
    # the device-memory form: one instance, at one row
    assert "CASE(1, true)" in switch
    assert int(re.search(r"#define SLAB_BIT \(1 << (\d+)\)", src)
               .group(1)) == fg.SLAB_BIT.bit_length() - 1
    assert ctypes.sizeof(fg._GobCfg) + 8 * fg.MAX_LEAVES <= fg.CALL_BYTES


def test_build_hash_covers_included_headers(tmp_path):
    """A library is named by the hash of its source and of the csrc/
    headers it includes: editing philox.cuh renames both libraries, so a
    stale build is never loaded."""
    import shutil

    from njode_tpu_torch.ops import _build

    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    for name in ("fused_scan", "fused_gob"):
        files = [os.path.basename(f) for f in
                 _build.source_files(str(csrc / f"{name}.cu"))]
        assert files == [f"{name}.cu", "philox.cuh"]
    before = {n: _build.source_digest(str(csrc / f"{n}.cu"))
              for n in ("fused_scan", "fused_gob")}
    with open(csrc / "philox.cuh", "a") as f:
        f.write("\n// edited\n")
    for n, d in before.items():
        assert _build.source_digest(str(csrc / f"{n}.cu")) != d


def test_ctypes_signatures_match_the_c_interface():
    """The argument types ``_build`` declares for each function of
    csrc/fused_gob.cu's C interface match its C parameters one for one
    (a pointer passed where ctypes expects an int is cut to 32 bits)."""
    import types

    from njode_tpu_torch.ops import _build

    with open(os.path.join(ROOT, "njode_tpu_torch", "ops", "csrc",
                           "fused_gob.cu")) as f:
        src = f.read()
    lib = types.SimpleNamespace(**{n: types.SimpleNamespace() for n in (
        "gob_error_string", "gob_scan_fwd", "gob_scan_bwd", "gob_masks")})
    _build._declare("fused_gob", lib)
    for name in ("gob_scan_fwd", "gob_scan_bwd", "gob_masks"):
        params = re.search(rf'extern "C" int {name}\((.*?)\)', src,
                           re.S).group(1)
        want = []
        for decl in params.split(","):
            decl = decl.strip()
            if "*" in decl:
                want.append(ctypes.c_void_p)
            elif decl.startswith("unsigned"):
                want.append(ctypes.c_uint32)
            else:
                assert decl.startswith("int "), decl
                want.append(ctypes.c_int)
        assert getattr(lib, name).argtypes == want, name
