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
        tb.n_obs_ot, tb.start_X, None, h0, *fs.flat_leaves(model))
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
    """The refusals the JAX rule makes: a masked config whose output
    differs from its input (with or without the GRU jump) and a bf16
    config; and the port's own: an unmasked output differing from its input
    with neither of them 1 (the JAX forward cannot broadcast its loss
    there). Inside: a masked config with ``output_size == input_size``, the
    GRU jump masked or not, an unmasked output of 1 at input 2 (and of 2
    at input 1), with the encoder or the GRU jump, and nets of 9 to 101
    linears (no depth cap: the layer table)."""
    deep = ((8, "tanh"),) * 16
    for D, kw in ((2, dict(masked=True, output_size=1)),
                  (2, dict(use_rnn=True, masked=True, output_size=1)),
                  (2, dict(compute_dtype="bfloat16")),
                  (2, dict(output_size=3))):
        _, tcfg = H.configs(D, 10, **kw)
        assert not fs.supported(tcfg)
        with pytest.raises(NotImplementedError):
            fs.make_fused_loss_fn(tcfg)
        with pytest.raises(NotImplementedError):
            fs.make_fused_eval_fn(tcfg)
    for D, kw in ((2, dict(masked=True)), (2, dict(use_rnn=True)),
                  (2, dict(use_rnn=True, masked=True)),
                  (2, dict(use_rnn=True, bias=False)),
                  (2, dict(use_rnn=True, output_size=1)),
                  (2, dict(output_size=1)), (1, dict(output_size=2)),
                  (2, dict(use_rnn=True, ode_nn=deep[1:])),
                  (2, dict(use_rnn=True, ode_nn=deep)),
                  (1, dict(ode_nn=((10, "tanh"),) * 100,
                           enc_nn=((10, "relu"),) * 100)),
                  (1, dict(readout_nn=((50, "tanh"),) * 8))):
        _, tcfg = H.configs(D, 10, **kw)
        assert fs.supported(tcfg)
        fs.make_fused_loss_fn(tcfg)
        fs.make_fused_eval_fn(tcfg)
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
    # the weights alone overflow one CTA: the global plan takes it
    assert fs.supported(wide) and fs.Spec(wide).plan == "global"
    # a net whose activations of one row overflow one CTA is outside
    _, huge = H.configs(1, 10, ode_nn=((30000, "tanh"),))
    assert not fs.supported(huge)
    with pytest.raises(NotImplementedError):
        fs.make_fused_loss_fn(huge)


def _c_fields(src, name):
    """The field names of ``struct name`` in a C source, in order."""
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


def test_config_struct_mirrors_the_cuda_source():
    """``_ScanCfg`` / ``_MLPDesc`` list the fields of the C structs in
    csrc/fused_scan.cu in order, all 4 bytes wide, and no per-layer or
    per-leaf array rides in them: the kernels' parameter block (the
    config, the layer table's address and the other pointers) stays
    within the 4,096 bytes a kernel may take and within the 1,776 bytes
    of the by-value layout of 8 linears and 52 leaves it replaced."""
    with open(os.path.join(ROOT, "njode_tpu_torch", "ops", "csrc",
                           "fused_scan.cu")) as f:
        src = f.read()

    assert [f[0] for f in fs._MLPDesc._fields_] == _c_fields(src, "MLPDesc")
    assert [f[0] for f in fs._ScanCfg._fields_] == _c_fields(src, "ScanCfg")
    n_int = sum(ctypes.sizeof(t) for _, t in fs._ScanCfg._fields_)
    assert ctypes.sizeof(fs._ScanCfg) == n_int
    assert all(t is ctypes.c_int or t in (ctypes.c_uint32, ctypes.c_float)
               or issubclass(t, fs._MLPDesc)
               for _, t in fs._ScanCfg._fields_)
    assert re.search(r"#define MAX_ROWS (\d+)", src).group(1) == \
        str(fs.MAX_ROWS)
    assert not re.search(r"MAX_LIN|MAX_LEAVES", src)
    # K1 and K2's chain take ScanCfg by value, then the table's address
    # and other pointers (K1: 16; the chain: 18 and, n_fld after the
    # 17th, and k0, k1, Kc, first at the end, 5 ints)
    for kern, n_ptr, n_int in (
            ("njode_scan_fwd_kernel", fs.KERNEL_PTRS, 0),
            ("njode_scan_bwd_kernel", fs.CHAIN_PTRS, fs.CHAIN_INTS)):
        params = re.search(r"\n%s\((.*?)\)" % kern, src, re.S).group(1)
        decls = [d.strip() for d in params.split(",")]
        assert decls[0] == "ScanCfg c" and "tab" in decls[1]
        assert len(decls) == 1 + n_ptr + n_int
        assert sum("*" in d for d in decls[1:]) == n_ptr
        assert all(d.startswith("int ") for d in decls[1:]
                   if "*" not in d)
    assert fs.param_bytes() <= min(4096, 1776)
    # the GRU's leaf offsets and regions follow the layout fields
    names = [f[0] for f in fs._ScanCfg._fields_]
    assert {"use_rnn", "gru_wih", "gru_whh", "gru_bih", "gru_bhh", "o_gru",
            "o_dG", "o_lay", "n_rec", "tab_leaves", "tab_ptrs"} <= set(names)


def test_layer_record_mirrors_the_cuda_source():
    """``_LayerRec`` lists the fields of ``struct LayerRec`` in order, 4
    bytes each, ``LAYER_INTS`` of them (the stride the kernels copy the
    records with)."""
    with open(os.path.join(ROOT, "njode_tpu_torch", "ops", "csrc",
                           "fused_scan.cu")) as f:
        src = f.read()
    assert [f[0] for f in fs._LayerRec._fields_] == _c_fields(src,
                                                              "LayerRec")
    assert all(t is ctypes.c_int for _, t in fs._LayerRec._fields_)
    assert ctypes.sizeof(fs._LayerRec) == 4 * fs.LAYER_INTS
    assert re.search(r"#define LAYER_INTS (\d+)", src).group(1) == \
        str(fs.LAYER_INTS)


@pytest.mark.parametrize("kw", [
    dict(masked=True, ode_nn=((7, "relu"), (6, "tanh")),
         readout_nn=((5, "tanh"),) * 3),
    dict(use_rnn=True, bias=False, ode_nn=((4, "tanh"),) * 40)],
    ids=["masked", "rnn_nobias_deep41"])
def test_layer_table_holds_each_linear_and_leaf(kw):
    """The layer table (``layer_table`` on CPU tensors): a record a Linear
    of the ODE net, the encoder and the readout in turn (``lay`` in each
    net's ``MLPDesc``; the post-jump readout shares the readout's), each
    with its widths, the activation after it, its weight's and bias's
    offsets in the flat and the packed parameters and the summed widths of
    the hidden layers below it; then the leaves' offsets and their
    addresses. A second call with the same leaves returns the same table;
    a leaf at another address makes a new one."""
    _, tcfg = H.configs(2, 10, **kw)
    _, model = H.twin_models(*H.configs(2, 10, **kw))
    spec = fs.Spec(tcfg)
    leaves = [p.detach() for p in fs.flat_leaves(model)]
    tab = fs.layer_table(spec, leaves)
    assert tab.dtype == torch.int32 and tab.shape == (spec.tab_ints,)
    recs = (fs._LayerRec * spec.n_rec).from_buffer_copy(
        tab[:spec.tab_leaves].numpy().tobytes())
    c = fs.make_cfg(spec, 30, 50, True, 0.5)
    assert (c.n_rec, c.tab_leaves, c.tab_ptrs) == (
        spec.n_rec, spec.tab_leaves, spec.tab_ptrs)
    assert c.o_lay >= 0 and spec.tab_ptrs % 2 == 0
    leaf = 0
    for desc, ws, acts in ((c.ode, spec.ode_w, spec.ode_a),
                           (c.enc, spec.enc_w, spec.enc_a),
                           (c.ro, spec.ro_w, spec.ro_a)):
        assert (desc.n_lin, desc.w_in) == (len(ws) - 1, ws[0])
        for l in range(desc.n_lin):
            r = recs[desc.lay + l]
            assert (r.w_in, r.w_out) == (ws[l], ws[l + 1])
            assert r.act == (0 if l == desc.n_lin - 1 or acts[l] == "tanh"
                             else 1)
            assert (r.w_off, r.pw_off) == (spec.leaf_off[leaf],
                                           spec.pack_off[leaf])
            leaf += 1
            if spec.bias:
                assert r.b_off == spec.leaf_off[leaf]
                leaf += 1
            else:
                assert r.b_off == -1
            assert r.save == sum(ws[1:l + 1])
    assert c.ro2.lay == c.ro.lay and c.ro2.n_lin == c.ro.n_lin
    n = len(spec.leaf_off)
    assert tab[spec.tab_leaves:spec.tab_leaves + n].tolist() == \
        spec.leaf_off
    assert tab[spec.tab_ptrs:].view(torch.int64).tolist() == [
        p.data_ptr() for p in leaves]
    assert fs.layer_table(spec, leaves) is tab
    moved = [leaves[0].clone()] + leaves[1:]
    tab2 = fs.layer_table(spec, moved)
    assert tab2 is not tab and torch.equal(tab2[:spec.tab_ptrs],
                                           tab[:spec.tab_ptrs])
    assert tab2[spec.tab_ptrs:].view(torch.int64)[0] == moved[0].data_ptr()


def _arm_cfg(D, hidden, width, masked):
    nn = ((width, "tanh"), (width, "tanh"))
    return H.configs(D, hidden, ode_nn=nn, readout_nn=nn, enc_nn=nn,
                     dropout_rate=0.1, masked=masked)[1]


# (id, D, H, width, masked, use_rnn, plan, rows, bytes of one CTA, bytes
# of the activations alone): the arms of PERF.md section 4, those that fit
# resident and the published arms whose weights do not fit one CTA
# (experiments/configs.py: PhysioNet :233-245, climate :141-150, sine
# :265-279); the global plan adds the layer records and the ring (and,
# with the GRU jump, its gate sums) in the shared memory the activations
# leave; the resident plan's bytes are K2's chain's at the most rows that
# fit (its weights, two io sets each with a step's forward values, no
# weight gradients), its nine layer records (288 bytes) included; both
# hold the dropout mask words (the global plan's masked branch without
# the GRU jump inside a backward buffer, so its bytes are the
# activations').
PLAN_ARMS = [
    ("main_path", 1, 10, 50, False, False, "resident", 16, 168544, 168544),
    ("main_path_rnn", 1, 10, 50, False, True, "resident", 16, 152192,
     152192),
    ("climate_small", 5, 10, 50, True, False, "resident", 16, 177856,
     177856),
    ("climate_small_rnn", 5, 10, 50, True, True, "resident", 16, 161328,
     161328),
    ("physionet_50", 41, 41, 50, True, False, "resident", 8, 208512,
     208512),
    ("physionet_50_rnn", 41, 41, 50, True, True, "resident", 4, 194752,
     194752),
    ("physionet_200", 41, 41, 200, True, False, "global", 8, 232448,
     161120),
    ("climate_400", 5, 50, 400, True, False, "global", 4, 232432, 138800),
    ("sine_400", 1, 10, 400, False, False, "global", 4, 232448, 131904),
]


def _plan_cfg(arm):
    _, D, hidden, width, masked, use_rnn = arm[:6]
    nn = ((width, "tanh"), (width, "tanh"))
    return H.configs(D, hidden, ode_nn=nn, readout_nn=nn, enc_nn=nn,
                     dropout_rate=0.1, masked=masked, use_rnn=use_rnn)[1]


@pytest.mark.parametrize("arm", PLAN_ARMS, ids=[a[0] for a in PLAN_ARMS])
def test_plan_rule(arm):
    """``Spec`` takes the resident plan where K2's chain's layout (every
    weight, two io sets with a step's forward values) and K1's fit at some
    of 16, 8, 4, 2, 1 rows, ``rows`` the most that fit (PhysioNet 50: 8),
    else the
    global plan at the most rows whose activations fit, with the ring in
    what they leave (no arm loses rows to it); ``supported`` admits every
    arm."""
    plan, rows, nbytes, act_bytes = arm[6:]
    cfg = _plan_cfg(arm)
    spec = fs.Spec(cfg)
    assert fs.supported(cfg)
    assert (spec.plan, spec.rows, spec.smem_bytes) == (plan, rows, nbytes)
    assert spec.smem_bytes <= fs.SMEM_LIMIT
    if rows < 16:
        assert not spec.fits(plan, 2 * rows)
    if plan == "global":
        off, _ = spec.layout(rows, "global")
        act = off["gsc"] if "gsc" in off else off["lay"]
        assert 4 * act == act_bytes
        assert off["ring"] - off["lay"] == fs.LAYER_INTS * spec.n_rec
        assert not any(spec.fits("resident", R) for R in fs.ROW_CHOICES)


# (arm of PLAN_ARMS, batch, K2's rows, K1/K3's rows): the published
# batches (experiments/configs.py) and the main path's last batch of 60;
# the global arms keep their plan's rows
ROWS_CASES = [
    ("main_path", 100, 1, 1), ("main_path", 200, 1, 1),
    ("main_path", 4000, 16, 16), ("main_path", 60, 1, 1),
    ("main_path_rnn", 100, 1, 1), ("main_path_rnn", 200, 1, 1),
    ("main_path_rnn", 4000, 16, 16), ("climate_small", 100, 1, 1),
    ("climate_small_rnn", 100, 1, 1), ("physionet_50", 50, 1, 1),
    ("physionet_50_rnn", 50, 1, 1), ("physionet_200", 50, 8, 8),
]


@pytest.mark.parametrize("case", ROWS_CASES,
                         ids=[f"{c[0]}_B{c[1]}" for c in ROWS_CASES])
def test_rows_rule(case):
    """``Spec.rows_for(B, bwd)``: in the resident plan the fewest rows of
    1, 2, 4, 8, 16 at which the launch's ceil(B / R) CTAs are all resident
    at once on the card's SMs (counted from the kernel's own shared bytes,
    at most ``CTAS_PER_SM`` a SM), else the most that fit, or the global
    plan's rows; ``make_cfg``
    takes them per batch and per kernel."""
    name, B, r_bwd, r_fwd = case
    spec = fs.Spec(_plan_cfg(next(a for a in PLAN_ARMS if a[0] == name)))
    assert (spec.rows_for(B), spec.rows_for(B, False)) == (r_bwd, r_fwd)
    for bwd, R in ((True, r_bwd), (False, r_fwd)):
        assert fs.make_cfg(spec, 30, B, True, 0.5, bwd=bwd).rows == R
        if spec.plan != "resident":
            continue
        assert spec.fits("resident", R)
        per_sm = spec.ctas_per_sm(R, bwd)
        total = 4 * spec.layout(R, "resident", bwd)[1] + fs.CTA_RESERVED
        assert per_sm == min(fs.CTAS_PER_SM, fs.SM_SMEM // total) >= 1
        # every CTA resident at once, or (K2 at the eval's B = 4,000) none
        # of the rows that fit allows it and the most are taken
        assert -(-B // R) <= per_sm * fs.N_SM or R == spec.rows
        if R > 1:        # fewer rows would take a second wave
            half = R // 2
            assert -(-B // half) > spec.ctas_per_sm(half, bwd) * fs.N_SM


def test_forward_layout_and_rows_per_batch():
    """K1/K3's resident layout holds no backward region (K2's chain holds
    them), so more of its CTAs fit an SM, and ends with two sets of mask
    words and the layer records; the chain's holds no weight gradients
    and no carries, and each of its two io sets holds a step's inputs and
    every forward value the chain reads (stage (a)'s fields, the mask
    words among them), ``io_stride`` apart; ``make_cfg`` keeps one
    configuration per call shape and kernel, each at its batch's rows (the
    last, smaller batch of an epoch at its own), and a forced plan's rows
    at every batch."""
    spec = fs.Spec(_plan_cfg(PLAN_ARMS[0]))
    P4 = (spec.n_params + 3) // 4 * 4
    bwd_only = {"dA", "dB", "dh", "dlx", "dtau", "dst", "dh1", "dhe",
                "df", "dlxc", "dtauc", "dG"}
    in_io = ("in_ode", "tX", "h1", "h2", "in_ro", "ro", "le", "s_ode",
             "s_enc", "s_ro", "mw")
    for R in fs.ROW_CHOICES:
        fwd, n_fwd = spec.layout(R, "resident", bwd=False)
        bwd, n_bwd = spec.layout(R, "resident")
        assert not bwd_only & set(fwd) and bwd_only - {"dG"} <= set(bwd)
        assert "g" not in bwd and bwd["io"] == fwd["io"] == P4
        assert all(bwd["io"] <= bwd[k] < bwd["io2"] for k in in_io)
        assert bwd["h"] == bwd["lx"] == bwd["tau"] == bwd["X"]
        assert n_bwd > n_fwd
        assert fwd["lay"] - fwd["mw"] == (
            2 * spec.mask_words(R) + 3) // 4 * 4
        for off, n in ((fwd, n_fwd), (bwd, n_bwd)):
            assert n - off["lay"] == fs.LAYER_INTS * spec.n_rec
            assert off["lay"] == max(off.values())
    assert 4 * spec.layout(16, "resident", bwd=False)[1] == 100384
    assert (spec.ctas_per_sm(16), spec.ctas_per_sm(16, False)) == (1, 2)
    c_fwd = fs.make_cfg(spec, 100, 100, True, 0.5, bwd=False)
    c_bwd = fs.make_cfg(spec, 100, 100, True, 0.5)
    assert (c_fwd.rows, c_fwd.o_dA) == (1, -1)
    assert (c_bwd.rows, c_bwd.o_tdt, c_bwd.rec) == (1, P4, spec.rec)
    assert c_fwd.smem_floats == spec.layout(1, "resident", bwd=False)[1]
    assert fs.make_cfg(spec, 100, 100, True, 0.5, bwd=False) is c_fwd
    assert fs.make_cfg(spec, 100, 4000, False, 0.5, bwd=False).rows == 16
    assert fs.make_cfg(spec, 100, 60, True, 0.5).rows == 1
    forced = fs.Spec(spec.cfg, "prng", ("resident", 16))
    assert {fs.make_cfg(forced, 100, B, True, 0.5, bwd=bwd).rows
            for B in (60, 100, 4000) for bwd in (True, False)} == {16}


# the arms the global plan runs, and PhysioNet 50's GRU jump forced into
# it at 16 rows
TILE_ARMS = [a for a in PLAN_ARMS
             if a[6] == "global" or a[0] == "physionet_50_rnn"]


@pytest.mark.parametrize("arm", TILE_ARMS, ids=[a[0] for a in TILE_ARMS])
def test_tile_program_walks_each_product(arm):
    """The global plan's tile program: every weight product of a step, in
    the order the kernels run them, walked in ascending blocks of its
    summed index (once per pass of ``MAXI * NTHREADS`` items when split),
    each tile within a ring stage (a forward tile with room for its bias),
    the last tile of each walk flagged, and the counts ``make_cfg`` hands
    the kernels."""
    spec = fs.Spec(_plan_cfg(arm))
    if spec.plan != "global":
        spec = fs.Spec(_plan_cfg(arm), "prng", ("global", 16))
    prog, n_fwd, n_bwd, stage = spec.tile_program()
    tiles = iter([prog[i:i + fs.TILE_INTS]
                  for i in range(0, len(prog), fs.TILE_INTS)])
    assert len(prog) == fs.TILE_INTS * (n_fwd + n_bwd) and stage % 4 == 0
    for ops, n_tiles in zip(spec.ring_ops(spec.rows), (n_fwd, n_bwd)):
        used = 0
        for dx, key, wo, wi, rows, bias in ops:
            n_o, n_s = (wi, wo) if dx else (wo, wi)
            walk, s0 = [], 0
            while s0 < n_s:
                tile = next(tiles)
                src, nr, stride, cols, flags, bsrc, k, _ = tile
                ns = nr if dx else cols
                assert (k, flags >> 1, stride) == (key, int(dx), wi)
                assert src == key + (s0 * wi if dx else s0)
                assert nr * cols + (0 if dx else wo) <= stage
                s0 += ns
                assert (flags & 1) == int(s0 == n_s)
                assert bsrc == (bias if s0 == n_s and not dx else -1)
                walk.append(tile)
            passes = 1 if len(walk) == 1 else -(
                -(-(-rows // fs.RB) * n_o) // (fs.MAXI * fs.NTHREADS))
            for _ in range((passes - 1) * len(walk)):
                assert next(tiles) == walk[_ % len(walk)]
            used += passes * len(walk)
        assert used == n_tiles
    c = fs.make_cfg(spec, 30, 50, True, 0.5)
    assert (c.n_tiles_fwd, c.n_tiles_bwd, c.stage) == (n_fwd, n_bwd, stage)


@pytest.mark.parametrize("shape", [(13, 10071), (4, 24423), (25, 571305)],
                         ids=["main_path", "phys50", "climate400"])
def test_reduce_order_is_ascending_rows(shape):
    """``reduce_partials_plain``, the order the kernel keeps (and gives
    bit for bit on the card, tests/test_torch_fused_scan_card.py), is an
    fp32 sum of the rows in ascending order, then the scale: held against
    a numpy loop."""
    n_parts, n = shape
    rs = np.random.RandomState(n_parts)
    buf = rs.normal(size=(n_parts, n)).astype(np.float32)
    want = np.zeros(n, np.float32)
    for q in range(n_parts):
        want = want + buf[q]
    want = want * np.float32(0.37)
    got = fs.reduce_partials_plain(torch.as_tensor(buf), 0.37)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), want)


def test_forced_plans_and_global_layout():
    """A forced plan: the resident plan of PhysioNet's 50 arm fits at 8
    rows (208,512 B), not at 16, and every launch takes the forced rows
    whatever the batch; the global plan's layout has no weight or io-set
    regions, and ``make_cfg`` marks their offsets -1, names the plan and
    the rows, and counts the activations alone; the resident plan's holds
    the weights, then the two io sets (``io_stride`` apart), and no
    ring."""
    cfg = _arm_cfg(41, 41, 50, True)
    spec = fs.Spec(cfg, "prng", ("resident", 8))
    assert (spec.plan, spec.rows, spec.smem_bytes) == ("resident", 8, 208512)
    assert spec.rows_for(50) == spec.rows_for(4000, False) == 8
    with pytest.raises(ValueError, match="overflows"):
        fs.Spec(cfg, "prng", ("resident", 16))
    with pytest.raises(ValueError, match="unknown plan"):
        fs.Spec(cfg, "prng", ("global", 3))
    g = fs.Spec(cfg, "prng", ("global", 4))
    off, total = g.layout(4, "global")
    res_off, res_total = g.layout(4, "resident")
    assert "w" not in off and "g" not in res_off and "ring" not in res_off
    assert not {"io", "io2", "tdt"} & set(off)
    assert {"w", "io", "io2", "tdt"} <= set(res_off)
    assert (res_off["w"], res_off["io"]) == (0, (g.n_params + 3) // 4 * 4)
    # the ring takes two stages after the activations
    assert total - off["ring"] == 2 * g.tile_program()[3]
    c = fs.make_cfg(g, 30, 50, True, 0.5)
    assert (c.rows, c.plan, c.smem_floats, c.io_stride) == (4, 1, total, 0)
    assert c.o_w == -1 and c.o_ring == off["ring"]
    assert c.o_h == 0 and c.o_M == off["M"] and c.ro2.save_off == off["s_ro2"]
    assert c.o_tdt == -1
    r_off, r_total = spec.layout(8, "resident")
    r = fs.make_cfg(spec, 30, 50, True, 0.5)
    assert (r.rows, r.plan, r.o_w, r.o_ring, r.n_tiles_fwd) == (
        8, 0, 0, -1, 0)
    assert (r.o_tdt, r.io_stride, r.smem_floats) == (
        r_off["io"], r_off["io2"] - r_off["io"], r_total)
    assert fs.packed_weights(spec, []) is None


def test_packed_weights_follow_leaf_offsets():
    """The global plan's weight buffer holds each leaf at its
    ``pack_off`` offset, flattened in the [out, in] layout: every leaf
    starts at a 16-byte boundary (the ring's 16-byte copies assume it),
    zeros fill the gaps, and the layer table hands the kernels the packed
    offsets beside the unpadded ``leaf_off`` ones of the gradients."""
    _, tcfg = H.configs(2, 10, masked=True)
    _, model = H.twin_models(*H.configs(2, 10, masked=True))
    spec = fs.Spec(tcfg, "prng", ("global", 16))
    leaves = [p.detach() for p in fs.flat_leaves(model)]
    wg = fs.packed_weights(spec, leaves)
    assert wg.shape == (spec.pack_off[-1],)
    assert all(o % 4 == 0 for o in spec.pack_off)
    for p, a, b in zip(leaves, spec.pack_off[:-1], spec.pack_off[1:]):
        assert torch.equal(wg[a:a + p.numel()], p.reshape(-1))
        assert not wg[a + p.numel():b].any()
    recs = (fs._LayerRec * spec.n_rec).from_buffer_copy(
        spec.table_head()[:spec.tab_leaves].numpy().tobytes())
    assert [r.pw_off for r in recs[:3]] == spec.pack_off[0:6:2]
    assert [r.w_off for r in recs[:3]] == spec.leaf_off[0:6:2]


def test_ctypes_signatures_match_the_c_interface():
    """The argument types ``_build`` declares for each function of
    csrc/fused_scan.cu's C interface (the occupancy query among them)
    match its C parameters one for one (a pointer passed where ctypes
    expects an int is cut to 32 bits)."""
    import types

    from njode_tpu_torch.ops import _build

    with open(os.path.join(ROOT, "njode_tpu_torch", "ops", "csrc",
                           "fused_scan.cu")) as f:
        src = f.read()
    names = ("njode_scan_fwd", "njode_scan_bwd", "njode_scan_occupancy",
             "njode_phase_clock", "njode_reduce_partials",
             "njode_philox_masks", "njode_scan_fwd_members",
             "njode_scan_bwd_members", "njode_reduce_partials_members")
    lib = types.SimpleNamespace(**{n: types.SimpleNamespace() for n in (
        "njode_error_string",) + names})
    _build._declare("fused_scan", lib)
    for name in names:
        params = re.search(rf'extern "C" int {name}\((.*?)\)', src,
                           re.S).group(1)
        want = []
        for decl in params.split(","):
            decl = decl.strip()
            if "*" in decl:
                want.append(ctypes.c_void_p)
            elif decl.startswith("unsigned"):
                want.append(ctypes.c_uint32)
            elif decl.startswith("float "):
                want.append(ctypes.c_float)
            else:
                assert decl.startswith("int "), decl
                want.append(ctypes.c_int)
        assert getattr(lib, name).argtypes == want, name
