"""Rehearse the NJODE scan kernels (njode_tpu_torch/ops/csrc/fused_scan.cu)
on the CPU, before a card run.

    python scripts/rehearse_fused_scan.py [variant ...]

Builds the source with g++ through the stub header of
scripts/rehearse_fused_gob.py (each CTA's 256 threads as ``std::thread``s,
``__syncthreads`` a ``std::barrier``, the dynamic shared memory a global
array filled with NaN before each CTA, cp.async a plain copy), then drives
the C interface with the configuration the wrappers build
(``fused_scan.make_cfg``) on CPU tensors: K1 (loss and histories), K2
(gradients and dh0) and K3 (eval loss) in the resident plan at R = 1, 2
and 16 (the last CTA of a batch of 5 partly padding), in both mask modes,
against the plain versions, and the global plan forced at the same rows
against the resident plan bit for bit; the member-axis calls (E = 3
members in one launch) against three solo calls bit for bit; and
(``masks``) the standalone mask kernel's C call against
``philox_keep_plain`` bit for bit. Each variant is one branch of the
kernels (unmasked or masked, encoder or GRU jump) or one option (no bias,
relu, easy loss, input_current_t, residual encoder and readout, nets of
other depths, nets of 9 to 33 linears, an output width other than the
input's). It finds arithmetic, indexing and barrier faults (a
mismatched barrier hangs), not what nvcc refuses.
"""

import ctypes
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

B, K = 5, 7


def _ptr(t):
    return None if t is None else t.data_ptr()


def _setup(kw, D, seed=0):
    import numpy as np
    import torch

    from njode_tpu_torch.data import grid
    from njode_tpu_torch.models.njode import NJODE, NJODEConfig

    nn = kw.pop("nn", ((6, "tanh"), (5, "tanh")))
    args = dict(input_size=D, hidden_size=4, output_size=D, ode_nn=nn,
                readout_nn=nn, enc_nn=nn, dropout_rate=0.2)
    args.update(kw)
    cfg = NJODEConfig(**args)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = NJODE(cfg)
    rs = np.random.RandomState(seed)
    paths = rs.lognormal(0.0, 0.3, size=(B, D, K))
    observed = (rs.random((B, K)) < 0.5).astype(np.int64)
    b = grid.recompute_n_obs(grid.batch_from_paths(paths, observed,
                                                   1.0 / (K - 1)))
    m = (rs.random(b.X.shape) < 0.6).astype(np.float32)
    m[..., 0] = 1.0
    M = m * b.obs[:, :, None]
    b = b._replace(M=M, X=(b.X * M).astype(np.float32))
    batch = grid.to_torch(b, "cpu")
    arrays = tuple(t.contiguous() for t in (
        batch.times, batch.dt, batch.obs, batch.X, batch.n_obs_ot,
        batch.start_X, batch.M))
    leaves = [p.detach().contiguous() for p in
              __import__("njode_tpu_torch.ops.fused_scan",
                         fromlist=["x"]).flat_leaves(model)]
    with torch.no_grad():
        zero = torch.zeros_like(batch.start_X) if cfg.masked else None
        h0 = model.encoder_map(batch.start_X, zero).contiguous()
    return cfg, arrays, leaves, h0


def _run(lib, fs, spec, leaves, arrays, h0, u, seed, dloss=1.3, chunk=4,
         stretch=4):
    """K1, K2 and K3 of ``spec`` through the CPU build: (loss, histories,
    gradients, dh0, eval loss), then K2's workspace as the first chunk
    left it (K2 at ``chunk`` steps a chunk, stage (c) at ``stretch``)."""
    import torch

    times, dts, obs, X, n_obs, start_X, M = fs.unpack_arrays(spec, arrays)
    Kk, Bb = obs.shape
    tab = fs.layer_table(spec, leaves)
    wg = fs.packed_weights(spec, leaves)
    prog = (None if spec.plan != "global" else
            torch.tensor(spec.tile_program()[0], dtype=torch.int32))
    out = []
    for want in (True, False):
        train = want
        c = fs.make_cfg(spec, Kk, Bb, train, 0.5, bwd=False)
        part = torch.full((-(-Bb // c.rows),), float("nan"))
        loss = torch.empty(())
        hists = ((torch.empty(Kk, Bb, spec.H), torch.empty(Kk, Bb, spec.D),
                  torch.empty(Kk, Bb, 1)) if want else (None,) * 3)
        rc = lib.njode_scan_fwd(
            ctypes.addressof(c), _ptr(tab), _ptr(wg), _ptr(prog),
            _ptr(times),
            _ptr(dts), _ptr(obs), _ptr(X), _ptr(M),
            _ptr(u if train else None), _ptr(seed if train else None),
            _ptr(n_obs), _ptr(h0), _ptr(start_X), _ptr(part), _ptr(loss),
            *(_ptr(t) for t in hists), int(want), 1.0 / Bb, None)
        assert rc == 0, rc
        out.append((loss.clone(), hists))
    (loss, hists), (loss3, _) = out
    c, work, keep, _ = fs._k2_work(spec, Kk, Bb, 1, True, 0.5,
                                   torch.device("cpu"), chunk, stretch)
    keep[-3].fill_(float("nan"))
    flat = torch.empty(spec.n_params)
    dh0 = torch.empty(Bb, spec.H)
    dloss = torch.tensor([dloss])
    rc = lib.njode_scan_bwd(
        ctypes.addressof(c), ctypes.addressof(work), _ptr(tab), _ptr(wg),
        _ptr(prog), _ptr(times),
        _ptr(dts), _ptr(obs), _ptr(X), _ptr(M), _ptr(u), _ptr(seed),
        _ptr(n_obs), *(_ptr(t) for t in hists), _ptr(dloss), _ptr(keep[-1]),
        _ptr(flat), _ptr(dh0), None)
    assert rc == 0, rc
    grads = [flat[a:b].view(s) for a, b, s in
             zip(spec.leaf_off[:-1], spec.leaf_off[1:], spec.leaf_shapes)]
    return [loss, *hists, *grads, dh0, loss3], keep[-3][0]


def ws_errors(fs, spec, ws, ws_plain, rows, mode):
    """The largest relative distance of the workspace fields the plan
    writes (stage (a)'s forward fields, or the global chain's Linear
    inputs, and the chain's deltas) from the plain stages', over the
    records of ``rows`` (step, row) pairs: (forward, deltas); and
    whether the mask words hold the draws the chain needs (their bits
    are checked through the deltas; here only that stage (a) wrote
    them: no NaN left from the CPU build's NaN fill)."""
    kinds = "xf" if spec.plan == "resident" else "x"
    err = {"fwd": 0.0, "dlt": 0.0}
    for name, _, kind in spec.ws_fields:
        if kind not in kinds + "d" or name == ("mw",):
            continue
        if name[0] == "le" and spec.D != spec.O:
            continue
        a = fs.ws_view(spec, ws[:rows], name)
        b = fs.ws_view(spec, ws_plain[:rows], name)
        e = float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
        e = e if e == e else float("inf")
        key = "dlt" if kind == "d" else "fwd"
        err[key] = max(err[key], e)
    return err


def rehearse(lib, name, kw, D, R, mode):
    """One variant at R rows in one mask mode against the plain versions,
    and the global plan at R rows against the resident plan bit for bit
    (an output of another width than the input runs in the global plan
    alone: there the global plan against the plain versions); prints one
    line and returns whether both hold."""
    import torch

    from njode_tpu_torch.ops import fused_scan as fs

    cfg, arrays, leaves, h0 = _setup(dict(kw), D)
    both = cfg.output_size == cfg.input_size
    spec = fs.Spec(cfg, mode, ("resident" if both else "global", R))
    u = seed = None
    if spec.rate > 0 and spec.S > 0:
        if mode == "input":
            u = (torch.rand((K, spec.S, B, spec.w_max),
                            generator=torch.Generator().manual_seed(1))
                 < 0.8).to(torch.int8)
        else:
            seed = torch.tensor([123456789012345], dtype=torch.int64)
    got, ws = _run(lib, fs, spec, leaves, arrays, h0, u, seed)
    lp, hp = fs.scan_fwd_plain(spec, leaves, arrays, 0.5, h0, True, u, seed)
    gp, dp = fs.scan_bwd_plain(spec, leaves, arrays, 0.5, True, got[1:4],
                               torch.tensor(1.3), u, seed)
    l3, _ = fs.scan_fwd_plain(spec, leaves, arrays, 0.5, h0, False,
                              want_hists=False)
    want = [lp, *hp, *gp, dp, l3]
    errs = [float((a - b).abs().max()) / max(1.0, float(b.abs().max()))
            for a, b in zip(got, want)]
    # K2's stages against the plain ones (the chunk of steps 0-3)
    _, _, wsp = fs.scan_bwd_staged_plain(spec, leaves, arrays, 0.5, True,
                                         got[1:4], torch.tensor(1.3), u,
                                         seed, 4, 4, want_ws=True)
    we = ws_errors(fs, spec, ws, wsp, 4 * B, mode)
    glob = got if not both else _run(
        lib, fs, fs.Spec(cfg, mode, ("global", R)), leaves, arrays, h0, u,
        seed)[0]
    n_diff = sum(not torch.equal(a, b) for a, b in zip(got, glob))
    ok = max(errs + list(we.values())) < 1e-4 and n_diff == 0 and all(
        bool(torch.isfinite(t).all()) for t in got)
    print(f"{'ok ' if ok else 'BAD'} {name} R={R} {mode} "
          f"loss {errs[0]:.1e} hist {max(errs[1:4]):.1e} "
          f"grad {max(errs[4:-2]):.1e} dh0 {errs[-2]:.1e} eval "
          f"{errs[-1]:.1e} stage_fwd {we['fwd']:.1e} stage_dlt "
          f"{we['dlt']:.1e} " + (f"global-vs-resident outputs differing "
                                 f"{n_diff}" if both else "global plan"),
          flush=True)
    return ok


VARIANTS = [
    ("unmasked", dict(), 1),
    ("unmasked_D2", dict(), 2),
    ("masked", dict(masked=True), 2),
    ("rnn", dict(use_rnn=True), 2),
    ("rnn_masked", dict(use_rnn=True, masked=True), 2),
    ("rnn_nobias", dict(use_rnn=True, bias=False), 1),
    ("nobias_relu_easy", dict(bias=False, which_loss="easy",
                              nn=((6, "relu"), (5, "tanh"))), 2),
    ("ict_residual", dict(input_current_t=True, residual_enc_dec=True), 2),
    ("masked_ict_residual", dict(masked=True, input_current_t=True,
                                 residual_enc_dec=True), 2),
    ("depths", dict(ode_nn=((6, "tanh"),),
                    enc_nn=((5, "tanh"), (6, "relu"), (4, "tanh")),
                    readout_nn=((7, "tanh"),)), 1),
    ("masked_depths", dict(masked=True, ode_nn=((6, "tanh"), (3, "tanh"),
                                                (5, "tanh")),
                           enc_nn=((5, "tanh"),)), 2),
    # a widest layer of 37 columns: a row's mask bits span two words and
    # end in a partial quad, and the slots' widths differ
    ("wide37", dict(ode_nn=((37, "tanh"), (6, "tanh")),
                    readout_nn=((33, "tanh"),),
                    enc_nn=((5, "tanh"), (37, "relu"))), 2),
    # output_size != input_size (unmasked, the global plan): the loss
    # broadcasts X [B, D] against y [B, O], the gradient sums over the
    # broadcast axis
    ("out1_D2", dict(output_size=1), 2),
    ("out2_D1", dict(output_size=2), 1),
    ("easy_out1_D3", dict(output_size=1, which_loss="easy",
                          residual_enc_dec=False), 3),
    ("rnn_out1_D2", dict(use_rnn=True, output_size=1), 2),
    ("rnn_out2_D1", dict(use_rnn=True, output_size=2), 1),
    # nets deeper than 8 linears: 16 in the ODE net, then 17 and 33 (the
    # layer table's records, no cap but shared memory)
    ("deep9", dict(ode_nn=((6, "tanh"),) * 8, enc_nn=((5, "relu"),) * 8,
                   readout_nn=((4, "tanh"),) * 8), 1),
    ("deep16", dict(ode_nn=((5, "tanh"), (4, "relu")) * 7 + ((6, "tanh"),),
                    readout_nn=((4, "tanh"),) * 11), 2),
    ("masked_deep12", dict(masked=True, ode_nn=((5, "tanh"),) * 11,
                           enc_nn=((4, "tanh"),) * 9), 2),
    ("rnn_deep10", dict(use_rnn=True, readout_nn=((5, "tanh"),) * 9,
                        ode_nn=((4, "relu"),) * 9), 2),
    ("deep33", dict(ode_nn=((5, "tanh"), (6, "relu")) * 16,
                    enc_nn=((4, "tanh"),) * 32,
                    readout_nn=((6, "tanh"),) * 32), 1),
    ("masked_deep17", dict(masked=True, ode_nn=((5, "tanh"),) * 16,
                           readout_nn=((4, "relu"),) * 16), 2),
    ("rnn_deep17", dict(use_rnn=True, ode_nn=((6, "tanh"),) * 16,
                        readout_nn=((5, "tanh"),) * 3), 2),
]


def rehearse_members(lib, name, kw, D, R, mode, plan="resident", E=3):
    """The member-axis calls (njode_scan_fwd_members,
    njode_scan_bwd_members: E members of one config, each on its own
    weights and batch, in one launch of grid (ceil(B/R), E)) against E solo
    calls of the same plan and rows, bit for bit: K1's losses and
    histories, K2's gradients and dh0 (each member its own cotangent), K3's
    losses; and njode_reduce_partials_members against its plain version.
    Prints one line and returns whether all hold."""
    import torch

    from njode_tpu_torch.ops import fused_scan as fs

    members = [_setup(dict(kw), D, seed=e) for e in range(E)]
    cfg = members[0][0]
    Kk, Bb = members[0][1][2].shape
    spec = fs.Spec(cfg, mode, (plan, R))
    dropping = spec.rate > 0 and spec.S > 0
    us, seeds, solo = [], [], []
    dl = [1.3 + 0.25 * e for e in range(E)]
    for e, (_, arrays, leaves, h0) in enumerate(members):
        u = seed = None
        if dropping and mode == "input":
            u = (torch.rand((Kk, spec.S, Bb, spec.w_max),
                            generator=torch.Generator().manual_seed(e + 1))
                 < 0.8).to(torch.int8)
        elif dropping:
            seed = torch.tensor([123456789012345 + 7919 * e],
                                dtype=torch.int64)
        us.append(u)
        seeds.append(seed)
        solo.append(_run(lib, fs, spec, leaves, arrays, h0, u, seed,
                         dloss=dl[e], chunk=8, stretch=4)[0])
    leaves = [torch.stack(ls).contiguous()
              for ls in zip(*(m[2] for m in members))]
    arrays = tuple(members[0][1][i] if i < 2 else
                   torch.stack([m[1][i] for m in members]).contiguous()
                   for i in range(7))
    h0 = torch.stack([m[3] for m in members]).contiguous()
    u = torch.stack(us).contiguous() if us[0] is not None else None
    seed = torch.cat(seeds) if seeds[0] is not None else None
    times, dts, obs, X, n_obs, start_X, M = fs.unpack_arrays(spec, arrays)
    tab = fs.layer_table(spec, leaves)
    wg = fs.packed_weights_members(spec, leaves)
    prog = (None if spec.plan != "global" else
            torch.tensor(spec.tile_program()[0], dtype=torch.int32))
    out = []
    for want in (True, False):
        c = fs.make_cfg(spec, Kk, Bb, want, 0.5, bwd=False)
        part = torch.full((E, -(-Bb // c.rows)), float("nan"))
        loss = torch.empty(E)
        hists = ((torch.empty(E, Kk, Bb, spec.H),
                  torch.empty(E, Kk, Bb, spec.D), torch.empty(E, Kk, Bb, 1)) if want else (None,) * 3)
        assert lib.njode_scan_fwd_members(
            ctypes.addressof(c), E, _ptr(tab), _ptr(wg), _ptr(prog),
            _ptr(times),
            _ptr(dts), _ptr(obs), _ptr(X), _ptr(M),
            _ptr(u if want else None), _ptr(seed if want else None),
            _ptr(n_obs), _ptr(h0), _ptr(start_X), _ptr(part), _ptr(loss),
            *(_ptr(t) for t in hists), int(want), 1.0 / Bb, None) == 0
        out.append((loss, hists))
    (loss, hists), (loss3, _) = out
    # the member call at another chunk length than the solo calls' (both
    # multiples of the stretch), as a launch whose workspace holds all its
    # members takes: the same bits
    c, work, keep, _ = fs._k2_work(spec, Kk, Bb, E, True, 0.5,
                                   torch.device("cpu"), 4, 4)
    if spec.plan == "resident" and R == 1:
        work.threads = 128       # a member launch that overflows a wave
    flat = torch.empty(E, spec.n_params)
    dh0 = torch.empty(E, Bb, spec.H)
    dloss = torch.tensor(dl)
    assert lib.njode_scan_bwd_members(
        ctypes.addressof(c), E, ctypes.addressof(work), _ptr(tab), _ptr(wg),
        _ptr(prog), _ptr(times),
        _ptr(dts), _ptr(obs), _ptr(X), _ptr(M), _ptr(u), _ptr(seed),
        _ptr(n_obs), *(_ptr(t) for t in hists), _ptr(dloss),
        _ptr(keep[-1]), _ptr(flat), _ptr(dh0), None) == 0
    n_diff = 0
    for e in range(E):
        got = [loss[e], *(h[e] for h in hists),
               *[flat[e, a:b].view(sh) for a, b, sh in zip(
                   spec.leaf_off[:-1], spec.leaf_off[1:], spec.leaf_shapes)],
               dh0[e], loss3[e]]
        n_diff += sum(not torch.equal(a, b) for a, b in zip(got, solo[e]))
    P = torch.randn(E, 5, 37, generator=torch.Generator().manual_seed(3))
    red = torch.empty(E, 37)
    assert lib.njode_reduce_partials_members(_ptr(P), E, 5, 37, 0.5,
                                             _ptr(red), None) == 0
    red_ok = torch.equal(red, fs.reduce_partials_members_plain(P, 0.5))
    ok = n_diff == 0 and red_ok
    print(f"{'ok ' if ok else 'BAD'} members {name} {plan} R={R} {mode} "
          f"E={E} outputs differing from solo calls {n_diff} "
          f"reduce_members_equal {red_ok}", flush=True)
    return ok


def masks(lib, K, S, Bm, W, seed=2 ** 40 + 17, rate=0.1):
    """njode_philox_masks through the CPU build against
    ``philox_keep_plain``: whether every byte is the plain draw."""
    import torch

    from njode_tpu_torch.ops import fused_scan as fs

    thresh = min(int((1.0 - rate) * 2.0 ** 32), 2 ** 32 - 1)
    out = torch.full((K, S, Bm, W), -1, dtype=torch.int8)
    sd = torch.tensor([seed], dtype=torch.int64)
    assert lib.njode_philox_masks(_ptr(sd), K, S, Bm, W, thresh, _ptr(out),
                                  None) == 0
    want = fs.philox_keep_plain(seed, torch.arange(K), S, Bm, W, thresh)
    return torch.equal(out, want.to(torch.int8))


def main(names):
    import rehearse_fused_gob as rg

    from njode_tpu_torch.ops import _build

    with tempfile.TemporaryDirectory() as tmp:
        lib = ctypes.CDLL(rg.build(tmp, "fused_scan"))
        _build._declare("fused_scan", lib)
        ok = True
        for name, kw, D in VARIANTS:
            if names and name not in names:
                continue
            for R in (1, 2, 16):
                for mode in ("input", "prng"):
                    ok &= rehearse(lib, name, kw, D, R, mode)
            for plan, R, mode in (("resident", 1, "prng"),
                                  ("global", 2, "input")):
                # an output of another width than the input: global alone
                if plan == "global" or kw.get("output_size", D) == D:
                    ok &= rehearse_members(lib, name, kw, D, R, mode, plan)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
