"""A/B timing of the NJODE scan kernels (K1-K3) and reduce_partials of one
checkout on one CUDA card, to compare two versions within one machine.

    python3 ab_scan_kernels.py ROOT TAG [witness|gob|phases]

ROOT is a checkout holding ``njode_tpu_torch/`` and ``chip_smoke.py`` (e.g.
the parent commit unpacked with ``git archive`` into a git-ignored
directory); TAG names it in the output. Run the versions alternately in one
call (parent, change, change, parent). Prints the build time, ptxas's
register and spill lines, then one line of CUDA-event ms:

- the resident plan, each arm at the checkout's own rows rule and forced
  at 16 rows (suffix ``r16``): the main path's K1/K2/K3 ('prng', K = 100)
  at B = 200 and 100, its K3 at the eval's B = 4,000, and the masked
  K1/K2/K3 at the climate small arm's widths (B = 100, K = 2,004); the
  PhysioNet 50 arm (D = H = 41, width 50, B = 50, K = 3,006) at the rule's
  rows (``r50``);
- the global plan: K1/K2/K3 at the PhysioNet 50 arm forced into it at 16
  rows, the PhysioNet 200 arm (width 200, same grid) and the climate 400
  arm (D 5, H 50, width 400, B = 100, K = 2,004);
- reduce_partials at the partials of the main path and the PhysioNet 50
  arm at one row a CTA and at 16 rows, and of the climate 400 arm: the
  device time per launch
  from torch.profiler (``red...``) and, the old yardstick, CUDA events
  around a Python loop of wrapper calls (``red...host``).

Every arm runs on a synthetic masked batch (2 % of the rows observed a
step, 40 % of an observed row's coordinates), its model from the
checkout's ``chip_smoke._masked_njode``.

With ``gob`` it times the GRU-ODE-Bayes kernels instead (``gob_arms``):
K5, K5's eval form and K6 at hidden 50 and 100 (B = 20, K = 100, the
published grid's widths), the climate GOB arm (D 5, hidden 50, p_hidden
25, prep_hidden 10, impute off; B = 100, K = 2,004, on the synthetic
masked batch) and the eval at B = 2,000 (hidden 50), through the API both
the parent (8 rows a CTA, one backward kernel) and this tree have; where
the checkout takes a forced rows per CTA (``fused_gob.ROW_CHOICES``), also
at each R that fits, with the weights forced through L1/L2 ('G'), and
K6's stages' device times (torch.profiler).

With ``phases`` it builds the scan kernels with -DNJODE_PHASE_CLOCK (a
library of their own, where the checkout's ``_build`` takes defines) and
prints, a line a
kernel, the SM cycles of each phase of one step (the middle one, CTA 0)
of the resident K1, K2 and K3 at the rows rule's pick: the main path (B =
100 and 200, and K3 at 4,000) with the encoder and with the GRU jump, the
climate small arm and the PhysioNet 50 arm (B = 50, on the synthetic
masked batch, K = 200).

With ``witness`` it runs ``draw_witness`` instead of the timings: K1 of
the PhysioNet 200 arm on masks drawn as chip_smoke.py drew them, one line
a draw with a digest of K1's output bits (equal digests: equal bits in two
checkouts) and its histories against the plain version in fp32 and in
fp64."""

import hashlib
import sys
import time


def device_ms(fn, name, reps=50):
    """Device time per call of ``fn`` of the kernels whose name holds
    ``name`` (torch.profiler), or None."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(getattr(e, "device_time_total", 0.0)
                or getattr(e, "cuda_time_total", 0.0)
                for e in prof.key_averages() if name in e.key)
    return total / 1e3 / reps if total > 0 else None


def draw_witness(cs, fs, dev, tag):
    """K1 of the PhysioNet 200 arm in 'prng' mode over the first 100 steps
    of the stand-in's first batch (chip_smoke.py's check), on the two draws
    chip_smoke.py's physionet_kernels phase made when every arm drew from
    one generator, replayed from it (seed 4: the plan checks of the main
    path and the climate small arm, the 50 arm's K = 100 and K = 3,006
    checks, with ('shared_resident') or without ('shared') the 50 arm's two
    checks in the resident plan, then the 200 arm's 'input' draw), and on
    fresh draws. Prints, per draw, a digest of K1's
    loss and histories and the histories' largest distance |a - b| and
    share of GRAD_TOL (|a - b| / (atol + rtol |b|), 1 at the limit): the
    kernel against the plain version in fp32 (chip_smoke.py's check) and
    in fp64, and the fp32 plain version against the fp64 one."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    res = {}
    cs.physionet_setup(res)
    b = cs._first_steps(res["phys"]["batch"], 100)
    K, B = b.obs.shape
    cfg, model = cs._masked_njode(41, 41, 200, dev)
    leaves = [p.detach() for p in fs.flat_leaves(model)]
    arrays = fs.batch_arrays(b)
    with torch.no_grad():
        h0 = fs.t0_state(model, b)
    spec = fs.Spec(cfg, "prng")

    def u_draw(gen, cfg_u, K_u, B_u):
        s = fs.Spec(cfg_u, "input")
        torch.rand((K_u, s.S, B_u, s.w_max), generator=gen, device=dev)

    def seed_draw(gen):
        return torch.randint(0, 2 ** 62, (1,), generator=gen, device=dev,
                             dtype=torch.int64)

    def replayed(resident_checks):
        gen = torch.Generator(device=dev).manual_seed(4)
        main_cfg = cs.main_path_setup(200, 100, 0, dev)[0]
        cfg_c = cs._masked_njode(5, 10, 50, dev)[0]
        cfg_50 = cs._masked_njode(41, 41, 50, dev)[0]
        for cfg_u, B_u in ((main_cfg, 200), (cfg_c, 100)):
            u_draw(gen, cfg_u, 100, B_u)
            seed_draw(gen)
        u_draw(gen, cfg_50, 100, 50)
        seed_draw(gen)
        seed_draw(gen)
        if resident_checks:
            u_draw(gen, cfg_50, 100, 50)
            seed_draw(gen)
        u_draw(gen, cfg, K, B)
        return seed_draw(gen)

    draws = [("shared", replayed(False)),
             ("shared_resident", replayed(True))]
    for i in range(4):
        draws.append((f"fresh{i}", seed_draw(
            torch.Generator(device=dev).manual_seed(100 + i))))
    tol = cs.GRAD_TOL
    leaves64 = [p.double() for p in leaves]
    arrays64 = tuple(a.double() for a in arrays)

    def dist(a, c):
        d = (a.double() - c.double()).abs()
        share = d / (tol["atol"] + tol["rtol"] * c.double().abs())
        return float(d.max()), float(share.max())

    for name, seed in draws:
        lk, hk = fs.scan_fwd_cuda(spec, leaves, arrays, 0.5, h0, True, None,
                                  seed)
        torch.cuda.synchronize()
        digest = hashlib.sha1(b"".join(
            t.cpu().numpy().tobytes() for t in (lk, *hk))).hexdigest()[:16]
        _, hp = fs.scan_fwd_plain(spec, leaves, arrays, 0.5, h0, True, None,
                                  seed)
        _, hd = fs.scan_fwd_plain(spec, leaves64, arrays64, 0.5, h0.double(),
                                  True, None, seed)
        ek, sk = dist(hk[0], hp[0])
        ed, sd = dist(hk[0], hd[0])
        ep, sp = dist(hp[0], hd[0])
        print(tag, "witness", name, f"seed={int(seed)}", f"digest={digest}",
              f"kernel_vs_fp32={ek:.4e}", f"share={sk:.3f}",
              f"kernel_vs_fp64={ed:.4e}", f"share={sd:.3f}",
              f"fp32_vs_fp64={ep:.4e}", f"share={sp:.3f}", flush=True)


def gob_arms(cs, dev, tag, masked_batch):
    """CUDA-event ms of K5 ('prng', training), K5 eval and K6 ('prng') at
    each GOB arm, at the checkout's own rows rule ('rule') and, where it
    takes one, each forced R that fits; K6's stage device times."""
    import torch

    from njode_tpu_torch.models import gru_ode_bayes as gob
    from njode_tpu_torch.ops import fused_gob as fg

    from njode_tpu_torch.ops import _build

    for ln in _build.build_log["fused_gob"]["ptxas"].splitlines():
        if "registers" in ln or "spill" in ln or "Compiling" in ln:
            print(tag, ln.strip())
    print(tag, "gob_nvcc_s", round(_build.build_log["fused_gob"]["seconds"],
                                   2), flush=True)
    seed = torch.tensor([7], dtype=torch.int64, device=dev)
    one = torch.ones((), device=dev)
    forced = getattr(fg, "ROW_CHOICES", None)
    arms = []
    for hidden in (50, 100):
        cfg, _, _, arrays, leaves, st = cs.gob_setup(20, 100, hidden, True,
                                                     1e-4, hidden, dev)
        arms.append((f"h{hidden}", cfg, arrays, leaves, st, 10, 5))
    gcfg, gmodel = cs._climate_gob(dev)
    b = masked_batch(2004, 100, 5)
    with torch.no_grad():
        h0 = gob.mlp2(gmodel.covariates_map, b.start_X, 0.0)
        p0 = gob.mlp2(gmodel.p_model, h0, 0.0)
    arms.append(("clim", gcfg, (b.times, b.dt, b.obs, b.X, b.M),
                 [p.detach() for p in fg.flat_leaves(gmodel, fg.Spec(gcfg))],
                 (h0.contiguous(), p0[:, :5].contiguous(),
                  p0[:, 5:].contiguous()), 3, 2))
    cfg_e, _, _, arrays_e, leaves_e, st_e = cs.gob_setup(2000, 100, 50, True,
                                                         1e-4, 7, dev)
    out = {}

    def spec_at(cfg, mode, R):
        return fg.Spec(cfg, mode) if R is None else fg.Spec(cfg, mode, rows=R)

    for name, cfg, arrays, leaves, st, r5, r6 in arms:
        base = fg.Spec(cfg)
        rows = [None] + [R for R in (forced or ()) if base.fits(R)]
        for R in rows:
            suffix = f"{name}" + ("" if R is None else f"R{R}")
            spec = spec_at(cfg, "prng", R)
            _, hists = fg.gob_scan_fwd_cuda(spec, leaves, arrays, *st, True,
                                            None, seed)
            out["K5" + suffix] = cs.cuda_ms(lambda: fg.gob_scan_fwd_cuda(
                spec, leaves, arrays, *st, True, None, seed), r5, 1)
            out["K6" + suffix] = cs.cuda_ms(lambda: fg.gob_scan_bwd_cuda(
                spec, leaves, arrays, True, hists, one, None, seed), r6, 1)
            if forced is not None and R is None:
                # the weights forced through L1/L2 (the rule stages them
                # where they fit): K5 and K6 once more
                gspec = fg.Spec(cfg, "prng", weights="global")
                out["K5" + suffix + "G"] = cs.cuda_ms(
                    lambda: fg.gob_scan_fwd_cuda(gspec, leaves, arrays, *st,
                                                 True, None, seed), r5, 1)
                out["K6" + suffix + "G"] = cs.cuda_ms(
                    lambda: fg.gob_scan_bwd_cuda(gspec, leaves, arrays, True,
                                                 hists, one, None, seed),
                    r6, 1)
                for kern in ("gob_remat_kernel", "gob_chain_kernel",
                             "gob_wgrad_kernel"):
                    ms = device_ms(lambda: fg.gob_scan_bwd_cuda(
                        spec, leaves, arrays, True, hists, one, None, seed),
                        kern, reps=r6)
                    out[kern.split("_")[1] + suffix] = ms or float("nan")
            print(tag, " ".join(f"{k}={v:.4f}" for k, v in out.items()
                                if k.endswith((suffix, suffix + "G"))),
                  flush=True)
    base = fg.Spec(cfg_e, "input")
    rows = [None] + [R for R in (forced or ()) if base.fits(R, False)]
    for R in rows:
        spec = spec_at(cfg_e, "input", R)
        k = "K5e" + ("" if R is None else f"R{R}")
        out[k] = cs.cuda_ms(lambda: fg.gob_scan_fwd_cuda(
            spec, leaves_e, arrays_e, *st_e, False, want_hists=False), 5, 1)
        print(tag, f"{k}={out[k]:.4f}", flush=True)


def phase_clocks(cs, fs, lib, dev, tag, masked_batch):
    """``phases``: K1, K2 and K3 through the library ``lib`` (built with
    -DNJODE_PHASE_CLOCK); prints each launch's phase cycles."""
    import ctypes

    import torch

    fs._lib = lambda: lib
    seed = torch.tensor([7], dtype=torch.int64, device=dev)
    one = torch.ones((), device=dev)

    def show(name):
        torch.cuda.synchronize()
        buf = (ctypes.c_longlong * 256)()
        n = ctypes.c_int(0)
        fs._raise_rc(lib, lib.njode_phase_clock(buf, ctypes.byref(n)),
                     "njode_phase_clock")
        d = [buf[i + 1] - buf[i] for i in range(n.value - 1)]
        print(tag, name, f"phases={len(d)} cycles={sum(d)} "
              f"per_phase={','.join(map(str, d))}", flush=True)

    def three(name, cfg, model, b, B3=None):
        leaves = [p.detach() for p in fs.flat_leaves(model)]
        arrays = fs.batch_arrays(b)
        with torch.no_grad():
            h0 = fs.t0_state(model, b)
        K, B = arrays[2].shape
        spec = fs.Spec(cfg, "prng")
        _, hists = fs.scan_fwd_cuda(spec, leaves, arrays, 0.5, h0, True,
                                    None, seed)
        show(f"K1 {name} B={B} R={spec.rows_for(B, False)}")
        fs.scan_bwd_cuda(spec, leaves, arrays, 0.5, True, hists, one, None,
                         seed)
        show(f"K2 {name} B={B} R={spec.rows_for(B)}")
        spec3 = fs.Spec(cfg, "input")
        fs.scan_fwd_cuda(spec3, leaves, arrays, 0.5, h0, False,
                         want_hists=False)
        show(f"K3 {name} B={B} R={spec3.rows_for(B, False)}")

    for use_rnn in (False, True):
        for B in (100, 200, 4000):
            cfg, model, batch = cs.main_path_setup(B, 100, 0, dev, use_rnn)
            three("main_path" + ("_rnn" if use_rnn else ""), cfg, model,
                  batch)
    for name, D, H, width, B in (("climate_small", 5, 10, 50, 100),
                                 ("physionet_50", 41, 41, 50, 50)):
        cfg, model = cs._masked_njode(D, H, width, dev)
        three(name, cfg, model, masked_batch(200, B, D))


def main(root, tag, what="timing"):
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke as cs
    from njode_tpu_torch.data.grid import GridBatch
    from njode_tpu_torch.ops import _build
    from njode_tpu_torch.ops import fused_scan as fs

    t0 = time.time()
    if what == "phases":
        lib = _build.load("fused_scan", ("NJODE_PHASE_CLOCK",))
        key = "fused_scan_njode_phase_clock"
    else:
        _build.build_all(("fused_scan", "fused_gob") if what == "gob"
                         else ("fused_scan",))
        _build.load("fused_scan")
        key = "fused_scan"
    print(tag, "build_s", round(time.time() - t0, 2), flush=True)
    for ln in _build.build_log[key]["ptxas"].splitlines():
        if "registers" in ln or "spill" in ln or "Compiling" in ln:
            print(tag, ln.strip())
    dev = torch.device("cuda")
    if what == "witness":
        draw_witness(cs, fs, dev, tag)
        return

    def masked_batch(K, B, D):
        rs = np.random.RandomState(0)
        obs = (rs.random((K, B)) < 0.02).astype(np.float32)
        M = (rs.random((K, B, D)) < 0.4).astype(np.float32) * obs[:, :, None]
        X = rs.normal(size=(K, B, D)).astype(np.float32) * M
        times = (np.arange(1, K + 1) * 0.1).astype(np.float32)
        return GridBatch(times=torch.as_tensor(times, device=dev),
                         dt=torch.full((K,), 0.1, device=dev),
                         obs=torch.as_tensor(obs, device=dev),
                         X=torch.as_tensor(X, device=dev),
                         M=torch.as_tensor(M, device=dev),
                         start_X=torch.zeros((B, D), device=dev),
                         n_obs_ot=torch.as_tensor(obs.sum(0), device=dev))

    if what == "gob":
        gob_arms(cs, dev, tag, masked_batch)
        return
    if what == "phases":
        phase_clocks(cs, fs, lib, dev, tag, masked_batch)
        return
    one = torch.ones((), device=dev)
    seed = torch.tensor([7], dtype=torch.int64, device=dev)
    out = {}

    def time_three(cfg, leaves, arrays, h0, suffix, reps, warmup,
                   plan=None):
        spec = fs.Spec(cfg, "prng", plan)
        spec3 = fs.Spec(cfg, "input", plan)
        _, hists = fs.scan_fwd_cuda(spec, leaves, arrays, 0.5, h0, True,
                                    None, seed)
        out["K1" + suffix] = cs.cuda_ms(lambda: fs.scan_fwd_cuda(
            spec, leaves, arrays, 0.5, h0, True, None, seed), reps, warmup)
        out["K2" + suffix] = cs.cuda_ms(lambda: fs.scan_bwd_cuda(
            spec, leaves, arrays, 0.5, True, hists, one, None, seed), reps,
            warmup)
        out["K3" + suffix] = cs.cuda_ms(lambda: fs.scan_fwd_cuda(
            spec3, leaves, arrays, 0.5, h0, False, want_hists=False), reps,
            warmup)

    r16 = ("resident", 16)
    for B in (200, 100):
        cfg, model, batch = cs.main_path_setup(B, 100, 0, dev)
        arrays = (batch.times, batch.dt, batch.obs, batch.X, batch.n_obs_ot,
                  batch.start_X)
        with torch.no_grad():
            h0 = model.encoder_map(batch.start_X)
        for plan, sfx in ((None, ""), (r16, "_r16")):
            time_three(cfg, [p.detach() for p in fs.flat_leaves(model)],
                       arrays, h0, f" B={B}{sfx}", 20, 2, plan)
    cfg, model, batch = cs.main_path_setup(4000, 100, 2, dev)
    arrays = (batch.times, batch.dt, batch.obs, batch.X, batch.n_obs_ot,
              batch.start_X)
    with torch.no_grad():
        h0 = model.encoder_map(batch.start_X)
    leaves = [p.detach() for p in fs.flat_leaves(model)]
    for plan, sfx in ((None, ""), (r16, "_r16")):
        spec3 = fs.Spec(cfg, "input", plan)
        out["K3 B=4000" + sfx] = cs.cuda_ms(lambda: fs.scan_fwd_cuda(
            spec3, leaves, arrays, 0.5, h0, False, want_hists=False), 10, 2)

    # (suffix, D, H, width, B, K, timed calls, forced plan)
    arms = [("m", 5, 10, 50, 100, 2004, 3, None),
            ("m_r16", 5, 10, 50, 100, 2004, 3, r16),
            ("g50", 41, 41, 50, 50, 3006, 3, ("global", 16)),
            ("r50", 41, 41, 50, 50, 3006, 3, None),
            ("g200", 41, 41, 200, 50, 3006, 2, None),
            ("g400", 5, 50, 400, 100, 2004, 2, None)]
    for suffix, D, H, width, B, K, reps, plan in arms:
        b = masked_batch(K, B, D)
        cfg, model = cs._masked_njode(D, H, width, dev)
        with torch.no_grad():
            h0 = fs.t0_state(model, b)
        time_three(cfg, [p.detach() for p in fs.flat_leaves(model)],
                   fs.batch_arrays(b), h0, suffix, reps, 1, plan)

    gen = torch.Generator(device=dev).manual_seed(2)
    for n_parts, n in ((100, 10071), (50, 24423), (13, 10071), (4, 24423),
                       (25, 571305)):
        P = torch.randn((n_parts, n), generator=gen, device=dev)
        tag_s = f"red{n_parts}x{n}"
        out[tag_s] = device_ms(lambda: fs.reduce_partials_cuda(P),
                               "reduce_partials_kernel") or float("nan")
        out[tag_s + "host"] = cs.cuda_ms(lambda: fs.reduce_partials_cuda(P),
                                         200)
    print(tag, " ".join(f"{k}={v:.4f}" for k, v in out.items()), flush=True)


if __name__ == "__main__":
    main(*sys.argv[1:4])
