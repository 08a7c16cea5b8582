"""A/B timing of the NJODE scan kernels (K1-K3) and reduce_partials of one
checkout on one CUDA card, to compare two versions within one machine.

    python3 ab_scan_kernels.py ROOT TAG [MODE]

MODE: witness, gob, phases, masks, main, wgrad, scope or build (none:
the timings below).

ROOT is a checkout holding ``njode_tpu_torch/`` and ``chip_smoke.py`` (e.g.
the parent commit unpacked with ``git archive`` into a git-ignored
directory); TAG names it in the output. Run the versions alternately in one
call (parent, change, change, parent). Prints the build time, ptxas's
register and spill lines, the bytes of K1/K2's parameter block
(``param_bytes``), then one line of CUDA-event ms:

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
masked batch, K = 200); K1 and K2 in 'prng' mode and with dropout off
(``off``: train False, no masks).

With ``masks`` it times the dropout masks (``mask_costs``): the
standalone mask kernels K4 (``philox_masks_kernel``, K = 100, S = 8, B =
200, W = 50) and K7 (``gob_masks_kernel`` at the GOB shape K = 100, B =
20, P = 50 and the climate GOB arm's K = 2,004, B = 100, P = 25) by
device time (torch.profiler) beside the host yardstick (CUDA events around
a loop of wrapper calls), and what the masks cost inside the kernels that
draw them: K1/K2 at the main path (B = 100), the climate small arm and the
PhysioNet 50 arm, K5/K6 at GOB hidden 50 and the climate GOB arm, each
with dropout off, in 'input' mode fed with the standalone kernel's masks
and in 'prng' mode (CUDA-event ms), whether the 'input' and the 'prng'
outputs are equal bit for bit, and a digest of the 'prng' outputs (equal
digests in two checkouts: equal bits).

With ``main`` it times only the kernels of the main path and the arms
that share their code (``main_arms``, CUDA-event ms, 'prng', K = 100): the
resident K1/K2/K3 at B = 200 and 100 with the encoder and with the GRU
jump, the same at B = 100 forced into the global plan at 16 rows, the
resident K1/K2/K3 of the PhysioNet 50 arm (``r50``, on the synthetic
masked batch), the member K1/K2 (E = 5, B = 100, through the checkout's
``chip_smoke._member_times``), and where the checkout's ``supported``
takes it, an unmasked output of another width than the input
(HestonWOFeller return_vol shapes, D = 2, O = 1, B = 100) in the plan its
rule picks, and the main path's model with a 16-linear ODE net (B = 100,
the global plan); then a line of digests of each arm's outputs.

The digests hold K1's and K3's outputs and, apart, K2's dh0; K2's weight
gradients go to ``_check/ab_grads/<TAG>_<arm>.pt`` (a git-ignored
directory), and ``python3
ab_scan_kernels.py . TAG_A grads TAG_B`` holds each arm's against the
other checkout's at the North-star tolerances (since K2's stage (c) sums
them in another order than a single walk did, they need not be equal bit
for bit).

With ``wgrad`` it times the weight gradients' stage (c) alone
(``wgrad_arms``): the device time a call (torch.profiler, every chunk's
launch) of K2's ``njode_wgrad_kernel`` at the main path (B = 200 and 100,
the GRU jump at B = 200, members E = 5 at B = 100) and of K6's
``gob_wgrad_kernel`` at GOB hidden 50 and 100 and the climate GOB arm,
then a line of digests of the gradients and d(h0) each call gives (equal
digests in two checkouts: equal bits).

With ``scope`` it runs the checkout's ``chip_smoke.phase_scope`` alone
(its checks, launch counts and times; a checkout that has it).

With ``build`` it builds ``fused_scan.cu`` and prints nvcc's seconds
(``build_s``) and the parameter block's bytes, nothing else: run it for
two checkouts side by side (two processes started together) to compare
their builds on one machine.

With ``witness`` it runs ``draw_witness`` instead of the timings: K1 of
the PhysioNet 200 arm on masks drawn as chip_smoke.py drew them, one line
a draw with a digest of K1's output bits (equal digests: equal bits in two
checkouts) and its histories against the plain version in fp32 and in
fp64."""

import hashlib
import os
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
        for train, mode in ((True, ""), (False, " off")):
            _, hists = fs.scan_fwd_cuda(spec, leaves, arrays, 0.5, h0, train,
                                        None, seed)
            show(f"K1{mode} {name} B={B} R={spec.rows_for(B, False)}")
            fs.scan_bwd_cuda(spec, leaves, arrays, 0.5, train, hists, one,
                             None, seed)
            show(f"K2{mode} {name} B={B} R={spec.rows_for(B)}")
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


def mask_costs(cs, fs, dev, tag, masked_batch):
    """``masks``: K4's and K7's device and host times, then each
    mask-carrying kernel with dropout off (train False), in 'input' mode on
    the standalone kernel's masks and in 'prng' mode (CUDA-event ms), and
    whether 'input' and 'prng' give the same bits."""
    import torch

    from njode_tpu_torch.models import gru_ode_bayes as gob
    from njode_tpu_torch.ops import fused_gob as fg

    seed = torch.tensor([7], dtype=torch.int64, device=dev)
    one = torch.ones((), device=dev)
    thresh = min(int(0.9 * 2.0 ** 32), 2 ** 32 - 1)     # dropout 0.1
    out = {}
    for name, fn, kern in (
            ("K4", lambda: fs.philox_masks_cuda(seed, 100, 8, 200, 50,
                                                thresh),
             "philox_masks_kernel"),
            ("K7gob", lambda: fg.gob_masks_cuda(seed, 100, 20, 50, thresh),
             "gob_masks_kernel"),
            ("K7clim", lambda: fg.gob_masks_cuda(seed, 2004, 100, 25,
                                                 thresh),
             "gob_masks_kernel")):
        out[name + "_device"] = device_ms(fn, kern) or float("nan")
        out[name + "_host"] = cs.cuda_ms(fn, 50)
    print(tag, "mask_kernels", " ".join(f"{k}={v:.5f}"
                                        for k, v in out.items()), flush=True)

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    def digest(ts):
        return hashlib.sha1(b"".join(
            t.cpu().numpy().tobytes() for t in ts)).hexdigest()[:16]

    def njode(arm, cfg, model, b, reps):
        leaves = [p.detach() for p in fs.flat_leaves(model)]
        arrays = fs.batch_arrays(b)
        with torch.no_grad():
            h0 = fs.t0_state(model, b)
        K, B = arrays[2].shape
        sp, si = fs.Spec(cfg, "prng"), fs.Spec(cfg, "input")
        u = fs.philox_masks_cuda(seed, K, sp.S, B, sp.w_max, sp.thresh)
        ms, got = {}, {}
        for mode, spec, train, uu, ss in (("off", sp, False, None, None),
                                          ("input", si, True, u, None),
                                          ("prng", sp, True, None, seed)):
            lk, hk = fs.scan_fwd_cuda(spec, leaves, arrays, 0.5, h0, train,
                                      uu, ss)
            gk, dk = fs.scan_bwd_cuda(spec, leaves, arrays, 0.5, train, hk,
                                      one, uu, ss)
            got[mode] = (lk, *hk, *gk, dk)
            ms["K1_" + mode] = cs.cuda_ms(lambda: fs.scan_fwd_cuda(
                spec, leaves, arrays, 0.5, h0, train, uu, ss), reps, 1)
            ms["K2_" + mode] = cs.cuda_ms(lambda: fs.scan_bwd_cuda(
                spec, leaves, arrays, 0.5, train, hk, one, uu, ss), reps, 1)
        print(tag, "mask_cost", f"arm={arm} B={B} K={K} "
              f"R={sp.rows_for(B, False)}/{sp.rows_for(B)}",
              " ".join(f"{k}={v:.4f}" for k, v in ms.items()),
              f"prng_eq_input={same(got['prng'], got['input'])}",
              f"prng_digest={digest(got['prng'])}", flush=True)

    cfg, model, batch = cs.main_path_setup(100, 100, 0, dev)
    njode("main", cfg, model, batch, 20)
    for arm, D, H, K, B, reps in (("climate_small", 5, 10, 2004, 100, 3),
                                  ("physionet_50", 41, 41, 3006, 50, 2)):
        cfg, model = cs._masked_njode(D, H, 50, dev)
        njode(arm, cfg, model, masked_batch(K, B, D), reps)

    def gob_arm(arm, cfg, arrays, leaves, st, reps):
        K, B = arrays[2].shape
        spec, si = fg.Spec(cfg, "prng"), fg.Spec(cfg, "input")
        u = fg.gob_masks_cuda(seed, K, B, spec.P, spec.thresh)
        ms, got = {}, {}
        for mode, sp, train, uu, ss in (("off", spec, False, None, None),
                                        ("input", si, True, u, None),
                                        ("prng", spec, True, None, seed)):
            lk, hk = fg.gob_scan_fwd_cuda(sp, leaves, arrays, *st, train, uu,
                                          ss)
            g = fg.gob_scan_bwd_cuda(sp, leaves, arrays, train, hk, one, uu,
                                     ss)
            got[mode] = (lk, *hk, *g[0], *g[1:])
            ms["K5_" + mode] = cs.cuda_ms(lambda: fg.gob_scan_fwd_cuda(
                sp, leaves, arrays, *st, train, uu, ss), reps, 1)
            ms["K6_" + mode] = cs.cuda_ms(lambda: fg.gob_scan_bwd_cuda(
                sp, leaves, arrays, train, hk, one, uu, ss), reps, 1)
        print(tag, "mask_cost", f"arm={arm} B={B} K={K} "
              f"R={spec.rows_for(B)}",
              " ".join(f"{k}={v:.4f}" for k, v in ms.items()),
              f"prng_eq_input={same(got['prng'], got['input'])}",
              f"prng_digest={digest(got['prng'])}", flush=True)

    cfg, _, _, arrays, leaves, st = cs.gob_setup(20, 100, 50, True, 1e-4, 50,
                                                 dev)
    gob_arm("gob_h50", cfg, arrays, leaves, st, 10)
    gcfg, gmodel = cs._climate_gob(dev)
    b = masked_batch(2004, 100, 5)
    with torch.no_grad():
        h0 = gob.mlp2(gmodel.covariates_map, b.start_X, 0.0)
        p0 = gob.mlp2(gmodel.p_model, h0, 0.0)
    gob_arm("gob_climate", gcfg, (b.times, b.dt, b.obs, b.X, b.M),
            [p.detach() for p in fg.flat_leaves(gmodel, fg.Spec(gcfg))],
            (h0.contiguous(), p0[:, :5].contiguous(),
             p0[:, 5:].contiguous()), 3)


def main_arms(cs, fs, dev, tag, masked_batch):
    """The ``main`` mode's timings (module docstring), one line, then a
    line of digests of each arm's outputs (K1's loss and histories, K2's
    gradients and dh0, K3's loss): equal digests in two checkouts, equal
    bits."""
    import torch

    one = torch.ones((), device=dev)
    seed = torch.tensor([7], dtype=torch.int64, device=dev)
    out, digests = {}, {}

    def digest(ts):
        return hashlib.sha1(b"".join(
            t.detach().cpu().numpy().tobytes() for t in ts)).hexdigest()[:16]

    def time_three(cfg, model, batch, name, reps, plan=None):
        spec = fs.Spec(cfg, "prng", plan)
        spec3 = fs.Spec(cfg, "input", plan)
        leaves = [p.detach() for p in fs.flat_leaves(model)]
        arrays = fs.batch_arrays(batch)
        with torch.no_grad():
            h0 = fs.t0_state(model, batch)
        loss, hists = fs.scan_fwd_cuda(spec, leaves, arrays, 0.5, h0, True,
                                       None, seed)
        grads, dh0 = fs.scan_bwd_cuda(spec, leaves, arrays, 0.5, True, hists,
                                      one, None, seed)
        l3, _ = fs.scan_fwd_cuda(spec3, leaves, arrays, 0.5, h0, False,
                                 want_hists=False)
        # K1's and K3's outputs and K2's dh0 keep their bits (K1's
        # histories apart: a plan that changed its rows a CTA sums the
        # loss in another order); K2's weight
        # gradients (summed in another order since K2's stage (c)) are
        # saved for ``compare_grads``
        digests[name[1:]] = digest([loss, *hists, l3])
        digests[name[1:] + "_hist"] = digest(list(hists))
        digests[name[1:] + "_dh0"] = digest([dh0])
        torch.save([g.cpu() for g in grads], grads_file(tag, name[1:]))
        out["K1" + name] = cs.cuda_ms(lambda: fs.scan_fwd_cuda(
            spec, leaves, arrays, 0.5, h0, True, None, seed), reps, 2)
        out["K2" + name] = cs.cuda_ms(lambda: fs.scan_bwd_cuda(
            spec, leaves, arrays, 0.5, True, hists, one, None, seed), reps,
            2)
        out["K3" + name] = cs.cuda_ms(lambda: fs.scan_fwd_cuda(
            spec3, leaves, arrays, 0.5, h0, False, want_hists=False), reps,
            2)

    for rnn in (False, True):
        for B in (200, 100):
            cfg, model, batch = cs.main_path_setup(B, 100, 0, dev,
                                                   use_rnn=rnn)
            time_three(cfg, model, batch,
                       f"_{'rnn' if rnn else 'main'}_B{B}", 20)
        time_three(cfg, model, batch, f"_{'rnn' if rnn else 'main'}"
                   "_B100_g16", 10, ("global", 16))
    b = masked_batch(3006, 50, 41)
    cfg, model = cs._masked_njode(41, 41, 50, dev)
    time_three(cfg, model, b, "_r50", 3)
    t = cs._member_times("main", *cs._synthetic_members(5, 100, 100, 50,
                                                        seed0=3), 10)
    out["K1_members"], out["K2_members"] = t["K1"]["ms"], t["K2"]["ms"]
    try:
        cfg, model, batch = cs.main_path_setup(
            100, 100, 20, dev, data=("HestonWOFeller", cs.HWOF_RV),
            output_size=1)
    except (TypeError, AttributeError):  # a checkout without the option
        cfg = None
    if cfg is not None and fs.supported(cfg):
        time_three(cfg, model, batch, f"_out1_{fs.Spec(cfg).plan}", 20)
    # the scope phase's 16-linear ODE net (width 50, the global plan)
    cfg, model, batch = cs.main_path_setup(
        100, 100, 16, dev, ode_nn=((50, "tanh"),) * 15)
    time_three(cfg, model, batch, "_deep16", 5)
    print(tag, " ".join(f"{k}={v:.4f}" for k, v in out.items()), flush=True)
    print(tag, "digests", " ".join(f"{k}={v}" for k, v in digests.items()),
          flush=True)


def wgrad_arms(cs, fs, dev, tag, masked_batch):
    """The ``wgrad`` mode (module docstring): stage (c)'s device ms a call
    at each arm, one line, then a line of digests of each call's outputs."""
    import torch

    from njode_tpu_torch.models import gru_ode_bayes as gob
    from njode_tpu_torch.ops import fused_gob as fg

    one = torch.ones((), device=dev)
    seed = torch.tensor([7], dtype=torch.int64, device=dev)
    out, digests = {}, {}

    def digest(ts):
        return hashlib.sha1(b"".join(
            t.detach().cpu().numpy().tobytes() for t in ts)).hexdigest()[:16]

    def njode(name, cfg, model, batch):
        spec = fs.Spec(cfg, "prng")
        leaves = [p.detach() for p in fs.flat_leaves(model)]
        arrays = fs.batch_arrays(batch)
        with torch.no_grad():
            h0 = fs.t0_state(model, batch)
        _, hists = fs.scan_fwd_cuda(spec, leaves, arrays, 0.5, h0, True,
                                    None, seed)
        bwd = lambda: fs.scan_bwd_cuda(spec, leaves, arrays, 0.5,  # noqa
                                       True, hists, one, None, seed)
        g, dh0 = bwd()
        digests[name] = digest([*g, dh0])
        out[name] = device_ms(bwd, "njode_wgrad_kernel", 20)

    for B in (200, 100):
        njode(f"main_B{B}", *cs.main_path_setup(B, 100, 0, dev))
    njode("rnn_B200", *cs.main_path_setup(200, 100, 0, dev, use_rnn=True))
    cfg, models, batches = cs._synthetic_members(5, 100, 100, 50, seed0=3)
    _, leaves, arrays, h0 = cs._member_layout(models, batches)
    spec = fs.Spec(cfg, "prng")
    seeds = torch.arange(5, dtype=torch.int64, device=dev) + 11
    _, hists = fs.scan_fwd_members_cuda(spec, leaves, arrays, 0.5, h0, True,
                                        None, seeds)
    dl = torch.linspace(0.8, 1.2, 5, device=dev)
    bwd = lambda: fs.scan_bwd_members_cuda(spec, leaves, arrays,  # noqa
                                           0.5, True, hists, dl, None, seeds)
    g, dh0 = bwd()
    digests["members_E5"] = digest([*g, dh0])
    out["members_E5"] = device_ms(bwd, "njode_wgrad_kernel", 10)
    arms = []
    for hidden in (50, 100):
        cfg, _, _, arrays, leaves, st = cs.gob_setup(20, 100, hidden, True,
                                                     1e-4, hidden, dev)
        arms.append((f"gob_h{hidden}", cfg, arrays, leaves, st, 10))
    gcfg, gmodel = cs._climate_gob(dev)
    b = masked_batch(2004, 100, 5)
    with torch.no_grad():
        h0 = gob.mlp2(gmodel.covariates_map, b.start_X, 0.0)
        p0 = gob.mlp2(gmodel.p_model, h0, 0.0)
    arms.append(("gob_clim", gcfg, (b.times, b.dt, b.obs, b.X, b.M),
                 [p.detach() for p in fg.flat_leaves(gmodel, fg.Spec(gcfg))],
                 (h0.contiguous(), p0[:, :5].contiguous(),
                  p0[:, 5:].contiguous()), 3))
    for name, cfg, arrays, leaves, st, reps in arms:
        spec = fg.Spec(cfg, "prng")
        _, hists = fg.gob_scan_fwd_cuda(spec, leaves, arrays, *st, True,
                                        None, seed)
        bwd = lambda: fg.gob_scan_bwd_cuda(spec, leaves, arrays,  # noqa
                                           True, hists, one, None, seed)
        digests[name] = digest([*bwd()[0]])
        out[name] = device_ms(bwd, "gob_wgrad_kernel", reps)
    print(tag, "wgrad_ms", " ".join(f"{k}={v:.5f}" for k, v in out.items()),
          flush=True)
    print(tag, "digests", " ".join(f"{k}={v}" for k, v in digests.items()),
          flush=True)


GRADS_DIR = os.path.join("_check", "ab_grads")


def grads_file(tag, arm):
    """Where ``main`` keeps an arm's K2 weight gradients (under the
    working directory's git-ignored ``_check/``)."""
    os.makedirs(GRADS_DIR, exist_ok=True)
    safe = "".join(c if c.isalnum() else "_" for c in tag)
    return os.path.join(GRADS_DIR, f"{safe}_{arm}.pt")


def compare_grads(tag_a, tag_b):
    """Each arm's K2 weight gradients of two checkouts' ``main`` runs
    against each other: the largest |a - b| over atol + rtol |b| of every
    leaf, at the North-star tolerances (rtol 2e-4, atol 2e-5), and whether
    they are equal bit for bit; one line an arm, then whether all held."""
    import glob

    import torch

    safe = "".join(c if c.isalnum() else "_" for c in tag_a)
    head = os.path.join(GRADS_DIR, f"{safe}_")
    ok = True
    for path in sorted(glob.glob(head + "*.pt")):
        arm = path[len(head):-3]
        ga = torch.load(path)
        gb = torch.load(grads_file(tag_b, arm))
        share = max(float(((a - b).abs() / (2e-5 + 2e-4 * b.abs())).max())
                    for a, b in zip(ga, gb))
        equal = all(torch.equal(a, b) for a, b in zip(ga, gb))
        ok &= share <= 1.0
        print("grads", arm, f"share_of_tol={share:.4f}", f"bitwise={equal}",
              flush=True)
    print("grads_within_tolerance", ok, flush=True)
    return ok


def param_bytes(fs):
    """Bytes of K1/K2's parameter block in the checkout ``fs`` comes from:
    its own count, or (a checkout whose kernels take their per-leaf
    pointers by value) ScanCfg, the ``MAX_LEAVES`` pointers at 8-byte
    alignment and the 16 other pointers."""
    import ctypes

    if hasattr(fs, "param_bytes"):
        return fs.param_bytes()
    return (-(-ctypes.sizeof(fs._ScanCfg) // 8) * 8 + 8 * fs.MAX_LEAVES
            + 8 * 16)


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
        _build.build_all(("fused_scan", "fused_gob")
                         if what in ("gob", "masks", "scope", "wgrad")
                         else ("fused_scan",))
        _build.load("fused_scan")
        key = "fused_scan"
    print(tag, "build_s", round(time.time() - t0, 2), flush=True)
    for ln in _build.build_log[key]["ptxas"].splitlines():
        if "registers" in ln or "spill" in ln or "Compiling" in ln:
            print(tag, ln.strip())
    print(tag, "param_bytes", param_bytes(fs), flush=True)
    if what == "build":
        return
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
    if what == "main":
        main_arms(cs, fs, dev, tag, masked_batch)
        return
    if what == "wgrad":
        wgrad_arms(cs, fs, dev, tag, masked_batch)
        return
    if what == "scope":
        t1 = time.time()
        cs.phase_scope({})
        print(tag, "scope_s", round(time.time() - t1, 2), flush=True)
        return
    if what == "masks":
        mask_costs(cs, fs, dev, tag, masked_batch)
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
    if sys.argv[3:4] == ["grads"]:
        sys.exit(0 if compare_grads(sys.argv[2], sys.argv[4]) else 1)
    main(*sys.argv[1:4])
