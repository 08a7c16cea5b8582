"""On-card smoke test of the PyTorch/CUDA port (njode_tpu_torch) on one H100.

    python3 chip_smoke.py            # every phase, one card, no arguments

Phases, one line each, then the ``kernels`` JSON line, the card's name and
power limit, and the final ``{"ok": true, ...}`` line:

1. device   - a CUDA card must be present (else exit 1, no result);
2. build    - nvcc builds ops/csrc/fused_scan.cu for sm_90a;
3. kernels  - every kernel against its plain PyTorch version at the main
              path's shapes (B=200, K=100, D=1, H=10, W=50, S=8, dropout
              0.1; the eval forward at B=4,000), in both mask modes, each
              kernel run twice and compared bit for bit;
4. timing   - CUDA-event times of each kernel and its plain version, and
              the least time the card could take (bound);
5. trainer  - njode_tpu_torch.training.trainer.train on a 20,000-path
              BlackScholes dataset, 2 epochs of batch 100 with 'prng'
              dropout masks; losses must be finite and the launch counts
              of the main path's kernels what 2 epochs need;
6. gob_kernels - the GRU-ODE-Bayes kernels (ops/csrc/fused_gob.cu: K5
              forward, K6 backward, K7 masks) against their plain versions
              at the published widths (D=1, hidden 50 and 100 with
              p_hidden = prep_hidden = cov_hidden = hidden, full field,
              logvar, mixing 1e-4 and 0.5, impute on and off, dropout 0.1,
              B=20, K=100), in both mask modes, each run twice and compared
              bit for bit; K5's eval form at B=2,000 (the validation split
              of the default 10,000-path dataset);
7. gob_timing - CUDA-event times of K5, K5 eval, K6 and K7 and their plain
              versions, and the bound of each;
8. gob_trainer - trainer.train(other_model="GRU_ODE_Bayes", hidden 50,
              batch 20, dropout 0.1, impute, logvar, mixing 1e-4) on a
              10,000-path BlackScholes dataset (8,000 train paths, 400 steps
              an epoch) for 2 epochs; losses and evaluation_mean_diff
              finite, optimal_eval_loss NaN by design, and the launch counts
              exactly what 2 epochs need.

Tolerances are those the JAX package's Pallas kernel is held to
(tests/test_fused_scan.py): loss rtol 1e-5 / atol 1e-6, gradients rtol
2e-4 / atol 2e-5. The carry histories are held to the gradient tolerance:
they are the states after up to 100 fp32 steps whose matmuls sum in a
different order in the kernel (serial FMA) and in the plain version
(cuBLAS), so the loss tolerance on each element is tighter than the
arithmetic guarantees. The GRU-ODE-Bayes gradients and histories take an
atol of 2e-5 scaled by the largest |value| (at least 1): the GOB loss is a
sum over observations with 1/var and mixing/s2^2 (up to 5,000) factors, so
gradients reach the thousands (tests/test_fused_gob.py scales its mesh
check the same way).
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# published peaks of one H100 SXM at 700 W (NVIDIA data sheet / Hopper
# white paper): fp32 outside the tensor cores, int32, memory bandwidth
PEAK_FP32 = 67e12
PEAK_INT32 = 33.5e12
PEAK_BYTES = 3.35e12
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)


def say(phase, **kw):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kw.items()),
          flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps, warmup=2):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        fn()
    e.record()
    e.synchronize()
    return s.elapsed_time(e) / reps


def max_err(a, b):
    return float((a.double() - b.double()).abs().max())


def check_close(name, a, b, tol):
    import torch
    ok = torch.allclose(a, b, **tol)
    err = max_err(a, b)
    if not ok:
        raise AssertionError(f"{name}: kernel disagrees with the plain "
                             f"version (max abs err {err:.3e}, {tol})")
    return err


def main_path_setup(B, K, seed, device):
    """Main-path model and a BlackScholes batch on the card."""
    import numpy as np
    import torch

    from njode_tpu_torch.data import grid, sde
    from njode_tpu_torch.data.datasets import hyperparam_default
    from njode_tpu_torch.models.njode import NJODE, NJODEConfig

    nn_desc = ((50, "tanh"), (50, "tanh"))
    cfg = NJODEConfig(1, 10, 1, nn_desc, nn_desc, nn_desc,
                      dropout_rate=0.1)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = NJODE(cfg).to(device)
    hp = dict(hyperparam_default, nb_paths=B, nb_steps=K)
    gen = torch.Generator(device=device).manual_seed(seed)
    paths, dt = sde.make_model("BlackScholes", hp).generate_paths(gen)
    obs = (np.random.RandomState(seed).random((B, K + 1)) < 0.1)
    batch = grid.to_torch(grid.batch_from_paths(
        paths.cpu().numpy(), obs.astype(np.int64), dt), device)
    return cfg, model, batch


def phase_kernels(results):
    import torch

    from njode_tpu_torch.ops import fused_scan as fs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    B, K = 200, 100
    cfg, model, batch = main_path_setup(B, K, 0, dev)
    leaves = [p.detach() for p in fs.flat_leaves(model)]
    arrays = (batch.times, batch.dt, batch.obs, batch.X, batch.n_obs_ot,
              batch.start_X)
    with torch.no_grad():
        h0 = model.encoder_map(batch.start_X)
    weight = 0.5
    gen = torch.Generator(device=dev).manual_seed(1)
    errs = {}
    for mode in ("input", "prng"):
        spec = fs.Spec(cfg, mode)
        u = seed = None
        if mode == "input":
            u = (torch.rand((K, spec.S, B, spec.w_max), generator=gen,
                            device=dev) < 0.9).to(torch.int8)
        else:
            seed = torch.randint(0, 2 ** 62, (1,), generator=gen,
                                 device=dev, dtype=torch.int64)
        runs = [fs.scan_fwd_cuda(spec, leaves, arrays, weight, h0, True, u,
                                 seed) for _ in range(2)]
        (lk, hk), (lk2, hk2) = runs
        torch.cuda.synchronize()
        if not (torch.equal(lk, lk2) and all(
                torch.equal(a, b) for a, b in zip(hk, hk2))):
            raise AssertionError(f"K1 ({mode}) differs between two runs")
        lp, hp = fs.scan_fwd_plain(spec, leaves, arrays, weight, h0, True,
                                   u, seed)
        e_loss = check_close(f"K1 loss ({mode})", lk, lp, LOSS_TOL)
        e_hist = max(check_close(f"K1 {n} ({mode})", a, b, GRAD_TOL)
                     for n, a, b in zip(("h", "lastX", "tau"), hk, hp))
        dloss = torch.ones((), device=dev)
        gk, dk = fs.scan_bwd_cuda(spec, leaves, arrays, weight, True, hk,
                                  dloss, u, seed)
        gk2, dk2 = fs.scan_bwd_cuda(spec, leaves, arrays, weight, True, hk,
                                    dloss, u, seed)
        torch.cuda.synchronize()
        if not (torch.equal(dk, dk2) and all(
                torch.equal(a, b) for a, b in zip(gk, gk2))):
            raise AssertionError(f"K2 ({mode}) differs between two runs")
        gp, dp = fs.scan_bwd_plain(spec, leaves, arrays, weight, True, hk,
                                   dloss, u, seed)
        e_grad = max(check_close(f"K2 grad {i} ({mode})", a, b, GRAD_TOL)
                     for i, (a, b) in enumerate(zip(gk, gp)))
        e_dh0 = check_close(f"K2 dh0 ({mode})", dk, dp, GRAD_TOL)
        errs[mode] = dict(loss=e_loss, hist=e_hist, grad=e_grad, dh0=e_dh0)
        say("kernels", mode=mode, K1_loss_err=f"{e_loss:.3e}",
            K1_hist_err=f"{e_hist:.3e}", K2_grad_err=f"{e_grad:.3e}",
            K2_dh0_err=f"{e_dh0:.3e}", loss=f"{float(lk):.6f}",
            bitwise_repeat=True)
        if mode == "prng":
            spec_p, seed_p = spec, seed
    # K4 directly: the kernels' Philox against the plain Philox, all steps
    m1 = fs.philox_masks_cuda(seed_p, K, spec_p.S, B, spec_p.w_max,
                              spec_p.thresh)
    m2 = fs.philox_masks_cuda(seed_p, K, spec_p.S, B, spec_p.w_max,
                              spec_p.thresh)
    mp = fs.philox_keep_plain(int(seed_p), torch.arange(K, device=dev),
                              spec_p.S, B, spec_p.w_max, spec_p.thresh, dev)
    n_bad = int((m1.bool() != mp).sum())
    if n_bad or not torch.equal(m1, m2):
        raise AssertionError(f"K4 Philox masks disagree at {n_bad} places")
    keep_frac = float(m1.float().mean())
    say("kernels", K4_mask_mismatches=n_bad, keep_fraction=f"{keep_frac:.5f}")
    # K3 at the validation split's size
    B3 = 4000
    cfg3, model3, batch3 = main_path_setup(B3, K, 2, dev)
    leaves3 = [p.detach() for p in fs.flat_leaves(model3)]
    arrays3 = (batch3.times, batch3.dt, batch3.obs, batch3.X,
               batch3.n_obs_ot, batch3.start_X)
    with torch.no_grad():
        h03 = model3.encoder_map(batch3.start_X)
    spec3 = fs.Spec(cfg3, "input")
    l3 = [fs.scan_fwd_cuda(spec3, leaves3, arrays3, weight, h03, False,
                           want_hists=False)[0] for _ in range(2)]
    torch.cuda.synchronize()
    if not torch.equal(l3[0], l3[1]):
        raise AssertionError("K3 differs between two runs")
    l3p, _ = fs.scan_fwd_plain(spec3, leaves3, arrays3, weight, h03, False,
                               want_hists=False)
    e3 = check_close("K3 loss", l3[0], l3p, LOSS_TOL)
    # reduce_partials at the K2 partials' shape
    n_cta = -(-B // fs.ROWS)
    parts = torch.randn((n_cta, spec3.n_params), generator=gen, device=dev)
    r1 = fs.reduce_partials_cuda(parts)
    r2 = fs.reduce_partials_cuda(parts)
    if not torch.equal(r1, r2):
        raise AssertionError("reduce_partials differs between two runs")
    e_red = check_close("reduce_partials", r1,
                        fs.reduce_partials_plain(parts), LOSS_TOL)
    say("kernels", K3_loss_err=f"{e3:.3e}", K3_loss=f"{float(l3[0]):.6f}",
        reduce_err=f"{e_red:.3e}")
    results["setup"] = dict(cfg=cfg, model=model, batch=batch,
                            leaves=leaves, arrays=arrays, h0=h0,
                            arrays3=arrays3, leaves3=leaves3, h03=h03,
                            spec3=spec3, parts=parts, seed=seed_p)
    results["errs"] = dict(
        K1=max(errs[m]["loss"] for m in errs),
        K2=max(max(errs[m]["grad"], errs[m]["dh0"]) for m in errs),
        K3=e3, K4=float(n_bad), reduce=e_red)


def _macs_per_row_step(spec):
    def macs(ws):
        return sum(a * b for a, b in zip(ws[:-1], ws[1:]))
    return macs(spec.ode_w) + macs(spec.enc_w) + 2 * macs(spec.ro_w)


def phase_timing(results):
    import torch

    from njode_tpu_torch.ops import fused_scan as fs

    st = results["setup"]
    cfg, leaves, arrays, h0 = st["cfg"], st["leaves"], st["arrays"], st["h0"]
    spec = fs.Spec(cfg, "prng")
    seed = st["seed"]
    K, B = arrays[2].shape
    w = 0.5
    fwd = lambda: fs.scan_fwd_cuda(spec, leaves, arrays, w, h0, True,  # noqa
                                   None, seed)
    _, hists = fwd()
    dloss = torch.ones((), device=h0.device)
    bwd = lambda: fs.scan_bwd_cuda(spec, leaves, arrays, w, True,  # noqa
                                   hists, dloss, None, seed)
    spec3, arrays3, leaves3, h03 = (st["spec3"], st["arrays3"],
                                    st["leaves3"], st["h03"])
    K3, B3 = arrays3[2].shape
    ev = lambda: fs.scan_fwd_cuda(spec3, leaves3, arrays3, w, h03,  # noqa
                                  False, want_hists=False)
    parts = st["parts"]
    t = {}
    t["K1"] = (cuda_ms(fwd, 20),
               cuda_ms(lambda: fs.scan_fwd_plain(spec, leaves, arrays, w, h0,
                                                 True, None, seed), 2, 1))
    t["K2"] = (cuda_ms(bwd, 20),
               cuda_ms(lambda: fs.scan_bwd_plain(spec, leaves, arrays, w,
                                                 True, hists, dloss, None,
                                                 seed), 2, 1))
    t["K3"] = (cuda_ms(ev, 10),
               cuda_ms(lambda: fs.scan_fwd_plain(spec3, leaves3, arrays3, w,
                                                 h03, False,
                                                 want_hists=False), 2, 1))
    karange = torch.arange(K, device=h0.device)
    t["K4"] = (cuda_ms(lambda: fs.philox_masks_cuda(
        seed, K, spec.S, B, spec.w_max, spec.thresh), 50),
        cuda_ms(lambda: fs.philox_keep_plain(
            int(seed), karange, spec.S, B, spec.w_max, spec.thresh,
            h0.device), 3, 1))
    lib_ms = cuda_ms(lambda: parts.sum(dim=0), 200)
    t["reduce"] = (cuda_ms(lambda: fs.reduce_partials_cuda(parts), 200),
                   cuda_ms(lambda: fs.reduce_partials_plain(parts), 200))
    # K1 and K2 at the trainer's batch (100 rows), for the step breakdown
    Bt = 100
    arr_t = tuple(a.contiguous() for a in arrays[:2]) + tuple(
        a[:, :Bt].contiguous() for a in arrays[2:4]) + tuple(
        a[:Bt].contiguous() for a in arrays[4:])
    h0_t = h0[:Bt].contiguous()
    _, hists_t = fs.scan_fwd_cuda(spec, leaves, arr_t, w, h0_t, True, None,
                                  seed)
    k1_t = cuda_ms(lambda: fs.scan_fwd_cuda(spec, leaves, arr_t, w, h0_t,
                                            True, None, seed), 20)
    k2_t = cuda_ms(lambda: fs.scan_bwd_cuda(spec, leaves, arr_t, w, True,
                                            hists_t, dloss, None, seed), 20)
    say("timing", kernel="K1", B=Bt, ms=f"{k1_t:.4f}")
    say("timing", kernel="K2", B=Bt, ms=f"{k2_t:.4f}")

    # bounds: max(operations / peak, bytes / bandwidth), each input read
    # once and each output written once
    mac = _macs_per_row_step(spec)
    P = spec.n_params
    in_bytes = 4 * (2 * K + K * B + K * B * spec.D + B + B * spec.D
                    + B * spec.H + P) + 8
    hist_bytes = 4 * K * B * (spec.H + spec.D + 1)
    f1 = 2.0 * mac * B * K
    b1 = in_bytes + hist_bytes + 4 * -(-B // fs.ROWS)
    # backward: the recomputed forward, plus dW and dx per linear
    f2 = 3.0 * f1
    b2 = in_bytes + hist_bytes + 4 + 4 * -(-B // fs.ROWS) * P + 4 * B * spec.H
    f3 = 2.0 * mac * B3 * K3
    b3 = 4 * (2 * K3 + K3 * B3 * 2 + B3 * 2 + B3 * spec.H + P)
    n_mask = K * spec.S * B * spec.w_max
    # one Philox4x32-10 (10 rounds x 8 ops + 18 key adds) per 4 mask words,
    # plus one compare per element
    f4 = n_mask * (98.0 / 4 + 1)
    b4 = n_mask + 8
    n_parts, n = parts.shape
    b5 = 4 * (n_parts * n + n)
    f5 = float(n_parts * n)

    results["bounds"] = {"K1": bound(f1, b1, PEAK_FP32),
                         "K2": bound(f2, b2, PEAK_FP32),
                         "K3": bound(f3, b3, PEAK_FP32),
                         "K4": bound(f4, b4, PEAK_INT32),
                         "reduce": bound(f5, b5, PEAK_FP32)}
    results["times"] = t
    results["library_ms"] = {"reduce": lib_ms}
    for k, (ms, plain) in t.items():
        bms, by = results["bounds"][k]
        say("timing", kernel=k, ms=f"{ms:.4f}", plain_ms=f"{plain:.4f}",
            bound_ms=f"{bms:.5f}", bound_by=by)


def phase_trainer(results):
    import numpy as np
    import torch

    from njode_tpu_torch.data import datasets
    from njode_tpu_torch.ops import fused_scan as fs
    from njode_tpu_torch.training import trainer
    from njode_tpu_torch.utils.csv_frame import read_frame, to_float

    tmp = tempfile.mkdtemp(prefix="njode_smoke_")
    try:
        hp = dict(datasets.hyperparam_default, nb_paths=20_000,
                  obs_perc=0.1)
        t0 = time.time()
        datasets.create_dataset("BlackScholes", hp, seed=0,
                                base_path=os.path.join(tmp, "data"))
        say("trainer", dataset_s=f"{time.time() - t0:.2f}", paths=20000)
        fs.reset_launch_counts()
        trainer.train(epochs=2, batch_size=100, dropout_rate=0.1,
                      dataset="BlackScholes", plot=False, evaluate=True,
                      pallas_mask_mode="prng",
                      base_data_path=os.path.join(tmp, "data"),
                      saved_models_path=os.path.join(tmp, "models"))
        counts = dict(fs.LAUNCHES)
        cols, rows = read_frame(os.path.join(tmp, "models", "id-1",
                                             "metric_id-1.csv"))
        for row in rows:
            rec = dict(zip(cols, row))
            vals = {k: to_float(rec[k]) for k in (
                "train_loss", "eval_loss", "optimal_eval_loss",
                "evaluation_mean_diff", "train_time", "eval_time")}
            if not all(np.isfinite(v) for v in vals.values()):
                raise AssertionError(f"non-finite trainer metrics: {rec}")
            say("trainer", epoch=rec["epoch"],
                **{k: f"{v:.6f}" for k, v in vals.items()})
        if len(rows) != 2:
            raise AssertionError(f"expected 2 metric rows, got {len(rows)}")
        steps = 2 * (16_000 // 100)
        expect = {"njode_scan_fwd": steps, "njode_scan_bwd": steps,
                  "njode_scan_eval": 2, "philox_keep": 2 * steps}
        for k, v in expect.items():
            if counts[k] != v:
                raise AssertionError(f"launch count {k}={counts[k]}, "
                                     f"expected {v}: {counts}")
        if counts["reduce_partials"] < 2 * steps + 2:
            raise AssertionError(f"reduce_partials launched "
                                 f"{counts['reduce_partials']} times")
        say("trainer", launches=json.dumps(counts).replace(" ", ""))
        results["launches"] = counts
        torch.cuda.synchronize()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def scaled_tol(ref):
    return dict(rtol=2e-4, atol=2e-5 * max(1.0, float(ref.abs().max())))


def gob_setup(B, K, hidden, impute, mixing, seed, device):
    """A GRU-ODE-Bayes model at the published widths and a BlackScholes
    batch (obs_perc 0.1) on the card; returns (cfg, model, batch, arrays,
    leaves, (h0, m0, v0))."""
    import numpy as np
    import torch

    from njode_tpu_torch.data import grid, sde
    from njode_tpu_torch.data.datasets import hyperparam_default
    from njode_tpu_torch.models import gru_ode_bayes as gob
    from njode_tpu_torch.ops import fused_gob as fg

    cfg = gob.GOBConfig(input_size=1, hidden_size=hidden, p_hidden=hidden,
                        prep_hidden=hidden, cov_size=1, cov_hidden=hidden,
                        logvar=True, mixing=mixing, dropout_rate=0.1,
                        full_gru_ode=True, impute=impute)
    model = gob.GOB(cfg, generator=torch.Generator().manual_seed(seed))
    model.to(device)
    hp = dict(hyperparam_default, nb_paths=B, nb_steps=K)
    gen = torch.Generator(device=device).manual_seed(seed)
    paths, dt = sde.make_model("BlackScholes", hp).generate_paths(gen)
    obs = (np.random.RandomState(seed).random((B, K + 1)) < 0.1)
    batch = grid.to_torch(grid.batch_from_paths(
        paths.cpu().numpy(), obs.astype(np.int64), dt), device)
    arrays = (batch.times, batch.dt, batch.obs, batch.X, batch.M)
    spec = fg.Spec(cfg)
    leaves = [p.detach() for p in fg.flat_leaves(model, spec)]
    with torch.no_grad():
        h0 = gob.mlp2(model.covariates_map, batch.start_X, 0.0)
        p0 = gob.mlp2(model.p_model, h0, 0.0)
    return cfg, model, batch, arrays, leaves, (
        h0.contiguous(), p0[:, :1].contiguous(), p0[:, 1:].contiguous())


def phase_gob_kernels(results):
    import torch

    from njode_tpu_torch.ops import fused_gob as fg

    dev = torch.device("cuda")
    B, K = 20, 100
    errs = {"K5": 0.0, "K6": 0.0}
    gen = torch.Generator(device=dev).manual_seed(5)
    for hidden in (50, 100):
        for impute, mixing in ((True, 1e-4), (False, 1e-4), (True, 0.5),
                               (False, 0.5)):
            cfg, _, _, arrays, leaves, (h0, m0, v0) = gob_setup(
                B, K, hidden, impute, mixing, hidden, dev)
            for mode in ("input", "prng"):
                spec = fg.Spec(cfg, mode)
                u = seed = None
                if mode == "input":
                    u = (torch.rand((K, 3, B, spec.P), generator=gen,
                                    device=dev) < 0.9).to(torch.int8)
                else:
                    seed = torch.randint(0, 2 ** 62, (1,), generator=gen,
                                         device=dev, dtype=torch.int64)
                tag = f"H={hidden} impute={impute} mixing={mixing} {mode}"
                runs = [fg.gob_scan_fwd_cuda(spec, leaves, arrays, h0, m0, v0,
                                             True, u, seed)
                        for _ in range(2)]
                (lk, hk), (lk2, hk2) = runs
                torch.cuda.synchronize()
                if not (torch.equal(lk, lk2) and all(
                        torch.equal(a, b) for a, b in zip(hk, hk2))):
                    raise AssertionError(f"K5 ({tag}) differs between runs")
                lp, hp = fg.gob_scan_fwd_plain(spec, leaves, arrays, h0, m0,
                                               v0, True, u, seed)
                e_loss = check_close(f"K5 loss ({tag})", lk, lp, LOSS_TOL)
                e_hist = max(check_close(f"K5 {n} ({tag})", a, b,
                                         scaled_tol(b))
                             for n, a, b in zip("hmv", hk, hp))
                dloss = torch.ones((), device=dev)
                outs = [fg.gob_scan_bwd_cuda(spec, leaves, arrays, True, hk,
                                             dloss, u, seed)
                        for _ in range(2)]
                torch.cuda.synchronize()
                (gk, *dk), (gk2, *dk2) = outs
                if not all(torch.equal(a, b) for a, b in
                           zip(list(gk) + dk, list(gk2) + dk2)):
                    raise AssertionError(f"K6 ({tag}) differs between runs")
                gp, *dp = fg.gob_scan_bwd_plain(spec, leaves, arrays, True,
                                                hk, dloss, u, seed)
                tol = scaled_tol(torch.cat([g.reshape(-1) for g in gp]))
                e_grad = max(check_close(f"K6 grad {i} ({tag})", a, b, tol)
                             for i, (a, b) in enumerate(zip(gk, gp)))
                e_d0 = max(check_close(f"K6 {n} ({tag})", a, b, scaled_tol(b))
                           for n, a, b in zip(("dh0", "dm0", "dv0"), dk, dp))
                errs["K5"] = max(errs["K5"], e_loss)
                errs["K6"] = max(errs["K6"], e_grad, e_d0)
                say("gob_kernels", H=hidden, impute=impute, mixing=mixing,
                    mode=mode, K5_loss_err=f"{e_loss:.3e}",
                    K5_hist_err=f"{e_hist:.3e}", K6_grad_err=f"{e_grad:.3e}",
                    K6_d0_err=f"{e_d0:.3e}", loss=f"{float(lk):.6f}",
                    max_grad=f"{float(tol['atol']) / 2e-5:.3e}",
                    bitwise_repeat=True)
    # K7 directly: the kernels' Philox slots 0-2 against the plain Philox
    spec = fg.Spec(cfg, "prng")
    seed = torch.randint(0, 2 ** 62, (1,), generator=gen, device=dev,
                         dtype=torch.int64)
    m1 = fg.gob_masks_cuda(seed, K, B, 50, spec.thresh)
    m2 = fg.gob_masks_cuda(seed, K, B, 50, spec.thresh)
    mp = fg.gob_masks_plain(int(seed), torch.arange(K, device=dev), B, 50,
                            spec.thresh, dev)
    n_bad = int((m1.bool() != mp).sum())
    if n_bad or not torch.equal(m1, m2):
        raise AssertionError(f"K7 Philox masks disagree at {n_bad} places")
    say("gob_kernels", K7_mask_mismatches=n_bad,
        keep_fraction=f"{float(m1.float().mean()):.5f}")
    # K5's eval form at the validation split's size, the trainer's widths
    Be = 2000
    cfg_e, _, _, arrays_e, leaves_e, st_e = gob_setup(Be, K, 50, True, 1e-4,
                                                      7, dev)
    spec_e = fg.Spec(cfg_e, "input")
    le = [fg.gob_scan_fwd_cuda(spec_e, leaves_e, arrays_e, *st_e, False,
                               want_hists=False)[0] for _ in range(2)]
    torch.cuda.synchronize()
    if not torch.equal(le[0], le[1]):
        raise AssertionError("K5 eval differs between two runs")
    lep, _ = fg.gob_scan_fwd_plain(spec_e, leaves_e, arrays_e, *st_e, False,
                                   want_hists=False)
    e_ev = check_close("K5 eval loss", le[0], lep, LOSS_TOL)
    say("gob_kernels", K5_eval_B=Be, K5_eval_err=f"{e_ev:.3e}",
        K5_eval_loss=f"{float(le[0]):.6f}")
    results["gob_errs"] = dict(K5=errs["K5"], K5e=e_ev, K6=errs["K6"],
                               K7=float(n_bad))
    results["gob_eval"] = (spec_e, arrays_e, leaves_e, st_e)


def gob_macs_per_row_step(spec):
    """MACs of one forward step for one batch row: the propagation (field
    evaluations or the discretized cell), p_model (after the propagation,
    after the jump, and at the midpoint with impute), the prep transform
    with its expander, and the observation GRU."""
    D, H, P, DP = spec.D, spec.H, spec.P, spec.DP
    x = 2 * D * H if spec.impute else 0
    gates = 3 if (spec.full or spec.disc) else 2
    field = gates * (x + H * H)
    pm = H * P + P * 2 * D
    n_field = 2 if spec.prop == 1 else 1
    n_pm = 3 if (spec.prop == 1 and spec.impute) else 2
    obs = 5 * D * DP + 3 * (DP * H + H * H)
    return n_field * field + n_pm * pm + obs


def gob_bounds(spec, K, B, n_cta, train=True):
    """(flop, bytes) of K5 (train or eval form) and K6 at these shapes:
    the flops from the MACs per row-step (backward 3x the forward), the
    bytes with each input read once and each output written once."""
    mac = gob_macs_per_row_step(spec)
    f_fwd = 2.0 * mac * B * K
    D, H = spec.D, spec.H
    w = 4 * spec.n_params
    data = 4 * (2 * K + K * B + 2 * K * B * D)
    hists = 4 * K * B * (H + 2 * D)
    b_fwd = w + data + 4 * B * (H + 2 * D) + 4 * n_cta + (
        hists + 8 if train else 0)
    b_bwd = w + data + hists + 8 + 4 + 4 * n_cta * spec.n_params \
        + 4 * B * (H + 2 * D)
    return (f_fwd, b_fwd), (3.0 * f_fwd, b_bwd)


def bound(flops, nbytes, peak):
    tf, tb = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (tf, "operations") if tf >= tb else (tb, "bytes")


def phase_gob_timing(results):
    import torch

    from njode_tpu_torch.ops import fused_gob as fg

    dev = torch.device("cuda")
    B, K = 20, 100
    t, bnd = {}, {}
    for hidden in (50, 100):
        cfg, _, _, arrays, leaves, st = gob_setup(B, K, hidden, True, 1e-4,
                                                  hidden, dev)
        spec = fg.Spec(cfg, "prng")
        seed = torch.tensor([20251016], dtype=torch.int64, device=dev)
        fwd = lambda: fg.gob_scan_fwd_cuda(spec, leaves, arrays, *st,  # noqa
                                           True, None, seed)
        _, hists = fwd()
        dloss = torch.ones((), device=dev)
        bwd = lambda: fg.gob_scan_bwd_cuda(spec, leaves, arrays, True,  # noqa
                                           hists, dloss, None, seed)
        k5 = cuda_ms(fwd, 10)
        k6 = cuda_ms(bwd, 5)
        n_cta = -(-B // fg.ROWS)
        (f5, b5), (f6, b6) = gob_bounds(spec, K, B, n_cta)
        say("gob_timing", kernel="K5", H=hidden, B=B, ms=f"{k5:.4f}",
            bound_ms=f"{bound(f5, b5, PEAK_FP32)[0]:.5f}")
        say("gob_timing", kernel="K6", H=hidden, B=B, ms=f"{k6:.4f}",
            bound_ms=f"{bound(f6, b6, PEAK_FP32)[0]:.5f}")
        if hidden == 50:                 # the trainer's configuration
            t["K5"] = (k5, cuda_ms(lambda: fg.gob_scan_fwd_plain(
                spec, leaves, arrays, *st, True, None, seed), 2, 1))
            t["K6"] = (k6, cuda_ms(lambda: fg.gob_scan_bwd_plain(
                spec, leaves, arrays, True, hists, dloss, None, seed), 1, 1))
            bnd["K5"] = bound(f5, b5, PEAK_FP32)
            bnd["K6"] = bound(f6, b6, PEAK_FP32)
            karange = torch.arange(K, device=dev)
            t["K7"] = (cuda_ms(lambda: fg.gob_masks_cuda(
                seed, K, B, spec.P, spec.thresh), 50),
                cuda_ms(lambda: fg.gob_masks_plain(
                    int(seed), karange, B, spec.P, spec.thresh, dev), 3, 1))
            n_mask = K * 3 * B * spec.P
            bnd["K7"] = bound(n_mask * (98.0 / 4 + 1), n_mask + 8,
                              PEAK_INT32)
    spec_e, arrays_e, leaves_e, st_e = results["gob_eval"]
    Ke, Be = arrays_e[2].shape
    ev = lambda: fg.gob_scan_fwd_cuda(spec_e, leaves_e, arrays_e,  # noqa
                                      *st_e, False, want_hists=False)
    t["K5e"] = (cuda_ms(ev, 5), cuda_ms(lambda: fg.gob_scan_fwd_plain(
        spec_e, leaves_e, arrays_e, *st_e, False, want_hists=False), 1, 1))
    (fe, be), _ = gob_bounds(spec_e, Ke, Be, -(-Be // fg.ROWS), train=False)
    bnd["K5e"] = bound(fe, be, PEAK_FP32)
    results["times"].update(t)
    results["bounds"].update(bnd)
    for k in ("K5", "K5e", "K6", "K7"):
        ms, plain = t[k]
        bms, by = bnd[k]
        say("gob_timing", kernel=k, ms=f"{ms:.4f}", plain_ms=f"{plain:.4f}",
            bound_ms=f"{bms:.6f}", bound_by=by,
            roofline_share=f"{bms / ms:.2e}")


GOB_TRAIN_SIZE = 8000      # all 8,000 training paths: 400 steps an epoch


def phase_gob_trainer(results):
    import numpy as np
    import torch

    from njode_tpu_torch.data import datasets
    from njode_tpu_torch.ops import fused_gob as fg
    from njode_tpu_torch.ops import fused_scan as fs
    from njode_tpu_torch.training import trainer
    from njode_tpu_torch.utils.csv_frame import read_frame, to_float

    tmp = tempfile.mkdtemp(prefix="njode_smoke_gob_")
    try:
        hp = dict(datasets.hyperparam_default, obs_perc=0.1)
        t0 = time.time()
        datasets.create_dataset("BlackScholes", hp, seed=0,
                                base_path=os.path.join(tmp, "data"))
        say("gob_trainer", dataset_s=f"{time.time() - t0:.2f}",
            paths=hp["nb_paths"], training_size=GOB_TRAIN_SIZE)
        fs.reset_launch_counts()
        fg.reset_launch_counts()
        trainer.train(epochs=2, batch_size=20, hidden_size=50,
                      dropout_rate=0.1, dataset="BlackScholes", plot=False,
                      evaluate=True, other_model="GRU_ODE_Bayes",
                      training_size=GOB_TRAIN_SIZE,
                      base_data_path=os.path.join(tmp, "data"),
                      saved_models_path=os.path.join(tmp, "models"),
                      **{"GRU_ODE_Bayes-impute": True,
                         "GRU_ODE_Bayes-logvar": True,
                         "GRU_ODE_Bayes-mixing": 1e-4})
        torch.cuda.synchronize()
        counts = dict(fg.LAUNCHES)
        counts["reduce_partials"] = fs.LAUNCHES["reduce_partials"]
        njode_counts = {k: v for k, v in fs.LAUNCHES.items()
                        if k != "reduce_partials"}
        cols, rows = read_frame(os.path.join(tmp, "models", "id-1",
                                             "metric_id-1.csv"))
        for row in rows:
            rec = dict(zip(cols, row))
            vals = {k: to_float(rec[k]) for k in (
                "train_loss", "eval_loss", "evaluation_mean_diff",
                "train_time", "eval_time")}
            if not all(np.isfinite(v) for v in vals.values()):
                raise AssertionError(f"non-finite GOB trainer metrics: {rec}")
            if not np.isnan(to_float(rec["optimal_eval_loss"])):
                raise AssertionError("optimal_eval_loss should be NaN for "
                                     f"GRU-ODE-Bayes: {rec}")
            say("gob_trainer", epoch=rec["epoch"],
                **{k: f"{v:.6f}" for k, v in vals.items()})
        if len(rows) != 2:
            raise AssertionError(f"expected 2 metric rows, got {len(rows)}")
        steps = 2 * (GOB_TRAIN_SIZE // 20)
        expect = {"gob_scan_fwd": steps, "gob_scan_bwd": steps,
                  "gob_scan_eval": 2, "gob_philox_keep": 2 * steps,
                  "reduce_partials": 2 * steps + 2}
        for k, v in expect.items():
            if counts[k] != v:
                raise AssertionError(f"launch count {k}={counts[k]}, "
                                     f"expected {v}: {counts}")
        if any(njode_counts.values()):
            raise AssertionError(f"NJODE kernels ran in the GOB path: "
                                 f"{njode_counts}")
        say("gob_trainer", launches=json.dumps(counts).replace(" ", ""))
        results["gob_launches"] = counts
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def kernels_line(results):
    src = "njode_tpu_torch/ops/csrc/fused_scan.cu"
    rows = [("njode_scan_fwd", "K1", "njode_tpu/ops/fused_scan.py:1115",
             "njode_scan_fwd"),
            ("njode_scan_bwd", "K2", "njode_tpu/ops/fused_scan.py:1164",
             "njode_scan_bwd"),
            ("njode_scan_eval", "K3", "njode_tpu/ops/fused_scan.py:1278",
             "njode_scan_eval"),
            ("philox_keep", "K4", "njode_tpu/ops/fused_scan.py:651",
             "philox_keep"),
            ("reduce_partials", "reduce",
             "njode_tpu/ops/fused_scan.py:522", "reduce_partials")]
    out = []
    gl = results["gob_launches"]
    for name, key, replaces, count in rows:
        ms, plain = results["times"][key]
        bms, by = results["bounds"][key]
        launches = results["launches"][count]
        if name == "reduce_partials":    # runs on both paths
            launches += gl["reduce_partials"]
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": replaces, "launches": launches,
                    "max_abs_err": results["errs"][key], "ms": ms,
                    "plain_ms": plain, "bound_ms": bms, "bound_by": by,
                    "library_ms": results["library_ms"].get(key)})
    gsrc = "njode_tpu_torch/ops/csrc/fused_gob.cu"
    for name, key, replaces in (
            ("gob_scan_fwd", "K5", "njode_tpu/ops/fused_gob.py:919"),
            ("gob_scan_eval", "K5e", "njode_tpu/ops/fused_gob.py:718"),
            ("gob_scan_bwd", "K6", "njode_tpu/ops/fused_gob.py:963"),
            ("gob_philox_keep", "K7", "njode_tpu/ops/fused_gob.py:700")):
        ms, plain = results["times"][key]
        bms, by = results["bounds"][key]
        out.append({"name": name, "route": "cuda",
                    "source": gsrc if key != "K7"
                    else "njode_tpu_torch/ops/csrc/philox.cuh",
                    "replaces": replaces, "launches": gl[name],
                    "max_abs_err": results["gob_errs"][key], "ms": ms,
                    "plain_ms": plain, "bound_ms": bms, "bound_by": by,
                    "library_ms": None})
    return json.dumps({"kernels": out})


def main():
    sys.path.insert(0, ROOT)
    if not os.path.isdir(os.path.join(ROOT, "njode_tpu_torch")):
        print("chip_smoke: the njode_tpu_torch package is not beside this "
              "script", file=sys.stderr)
        return 1
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    card = card_line()
    say("device", name=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), card=f"'{card}'",
        torch=torch.__version__, cuda=torch.version.cuda)
    from njode_tpu_torch.ops import _build
    t0 = time.time()
    libs = ("fused_scan", "fused_gob")
    _build.build_all(libs)             # one nvcc per source, in parallel
    for name in libs:
        _build.load(name)
        log = _build.build_log[name]
        say("build", lib=name, nvcc_s=f"{log['seconds']:.2f}")
        for ln in log["ptxas"].splitlines():
            if "registers" in ln or "spill" in ln or "Compiling" in ln:
                print("[build] " + ln.strip(), flush=True)
    say("build", seconds=f"{time.time() - t0:.2f}")
    results = {}
    t0 = time.time()
    for phase in (phase_kernels, phase_timing, phase_trainer,
                  phase_gob_kernels, phase_gob_timing, phase_gob_trainer):
        phase(results)
        say(phase.__name__[6:], phase_s=f"{time.time() - t0:.2f}")
        t0 = time.time()
    print(kernels_line(results), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
