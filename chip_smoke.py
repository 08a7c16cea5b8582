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
              of the main path's kernels what 2 epochs need.

Tolerances are those the JAX package's Pallas kernel is held to
(tests/test_fused_scan.py): loss rtol 1e-5 / atol 1e-6, gradients rtol
2e-4 / atol 2e-5. The carry histories are held to the gradient tolerance:
they are the states after up to 100 fp32 steps whose matmuls sum in a
different order in the kernel (serial FMA) and in the plain version
(cuBLAS), so the loss tolerance on each element is tighter than the
arithmetic guarantees.
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

    def bound(flops, nbytes, peak):
        tf, tb = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
        return (tf, "operations") if tf >= tb else (tb, "bytes")

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
    for name, key, replaces, count in rows:
        ms, plain = results["times"][key]
        bms, by = results["bounds"][key]
        out.append({"name": name, "route": "cuda", "source": src,
                    "replaces": replaces,
                    "launches": results["launches"][count],
                    "max_abs_err": results["errs"][key], "ms": ms,
                    "plain_ms": plain, "bound_ms": bms, "bound_by": by,
                    "library_ms": results["library_ms"].get(key)})
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
    _build.load("fused_scan")
    log = _build.build_log["fused_scan"]
    say("build", seconds=f"{time.time() - t0:.2f}",
        nvcc_s=f"{log['seconds']:.2f}")
    for ln in log["ptxas"].splitlines():
        if "registers" in ln or "spill" in ln:
            print("[build] " + ln.strip(), flush=True)
    results = {}
    phase_kernels(results)
    phase_timing(results)
    phase_trainer(results)
    print(kernels_line(results), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
